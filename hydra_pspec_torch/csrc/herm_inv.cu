// herm_inv: per-chain inverse of the Jacobi-equilibrated Hermitian
// positive-definite system S = I + D P~ D (n x n complex64, n <= 128 per
// launch; a larger n is the block Schur recursion of the wrapper,
// ops/kernels/herm_inv.py::blocked_herm_inv, with this kernel on its
// diagonal blocks and cgemm for its products).
//
// Replaces the recursive Schur-complement SPD inverse of the TPU kernel,
// hydra_pspec_tpu/ops/pallas/spd_inv.py::_spd_inv_into (with its 32x32 base
// case spd_solve.py::_chol_block / _inv_lower_block), which inverted the
// 2n x 2n real embedding [[Re, -Im], [Im, Re]] because the TPU has no
// complex ALU. Here the n x n Hermitian matrix is factored directly: half
// the memory and half the real FMAs of the embedding.
//
// Bound on the H100: one chain's work is ~n^3 complex FMAs (Cholesky n^3/6,
// triangular inverse n^3/6, L^-H L^-1 n^3/3), a few MFLOP, on data that
// fits in one SM's shared memory. It is bound by the sequential dependency
// chain of the factorization (n steps, each ending in a barrier) and by
// shared-memory latency, not by HBM. Design: one CTA per chain holds the
// whole matrix in dynamic shared memory (n x (n+1) complex, 133 KB at
// n = 128, row stride n+1 against bank conflicts); the 256x256 real
// embedding (256 KiB) would not fit in the 227 KB a block may use.
//   1. right-looking Cholesky S = L L^H in place (lower triangle), pivot
//      floored at FLT_MIN as _chol_block does (herm_chol.cuh, shared with
//      herm_chol_solve.cu);
//   2. X = L^-1 by forward substitution, one thread per column; the strict
//      lower part of X goes to the (dead) upper triangle, transposed, its
//      diagonal to a separate vector;
//   3. S^-1 = X^H X, written to global memory (both triangles).
#include "herm_chol.cuh"

namespace {
constexpr int HI_THREADS = 512;

__global__ void __launch_bounds__(HI_THREADS)
herm_inv_kernel(const float2* __restrict__ S, float2* __restrict__ out,
                int n) {
  extern __shared__ float2 sm[];
  const int ld = n + 1;
  float2* A = sm;            // n x ld
  float2* dX = sm + n * ld;  // diag of X = L^-1
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long boff = (long long)blockIdx.x * n * n;
  const float2* Sb = S + boff;
  for (int e = tid; e < n * n; e += nt) A[(e / n) * ld + e % n] = Sb[e];
  __syncthreads();

  // 1. Cholesky (herm_chol.cuh)
  chol_lower_inplace(A, n, ld);

  // 2. X = L^-1, column j by thread j: X[i][j] stored at A[j][i] (i > j)
  for (int j = tid; j < n; j += nt) {
    const float2 xj = make_float2(1.0f / A[j * ld + j].x, 0.f);
    dX[j] = xj;
    for (int i = j + 1; i < n; ++i) {
      float2 s = make_float2(0.f, 0.f);
      cfma(s, A[i * ld + j], xj);
      for (int k = j + 1; k < i; ++k) cfma(s, A[i * ld + k], A[j * ld + k]);
      const float inv_lii = 1.0f / A[i * ld + i].x;
      A[j * ld + i] = make_float2(-s.x * inv_lii, -s.y * inv_lii);
    }
  }
  __syncthreads();

  // 3. S^-1[i][j] = sum_{k >= max(i, j)} conj(X[k][i]) X[k][j]
  float2* Ob = out + boff;
  for (int e = tid; e < n * n; e += nt) {
    const int i = e / n, j = e % n;
    float2 s = make_float2(0.f, 0.f);
    for (int k = max(i, j); k < n; ++k) {
      const float2 xki = (k == i) ? dX[i] : A[i * ld + k];
      const float2 xkj = (k == j) ? dX[j] : A[j * ld + k];
      cfma_conj(s, xki, xkj);
    }
    Ob[e] = s;
  }
}
}  // namespace

HK_API int hk_herm_inv(const float2* S, float2* out, int batch, int n,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float2) * ((size_t)n * (n + 1) + n);
  cudaError_t err = cudaFuncSetAttribute(
      herm_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  herm_inv_kernel<<<batch, HI_THREADS, smem, stream>>>(S, out, n);
  return (int)cudaGetLastError();
}
