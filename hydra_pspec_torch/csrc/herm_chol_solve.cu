// herm_chol_solve: x = A^-1 b for a batch of Hermitian positive-definite
// complex64 matrices A (B, n, n), n <= 128 per call, and many right-hand
// sides b (B, n, K), by Cholesky A = L L^H and two triangular sweeps. A
// larger n is block elimination in the wrapper (ops/kernels/spd_solve.py::
// blocked_herm_chol_solve), with this kernel on its diagonal blocks and
// cgemm for its products.
//
// Replaces the TPU kernel hydra_pspec_tpu/ops/pallas/spd_solve.py::
// spd_factor_solve / _spd_kernel (blocked NB = 32 Cholesky of the 2n x 2n
// real embedding with the forward substitution fused into the factor sweep,
// products split into 3 bf16 passes). The TPU needed the embedding because
// it has no complex ALU, and the bf16 passes because Mosaic offered no f32
// product. Here the n x n Hermitian matrix is factored directly in FP32
// complex arithmetic: half the memory and half the real FMAs. No tensor
// cores, no TF32.
//
// Bound on the H100: n^3/6 complex MACs for the factor and n^2 K for the
// two sweeps, about 2.6 GFLOP at B = 100, n = 120, K = 203 (0.04 ms at the
// FP32 rate), against ~50 MB of HBM traffic (0.015 ms): compute bound on
// paper. Each factor step is a block-wide barrier, and each sweep a chain of
// four dependent 32-row blocks, so latency keeps it well above that.
// Design:
//   1. factor_kernel: one CTA per chain holds A in shared memory (n x (n+1)
//      complex, 115 KB at n = 120), factors it with the Cholesky shared with
//      herm_inv.cu (herm_chol.cuh, pivot floored at FLT_MIN), and writes L
//      (zeros above the diagonal) to a scratch buffer;
//   2. sweep_kernel: one CTA per (chain, TILES tiles of 32 right-hand
//      sides) holds L in shared memory as 32 x 32 blocks (the rows padded to
//      a multiple of 32 with the identity). Each warp owns one tile's
//      columns (a lane per column) and one 32-row block of them in
//      registers. Block by block, the owning warp solves its diagonal block
//      on its own registers and hands the result to the warps below (above,
//      in the backward sweep) through shared memory, which subtract their
//      block's product with it: every L read is a broadcast, every step
//      four FMAs per complex multiply-add, two barriers per block.
#include "herm_chol.cuh"

namespace {
constexpr int FACTOR_THREADS = 512;
constexpr int RB = 32;       // rows per block, and right-hand sides per tile
constexpr int MAX_BLOCKS = 4;  // n <= 32 * MAX_BLOCKS = 128
constexpr int TILES = 2;     // tiles per sweep CTA

__global__ void __launch_bounds__(FACTOR_THREADS)
factor_kernel(const float2* __restrict__ A, float2* __restrict__ L, int n) {
  extern __shared__ float2 sm[];
  const int ld = n + 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long boff = (long long)blockIdx.x * n * n;
  const float2* Ab = A + boff;
  for (int e = tid; e < n * n; e += nt) sm[(e / n) * ld + e % n] = Ab[e];
  __syncthreads();
  chol_lower_inplace(sm, n, ld);
  float2* Lb = L + boff;
  for (int e = tid; e < n * n; e += nt) {
    const int i = e / n, j = e % n;
    Lb[e] = (j <= i) ? sm[i * ld + j] : make_float2(0.f, 0.f);
  }
}

// offset of the 32 x 32 block (I, J), J <= I, of the blocked lower triangle
__device__ __forceinline__ int block_at(int I, int J) {
  return (I * (I + 1) / 2 + J) * RB * RB;
}

__device__ __forceinline__ float2 neg(float2 v) {
  return make_float2(-v.x, -v.y);
}

__global__ void __launch_bounds__(TILES * MAX_BLOCKS * 32)
sweep_kernel(const float2* __restrict__ L, const float2* __restrict__ b,
             float2* __restrict__ x, int n, int K) {
  extern __shared__ float4 sm4[];   // 16-byte aligned: pairs are read as one
  const int nb = (n + RB - 1) / RB;
  float2* Ls = reinterpret_cast<float2*>(sm4);     // nb (nb + 1) / 2 blocks
  float* dinv = reinterpret_cast<float*>(Ls + block_at(nb, 0));  // 32 nb
  float2* Xs = reinterpret_cast<float2*>(dinv + nb * RB);  // TILES blocks
  const int tid = threadIdx.x, nt = blockDim.x;
  const int chain = blockIdx.y;
  const float2* Lb = L + (long long)chain * n * n;
  for (int I = 0; I < nb; ++I)
    for (int J = 0; J <= I; ++J)
      for (int e = tid; e < RB * RB; e += nt) {
        const int r = RB * I + e / RB, c = RB * J + e % RB;
        float2 v = make_float2(r == c ? 1.f : 0.f, 0.f);   // padding rows
        if (r < n) v = (c <= r) ? Lb[(long long)r * n + c]
                                : make_float2(0.f, 0.f);
        Ls[block_at(I, J) + e] = v;
      }
  __syncthreads();
  for (int i = tid; i < nb * RB; i += nt)
    dinv[i] = 1.0f / Ls[block_at(i / RB, i / RB) + (i % RB) * (RB + 1)].x;

  const int lane = tid & 31, warp = tid >> 5;
  const int w = warp % nb, tile = warp / nb;   // row block, tile in the CTA
  float2* X = Xs + tile * RB * RB;
  const int col = (blockIdx.x * TILES + tile) * RB + lane;
  const bool live = col < K;
  const float2* bb = b + (long long)chain * n * K;
  float2 y[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int row = RB * w + r;
    y[r] = (live && row < n) ? bb[(long long)row * K + col]
                             : make_float2(0.f, 0.f);
  }
  __syncthreads();

  // forward sweep L y = b: block I solved by warp I, then subtracted below
  for (int I = 0; I < nb; ++I) {
    if (w == I) {
      const float2* D = Ls + block_at(I, I);
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const float d = dinv[RB * I + k];
        y[k].x *= d;
        y[k].y *= d;
        const float2 ny = neg(y[k]);
#pragma unroll
        for (int r = k + 1; r < RB; ++r) cfma(y[r], D[r * RB + k], ny);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) X[r * RB + lane] = y[r];
    }
    __syncthreads();
    if (w > I) {   // y_w -= L(w, I) x_I, two columns of L(w, I) per read
      const float2* O = Ls + block_at(w, I);
      for (int k = 0; k < RB; k += 2) {
        const float2 n0 = neg(X[k * RB + lane]);
        const float2 n1 = neg(X[(k + 1) * RB + lane]);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4 l = *reinterpret_cast<const float4*>(O + r * RB + k);
          cfma(y[r], make_float2(l.x, l.y), n0);
          cfma(y[r], make_float2(l.z, l.w), n1);
        }
      }
    }
    __syncthreads();
  }
  // backward sweep L^H x = y: block I solved by warp I, then subtracted above
  for (int I = nb - 1; I >= 0; --I) {
    if (w == I) {
      const float2* D = Ls + block_at(I, I);
#pragma unroll
      for (int k = RB - 1; k >= 0; --k) {
        const float d = dinv[RB * I + k];
        y[k].x *= d;
        y[k].y *= d;
        const float2 ny = neg(y[k]);
#pragma unroll
        for (int r = 0; r < k; ++r) cfma_conj(y[r], D[k * RB + r], ny);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) X[r * RB + lane] = y[r];
    }
    __syncthreads();
    if (w < I) {   // y_w -= L(I, w)^H x_I, two rows of L(I, w)^H per read
      const float2* O = Ls + block_at(I, w);
      for (int k = 0; k < RB; ++k) {
        const float2 nx = neg(X[k * RB + lane]);
#pragma unroll
        for (int r = 0; r < RB; r += 2) {
          const float4 l = *reinterpret_cast<const float4*>(O + k * RB + r);
          cfma_conj(y[r], make_float2(l.x, l.y), nx);
          cfma_conj(y[r + 1], make_float2(l.z, l.w), nx);
        }
      }
    }
    __syncthreads();
  }

  float2* xb = x + (long long)chain * n * K;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int row = RB * w + r;
    if (live && row < n) xb[(long long)row * K + col] = y[r];
  }
}
}  // namespace

HK_API int hk_herm_chol_solve(const float2* A, const float2* b, float2* L,
                              float2* x, int batch, int n, int K,
                              cudaStream_t stream) {
  if (n > RB * MAX_BLOCKS) return (int)cudaErrorInvalidValue;
  const size_t smem_f = sizeof(float2) * (size_t)n * (n + 1);
  cudaError_t err = cudaFuncSetAttribute(
      factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_f);
  if (err != cudaSuccess) return (int)err;
  factor_kernel<<<batch, FACTOR_THREADS, smem_f, stream>>>(A, L, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nb = (n + RB - 1) / RB;
  const size_t smem_s = sizeof(float2) * (nb * (nb + 1) / 2) * RB * RB +
                        sizeof(float) * nb * RB +
                        sizeof(float2) * TILES * RB * RB;
  err = cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_s);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (K + RB - 1) / RB;
  dim3 grid((tiles + TILES - 1) / TILES, batch);
  sweep_kernel<<<grid, TILES * nb * 32, smem_s, stream>>>(L, b, x, n, K);
  return (int)cudaGetLastError();
}
