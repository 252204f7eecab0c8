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
// FP32 rate), against ~50 MB of HBM traffic (0.015 ms): compute bound. The
// sweeps are most of the work; the factor's chain of single-warp steps is
// the latency. Design: one launch, one CTA of 16 warps per chain, so L
// never leaves shared memory (it never goes to HBM):
//   1. load the lower triangle of A and factor it with the blocked
//      Cholesky of herm_chol.cuh; invert each diagonal tile (a warp each);
//   2. fold the inverses into the off-diagonal blocks, a warp per product:
//      P(a, b) = L(a, b) Dinv_b in place of L(a, b) for the forward sweep,
//      Q(a, b) = Dinv_a L(a, b) into the free upper tile (b, a) for the
//      backward sweep; then no sweep step waits for a triangular solve;
//   3. the sweeps, 16 / nb tiles of 32 right-hand sides a pass: a warp per
//      (tile, 32-row block) keeps its block in registers, 8 rows x 4
//      columns a lane (each shared load feeds 4 or 8 complex multiply-adds,
//      so the tile products are bound by the FMA rate, not by shared-memory
//      bandwidth). At step I the owner of block I publishes it; the warps
//      below (above, backward) subtract P(w, I) y_I (Q(I, w)^H y_I) while
//      the owner forms x_I = Dinv_I y_I (Dinv_I^H y_I): two barriers a
//      step. The nb warps of a tile sit on different SM sub-partitions, and
//      each sub-partition holds a mix of row blocks (a Latin square).
// One CTA per chain for all its right-hand sides: at B = 100 that fills 100
// of the 132 SMs (one CTA an SM by its shared memory), and more CTAs per
// chain, each factoring its own copy or copying L from a cluster peer,
// only queue a second wave (PERF.md). Each output is a fixed-order sum over
// its own chain's data (no atomics), the same for any batch.
#include "herm_chol.cuh"

namespace {
using namespace hchol;

// A warp's 32 x 32 block: lane = (rg, cg) holds rows rg + 4 i and columns
// 4 cg + j in y[i][j] (each shared load below feeds 4 or 8 complex
// multiply-adds; the 4 rows a load instruction reads lie in different
// banks).
template <int ys>
__device__ __forceinline__ void to_block(float2* Y, const float2 (&y)[8][4],
                                         int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Y[(rg + 4 * i) * ys + 4 * cg + j] = y[i][j];
}

// y = ZERO ? M X : y +- M X for the 32 x 32 blocks M and X, with
// M[r][k] = m[r ms + k], or conj(m[k ms + r]) when H, and X[k][c] =
// X[k xs + c] (read as float4 when xs is even).
template <int ms, int xs, bool H, bool NEG, bool ZERO>
__device__ __forceinline__ void block_mma(float2 (&y)[8][4],
                                          const float2* m, const float2* X,
                                          int rg, int cg) {
  if (ZERO) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) y[i][j] = make_float2(0.f, 0.f);
  }
#pragma unroll 2
  for (int k = 0; k < TB; ++k) {
    float2 xv[4];
    if (xs % 2 == 0) {
      const float4* xp = reinterpret_cast<const float4*>(X + k * xs + 4 * cg);
      const float4 a = xp[0], c = xp[1];
      xv[0] = make_float2(a.x, a.y);
      xv[1] = make_float2(a.z, a.w);
      xv[2] = make_float2(c.x, c.y);
      xv[3] = make_float2(c.z, c.w);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = X[k * xs + 4 * cg + j];
    }
    if (NEG) {
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = neg(xv[j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rg + 4 * i;
      const float2 mv = H ? m[k * ms + r] : m[r * ms + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (H) cfma_conj(y[i][j], mv, xv[j]);
        else cfma(y[i][j], mv, xv[j]);
      }
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(THREADS)
solve_kernel(const float2* __restrict__ A, const float2* __restrict__ b,
             float2* __restrict__ x, int n, int K) {
  extern __shared__ float4 sm4[];   // 16-byte aligned: X is read as float4
  constexpr int nb = NB, ld = ld_of<NB>(), np = TB * NB;
  constexpr int tpp = THREADS / 32 / NB;          // tiles a pass
  float2* L = reinterpret_cast<float2*>(sm4);     // np x ld
  float2* Dinv = L + np * ld;      // the inverse of each diagonal tile
  float2* Xs = Dinv + nb * TB * TB;   // a published 32 x 32 block per tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane >> 3, cg = lane & 7;
  const int chain = blockIdx.x;

  // 1.
  load_lower<NB>(L, A + (long long)chain * n * n, n);
  chol_tiles<NB>(L);
  if (warp < nb) inv_tile<ld>(L + TB * warp * (ld + 1), Dinv + warp * TB * TB);
  __syncthreads();

  // 2. warps [0, NOFF) form Q, warps [NOFF, 2 NOFF) form P; both are stored
  // once every warp has read L
  constexpr int NOFF = nb * (nb - 1) / 2;
  float2 y[8][4];
  float2* fold = nullptr;
  if (warp < 2 * NOFF) {
    const bool q = warp < NOFF;
    int b0 = q ? warp : warp - NOFF, a = 1;
    while (b0 >= a) { b0 -= a; ++a; }
    float2* Lab = L + TB * a * ld + TB * b0;
    if (q)
      block_mma<TB, ld, false, false, true>(y, Dinv + a * TB * TB, Lab,
                                            rg, cg);
    else
      block_mma<ld, TB, false, false, true>(y, Lab, Dinv + b0 * TB * TB,
                                            rg, cg);
    fold = q ? L + TB * b0 * ld + TB * a : Lab;
  }
  __syncthreads();
  if (fold) to_block<ld>(fold, y, rg, cg);

  // 3. tile slot and row block of this warp
  const int slot = warp / nb, w = (warp % nb + slot) % nb;
  float2* X = Xs + slot * TB * TB;
  const int tiles = (K + TB - 1) / TB;
  const float2* bb = b + (long long)chain * n * K;
  float2* xb = x + (long long)chain * n * K;
  for (int t0 = 0; t0 < tiles; t0 += tpp) {
    const bool active = slot < tpp && t0 + slot < tiles;
    const int col0 = (t0 + slot) * TB + 4 * cg;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = TB * w + rg + 4 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        y[i][j] = (active && row < n && col0 + j < K)
                      ? bb[(long long)row * K + col0 + j]
                      : make_float2(0.f, 0.f);
    }
    __syncthreads();   // P and Q stored; X free from the previous pass

    // forward sweep L y = b
    for (int I = 0; I < nb; ++I) {
      if (active && w == I) to_block<TB>(X, y, rg, cg);   // y_I, final
      __syncthreads();
      if (active && w > I)    // y_w -= L(w, I) x_I = P(w, I) y_I
        block_mma<ld, TB, false, true, false>(y, L + TB * w * ld + TB * I,
                                              X, rg, cg);
      else if (active && w == I)   // x_I = L(I, I)^-1 y_I
        block_mma<TB, TB, false, false, true>(y, Dinv + I * TB * TB, X,
                                              rg, cg);
      __syncthreads();
    }
    // backward sweep L^H x = y
    for (int I = nb - 1; I >= 0; --I) {
      if (active && w == I) to_block<TB>(X, y, rg, cg);   // y_I, final
      __syncthreads();
      if (active && w < I)    // y_w -= L(I, w)^H x_I = Q(I, w)^H y_I
        block_mma<ld, TB, true, true, false>(y, L + TB * w * ld + TB * I,
                                             X, rg, cg);
      else if (active && w == I)   // x_I = L(I, I)^-H y_I
        block_mma<TB, TB, true, false, true>(y, Dinv + I * TB * TB, X,
                                             rg, cg);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = TB * w + rg + 4 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (active && row < n && col0 + j < K)
          xb[(long long)row * K + col0 + j] = y[i][j];
    }
  }
}
}  // namespace

// L: unused (L stays in shared memory); kept in the C interface, may be null
HK_API int hk_herm_chol_solve(const float2* A, const float2* b, float2* L,
                              float2* x, int batch, int n, int K,
                              cudaStream_t stream) {
  (void)L;
  if (n < 1 || n > TB * MAX_TILES || K < 1) return (int)cudaErrorInvalidValue;
  const int nb = (n + TB - 1) / TB, np = TB * nb;
  const int tpp = THREADS / 32 / nb;
  const size_t smem = sizeof(float2) *
      ((size_t)np * (np + 1) + (size_t)(nb + tpp) * TB * TB);
  void (*kernel)(const float2*, const float2*, float2*, int, int) =
      nb == 1 ? solve_kernel<1> : nb == 2 ? solve_kernel<2>
    : nb == 3 ? solve_kernel<3> : solve_kernel<4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, THREADS, smem, stream>>>(A, b, x, n, K);
  return (int)cudaGetLastError();
}
