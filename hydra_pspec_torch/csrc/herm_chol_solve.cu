// herm_chol_solve: x = A^-1 b for a batch of Hermitian positive-definite
// complex64 matrices A (B, n, n), n <= 192 per call, and many right-hand
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
//
// Above 128 (5 or 6 tiles a side, solve_tri_kernel) the padded square does
// not fit (296 KB at n = 192), and the sweeps above would keep 12 of the 16
// warps busy at nb = 6 (16 / nb = 2 tiles a pass) with each warp's row
// block idle for half of every sweep. So:
//   1. the lower tiles only (herm_tri.cuh, 177 KB at n = 192), factored
//      by the same blocked Cholesky; each diagonal tile inverted in place;
//   2. one fold, P(a, b) = L(a, b) Dinv_b in place of L(a, b), and
//      W_b = Dinv_b^H Dinv_b in place of Dinv_b, so both sweeps need only
//      P: the forward sweep subtracts P(w, I) t_I from the rows below the
//      published partial t_I = b_I - sum_{K<I} L(I, K) y_K, and the
//      backward sweep is x_I = W_I t_I - sum_{a>I} P(a, I)^H x_a, whose
//      first term the owner forms in the forward step (no Q tiles, no
//      upper tiles, no product on the backward sweep's owner);
//   3. a sweep schedule that keeps every warp busy at every step: the
//      right-hand sides go in chunks of 16 columns, four chunks at a time,
//      each chunk on 4 warps, and warp q of a chunk holds rows 8q..8q+7 of
//      every row block (a lane 2 rows x 2 columns of each), so the shrinking
//      work of a sweep step (the blocks below or above the published one)
//      is split evenly over all 16 warps. A chunk's 4 warps sit on the 4
//      SM sub-partitions and synchronise on a named barrier of their own,
//      once a step: the published block is double-buffered (8 KB a
//      chunk), so a step's publish never waits for the step before it to
//      finish reading. Each chunk runs its passes on its own.
#include "herm_chol.cuh"
#include "herm_tri.cuh"

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

// --- 128 < n <= 192: the lower tiles and the 16-warp sweep schedule ---

constexpr int CW = 16;            // right-hand-side columns of a chunk
constexpr int CHUNKS = 4;         // chunks at a time, 4 warps each
constexpr int XB = TB * CW;       // complex of one published block

// y[T][i][j] (+/-)= sum_k M(T)[8q + rg + 4i][k] X[k][2cg + j] for the row
// blocks T in [T0, T1), with M(T) = P(T, I) (SUB: forward update) or
// W_I (T0 = I, not SUB), or, when H, M(T)[r][k] = conj(P(I, T)[k][r])
// (backward update, SUB). X is the published block (row stride CW,
// read as float4). All of T0, T1 and the tiles' offsets are static.
template <int NB, int T0, int T1, bool H, bool SUB>
__device__ __forceinline__ void strip_mma(float2 (&y)[NB][2][2],
                                          const float2* A, int I,
                                          const float2* X, int q, int rg,
                                          int cg) {
  using htri::TS;
  using htri::off;
#pragma unroll 2
  for (int k = 0; k < TB; ++k) {
    const float4 xp = *reinterpret_cast<const float4*>(X + k * CW + 2 * cg);
    const float2 xv[2] = {
        SUB ? make_float2(-xp.x, -xp.y) : make_float2(xp.x, xp.y),
        SUB ? make_float2(-xp.z, -xp.w) : make_float2(xp.z, xp.w)};
#pragma unroll
    for (int T = T0; T < T1; ++T) {
      const float2* m = A + (H ? off<NB>(I, T) : off<NB>(T, I));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 8 * q + rg + 4 * i;
        const float2 mv = H ? m[k * TS + r] : m[r * TS + k];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (H) cfma_conj(y[T][i][j], mv, xv[j]);
          else cfma(y[T][i][j], mv, xv[j]);
        }
      }
    }
  }
}

// the lane's rows of a row block, published into X (as float4)
__device__ __forceinline__ void publish(float2* X, const float2 (&y)[2][2],
                                        int q, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    *reinterpret_cast<float4*>(X + (8 * q + rg + 4 * i) * CW + 2 * cg) =
        make_float4(y[i][0].x, y[i][0].y, y[i][1].x, y[i][1].y);
}

// barrier of the 4 warps of chunk c (ids 1..4; id 0 is __syncthreads)
__device__ __forceinline__ void sync_chunk(int c) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + c) : "memory");
}

// forward step I: publish t_I; y_I = W_I t_I, y_T -= P(T, I) t_I (T > I)
template <int NB, int I>
__device__ __forceinline__ void forward(float2 (&y)[NB][2][2],
                                        const float2* A, float2* Xs,
                                        int& st, int c, int q, int rg,
                                        int cg) {
  if constexpr (I < NB) {
    float2* X = Xs + (st++ & 1) * XB;
    publish(X, y[I], q, rg, cg);
    sync_chunk(c);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) y[I][i][j] = make_float2(0.f, 0.f);
    strip_mma<NB, I, I + 1, false, false>(y, A, I, X, q, rg, cg);
    strip_mma<NB, I + 1, NB, false, true>(y, A, I, X, q, rg, cg);
    forward<NB, I + 1>(y, A, Xs, st, c, q, rg, cg);
  }
}

// backward step a: publish x_a; y_T -= P(a, T)^H x_a (T < a)
template <int NB, int a>
__device__ __forceinline__ void backward(float2 (&y)[NB][2][2],
                                         const float2* A, float2* Xs,
                                         int& st, int c, int q, int rg,
                                         int cg) {
  if constexpr (a > 0) {
    float2* X = Xs + (st++ & 1) * XB;
    publish(X, y[a], q, rg, cg);
    sync_chunk(c);
    strip_mma<NB, 0, a, true, true>(y, A, a, X, q, rg, cg);
    backward<NB, a - 1>(y, A, Xs, st, c, q, rg, cg);
  }
}

template <int NB>
__global__ void __launch_bounds__(THREADS)
solve_tri_kernel(const float2* __restrict__ A, const float2* __restrict__ b,
                 float2* __restrict__ x, int n, int K) {
  extern __shared__ float4 sm4[];   // 16-byte aligned: X is read as float4
  using htri::off;
  constexpr int NOFF = NB * (NB - 1) / 2, NW = THREADS / 32;
  static_assert(NOFF <= NW, "every fold P(a, b) in the first round");
  float2* L = reinterpret_cast<float2*>(sm4);       // the lower tiles
  float2* Xs = L + htri::tiles<NB>() * htri::TILE;  // 2 blocks a chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane >> 3, cg = lane & 7;
  const int chain = blockIdx.x;

  // 1.
  htri::load_lower<NB>(L, A + (long long)chain * n * n, n);
  htri::chol<NB>(L);
  if (warp < NB) htri::inv_tile_in_place(L + off<NB>(warp, warp));
  __syncthreads();

  // 2. items [0, NOFF): P(a, b); [NOFF, NOFF + NB): W_b. The first round
  // holds every P, so its barrier orders every read of Dinv_b before W_b
  // is stored; a later round's W_b reads only its own tile.
  for (int r0 = 0; r0 < NOFF + NB; r0 += NW) {
    const int it = r0 + warp;
    float2 y[8][4];
    float2* fold = nullptr;
    if (it < NOFF) {
      int b0 = it, a = 1;
      while (b0 >= a) { b0 -= a; ++a; }
      fold = L + off<NB>(a, b0);
      block_mma<htri::TS, htri::TS, false, false, true>(
          y, fold, L + off<NB>(b0, b0), rg, cg);
    } else if (it < NOFF + NB) {
      fold = L + off<NB>(it - NOFF, it - NOFF);
      block_mma<htri::TS, htri::TS, true, false, true>(y, fold, fold, rg,
                                                        cg);
    }
    if (r0 == 0) __syncthreads();
    else __syncwarp();
    if (fold) to_block<htri::TS>(fold, y, rg, cg);
  }
  __syncthreads();

  // 3. chunk c of 16 columns, rows 8q..8q+7 of every row block
  const int c = warp >> 2, q = warp & 3;
  float2* Xs_c = Xs + c * 2 * XB;
  const float2* bb = b + (long long)chain * n * K;
  float2* xb = x + (long long)chain * n * K;
  int st = 0;
  for (int col0 = CW * c; col0 < K; col0 += CW * CHUNKS) {
    float2 y[NB][2][2];
#pragma unroll
    for (int T = 0; T < NB; ++T)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = TB * T + 8 * q + rg + 4 * i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = col0 + 2 * cg + j;
          y[T][i][j] = row < n && col < K ? bb[(long long)row * K + col]
                                          : make_float2(0.f, 0.f);
        }
      }
    forward<NB, 0>(y, L, Xs_c, st, c, q, rg, cg);
    backward<NB, NB - 1>(y, L, Xs_c, st, c, q, rg, cg);
#pragma unroll
    for (int T = 0; T < NB; ++T)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = TB * T + 8 * q + rg + 4 * i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = col0 + 2 * cg + j;
          if (row < n && col < K) xb[(long long)row * K + col] = y[T][i][j];
        }
      }
  }
}

template <int NB>
int launch_tri(const float2* A, const float2* b, float2* x, int batch, int n,
               int K, cudaStream_t stream) {
  const size_t smem = sizeof(float2) *
      ((size_t)htri::tiles<NB>() * htri::TILE + (size_t)CHUNKS * 2 * XB);
  cudaError_t err = cudaFuncSetAttribute(
      solve_tri_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  solve_tri_kernel<NB><<<batch, THREADS, smem, stream>>>(A, b, x, n, K);
  return (int)cudaGetLastError();
}
}  // namespace

// L: unused (L stays in shared memory); kept in the C interface, may be null
HK_API int hk_herm_chol_solve(const float2* A, const float2* b, float2* L,
                              float2* x, int batch, int n, int K,
                              cudaStream_t stream) {
  (void)L;
  if (n < 1 || n > TB * htri::MAX_TRI_TILES || K < 1)
    return (int)cudaErrorInvalidValue;
  if (n > TB * MAX_TILES)
    return n > TB * 5 ? launch_tri<6>(A, b, x, batch, n, K, stream)
                      : launch_tri<5>(A, b, x, batch, n, K, stream);
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
