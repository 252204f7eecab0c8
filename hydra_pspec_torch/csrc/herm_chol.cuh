// Blocked Cholesky of one Hermitian positive-definite complex64 matrix held
// in shared memory, on 32 x 32 tiles, and the inverse of a factored
// diagonal tile; shared by herm_inv.cu and herm_chol_solve.cu. The
// counterpart of the TPU's 32 x 32 helpers hydra_pspec_tpu/ops/pallas/
// spd_solve.py::_chol_block and _inv_lower_block and of the NB = 32
// blocked loop of _spd_kernel.
//
// The n x n matrix (n <= 128) sits in shared memory padded to 32 NB rows
// and columns with the identity (a ragged last tile factors as if its pad
// were I, and leaves the real rows untouched), row stride ld = 32 NB + 1
// complex (odd: a warp reading down a column hits every bank pair once;
// NB is a template constant, so every offset is an immediate). Tile (I, J)
// starts at A + 32 I ld + 32 J. For each block column K:
//   1. the column's warps factor it together, a row a lane in registers:
//      warp 0 the diagonal tile, warp w the panel tile (K + w, K), which it
//      solves against the diagonal tile as that is factored. At step k warp
//      0 scales column k and writes it back, a barrier of the column's warps
//      (named barrier 1) follows, and every lane reads the entries of
//      column k it needs by broadcast;
//   2. the trailing tiles (I, J), K < J <= I, get the Hermitian rank-32
//      update A_IJ -= L_IK L_JK^H, a warp per 8-row strip of a tile, each
//      lane 8 outputs of one column in registers (each L_JK load feeds 8
//      complex multiply-adds).
// Two block barriers a block column, 7 at n = 128. The pivot is floored
// at FLT_MIN, as _chol_block does with floor=None; sqrtf and the
// reciprocals are correctly rounded (no fast math), so the identity factors
// to exactly the identity. Only the lower triangle of the input is read;
// the factor leaves L in the lower tiles, zeros above the diagonal of each
// diagonal tile, and the strict upper tiles as they were. FP32 fmaf only.
#pragma once
#include "hk_common.cuh"

namespace hchol {
constexpr int TB = 32;          // tile edge
constexpr int MAX_TILES = 4;    // n <= 32 MAX_TILES = 128 per launch
constexpr int THREADS = 512;    // 16 warps
constexpr int STRIP = 8;        // rows of a tile per warp in tile products
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float2 neg(float2 v) {
  return make_float2(-v.x, -v.y);
}

// Row stride of the padded matrix of NB tiles a side (a compile-time
// constant: every shared-memory offset below is an immediate).
template <int NB>
__host__ __device__ constexpr int ld_of() { return TB * NB + 1; }

// Load the lower triangle of the n x n matrix g into A (NB tiles a side),
// zeros above the diagonal and the identity in the pad, LOADS elements a
// thread in flight. Every thread of the block calls it; it ends with a
// barrier.
template <int NB>
__device__ __forceinline__ void load_lower(float2* A, const float2* g,
                                           int n) {
  constexpr int LOADS = 8, np = TB * NB, ld = ld_of<NB>();
  const int nt = blockDim.x;
  for (int e0 = threadIdx.x; e0 < np * np; e0 += LOADS * nt) {
    float2 v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = e0 + u * nt, r = e / np, c = e - r * np;
      v[u] = make_float2(r == c ? 1.f : 0.f, 0.f);
      if (e < np * np && r < n && c <= r) v[u] = g[(long long)r * n + c];
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int e = e0 + u * nt, r = e / np, c = e - r * np;
      if (e < np * np) A[r * ld + c] = v[u];
    }
  }
  __syncthreads();
}

// Barrier 1 among the first `warps` warps of the block.
__device__ __forceinline__ void sync_first_warps(int warps) {
  asm volatile("bar.sync 1, %0;" ::"r"(32 * warps) : "memory");
}

// 1. Factor block column K in place: warp 0 the diagonal tile
// T = L_KK L_KK^H, warp w in [1, m] the panel tile below it, solving
// L_(K+w)K L_KK^H = A_(K+w)K; a row a lane, the row in registers. At step
// k warp 0 scales column k of the diagonal tile and writes it back; after a
// barrier of the m + 1 warps every lane reads the entries it needs by
// broadcast.
template <int ld>
__device__ __forceinline__ void factor_column(float2* Lkk, int m) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float2* P = Lkk + TB * w * ld;
  float2 r[TB];
#pragma unroll
  for (int j = 0; j < TB; ++j) r[j] = P[lane * ld + j];
#pragma unroll
  for (int k = 0; k < TB; ++k) {
    if (w == 0) {
      const float d = fmaxf(__shfl_sync(FULL, r[k].x, k), FLT_MIN);
      const float sd = sqrtf(d);
      const float isd = 1.0f / sd;
      r[k] = lane == k ? make_float2(sd, 0.f)
           : lane > k  ? make_float2(r[k].x * isd, r[k].y * isd)
                       : make_float2(0.f, 0.f);
      P[lane * ld + k] = r[k];
    }
    sync_first_warps(m + 1);
    if (w != 0) {
      const float il = 1.0f / Lkk[k * ld + k].x;
      r[k] = make_float2(r[k].x * il, r[k].y * il);
    }
    // r[j] -= L[lane][k] conj(L_KK[j][k]) for every j > k; the diagonal
    // warp's lanes above the diagonal compute junk that step j replaces by 0
#pragma unroll
    for (int j = k + 1; j < TB; ++j) {
      const float2 ljk = Lkk[j * ld + k];
      cfma(r[j], r[k], make_float2(-ljk.x, ljk.y));
    }
  }
#pragma unroll
  for (int j = 0; j < TB; ++j) P[lane * ld + j] = r[j];
}

// 2. C -= Li Lj^H on rows [0, STRIP) of the strips C and Li (row stride
// ld), column = lane; Lj is the whole 32-row tile.
template <int ld>
__device__ __forceinline__ void update_strip(float2* C, const float2* Li,
                                             const float2* Lj) {
  const int lane = threadIdx.x & 31;
  float2 acc[STRIP];
#pragma unroll
  for (int r = 0; r < STRIP; ++r) acc[r] = C[r * ld + lane];
#pragma unroll 4
  for (int k = 0; k < TB; ++k) {
    const float2 l = Lj[lane * ld + k];
    const float2 nl = make_float2(-l.x, l.y);   // -conj(L_JK[lane][k])
#pragma unroll
    for (int r = 0; r < STRIP; ++r) cfma(acc[r], Li[r * ld + k], nl);
  }
#pragma unroll
  for (int r = 0; r < STRIP; ++r) C[r * ld + lane] = acc[r];
}

// X = L^-1 of the factored diagonal tile L (lane = column c, the column in
// registers, L read by broadcast), by forward substitution of e_c column
// by column (each step's updates independent of each other), written whole
// (zeros above the diagonal) to Xd (row stride TB).
template <int ld>
__device__ __forceinline__ void inv_tile(const float2* L, float2* Xd) {
  const int lane = threadIdx.x & 31;
  float2 x[TB];
#pragma unroll
  for (int i = 0; i < TB; ++i) x[i] = make_float2(i == lane ? 1.f : 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < TB; ++k) {
    const float il = 1.0f / L[k * ld + k].x;
    x[k] = make_float2(x[k].x * il, x[k].y * il);
    const float2 nx = neg(x[k]);
#pragma unroll
    for (int i = k + 1; i < TB; ++i) cfma(x[i], L[i * ld + k], nx);
  }
#pragma unroll
  for (int i = 0; i < TB; ++i) Xd[i * TB + lane] = x[i];
}

// Factor the padded matrix A (NB tiles a side, loaded by load_lower) in
// place. Every thread of the block (THREADS) calls it; it ends with a
// barrier.
template <int NB>
__device__ __forceinline__ void chol_tiles(float2* A) {
  constexpr int nb = NB, ld = ld_of<NB>();
  const int warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  for (int K = 0; K < nb; ++K) {
    const int m = nb - 1 - K;   // panel tiles below the diagonal
    if (warp <= m) factor_column<ld>(A + TB * K * (ld + 1), m);
    __syncthreads();
    if (m == 0) break;
    // trailing tiles (I, J), K < J <= I < nb, STRIP rows an item
    const int items = m * (m + 1) / 2 * (TB / STRIP);
    for (int it = warp; it < items; it += nwarp) {
      int t = it / (TB / STRIP);
      const int s = it - t * (TB / STRIP);
      int I = K + 1;
      while (t > I - K - 1) { t -= I - K; ++I; }
      const int J = K + 1 + t;
      const int row = TB * I + STRIP * s;
      update_strip<ld>(A + row * ld + TB * J, A + row * ld + TB * K,
                       A + TB * J * ld + TB * K);
    }
    __syncthreads();
  }
}
}  // namespace hchol
