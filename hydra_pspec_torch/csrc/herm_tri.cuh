// The lower-tile storage of a Hermitian positive-definite complex64 matrix
// of 128 < n <= 192 (NB = 5 or 6 tiles a side) in one block's shared
// memory, and the blocked Cholesky on it; shared by herm_inv.cu and
// herm_chol_solve.cu above 128. Up to 128 both kernels keep the whole padded
// square (herm_chol.cuh); at NB = 6 that square would need 296 KB, more
// than the 227 KB a block may opt in to. The lower triangle alone is
// NB (NB + 1) / 2 tiles: 21 at NB = 6, 177 KB.
//
// Each 32 x 32 tile is stored with the odd row stride TS = 33 complex (a
// warp reading down a column of a tile hits every bank pair once), the
// tiles in column-major order of the lower triangle: column J holds tiles
// (J, J), (J + 1, J), ..., (NB - 1, J) one after another, so the panel
// tiles below a diagonal tile lie TB TS apart, as the rows of the padded
// square's panel do at its stride, and herm_chol.cuh's factor_column and
// update_strip run unchanged at ld = TS. The identity fills the pad of a
// ragged last tile, as in the padded square. The factor leaves L in the
// tiles, zeros above the diagonal of each diagonal tile; its arithmetic is
// chol_tiles' (the same column factor and rank-32 updates in the same
// order). Only the lower triangle of the input is read. FP32 fmaf only.
#pragma once
#include "herm_chol.cuh"

namespace htri {
using namespace hchol;
constexpr int MAX_TRI_TILES = 6;  // n <= 192 per launch
constexpr int TS = TB + 1;       // row stride inside a stored tile
constexpr int TILE = TB * TS;    // complex a stored tile

// offset of tile (I, J), I >= J, of the column-major lower packing
template <int NB>
__host__ __device__ constexpr int off(int I, int J) {
  return TILE * (J * NB - J * (J - 1) / 2 + I - J);
}

template <int NB>
__host__ __device__ constexpr int tiles() { return NB * (NB + 1) / 2; }

// element (r, c), r >= c, of the packed matrix
template <int NB>
__device__ __forceinline__ int at(int r, int c) {
  return off<NB>(r / TB, c / TB) + (r % TB) * TS + c % TB;
}

// Load the lower triangle of the n x n matrix g into the lower tiles of A,
// zeros above the diagonal of the diagonal tiles and the identity in the
// pad, LOADS elements a thread in flight (consecutive threads read
// consecutive columns of a row). Every thread of the block calls it; it
// ends with a barrier.
template <int NB>
__device__ __forceinline__ void load_lower(float2* A, const float2* g,
                                           int n) {
  constexpr int LOADS = 8, np = TB * NB;
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
      if (e < np * np && c / TB <= r / TB) A[at<NB>(r, c)] = v[u];
    }
  }
  __syncthreads();
}

// Factor the packed matrix A (loaded by load_lower) in place, block column
// by block column as hchol::chol_tiles does. Every thread of the block
// calls it; it ends with a barrier.
template <int NB>
__device__ __forceinline__ void chol(float2* A) {
  const int warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  for (int K = 0; K < NB; ++K) {
    const int m = NB - 1 - K;   // panel tiles below the diagonal
    if (warp <= m) factor_column<TS>(A + off<NB>(K, K), m);
    __syncthreads();
    if (m == 0) break;
    // trailing tiles (I, J), K < J <= I < NB, STRIP rows an item
    const int items = m * (m + 1) / 2 * (TB / STRIP);
    for (int it = warp; it < items; it += nwarp) {
      int t = it / (TB / STRIP);
      const int s = it - t * (TB / STRIP);
      int I = K + 1;
      while (t > I - K - 1) { t -= I - K; ++I; }
      const int J = K + 1 + t;
      update_strip<TS>(A + off<NB>(I, J) + STRIP * s * TS,
                       A + off<NB>(I, K) + STRIP * s * TS,
                       A + off<NB>(J, K));
    }
    __syncthreads();
  }
}

// The factored diagonal tile L replaced by L^-1 (lane = column c, the
// column in registers, L read by broadcast): hchol::inv_tile's forward
// substitution, written back over L once the warp has read it.
__device__ __forceinline__ void inv_tile_in_place(float2* L) {
  const int lane = threadIdx.x & 31;
  float2 x[TB];
#pragma unroll
  for (int i = 0; i < TB; ++i) x[i] = make_float2(i == lane ? 1.f : 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < TB; ++k) {
    const float il = 1.0f / L[k * TS + k].x;
    x[k] = make_float2(x[k].x * il, x[k].y * il);
    const float2 nx = neg(x[k]);
#pragma unroll
    for (int i = k + 1; i < TB; ++i) cfma(x[i], L[i * TS + k], nx);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < TB; ++i) L[i * TS + lane] = x[i];
}
}  // namespace htri
