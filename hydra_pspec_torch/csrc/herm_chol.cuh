// In-place Cholesky of one Hermitian positive-definite complex64 matrix held
// in shared memory, shared by herm_inv.cu and herm_chol_solve.cu.
#pragma once
#include "hk_common.cuh"

// Right-looking Cholesky S = L L^H of the n x n matrix A (row stride ld) in
// shared memory: step k updates the trailing lower triangle with the
// unscaled column k (one warp per row, its lanes along the row), then scales
// column k. L overwrites the lower triangle; the strict upper triangle is
// left as it was. The pivot is floored at FLT_MIN, as spd_solve.py::
// _chol_block does with floor=None. Every thread of the block calls it
// (blockDim.x a multiple of 32); it ends with a barrier.
__device__ __forceinline__ void chol_lower_inplace(float2* A, int n, int ld) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nt >> 5;
  for (int k = 0; k < n; ++k) {
    const float d = fmaxf(A[k * ld + k].x, FLT_MIN);
    const float invd = 1.0f / d;
    for (int i = k + 1 + warp; i < n; i += nwarp) {
      const float2 aik = A[i * ld + k];
      for (int j = k + 1 + lane; j <= i; j += 32) {
        const float2 ajk = A[j * ld + k];
        float2& aij = A[i * ld + j];
        aij.x -= (aik.x * ajk.x + aik.y * ajk.y) * invd;
        aij.y -= (aik.y * ajk.x - aik.x * ajk.y) * invd;
      }
    }
    __syncthreads();
    const float sd = sqrtf(d);
    const float isd = 1.0f / sd;
    for (int i = k + tid; i < n; i += nt) {
      if (i == k) {
        A[k * ld + k] = make_float2(sd, 0.f);
      } else {
        A[i * ld + k].x *= isd;
        A[i * ld + k].y *= isd;
      }
    }
    // step k+1 neither reads nor writes column k: no barrier needed here
  }
  __syncthreads();
}
