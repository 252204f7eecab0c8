// Shared helpers of the hand-written kernels (plain C interface, ctypes).
#pragma once
#include <cuda_runtime.h>
#include <cfloat>

#define HK_API extern "C" __attribute__((visibility("default")))

// complex64 is float2 (re, im), the layout of torch.complex64
__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
}

// acc += conj(a) * b
__device__ __forceinline__ void cfma_conj(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(-a.y, b.x, acc.y));
}

__device__ __forceinline__ float abs2(float2 z) { return z.x * z.x + z.y * z.y; }

// Sum over the block (blockDim.x a multiple of 32, at most 1024). Every
// thread gets the total. `red` is 32 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nwarp; ++w) s += red[w];  // fixed order: deterministic
  return s;
}
