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
