// cgemm: batched complex64 product C = alpha * op(A) B + beta * X.
//
// Replaces every matrix product inside the TPU kernel gcr_megachain
// (hydra_pspec_tpu/ops/pallas/megastep.py:145-152, 191-194, 203-207, 221,
// 233; ops/pallas/megachain.py:385-388), where they were Gauss 3-mult
// products of 3-pass bf16-split MXU matmuls.
//
// op(A) is A (opA 0), A^T (1) or A^H (2); A is per batch element or shared
// (a_batched 0: one A for the whole batch, e.g. the DFT matrix F). X may be
// null (then beta is ignored); C may alias X (each element of X is read only
// by the thread that writes that element of C) but not A or B.
//
// Bound on the H100: at the main path's shapes (n=128, t=256, m=16) each
// chain's product is a 128x128x256 complex GEMM (~33 MFLOP real), so the
// batch is compute- and latency-bound on FP32 FMA, never on HBM bandwidth
// (operands of one chain are 0.5 MB and stay in L2). Design: 32x32 output
// tiles per block, 16-deep K tiles staged in shared memory, 2x2 outputs per
// thread in full FP32 FMA. No tensor cores (TF32 would reintroduce the
// precision loss the reference rejects) and no split-K atomics, so every
// output is deterministic and depends on its own chain's operands only.
#include "hk_common.cuh"

namespace {
constexpr int TM = 32, TN = 32, TK = 16;

__global__ void __launch_bounds__(256)
cgemm_kernel(const float2* __restrict__ A, const float2* __restrict__ B,
             const float2* X, float2* C, int M, int N, int K, int opA,
             long long a_bstride, float alpha, float beta) {
  __shared__ float2 As[TK][TM + 1];  // As[k][i] = op(A)[i][k]
  __shared__ float2 Bs[TK][TN + 1];
  const int b = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TN;
  const float2* Ab = A + (long long)b * a_bstride;
  const float2* Bb = B + (long long)b * K * N;
  float2 acc[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) acc[r][c] = make_float2(0.f, 0.f);

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < TM * TK; e += 256) {
      int ii, kk;
      float2 v = make_float2(0.f, 0.f);
      if (opA == 0) {  // A stored (M, K): read along k
        ii = e / TK;
        kk = e % TK;
        const int gi = i0 + ii, gk = k0 + kk;
        if (gi < M && gk < K) v = Ab[(long long)gi * K + gk];
      } else {  // A stored (K, M): read along i
        kk = e / TM;
        ii = e % TM;
        const int gi = i0 + ii, gk = k0 + kk;
        if (gi < M && gk < K) {
          v = Ab[(long long)gk * M + gi];
          if (opA == 2) v.y = -v.y;
        }
      }
      As[kk][ii] = v;
    }
    for (int e = tid; e < TK * TN; e += 256) {
      const int kk = e / TN, jj = e % TN;
      const int gk = k0 + kk, gj = j0 + jj;
      Bs[kk][jj] = (gk < K && gj < N) ? Bb[(long long)gk * N + gj]
                                      : make_float2(0.f, 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float2 a0 = As[kk][ty], a1 = As[kk][ty + 16];
      const float2 b0 = Bs[kk][tx], b1 = Bs[kk][tx + 16];
      cfma(acc[0][0], a0, b0);
      cfma(acc[0][1], a0, b1);
      cfma(acc[1][0], a1, b0);
      cfma(acc[1][1], a1, b1);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int gi = i0 + ty + 16 * r, gj = j0 + tx + 16 * c;
      if (gi < M && gj < N) {
        const long long o = (long long)b * M * N + (long long)gi * N + gj;
        float2 v = make_float2(alpha * acc[r][c].x, alpha * acc[r][c].y);
        if (X != nullptr) {
          const float2 x = X[o];
          v.x = fmaf(beta, x.x, v.x);
          v.y = fmaf(beta, x.y, v.y);
        }
        C[o] = v;
      }
    }
  }
}
}  // namespace

HK_API int hk_cgemm(const float2* A, const float2* B, const float2* X,
                    float2* C, int batch, int M, int N, int K, int opA,
                    int a_batched, float alpha, float beta,
                    cudaStream_t stream) {
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, batch);
  dim3 block(16, 16);
  const long long a_bstride = a_batched ? (long long)M * K : 0;
  cgemm_kernel<<<grid, block, 0, stream>>>(A, B, X, C, M, N, K, opA,
                                           a_bstride, alpha, beta);
  return (int)cudaGetLastError();
}

HK_API const char* hk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
