// herm_inv: per-chain inverse of the Jacobi-equilibrated Hermitian
// positive-definite system S = I + D P~ D (n x n complex64, n <= 192 per
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
// Bound on the H100: one chain's work is n^3/2 complex multiply-adds
// (Cholesky n^3/6, L^-1 n^3/6, L^-H L^-1 n^3/6), 4.2 M FP32 FMAs at
// n = 128, about 33 k clocks of one SM; the 128 KB in and out per chain are
// nothing next to it. What bounds it is latency, not HBM: the factor's
// chain of pivots and triangular solves, each on one warp, and the
// shared-memory bandwidth that feeds the FMAs of the tile products (a
// broadcast load costs the crossbar as much as a per-lane one, so a strip
// product moves about 2 bytes per FMA). Design: one CTA of 16 warps per
// chain holds the whole matrix in shared memory (herm_chol.cuh's padded
// layout, 132 KB at n = 128, plus 8 KB for each diagonal tile of L^-1), and
// every phase works on 32 x 32 tiles:
//   1. the blocked Cholesky of herm_chol.cuh (7 block barriers at
//      n = 128);
//   2. X = L^-1: one warp per diagonal tile inverts it (inv_tile of
//      herm_chol.cuh), all in parallel; then the tiles below the diagonal,
//      diagonal by diagonal, as tile products
//      X_IJ = -(sum_{J<K<=I} X_IK L_KJ) X_JJ, a warp per 8-row strip (the
//      strip of the sum stays in the warp: it goes through the output's own
//      slot). X_IJ is kept in the dead upper tile (J, I);
//   3. S^-1 = X^H X over the lower tiles only (10 at n = 128), the most
//      expensive first, a warp per 8-row strip, into the dead lower tiles
//      of L; the output's upper triangle is the conjugate transpose of the
//      lower one, written coalesced.
// Above 128 (5 or 6 tiles a side) the padded square no longer fits in a
// block's shared memory (296 KB at n = 192), so herm_inv_tri_kernel keeps
// only the lower tiles (herm_tri.cuh, 21 tiles, 177 KB at n = 192) and
// runs LAPACK potri's three phases in place on them:
//   1. the same blocked Cholesky, on the lower-tile storage;
//   2. X = L^-1 in place: each diagonal tile inverted where it lies (a
//      warp each), then the block columns right to left, X_IJ =
//      -(sum_{J<K<=I} X_IK L_KJ) X_JJ: the column's tile strips (bottom
//      tiles first, 16 strips a round) each keep their sum in registers
//      until a barrier (the sums read the column's L tiles), then write
//      it into their own slot and multiply it by X_JJ there;
//   3. S^-1 = X^H X in place, block rows top down: output (I, J) reads
//      X_KI and X_KJ for K >= I, so it only overwrites X_IJ, which no later
//      row reads; a row's tiles (4 a round, the diagonal tile last) keep
//      their strips in registers until a barrier and then write, so the
//      diagonal output is written after every tile of its row has read
//      X_II.
// One block of 16 warps per chain, one wave at B <= 132.
// FP32 fmaf products only (no tensor cores, no TF32). Each output is one
// warp's fixed-order sum over its chain's data: no cross-chain work, no
// atomics. The identity maps to exactly the identity.
//
// active (optional, int32 per chain): the CTA of a chain whose flag is 0
// returns before its first load and leaves that chain's output as it was.
//
// gate (optional, in place of active): the megachain warm start's drift
// gate, the TPU kernel's pl.when at hydra_pspec_tpu/ops/pallas/
// megachain.py:366-379, computed by each chain's CTA before its first
// matrix load. The CTA reads its chain's bandpowers ps and psx (this and
// the previous iteration, m floats each), takes the NaN-keeping largest
// relative move
//   max_j |ps_j - psx_j| / (0.5 (|ps_j| + |psx_j|) + 1e-6 max_j psx_j
//                           + FLT_MIN)
// with correctly rounded operations, writes its flag (1 = rebuild, also
// for a NaN: NaN <= x is false) to rebuild, and returns when it is 0. A
// maximum does not depend on the order of its terms, so the flags do not
// depend on the block size. The warm start (ops/kernels/megachain.py) so
// rebuilds, in a launch captured into a CUDA graph, only the chains whose
// move is not provably small, straight into the carried inverse, and
// needs no launch of its own for the gate (the gate's own work, 2m floats
// read a chain, is far below the cost of any launch).
#include "herm_chol.cuh"
#include "herm_tri.cuh"

namespace {
using namespace hchol;

struct Gate {
  const float* ps;    // (B, m) this iteration's bandpowers; null: no gate
  const float* psx;   // (B, m) the previous iteration's
  float drift_max;
  int m;
  int* rebuild;       // (B,) the flags written
};

// max that keeps a NaN: a NaN v replaces m, a NaN m stays (torch.amax)
__device__ __forceinline__ float nan_max(float m, float v) {
  return (m != m || m >= v) ? m : v;
}

// the NaN-keeping max over the block (blockDim.x a multiple of 32); every
// thread gets it. `red` is 32 floats of shared memory.
__device__ __forceinline__ float block_nan_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(FULL, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = nan_max(m, red[w]);
  return m;
}

// The gate of this block's chain: writes its flag, returns it (the same
// value on every thread).
__device__ bool drift_gate(const Gate& g) {
  __shared__ float red[32];
  const long long o = (long long)blockIdx.x * g.m;
  float top = -INFINITY;
  for (int j = threadIdx.x; j < g.m; j += blockDim.x)
    top = nan_max(top, g.psx[o + j]);
  const float lift = __fmul_rn(1e-6f, block_nan_max(top, red));
  float drift = -INFINITY;
  for (int j = threadIdx.x; j < g.m; j += blockDim.x) {
    const float p = g.ps[o + j], x = g.psx[o + j];
    const float den = __fadd_rn(
        __fadd_rn(__fmul_rn(0.5f, __fadd_rn(fabsf(p), fabsf(x))), lift),
        FLT_MIN);
    drift = nan_max(drift, __fdiv_rn(fabsf(__fsub_rn(p, x)), den));
  }
  const bool go = !(block_nan_max(drift, red) <= g.drift_max);
  if (threadIdx.x == 0) g.rebuild[blockIdx.x] = go ? 1 : 0;
  return go;
}

template <int NB>
__global__ void __launch_bounds__(THREADS)
herm_inv_kernel(const float2* __restrict__ S, float2* __restrict__ out,
                int n, const int* __restrict__ active, Gate gate) {
  if (gate.ps ? !drift_gate(gate) : active && !active[blockIdx.x]) return;
  extern __shared__ float2 sm[];
  constexpr int nb = NB, ld = ld_of<NB>();
  float2* A = sm;                     // (32 nb) x ld
  float2* Xd = sm + TB * nb * ld;     // nb diagonal tiles of X, stride TB
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  constexpr int NS = TB / STRIP;      // strips a tile
  const long long boff = (long long)blockIdx.x * n * n;

  load_lower<NB>(A, S + boff, n);
  chol_tiles<NB>(A);                  // 1.

  // 2a. the diagonal tiles of X = L^-1, a warp each
  if (warp < nb) inv_tile<ld>(A + TB * warp * (ld + 1), Xd + warp * TB * TB);
  __syncthreads();
  // 2b. X_IJ, I = J + d, diagonal by diagonal, into upper tile (J, I)
  for (int d = 1; d < nb; ++d) {
    for (int it = warp; it < (nb - d) * NS; it += nwarp) {
      const int J = it / NS, I = J + d, r0 = STRIP * (it - J * NS);
      float2* O = A + (TB * J + r0) * ld + TB * I;   // strip of X_IJ
      float2 acc[STRIP];
#pragma unroll
      for (int r = 0; r < STRIP; ++r) acc[r] = make_float2(0.f, 0.f);
      for (int K = J + 1; K <= I; ++K) {       // acc = sum_K X_IK L_KJ
        const float2* X = K == I ? Xd + K * TB * TB + r0 * TB
                                 : A + (TB * K + r0) * ld + TB * I;
        const int xs = K == I ? TB : ld;
        const float2* L = A + TB * K * ld + TB * J;
#pragma unroll 4
        for (int k = 0; k < TB; ++k) {
          const float2 l = L[k * ld + lane];
#pragma unroll
          for (int r = 0; r < STRIP; ++r) cfma(acc[r], X[r * xs + k], l);
        }
      }
#pragma unroll
      for (int r = 0; r < STRIP; ++r) O[r * ld + lane] = acc[r];
      __syncwarp();
      const float2* Xj = Xd + J * TB * TB;     // X_IJ = -acc X_JJ
#pragma unroll
      for (int r = 0; r < STRIP; ++r) acc[r] = make_float2(0.f, 0.f);
#pragma unroll 4
      for (int k = 0; k < TB; ++k) {
        const float2 x = neg(Xj[k * TB + lane]);
#pragma unroll
        for (int r = 0; r < STRIP; ++r) cfma(acc[r], O[r * ld + k], x);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < STRIP; ++r) O[r * ld + lane] = acc[r];
    }
    __syncthreads();
  }

  // 3. S^-1_IJ = sum_{K >= I} X_KI^H X_KJ for I >= J into lower tile (I, J)
  // (L is dead); tile (I, J) costs nb - I tile products: I = 0 first
  for (int it = warp; it < nb * (nb + 1) / 2 * NS; it += nwarp) {
    int t = it / NS;
    const int r0 = STRIP * (it - t * NS);
    int I = 0;
    while (t > I) { t -= I + 1; ++I; }
    const int J = t;
    float2 acc[STRIP];
#pragma unroll
    for (int r = 0; r < STRIP; ++r) acc[r] = make_float2(0.f, 0.f);
    for (int K = I; K < nb; ++K) {
      // X_KI[k][r0 + r] (broadcast) and X_KJ[k][lane]
      const float2* Xi = K == I ? Xd + K * TB * TB + r0
                                : A + TB * I * ld + TB * K + r0;
      const int is = K == I ? TB : ld;
      const float2* Xj = K == J ? Xd + K * TB * TB
                                : A + TB * J * ld + TB * K;
      const int js = K == J ? TB : ld;
#pragma unroll 4
      for (int k = 0; k < TB; ++k) {
        const float2 x = Xj[k * js + lane];
#pragma unroll
        for (int r = 0; r < STRIP; ++r) cfma_conj(acc[r], Xi[k * is + r], x);
      }
    }
    float2* O = A + (TB * I + r0) * ld + TB * J;
#pragma unroll
    for (int r = 0; r < STRIP; ++r) O[r * ld + lane] = acc[r];
  }
  __syncthreads();

  float2* Ob = out + boff;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    const float2 v = A[(j <= i) ? i * ld + j : j * ld + i];
    Ob[e] = (j <= i) ? v : make_float2(v.x, -v.y);
  }
}

// A in the padded layout and the nb diagonal tiles of X
template <int NB>
constexpr size_t smem_of() {
  return sizeof(float2) *
         ((size_t)TB * NB * ld_of<NB>() + (size_t)NB * TB * TB);
}

template <int NB>
int launch(const float2* S, float2* out, int batch, int n, const int* active,
           const Gate& gate, cudaStream_t stream) {
  // the shared-memory opt-in is no stream operation: it is set by the
  // launches outside a capture (a chunk graph's eager warm-up runs every
  // launch of the chunk before it is captured)
  cudaStreamCaptureStatus capture;
  cudaError_t err = cudaStreamIsCapturing(stream, &capture);
  if (err == cudaSuccess && capture == cudaStreamCaptureStatusNone)
    err = cudaFuncSetAttribute(herm_inv_kernel<NB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_of<NB>());
  if (err != cudaSuccess) return (int)err;
  herm_inv_kernel<NB><<<batch, THREADS, smem_of<NB>(), stream>>>(
      S, out, n, active, gate);
  return (int)cudaGetLastError();
}

// 128 < n <= 192: the potri phases in place on the lower tiles (header)
template <int NB>
__global__ void __launch_bounds__(THREADS)
herm_inv_tri_kernel(const float2* __restrict__ S, float2* __restrict__ out,
                    int n, const int* __restrict__ active, Gate gate) {
  if (gate.ps ? !drift_gate(gate) : active && !active[blockIdx.x]) return;
  extern __shared__ float2 sm[];
  using htri::TS;
  using htri::off;
  float2* A = sm;                     // the lower tiles, htri::off
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  constexpr int NS = TB / STRIP;      // strips a tile
  const long long boff = (long long)blockIdx.x * n * n;

  htri::load_lower<NB>(A, S + boff, n);
  htri::chol<NB>(A);                  // 1.

  // 2a. the diagonal tiles of X = L^-1 in place, a warp each
  if (warp < NB) htri::inv_tile_in_place(A + off<NB>(warp, warp));
  __syncthreads();
  // 2b. block columns right to left; X_IJ into tile (I, J), bottom first
  for (int J = NB - 2; J >= 0; --J) {
    const int items = (NB - 1 - J) * NS;
    for (int r0s = 0; r0s < items; r0s += nwarp) {
      const int it = r0s + warp;
      const bool mine = it < items;
      const int I = NB - 1 - it / NS, r0 = STRIP * (it % NS);
      float2 acc[STRIP];
#pragma unroll
      for (int r = 0; r < STRIP; ++r) acc[r] = make_float2(0.f, 0.f);
      if (mine) {
        for (int K = J + 1; K <= I; ++K) {   // acc = sum_K X_IK L_KJ
          const float2* X = A + off<NB>(I, K) + r0 * TS;
          const float2* L = A + off<NB>(K, J);
#pragma unroll 4
          for (int k = 0; k < TB; ++k) {
            const float2 l = L[k * TS + lane];
#pragma unroll
            for (int r = 0; r < STRIP; ++r) cfma(acc[r], X[r * TS + k], l);
          }
        }
      }
      __syncthreads();   // every sum of the round has read column J's L
      if (mine) {
        float2* O = A + off<NB>(I, J) + r0 * TS;   // strip of X_IJ
#pragma unroll
        for (int r = 0; r < STRIP; ++r) O[r * TS + lane] = acc[r];
        __syncwarp();
        const float2* Xj = A + off<NB>(J, J);     // X_IJ = -acc X_JJ
#pragma unroll
        for (int r = 0; r < STRIP; ++r) acc[r] = make_float2(0.f, 0.f);
#pragma unroll 4
        for (int k = 0; k < TB; ++k) {
          const float2 x = neg(Xj[k * TS + lane]);
#pragma unroll
          for (int r = 0; r < STRIP; ++r) cfma(acc[r], O[r * TS + k], x);
        }
        __syncwarp();
#pragma unroll
        for (int r = 0; r < STRIP; ++r) O[r * TS + lane] = acc[r];
      }
    }
    __syncthreads();     // column J is X before column J - 1 reads it
  }

  // 3. S^-1_IJ = sum_{K >= I} X_KI^H X_KJ into tile (I, J), rows top down
  for (int I = 0; I < NB; ++I) {
    const int items = (I + 1) * NS;   // tiles J = 0..I, the diagonal last
    for (int r0s = 0; r0s < items; r0s += nwarp) {
      const int it = r0s + warp;
      const bool mine = it < items;
      const int J = it / NS, r0 = STRIP * (it % NS);
      float2 acc[STRIP];
#pragma unroll
      for (int r = 0; r < STRIP; ++r) acc[r] = make_float2(0.f, 0.f);
      if (mine) {
        for (int K = I; K < NB; ++K) {
          // X_KI[k][r0 + r] (broadcast) and X_KJ[k][lane]
          const float2* Xi = A + off<NB>(K, I) + r0;
          const float2* Xj = A + off<NB>(K, J);
#pragma unroll 4
          for (int k = 0; k < TB; ++k) {
            const float2 x = Xj[k * TS + lane];
#pragma unroll
            for (int r = 0; r < STRIP; ++r)
              cfma_conj(acc[r], Xi[k * TS + r], x);
          }
        }
      }
      __syncthreads();   // the round's tiles (and, last, X_II) are read
      if (mine) {
        float2* O = A + off<NB>(I, J) + r0 * TS;
#pragma unroll
        for (int r = 0; r < STRIP; ++r) O[r * TS + lane] = acc[r];
      }
    }
  }
  __syncthreads();

  float2* Ob = out + boff;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    const float2 v = A[j <= i ? htri::at<NB>(i, j) : htri::at<NB>(j, i)];
    Ob[e] = (j <= i) ? v : make_float2(v.x, -v.y);
  }
}

template <int NB>
constexpr size_t smem_tri() {
  return sizeof(float2) * (size_t)htri::tiles<NB>() * htri::TILE;
}

template <int NB>
int launch_tri(const float2* S, float2* out, int batch, int n,
               const int* active, const Gate& gate, cudaStream_t stream) {
  // the opt-in outside a capture, as launch<NB> does
  cudaStreamCaptureStatus capture;
  cudaError_t err = cudaStreamIsCapturing(stream, &capture);
  if (err == cudaSuccess && capture == cudaStreamCaptureStatusNone)
    err = cudaFuncSetAttribute(herm_inv_tri_kernel<NB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_tri<NB>());
  if (err != cudaSuccess) return (int)err;
  herm_inv_tri_kernel<NB><<<batch, THREADS, smem_tri<NB>(), stream>>>(
      S, out, n, active, gate);
  return (int)cudaGetLastError();
}
}  // namespace

// ps == nullptr: no gate (active, if given, selects the chains)
HK_API int hk_herm_inv(const float2* S, float2* out, int batch, int n,
                       const int* active, const float* ps, const float* psx,
                       float drift_max, int m, int* rebuild,
                       cudaStream_t stream) {
  if (n < 1 || n > TB * htri::MAX_TRI_TILES ||
      (ps && (!psx || !rebuild || m < 1)))
    return (int)cudaErrorInvalidValue;
  const Gate gate{ps, psx, drift_max, m, rebuild};
  const int nb = (n + TB - 1) / TB;
  return nb == 1 ? launch<1>(S, out, batch, n, active, gate, stream)
       : nb == 2 ? launch<2>(S, out, batch, n, active, gate, stream)
       : nb == 3 ? launch<3>(S, out, batch, n, active, gate, stream)
       : nb == 4 ? launch<4>(S, out, batch, n, active, gate, stream)
       : nb == 5 ? launch_tri<5>(S, out, batch, n, active, gate, stream)
                 : launch_tri<6>(S, out, batch, n, active, gate, stream);
}
