// draw_fused: the elementwise and row-reduction passes of one GCR draw.
//
// Replaces the VPU phases of the TPU kernel body
// hydra_pspec_tpu/ops/pallas/megastep.py::_draw_body:
//   draw_rhs        rc = ni_d + nih * omega_b * tmask          (:139-142)
//   draw_system     dd, dinv, S = (dd dd^T P~ + I) dinv dinv^T and the
//                   scaled RHS dinv (dd F rc + omega_a tmask)  (:153-174)
//   row_scale_sumsq sk = dd (dinv x), beta = sum_t |sk|^2; also the
//                   flagged-data bmask = sum_t |F w sig|^2     (:195-201, 233)
//   draw_resid      res = dw - sig - Fg da, chi, noise_nu, the lean
//                   chi_t (megachain.py:427-434), w sig for the bmask,
//                   and amps = da + a0                           (:208-227)
// Written in CUDA C++ (not Triton), one route for the whole library.
//
// The time mask is j < ntimes, or in the grouped time-flags mode
// (megachain.py:220-229, 427-433), where row b of the batch solves one
// flag-pattern time group, j < row_times[b] when row_times is given.
//
// Bound on the H100: pure streaming over (B, n, t) complex fields, a few
// FLOP per 8-byte element, so HBM bandwidth bound (3.35 TB/s). Design: one
// block per row of n (or t) elements, consecutive threads on consecutive
// elements (coalesced), row sums by a fixed-order block reduction so every
// result is deterministic and independent of the batch.
//
// Omegas (megachain.py:238-302 on the TPU, drawn in the kernel there too):
// draw_rhs and draw_system take them either as stored fields (ob, oa: the
// external randomness of the JAX pins, or rng_fields' output) or keyed on
// (seed, row stream ids sids, iteration g). Keyed, each thread draws the
// Philox words of its (b, i, j) and forms omega_b (draw_rhs, words 0-1) or
// omega_a (draw_system, words 2-3) with csrc/philox.cuh, the functions
// rng_fields uses; pad lanes (j >= the row's time count) take 0 as the
// stored fields hold there. So no omega field goes through device memory
// (52 MB of writes and reads an iteration at B = 100, n = 128, t = 256):
// both kernels stay bandwidth bound on their other fields, with the Philox
// rounds and Box-Muller running under those streams, at one Philox call per
// element more than a shared draw would take. A keyed omega carries the
// bits of the stored one and enters the same expression, so keyed and
// stored modes give equal results. The other layout, draw_rhs drawing both
// halves and writing omega_a for a stored-mode draw_system, measured slower
// on the H100 (PERF.md).
#include "hk_common.cuh"
#include "philox.cuh"

namespace {
constexpr int ROW_THREADS = 256;

// the keyed omega streams: (run seed, row stream ids, iteration g)
struct OmegaKey {
  unsigned seed;
  const int* sids;
  unsigned g;              // the iteration, or with g_dev its offset
  const unsigned* g_dev;   // null, or the device word of the first one
};

// the key's iteration (fields by value: no local copy of the parameter)
__device__ __forceinline__ unsigned iteration_of(unsigned g,
                                                 const unsigned* g_dev) {
  return g_dev ? *g_dev + g : g;
}

// rc = d + h (w mk) and xs = dinv (dd f + w mk) with their roundings
// written out (one fma each, as the compiler formed them before the keyed
// mode existed), so a keyed omega and a stored one give the same bits
__device__ __forceinline__ float rhs_of(float d, float h, float w, float mk) {
  return __fmaf_rn(h, __fmul_rn(w, mk), d);
}

__device__ __forceinline__ float xs_of(float dvi, float ddi, float f, float w,
                                       float mk) {
  return __fmul_rn(dvi, __fmaf_rn(ddi, f, __fmul_rn(w, mk)));
}

template <bool KEYED>
__global__ void __launch_bounds__(ROW_THREADS)
rhs_kernel(const float2* __restrict__ nid, const float* __restrict__ nih,
           const float2* __restrict__ ob, OmegaKey key,
           float2* __restrict__ rc, int n, int t, int ntimes,
           const int* __restrict__ row_times) {
  const long long row = blockIdx.x;  // b * n + i
  const int b = (int)(row / n), i = (int)(row % n);
  const float h = nih[row];
  const int ntb = row_times ? row_times[b] : ntimes;
  const unsigned sid = KEYED ? (unsigned)key.sids[b] : 0u;
  const unsigned g = KEYED ? iteration_of(key.g, key.g_dev) : 0u;
  for (int j = threadIdx.x; j < t; j += blockDim.x) {
    const long long o = row * t + j;
    const float mk = j < ntb ? 1.f : 0.f;
    float2 w;
    if constexpr (KEYED) {
      w = make_float2(0.f, 0.f);
      if (j < ntb) {
        const uint4 q = omega_words(key.seed, sid, g, i, j);
        w = omega_of(q.x, q.y, OMEGA_B_SCALE);
      }
    } else {
      w = ob[o];
    }
    const float2 d = nid[o];
    rc[o] = make_float2(rhs_of(d.x, h, w.x, mk), rhs_of(d.y, h, w.y, mk));
  }
}

__device__ __forceinline__ float dd_of(float ps, float nf) {
  return sqrtf(fmaxf(ps, 0.f) / nf);
}

__device__ __forceinline__ float dinv_of(float dd, float ptjj) {
  return rsqrtf(fmaxf(1.f + dd * dd * ptjj, FLT_MIN));
}

template <bool KEYED>
__global__ void __launch_bounds__(ROW_THREADS)
system_kernel(const float2* __restrict__ pt, const float* __restrict__ ps,
              const float2* __restrict__ frc, const float2* __restrict__ oa,
              OmegaKey key, float sa, float2* __restrict__ S,
              float2* __restrict__ xs,
              float* __restrict__ dd_out, float* __restrict__ dinv_out,
              int n, int t, int ntimes, const int* __restrict__ row_times,
              float nf) {
  const int i = blockIdx.x, b = blockIdx.y;
  const int ntb = row_times ? row_times[b] : ntimes;
  const float2* ptb = pt + (long long)b * n * n;
  const float* psb = ps + (long long)b * n;
  const float ddi = dd_of(psb[i], nf);
  const float dvi = dinv_of(ddi, ptb[(long long)i * n + i].x);
  const long long row = (long long)b * n + i;
  if (threadIdx.x == 0) {
    dd_out[row] = ddi;
    dinv_out[row] = dvi;
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float ddj = dd_of(psb[j], nf);
    const float dvj = dinv_of(ddj, ptb[(long long)j * n + j].x);
    const float outer = ddi * ddj, dscale = dvi * dvj;
    const float2 p = ptb[(long long)i * n + j];
    S[row * n + j] = make_float2((outer * p.x + (i == j ? 1.f : 0.f)) * dscale,
                                 (outer * p.y) * dscale);
  }
  const unsigned sid = KEYED ? (unsigned)key.sids[b] : 0u;
  const unsigned g = KEYED ? iteration_of(key.g, key.g_dev) : 0u;
  for (int j = threadIdx.x; j < t; j += blockDim.x) {
    const long long o = row * t + j;
    const float mk = j < ntb ? 1.f : 0.f;
    float2 w;
    if constexpr (KEYED) {
      w = make_float2(0.f, 0.f);
      if (j < ntb) {
        const uint4 q = omega_words(key.seed, sid, g, i, j);
        w = omega_of(q.z, q.w, sa);
      }
    } else {
      w = oa[o];
    }
    const float2 f = frc[o];
    xs[o] = make_float2(xs_of(dvi, ddi, f.x, w.x, mk),
                        xs_of(dvi, ddi, f.y, w.y, mk));
  }
}

__global__ void __launch_bounds__(ROW_THREADS)
scale_sumsq_kernel(const float2* __restrict__ x, const float* __restrict__ s1,
                   const float* __restrict__ s2, float2* __restrict__ y,
                   float* __restrict__ sums, int t) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const float a = s1 ? s1[row] : 1.f;
  const float c = s2 ? s2[row] : 1.f;
  float acc = 0.f;
  for (int j = threadIdx.x; j < t; j += blockDim.x) {
    const long long o = row * t + j;
    const float2 v = x[o];
    const float2 u = make_float2(c * (a * v.x), c * (a * v.y));
    if (y) y[o] = u;
    acc += abs2(u);
  }
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) sums[row] = acc;
}

__global__ void __launch_bounds__(ROW_THREADS)
resid_kernel(const float2* __restrict__ dw, const float2* __restrict__ sig,
             const float2* __restrict__ fa, const float* __restrict__ ninvf,
             const float* __restrict__ w, const float2* __restrict__ da,
             const float2* __restrict__ a0, float* __restrict__ chi,
             float* __restrict__ noise, float* __restrict__ chit,
             float2* __restrict__ amp, float2* __restrict__ ws, int n, int m,
             int t, int ntimes, const int* __restrict__ row_times) {
  __shared__ float red[32];
  const int r = blockIdx.x, b = blockIdx.y;
  const int ntb = row_times ? row_times[b] : ntimes;
  if (r >= n) {  // amplitude rows: amps = da + a0
    if (amp == nullptr) return;
    const long long row = (long long)b * m + (r - n);
    for (int j = threadIdx.x; j < t; j += blockDim.x) {
      const long long o = row * t + j;
      const float2 d = da[o], z = a0[o];
      amp[o] = make_float2(d.x + z.x, d.y + z.y);
    }
    return;
  }
  const long long row = (long long)b * n + r;
  const float nv = ninvf[row], wv = w[row];
  const float wn = wv * nv;
  float acc_noise = 0.f, acc_chit = 0.f;
  for (int j = threadIdx.x; j < t; j += blockDim.x) {
    const long long o = row * t + j;
    const float2 s = sig[o], d = dw[o], f = fa[o];
    const float rr = d.x - s.x - f.x, ri = d.y - s.y - f.y;
    const float res2 = rr * rr + ri * ri;
    const float c = res2 * nv;
    if (chi) chi[o] = c;
    if (ws) ws[o] = make_float2(wv * s.x, wv * s.y);
    acc_noise += res2 * wn;
    acc_chit += j < ntb ? c : 0.f;
  }
  acc_noise = block_sum(acc_noise, red);
  if (chit) acc_chit = block_sum(acc_chit, red);
  if (threadIdx.x == 0) {
    noise[row] = acc_noise;
    if (chit) chit[row] = acc_chit;
  }
}
}  // namespace

// ob == nullptr: keyed mode on (seed, sids, g), g read as *g_dev + g when
// g_dev is given
HK_API int hk_draw_rhs(const float2* nid, const float* nih, const float2* ob,
                       unsigned seed, const int* sids, unsigned g,
                       const unsigned* g_dev, float2* rc, int batch, int n,
                       int t, int ntimes, const int* row_times,
                       cudaStream_t stream) {
  const OmegaKey key{seed, sids, g, g_dev};
  if (ob)
    rhs_kernel<false><<<batch * n, ROW_THREADS, 0, stream>>>(
        nid, nih, ob, key, rc, n, t, ntimes, row_times);
  else
    rhs_kernel<true><<<batch * n, ROW_THREADS, 0, stream>>>(
        nid, nih, nullptr, key, rc, n, t, ntimes, row_times);
  return (int)cudaGetLastError();
}

// oa == nullptr: keyed mode on (seed, sids, g), as hk_draw_rhs
HK_API int hk_draw_system(const float2* pt, const float* ps, const float2* frc,
                          const float2* oa, unsigned seed, const int* sids,
                          unsigned g, const unsigned* g_dev, float2* S,
                          float2* xs, float* dd, float* dinv, int batch, int n,
                          int t, int ntimes, int nfreqs, const int* row_times,
                          cudaStream_t stream) {
  const OmegaKey key{seed, sids, g, g_dev};
  const float sa = omega_a_scale(nfreqs);
  dim3 grid(n, batch);
  if (oa)
    system_kernel<false><<<grid, ROW_THREADS, 0, stream>>>(
        pt, ps, frc, oa, key, sa, S, xs, dd, dinv, n, t, ntimes, row_times,
        (float)nfreqs);
  else
    system_kernel<true><<<grid, ROW_THREADS, 0, stream>>>(
        pt, ps, frc, nullptr, key, sa, S, xs, dd, dinv, n, t, ntimes,
        row_times, (float)nfreqs);
  return (int)cudaGetLastError();
}

HK_API int hk_row_scale_sumsq(const float2* x, const float* s1,
                              const float* s2, float2* y, float* sums,
                              int rows, int t, cudaStream_t stream) {
  scale_sumsq_kernel<<<rows, ROW_THREADS, 0, stream>>>(x, s1, s2, y, sums, t);
  return (int)cudaGetLastError();
}

HK_API int hk_draw_resid(const float2* dw, const float2* sig, const float2* fa,
                         const float* ninvf, const float* w, const float2* da,
                         const float2* a0, float* chi, float* noise,
                         float* chit, float2* amp, float2* ws, int batch,
                         int n, int m, int t, int ntimes,
                         const int* row_times, cudaStream_t stream) {
  dim3 grid(n + m, batch);
  resid_kernel<<<grid, ROW_THREADS, 0, stream>>>(
      dw, sig, fa, ninvf, w, da, a0, chi, noise, chit, amp, ws, n, m, t,
      ntimes, row_times);
  return (int)cudaGetLastError();
}
