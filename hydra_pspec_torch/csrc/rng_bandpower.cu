// rng_bandpower: per-chain Philox4x32-10 streams and the in-kernel
// bandpower conditional.
//
// Replaces, inside the TPU kernel gcr_megachain
// (hydra_pspec_tpu/ops/pallas/megachain.py), the core-PRNG draws seeded on
// (seed, sid, k) with Box-Muller (:238-302; megastep.py:55-73) and the
// bandpower conditional _sample_bandpowers_body (:102-145): free bins
// beta / Gamma(alpha) with Gamma = -sum log u, and the bounded bins by
// inversion of the tabulated truncated inverse gamma (_q_at, _y_at): at
// most 8 on the megachain engine, any number on the single-step and real
// engines, which call the same kernel.
//
// Streams (the plain twin is hydra_pspec_torch/ops/philox.py): key =
// (run seed, global chain stream id sid); counter = (global iteration g,
// purpose, i, j). Purpose 0: omegas at (row i, time j); 1: the Gamma
// uniforms 4j..4j+3 of bin i; 2: the prior uniforms 4j..4j+3. Keying on
// the global iteration keeps streams unchanged by chunk size, resume and
// batch composition.
//
// Grouped time-flags mode (megachain.py:220-229, 256-263, 409-418): each
// chain spans G chain-major rows, row c*G + g solving flag-pattern time
// group g. fields_kernel masks row b at its own count row_times[b] (its keys
// are the row streams sid*G + g, given in sids). bandpower_kernel with
// G > 1 runs one block per CHAIN: it sums beta over the chain's rows in the
// fixed order g = 0..G-1, draws Gamma(alpha) and the prior uniforms once on
// the chain stream (seed, sidc + 2^30), and writes the chain's ps to all G
// rows. G = 1 is plain mode exactly (key sid, no offset).
//
// Bound on the H100: rng_fields is ALU bound (10 Philox rounds plus log,
// sqrt, sin, cos per element pair), one thread per (row, time) element, no
// memory reads; bandpower is latency bound (alpha/4 Philox calls and logs
// per bin, a 12-step binary search of the 4096-entry table per bounded bin)
// and tiny: one block per chain, one thread per bin.
#include "hk_common.cuh"

namespace {

__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float u_open(unsigned bits) {
  return (float)(bits >> 8) * 0x1p-24f + 0x1p-25f;
}

__device__ __forceinline__ float2 box_muller(unsigned b1, unsigned b2) {
  const float u1 = u_open(b1);
  const float u2 = (float)(b2 >> 8) * 0x1p-24f;
  const float r = sqrtf(-2.0f * logf(u1));
  const float th = 6.28318530717958647692f * u2;
  return make_float2(r * cosf(th), r * sinf(th));
}

__global__ void fields_kernel(unsigned seed, const int* __restrict__ sids,
                              unsigned g, float2* __restrict__ oa,
                              float2* __restrict__ ob, int n, int t,
                              int ntimes, const int* __restrict__ row_times,
                              float half, float sa) {
  const int b = blockIdx.z, i = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= t) return;
  const long long o = ((long long)b * n + i) * t + j;
  if (j >= (row_times ? row_times[b] : ntimes)) {
    oa[o] = make_float2(0.f, 0.f);
    ob[o] = make_float2(0.f, 0.f);
    return;
  }
  const uint4 w = philox(make_uint4(g, 0u, (unsigned)i, (unsigned)j),
                         make_uint2(seed, (unsigned)sids[b]));
  const float2 nb = box_muller(w.x, w.y);
  const float2 na = box_muller(w.z, w.w);
  ob[o] = make_float2(nb.x * half, nb.y * half);
  oa[o] = make_float2(na.x * sa, na.y * sa);
}

// Q(alpha, y) by linear interpolation in log y (ops/invgamma._table_q_at)
__device__ float q_at(const float* tlog, const float* tq, int S, float y) {
  const float ly = logf(fmaxf(y, FLT_MIN));
  int lo = 0, hi = S;  // count of tlog < ly
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tlog[mid] < ly) lo = mid + 1; else hi = mid;
  }
  const int idx = min(max(lo, 1), S - 1);
  const float l0 = tlog[idx - 1], l1 = tlog[idx];
  const float q0 = tq[idx - 1], q1 = tq[idx];
  const float tt = fminf(fmaxf((ly - l0) / fmaxf(l1 - l0, 1e-30f), 0.f), 1.f);
  return q0 + tt * (q1 - q0);
}

// y with Q(alpha, y) = c (ops/invgamma._table_y_at); tq is non-increasing
__device__ float y_at(const float* tlog, const float* tq, int S, float c) {
  int lo = 0, hi = S;  // first index with tq < c
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tq[mid] < c) hi = mid; else lo = mid + 1;
  }
  const int idx = min(max(S - lo, 1), S - 1);
  const int j0 = S - idx, j1 = S - 1 - idx;
  const float q0 = tq[j0], q1 = tq[j1];
  const float l0 = tlog[j0], l1 = tlog[j1];
  const float tt = fminf(fmaxf((c - q0) / fmaxf(q1 - q0, 1e-30f), 0.f), 1.f);
  return expf(l0 + tt * (l1 - l0));
}

__global__ void bandpower_kernel(
    const float* __restrict__ beta, const float* __restrict__ gam_ext,
    const float* __restrict__ u_ext, int u_stride, unsigned seed,
    const int* __restrict__ sids, unsigned g, int alpha,
    const float* __restrict__ tlog, const float* __restrict__ tq, int S,
    const int* __restrict__ pidx, const float* __restrict__ plo,
    const float* __restrict__ phi, int np, float* __restrict__ ps_out,
    float* __restrict__ gam_out, int n, int G) {
  // block = chain c, rows c*G .. c*G + G - 1 (G = 1: one row, plain mode)
  const long long r0 = (long long)blockIdx.x * G;
  const unsigned off = G > 1 ? (1u << 30) : 0u;
  const uint2 key = make_uint2(seed, sids ? (unsigned)sids[r0] + off : 0u);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const long long o = r0 * n + i;
    float gam;
    if (gam_ext) {
      gam = gam_ext[o];
    } else {
      float s = 0.f;
      const int nr = (alpha + 3) / 4;
      for (int r = 0; r < nr; ++r) {
        const uint4 w = philox(make_uint4(g, 1u, (unsigned)i, (unsigned)r),
                               key);
        const unsigned ws[4] = {w.x, w.y, w.z, w.w};
        float prod = 1.f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          prod *= (4 * r + q < alpha) ? u_open(ws[q]) : 1.f;
        s += logf(prod);
      }
      gam = -s;
    }
    float bt = beta[o];
    for (int r = 1; r < G; ++r) bt += beta[o + (long long)r * n];
    float out = bt / gam;
    for (int l = 0; l < np; ++l) {
      if (pidx[l] != i) continue;
      float u;
      if (u_ext) {
        u = u_ext[r0 * u_stride + l];
      } else {
        const uint4 w = philox(make_uint4(g, 2u, 0u, (unsigned)(l >> 2)),
                               key);
        const unsigned ws[4] = {w.x, w.y, w.z, w.w};
        u = u_open(ws[l & 3]);
      }
      const float lo = plo[l], hi = phi[l];
      const float p_lo = q_at(tlog, tq, S, bt / lo);
      const float p_hi = q_at(tlog, tq, S, bt / hi);
      const float c = p_lo + u * (p_hi - p_lo);
      const float y = y_at(tlog, tq, S, c);
      const float x = bt / fmaxf(y, FLT_MIN);
      out = fminf(fmaxf(x, lo), hi);
    }
    for (int r = 0; r < G; ++r) {
      ps_out[o + (long long)r * n] = out;
      if (gam_out) gam_out[o + (long long)r * n] = gam;
    }
  }
}

__global__ void philox_raw_kernel(const uint4* __restrict__ ctr,
                                  const uint2* __restrict__ key,
                                  uint4* __restrict__ out, int count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < count) out[e] = philox(ctr[e], key[e]);
}
}  // namespace

HK_API int hk_rng_fields(unsigned seed, const int* sids, unsigned g,
                         float2* oa, float2* ob, int batch, int n, int t,
                         int ntimes, int nfreqs, const int* row_times,
                         cudaStream_t stream) {
  const float half = 0.70710678118654752440f;
  const float sa = half * sqrtf((float)nfreqs);
  dim3 grid((t + 127) / 128, n, batch);
  fields_kernel<<<grid, 128, 0, stream>>>(seed, sids, g, oa, ob, n, t, ntimes,
                                          row_times, half, sa);
  return (int)cudaGetLastError();
}

HK_API int hk_bandpower(const float* beta, const float* gam_ext,
                        const float* u_ext, int u_stride, unsigned seed,
                        const int* sids, unsigned g, int alpha,
                        const float* tlog, const float* tq, int S,
                        const int* pidx, const float* plo, const float* phi,
                        int np, float* ps_out, float* gam_out, int batch,
                        int n, int G, cudaStream_t stream) {
  bandpower_kernel<<<batch / G, 128, 0, stream>>>(
      beta, gam_ext, u_ext, u_stride, seed, sids, g, alpha, tlog, tq, S, pidx,
      plo, phi, np, ps_out, gam_out, n, G);
  return (int)cudaGetLastError();
}

HK_API int hk_philox_raw(const unsigned* ctr, const unsigned* key,
                         unsigned* out, int count, cudaStream_t stream) {
  philox_raw_kernel<<<(count + 255) / 256, 256, 0, stream>>>(
      (const uint4*)ctr, (const uint2*)key, (uint4*)out, count);
  return (int)cudaGetLastError();
}
