// rng_bandpower: the omega fields of the real engine and the bandpower
// conditional, on per-chain Philox4x32-10 streams (csrc/philox.cuh).
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
// G > 1 sums beta over the chain's rows in the fixed order g = 0..G-1,
// draws Gamma(alpha) and the prior uniforms once on the chain stream
// (seed, sidc + 2^30), and writes the chain's ps to all G rows. G = 1 is
// plain mode exactly (key sid, no offset).
//
// rng_fields: the omega fields of the real engine, whose omegas are the
// transposed fields (the megachain and mega engines draw theirs in
// registers inside draw_rhs and draw_system, draw_fused.cu keyed mode, and
// launch no rng_fields). A thread takes FIELD_LANES = 4 consecutive time
// lanes of one row, and the threads of a launch tile the flat (row, lane
// chunk) space, so no block idles on the part of a fixed-width block that
// t leaves empty (the one-element form ran a thread an element on blocks
// of 128 along time: at t = 203 a row took 256 threads for 203 lanes). The
// four Philox calls of a thread go through philox.cuh's draw_lanes, as the
// keyed passes' do: their key schedule, round 1's products and round 2's
// product of its first word (all of which depend on the row, not the
// lane) are formed once for the four. Each lane keeps the bits of the
// one-element form: the same counter, Box-Mullers and __fmul_rn scaling.
// Stores: oa and ob in 16-byte pairs from each thread's first even
// element, a lane left over at either end stored alone. Where the pairs
// start at the row's first lane, an odd t (the real layout has t = 203)
// leaves every other row to four 8-byte stores 32 bytes apart, and that
// left the four-lane kernel no faster than the one-element form on the
// H100; pairs taken from the first even element cover both parities.
// Pad lanes (j >= ntimes, or row_times[b]) are written as zeros: a chunk
// wholly beyond the row's count draws nothing; the one that straddles it
// draws its four lanes together and stores zeros beyond the count.
// What bounds it: the issue of the draws (a Philox call and two accurate
// Box-Mullers a lane) against 16 bytes written a lane; chip_smoke.py counts
// the drawn lane's slots in the compiled SASS (sass_draw_slots).
//
// Time maps. With tmap, lane j of a row draws time counter tmap[j] in
// place of j (the fields of chosen times at a narrower width). With a
// segment table, one launch draws several time groups, each at its own
// width: segment s (t_s times) writes its (B, n, t_s) fields contiguously
// at element B n toff[s] of oa and ob, lane j drawing counter
// tidx[toff[s] + j]. The grouped real engine's time groups are these
// segments: group g's omegas are the full fields at its global time
// indices (ops/philox.py), so a segment carries the bits of the gather it
// replaces. Table (int32, on the device): coff[0..G] the segments' chunk
// offsets within a row's chunks (chunks of segment s: coff[s+1] - coff[s]
// a row), toff[0..G] their time offsets, tidx[T]. The launch's chunks run
// segment by segment, each segment's row by row.
//
// bandpower: its old form ran a thread per bin on 100 blocks of 4 warps:
// ceil(alpha/4) Philox calls and logs strictly one after another (51 at
// alpha = 202) and three 12-step binary searches of the 4096-entry table
// per bounded bin, each a chain of dependent loads: latency bound, at 3 %
// of its bound. Now a block is one chain's 32 bins (lane = bin) and 8
// warps, the grid every chain and bin group (400 blocks at B = 100,
// n = 128, all resident at once). The warps split each bin's Philox calls
// (warp w takes the Gamma words r = w, w + 8, ...) and leave the logs in
// shared memory; warp 0 sums them in the old order (one running float, r
// ascending), so every Gamma draw keeps its bits. A bounded bin is searched
// by one warp, first (its draw does not need the Gamma draw, so its load
// latency runs under the other warps' Philox calls): the two searches of
// Q(alpha, .) interleaved, then the inverse search, each a warp-cooperative
// search that tests 64 pivots a round and narrows by ballot/popc
// (4096 -> 64 -> 1 in two rounds), finding the binary search's index on
// the monotone table rows (tlog increasing, tq non-increasing). What bounds
// it now is the instruction rate of the Philox rounds on the SMs that hold
// four of the 400 blocks, plus the bounded bins' search latency on their
// blocks.
// Tried on the card and dropped, all slower: one warp per (chain, bin) with
// the lanes splitting r and a shuffle-broadcast sum; the table staged in
// shared memory (only 7 of 128 bins search, so every staging block paid
// more than its searches saved); 16-bin blocks; warps taking words from a
// shared counter; bounded bins spread over the blocks of a chain.
#include <cstdint>

#include "hk_common.cuh"
#include "philox.cuh"

namespace {
constexpr unsigned FULL = 0xffffffffu;
constexpr int BP_WARPS = 8;    // warps of a bandpower block (32 bins)
constexpr int BP_CHUNK = 128;  // Gamma words (r) staged at a time

constexpr int FIELD_LANES = 4;       // time lanes a thread of rng_fields
constexpr int FIELD_THREADS = 256;   // threads of a fields block

// The launch's modes: FIELDS_FULL, plain rows of t lanes all drawn at
// counters j (the real engine's fields); FIELDS_MASKED, plain with a time
// map or lanes at or beyond ntimes or row_times[b] written as zeros;
// FIELDS_SEGMENTS, the segment table of the header.
enum FieldsMode { FIELDS_FULL, FIELDS_MASKED, FIELDS_SEGMENTS };

// Where chunk c (FIELD_LANES lanes of one row) of a launch lies. Plain:
// row c / cpr, lanes from (c % cpr) FIELD_LANES, rows of width t one
// after another. FIELDS_SEGMENTS: segment by segment, so that consecutive
// chunks cover consecutive elements in every mode; segment s holds the
// chunks rows coff[s] .. rows coff[s+1] - 1, rows of its width t_s.
struct Chunk {
  int b, i;          // chain and row index i
  int j0, w, lim;    // first lane, row width, lanes below lim drawn
  long long e;       // element of lane j0
  const int* map;    // the row's time counters, or null (j)
};

struct FieldsArgs {
  unsigned seed;
  const int* sids;
  unsigned g;
  float2* oa;
  float2* ob;
  int n, rows, t, ntimes;
  const int* row_times;
  const int* tmap;
  const int* seg;    // the segment table of the header (FIELDS_SEGMENTS)
  int nseg, cpr;     // cpr: chunks a row (plain mode)
  unsigned chunks;   // chunks of the launch
  bool aligned;      // oa and ob 16-byte aligned
  float sa;
};

template <int MODE>
__device__ __forceinline__ Chunk chunk_at(const FieldsArgs& a, unsigned c) {
  Chunk ch;
  int row, k;
  if constexpr (MODE == FIELDS_SEGMENTS) {
    const int* coff = a.seg;
    const int* toff = a.seg + a.nseg + 1;
    const unsigned rows = (unsigned)a.rows;
    int lo = 0, hi = a.nseg - 1;   // the last s with rows coff[s] <= c
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (rows * (unsigned)__ldg(coff + mid) <= c)
        lo = mid;
      else
        hi = mid - 1;
    }
    const int cs = __ldg(coff + lo), cpr = __ldg(coff + lo + 1) - cs;
    const int t0 = __ldg(toff + lo);
    const unsigned local = c - rows * (unsigned)cs;
    row = (int)(local / (unsigned)cpr);
    k = (int)(local - (unsigned)row * (unsigned)cpr);
    ch.w = __ldg(toff + lo + 1) - t0;
    ch.e = (long long)a.rows * t0 + (long long)row * ch.w;
    ch.map = a.seg + 2 * (a.nseg + 1) + t0;
  } else {
    row = (int)(c / (unsigned)a.cpr);
    k = (int)(c - (unsigned)row * (unsigned)a.cpr);
    ch.w = a.t;
    ch.e = (long long)row * a.t;
    ch.map = MODE == FIELDS_MASKED ? a.tmap : nullptr;
  }
  ch.b = row / a.n;
  ch.i = row - ch.b * a.n;
  ch.j0 = k * FIELD_LANES;
  ch.e += ch.j0;
  if constexpr (MODE == FIELDS_MASKED)
    ch.lim = min(a.row_times ? a.row_times[ch.b] : a.ntimes, a.t);
  else
    ch.lim = ch.w;
  return ch;
}

__device__ __forceinline__ void store_pair(float2* __restrict__ p, float2 u,
                                           float2 v) {
  *reinterpret_cast<float4*>(p) = make_float4(u.x, u.y, v.x, v.y);
}

// the first nl of a thread's FIELD_LANES lanes at p = field + e: with
// aligned fields in 16-byte pairs from the first even element (so an odd
// e stores its first lane alone), a lane left over stored alone
__device__ __forceinline__ void store_lanes(float2* __restrict__ p,
                                            const float2 (&v)[FIELD_LANES],
                                            int nl, bool odd, bool aligned) {
  static_assert(FIELD_LANES == 4, "the pairs below are written for 4");
  if (!aligned) {
#pragma unroll
    for (int l = 0; l < FIELD_LANES; ++l)
      if (l < nl) p[l] = v[l];
  } else if (odd) {
    if (nl > 0) p[0] = v[0];
    if (nl > 2)
      store_pair(p + 1, v[1], v[2]);
    else if (nl > 1)
      p[1] = v[1];
    if (nl > 3) p[3] = v[3];
  } else {
    if (nl > 1)
      store_pair(p, v[0], v[1]);
    else if (nl > 0)
      p[0] = v[0];
    if (nl > 3)
      store_pair(p + 2, v[2], v[3]);
    else if (nl > 2)
      p[2] = v[2];
  }
}

// FIELD_LANES lanes of one row a thread, over the launch's chunks
template <int MODE>
__global__ void __launch_bounds__(FIELD_THREADS)
fields_kernel(FieldsArgs a) {
  const unsigned c = blockIdx.x * FIELD_THREADS + threadIdx.x;
  if (c >= a.chunks) return;
  const Chunk ch = chunk_at<MODE>(a, c);
  float2 vb[FIELD_LANES] = {}, va[FIELD_LANES] = {};
  if (MODE != FIELDS_MASKED || ch.j0 < ch.lim) {
    int j[FIELD_LANES];
    consecutive(j, ch.j0);
    if (MODE != FIELDS_FULL && ch.map) {
#pragma unroll
      for (int l = 0; l < FIELD_LANES; ++l)
        j[l] = __ldg(ch.map + min(ch.j0 + l, ch.w - 1));
    }
    draw_lanes<true, true>(vb, va, a.seed, (unsigned)a.sids[ch.b], a.g,
                           ch.i, j, a.sa);
    if (MODE == FIELDS_MASKED && ch.j0 + FIELD_LANES > ch.lim) {
#pragma unroll
      for (int l = 0; l < FIELD_LANES; ++l) {
        if (ch.j0 + l >= ch.lim) {
          vb[l] = make_float2(0.f, 0.f);
          va[l] = make_float2(0.f, 0.f);
        }
      }
    }
  }
  const int nl = min(FIELD_LANES, ch.w - ch.j0);
  const bool odd = ch.e & 1;
  store_lanes(a.ob + ch.e, vb, nl, odd, a.aligned);
  store_lanes(a.oa + ch.e, va, nl, odd, a.aligned);
}

// Two binary searches of monotone table rows by the warp, interleaved: the
// counts of the leading indices k < S with before_a(k), resp. before_b(k),
// true (each predicate true up to some index and false after it: the index
// a binary search finds). A round tests 64 pivots step apart, two a lane,
// both searches' loads sent before either ballot, so S = 4096 takes two
// rounds (steps 64 and 1). Warp-uniform; every lane returns the counts.
template <class A, class B>
__device__ __forceinline__ int2 warp_search2(int S, int lane, A before_a,
                                             B before_b) {
  int lo_a = 0, len_a = S, lo_b = 0, len_b = S;  // count in [lo, lo + len]
  while (len_a > 0 || len_b > 0) {
    const int st_a = (len_a + 63) >> 6, hi_a = lo_a + len_a;
    const int st_b = (len_b + 63) >> 6, hi_b = lo_b + len_b;
    const int a1 = lo_a + (lane + 1) * st_a - 1, a2 = a1 + 32 * st_a;
    const int b1 = lo_b + (lane + 1) * st_b - 1, b2 = b1 + 32 * st_b;
    const bool pa1 = len_a > 0 && a1 < hi_a && before_a(a1);
    const bool pa2 = len_a > 0 && a2 < hi_a && before_a(a2);
    const bool pb1 = len_b > 0 && b1 < hi_b && before_b(b1);
    const bool pb2 = len_b > 0 && b2 < hi_b && before_b(b2);
    const int ca = __popc(__ballot_sync(FULL, pa1))
                   + __popc(__ballot_sync(FULL, pa2));
    const int cb = __popc(__ballot_sync(FULL, pb1))
                   + __popc(__ballot_sync(FULL, pb2));
    if (len_a > 0) {
      lo_a += ca * st_a;
      len_a = min(st_a - 1, hi_a - lo_a);
    }
    if (len_b > 0) {
      lo_b += cb * st_b;
      len_b = min(st_b - 1, hi_b - lo_b);
    }
  }
  return make_int2(lo_a, lo_b);
}

// Q(alpha, y) at log y = ly from the count of tlog < ly, by linear
// interpolation in log y (ops/invgamma._table_q_at)
__device__ __forceinline__ float q_interp(const float* __restrict__ tlog,
                                          const float* __restrict__ tq,
                                          int S, float ly, int lo) {
  const int idx = min(max(lo, 1), S - 1);
  const float l0 = __ldg(tlog + idx - 1), l1 = __ldg(tlog + idx);
  const float q0 = __ldg(tq + idx - 1), q1 = __ldg(tq + idx);
  const float tt = fminf(fmaxf((ly - l0) / fmaxf(l1 - l0, 1e-30f), 0.f), 1.f);
  return q0 + tt * (q1 - q0);
}

// (Q(alpha, ya), Q(alpha, yb)), the two searches interleaved
__device__ float2 q_at2(const float* __restrict__ tlog,
                        const float* __restrict__ tq, int S, float ya,
                        float yb, int lane) {
  const float la = logf(fmaxf(ya, FLT_MIN)), lb = logf(fmaxf(yb, FLT_MIN));
  const int2 c = warp_search2(
      S, lane, [&](int k) { return __ldg(tlog + k) < la; },
      [&](int k) { return __ldg(tlog + k) < lb; });
  return make_float2(q_interp(tlog, tq, S, la, c.x),
                     q_interp(tlog, tq, S, lb, c.y));
}

// y with Q(alpha, y) = c (ops/invgamma._table_y_at); tq is non-increasing
__device__ float y_at(const float* __restrict__ tlog,
                      const float* __restrict__ tq, int S, float c, int lane) {
  const int lo = warp_search2(   // first index with tq < c
      S, lane, [&](int k) { return !(__ldg(tq + k) < c); },
      [](int) { return false; }).x;
  const int idx = min(max(S - lo, 1), S - 1);
  const int j0 = S - idx, j1 = S - 1 - idx;
  const float q0 = __ldg(tq + j0), q1 = __ldg(tq + j1);
  const float l0 = __ldg(tlog + j0), l1 = __ldg(tlog + j1);
  const float tt = fminf(fmaxf((c - q0) / fmaxf(q1 - q0, 1e-30f), 0.f), 1.f);
  return expf(l0 + tt * (l1 - l0));
}

// log(u_4r u_4r+1 u_4r+2 u_4r+3) of the Gamma word r of bin i, uniforms at
// index >= alpha taken as 1
__device__ __forceinline__ float gamma_log(uint2 key, unsigned g, int i,
                                           int r, int alpha) {
  const uint4 w = philox(make_uint4(g, 1u, (unsigned)i, (unsigned)r), key);
  const unsigned ws[4] = {w.x, w.y, w.z, w.w};
  float prod = 1.f;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    prod *= (4 * r + q < alpha) ? u_open(ws[q]) : 1.f;
  return logf(prod);
}

// pooled beta of bin i: the chain's G rows summed in the order g = 0..G-1
__device__ __forceinline__ float pooled_beta(const float* __restrict__ beta,
                                             long long o, int n, int G) {
  float bt = beta[o];
  for (int r = 1; r < G; ++r) bt += beta[o + (long long)r * n];
  return bt;
}

// block = chain c (rows c*G .. c*G + G - 1; G = 1: plain mode) x 32 bins
// b0 .. b0 + 31, lane = bin. First the bounded bins, each by warp
// bin % BP_WARPS with its l in order: their draw does not use the Gamma
// draw, so the latency of their table searches overlaps the other warps'
// Philox calls. Then the warps split the Gamma draw's Philox calls (warp w
// takes r = w, w + BP_WARPS, ...), a chunk of BP_CHUNK words at a time,
// and leave each log in shared memory; warp 0 sums them in r order.
__global__ void __launch_bounds__(32 * BP_WARPS) bandpower_kernel(
    const float* __restrict__ beta, const float* __restrict__ gam_ext,
    const float* __restrict__ u_ext, int u_stride, unsigned seed,
    const int* __restrict__ sids, unsigned g_arg,
    const unsigned* __restrict__ g_dev, int alpha,
    const float* __restrict__ tlog, const float* __restrict__ tq, int S,
    const int* __restrict__ pidx, const float* __restrict__ plo,
    const float* __restrict__ phi, int np, float* __restrict__ ps_out,
    float* __restrict__ gam_out, int n, int G) {
  __shared__ float lg_s[BP_CHUNK][32];
  __shared__ float out_s[32];
  __shared__ int bounded_s[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * 32, i = b0 + lane;
  const bool valid = i < n;
  const long long r0 = (long long)blockIdx.x * G;
  const unsigned off = G > 1 ? (1u << 30) : 0u;
  const uint2 key = make_uint2(seed, sids ? (unsigned)sids[r0] + off : 0u);
  const unsigned g = g_dev ? *g_dev + g_arg : g_arg;
  if (warp == 0) bounded_s[lane] = 0;
  __syncthreads();
  for (int l = 0; l < np; ++l) {
    const int bl = pidx[l] - b0;   // warp-uniform
    if (bl < 0 || bl >= 32 || bl % BP_WARPS != warp) continue;
    float u;
    if (u_ext) {
      u = u_ext[r0 * u_stride + l];
    } else {
      const uint4 w = philox(make_uint4(g, 2u, 0u, (unsigned)(l >> 2)), key);
      const unsigned ws[4] = {w.x, w.y, w.z, w.w};
      u = u_open(ws[l & 3]);
    }
    const float bt = pooled_beta(beta, r0 * n + b0 + bl, n, G);
    const float lo = plo[l], hi = phi[l];
    const float2 p = q_at2(tlog, tq, S, bt / lo, bt / hi, lane);
    const float c = p.x + u * (p.y - p.x);
    const float y = y_at(tlog, tq, S, c, lane);
    const float x = bt / fmaxf(y, FLT_MIN);
    if (lane == 0) {
      out_s[bl] = fminf(fmaxf(x, lo), hi);
      bounded_s[bl] = 1;
    }
  }
  // warp 0: its lane's pooled beta (loaded now, used last) and the
  // running sum of the Gamma logs
  const long long o = r0 * n + i;
  const float bt = warp == 0 && valid ? pooled_beta(beta, o, n, G) : 0.f;
  float s = 0.f;
  if (!gam_ext) {
    const int nr = (alpha + 3) / 4;
    for (int base = 0; base < nr; base += BP_CHUNK) {
      const int m = min(BP_CHUNK, nr - base);
      if (valid)
        for (int r = warp; r < m; r += BP_WARPS)
          lg_s[r][lane] = gamma_log(key, g, i, base + r, alpha);
      __syncthreads();
      if (warp == 0) {
#pragma unroll 4
        for (int r = 0; r < m; ++r) s += lg_s[r][lane];
      }
      __syncthreads();
    }
  }
  __syncthreads();   // the bounded bins' results
  if (warp == 0 && valid) {
    const float gam = gam_ext ? gam_ext[o] : -s;
    const float out = bounded_s[lane] ? out_s[lane] : bt / gam;
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

// plain (seg null): B x n rows of t lanes, counters j or tmap[j]; with
// seg, nseg segments of seg_chunks chunks a row in all (the header)
HK_API int hk_rng_fields(unsigned seed, const int* sids, unsigned g,
                         float2* oa, float2* ob, int batch, int n, int t,
                         int ntimes, int nfreqs, const int* row_times,
                         const int* tmap, const int* seg, int nseg,
                         int seg_chunks, cudaStream_t stream) {
  FieldsArgs a;
  a.seed = seed;
  a.sids = sids;
  a.g = g;
  a.oa = oa;
  a.ob = ob;
  a.n = n;
  a.rows = batch * n;
  a.t = t;
  a.ntimes = ntimes;
  a.row_times = row_times;
  a.tmap = tmap;
  a.seg = seg;
  a.nseg = nseg;
  a.cpr = (t + FIELD_LANES - 1) / FIELD_LANES;
  a.sa = omega_a_scale(nfreqs);
  const long long chunks =
      (long long)a.rows * (seg ? seg_chunks : a.cpr);
  if (chunks <= 0) return 0;
  if (chunks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  a.chunks = (unsigned)chunks;
  a.aligned = (((uintptr_t)oa | (uintptr_t)ob) & 15) == 0;
  const unsigned blocks =
      (unsigned)((chunks + FIELD_THREADS - 1) / FIELD_THREADS);
  const int T = FIELD_THREADS;
  if (seg)
    fields_kernel<FIELDS_SEGMENTS><<<blocks, T, 0, stream>>>(a);
  else if (tmap || row_times || ntimes < t)
    fields_kernel<FIELDS_MASKED><<<blocks, T, 0, stream>>>(a);
  else
    fields_kernel<FIELDS_FULL><<<blocks, T, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// the iteration is g, or with g_dev given *g_dev + g (as hk_draw_rhs)
HK_API int hk_bandpower(const float* beta, const float* gam_ext,
                        const float* u_ext, int u_stride, unsigned seed,
                        const int* sids, unsigned g, const unsigned* g_dev,
                        int alpha, const float* tlog, const float* tq, int S,
                        const int* pidx, const float* plo, const float* phi,
                        int np, float* ps_out, float* gam_out, int batch,
                        int n, int G, cudaStream_t stream) {
  dim3 grid(batch / G, (n + 31) / 32);
  bandpower_kernel<<<grid, 32 * BP_WARPS, 0, stream>>>(
      beta, gam_ext, u_ext, u_stride, seed, sids, g, g_dev, alpha, tlog, tq, S,
      pidx, plo, phi, np, ps_out, gam_out, n, G);
  return (int)cudaGetLastError();
}

HK_API int hk_philox_raw(const unsigned* ctr, const unsigned* key,
                         unsigned* out, int count, cudaStream_t stream) {
  philox_raw_kernel<<<(count + 255) / 256, 256, 0, stream>>>(
      (const uint4*)ctr, (const uint2*)key, (uint4*)out, count);
  return (int)cudaGetLastError();
}
