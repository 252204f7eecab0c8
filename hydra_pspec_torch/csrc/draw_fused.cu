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
// Bound on the H100. row_scale_sumsq and draw_resid stream (B, n, t)
// complex fields at a few FLOP per 8-byte element: HBM bandwidth bound
// (3.35 TB/s). Design: one block per row of n (or t) elements, consecutive
// threads on consecutive elements (coalesced), row sums by a fixed-order
// block reduction, so every result is deterministic and independent of the
// batch.
//
// draw_rhs and draw_system, the two passes that draw the omegas, were
// redesigned for the layout at the data's own widths (t = 204 on the main
// path, about 80 a row in the grouped time-flags mode, n = 120 or 180):
//   * a thread takes LANES = 4 consecutive time lanes of one row, as two
//     16-byte pairs where t is even and the fields 16-byte aligned (VEC),
//     and the threads of a launch tile the (row, lane-chunk) space flat, so
//     no block idles on the part of a 256-wide row that t does not fill;
//   * keyed, the four Philox calls of a thread share their row's key
//     (seed, sid), iteration and row index i: the key schedule and the
//     round-1 and round-2 products of the counter words g and i are common
//     subexpressions of the unrolled lanes, computed once for four lanes;
//   * pad lanes (j >= the row's time count) are written as zeros without
//     reading their inputs: in this layout every input there is zero
//     (models/mega.py), so a pad lane's result was 0 already;
//   * draw_system: dd and dinv are computed once per chain. A chain's n
//     rows go to a cluster of SYS_CLUSTER blocks (Hopper thread-block
//     clusters); each block computes dd_i and dinv_i of its own rows (one
//     square root and one reciprocal square root each, from ps and the
//     diagonal of P~), writes them out, and reads the other rows' values
//     from the other blocks' shared memory (distributed shared memory)
//     after a cluster barrier. The kernel it replaces recomputed all n
//     values in each of a chain's n blocks, from strided diagonal loads.
// What bounds them at these shapes. Keyed, instruction issue: a drawn
// lane costs one Philox4x32-10 call (ten rounds of two 32 x 32 -> 64-bit
// products, which issue at half the FP32 rate, and their xors) and one
// Box-Muller pair with accurate logf, sqrtf, sinf and cosf. chip_smoke.py
// counts them in the compiled SASS (cuobjdump): about 280 instructions a
// drawn lane in the keyed body beyond the stored one, some of them code the
// draws never run (sinf's and cosf's reduction of large arguments); the
// draw's arithmetic alone takes about 107 issue slots a lane, which at
// 2.44 M lanes (B = 100, 120 x 203) is 0.008 ms against the 0.012 ms of
// draw_rhs's bytes (16 a lane; draw_system adds 16 n bytes a chain row for
// S). So the bound the script states is the bytes', and on an H100 the
// passes run at about half of it, held by the draws' issue. Stored, both
// are bandwidth bound.
//
// Omegas (megachain.py:238-302 on the TPU, drawn in the kernel there too):
// draw_rhs and draw_system take them either as stored fields (ob, oa: the
// external randomness of the JAX pins, or rng_fields' output) or keyed on
// (seed, row stream ids sids, iteration g). Keyed, each thread draws the
// Philox words of its (b, i, j) and forms omega_b (draw_rhs, words 0-1) or
// omega_a (draw_system, words 2-3) with csrc/philox.cuh, the functions
// rng_fields uses. So no omega field goes through device memory, at one
// Philox call per element more than a shared draw would take. A keyed omega
// carries the bits of the stored one and enters the same expression, so
// keyed and stored modes give equal results. The other layout, draw_rhs
// drawing both halves and writing omega_a for a stored-mode draw_system,
// measured slower on the H100 (PERF.md).
#include <cooperative_groups.h>
#include <cstdint>

#include "hk_common.cuh"
#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {
constexpr int ROW_THREADS = 256;
constexpr int PASS_THREADS = 256;  // at most, draw_rhs and draw_system
constexpr int LANES = 4;           // time lanes a thread
constexpr int SYS_CLUSTER = 8;     // blocks of one chain in draw_system

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

// rc = d + h w and xs = dinv (dd f + w) on a real lane, with their
// roundings written out (one fma each, as the compiler formed them before
// the keyed mode existed), so a keyed omega and a stored one give the same
// bits
__device__ __forceinline__ float rhs_of(float d, float h, float w) {
  return __fmaf_rn(h, w, d);
}

__device__ __forceinline__ float xs_of(float dvi, float ddi, float f,
                                       float w) {
  return __fmul_rn(dvi, __fmaf_rn(ddi, f, w));
}

// Lanes j0 .. j0 + LANES - 1 of a row, at p = field + row * t + j0: those
// below lim read (VEC: in 16-byte pairs; t even, so a pair that starts
// below lim ends below t), the others left as they are.
template <bool VEC>
__device__ __forceinline__ void load_lanes(float2 (&v)[LANES],
                                           const float2* __restrict__ p,
                                           int j0, int lim) {
#pragma unroll
  for (int l = 0; l < LANES; l += VEC ? 2 : 1) {
    if (j0 + l < lim) {
      if constexpr (VEC) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p + l));
        v[l] = make_float2(q.x, q.y);
        v[l + 1] = make_float2(q.z, q.w);
      } else {
        v[l] = __ldg(p + l);
      }
    }
  }
}

// Lanes j0 .. of a row written at p, those below t.
template <bool VEC>
__device__ __forceinline__ void store_lanes(float2* __restrict__ p,
                                            const float2 (&v)[LANES], int j0,
                                            int t) {
#pragma unroll
  for (int l = 0; l < LANES; l += VEC ? 2 : 1) {
    if (j0 + l < t) {
      if constexpr (VEC) {
        *reinterpret_cast<float4*>(p + l) =
            make_float4(v[l].x, v[l].y, v[l + 1].x, v[l + 1].y);
      } else {
        p[l] = v[l];
      }
    }
  }
}

// The LANES omegas of lanes j0.. of row i: words 0-1 (omega_b, HALF
// false) or 2-3 (omega_a) of each lane's Philox call, every lane drawn
// (a lane beyond the row's count is drawn and not used), so the unrolled
// calls share their common subexpressions
template <bool HALF_A>
__device__ __forceinline__ void draw_lanes(float2 (&w)[LANES],
                                           unsigned seed, unsigned sid,
                                           unsigned g, int i, int j0,
                                           float scale) {
#pragma unroll
  for (int l = 0; l < LANES; ++l) {
    const uint4 q = omega_words(seed, sid, g, i, j0 + l);
    if constexpr (HALF_A)
      w[l] = omega_of(q.z, q.w, scale);
    else
      w[l] = omega_of(q.x, q.y, scale);
  }
}

// rc of LANES lanes a thread, the threads over the flat (row, lane chunk)
// space: row = b * n + i, cpr = ceil(t / LANES) chunks a row
template <bool KEYED, bool VEC>
__global__ void __launch_bounds__(PASS_THREADS)
rhs_kernel(const float2* __restrict__ nid, const float* __restrict__ nih,
           const float2* __restrict__ ob, OmegaKey key,
           float2* __restrict__ rc, int n, int t, int ntimes,
           const int* __restrict__ row_times, long long chunks, int cpr) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chunks) return;
  const long long row = c / cpr;
  const int j0 = (int)(c - row * cpr) * LANES;
  const int b = (int)(row / n), i = (int)(row - (long long)b * n);
  const int ntb = row_times ? row_times[b] : ntimes;
  const int lim = min(ntb, t);
  const long long o0 = row * t + j0;
  float2 r[LANES] = {};
  if (j0 < lim) {
    const float h = nih[row];
    float2 d[LANES] = {}, w[LANES] = {};
    load_lanes<VEC>(d, nid + o0, j0, lim);
    if constexpr (KEYED) {
      draw_lanes<false>(w, key.seed, (unsigned)key.sids[b],
                        iteration_of(key.g, key.g_dev), i, j0,
                        OMEGA_B_SCALE);
    } else {
      load_lanes<VEC>(w, ob + o0, j0, lim);
    }
#pragma unroll
    for (int l = 0; l < LANES; ++l)
      if (j0 + l < lim)
        r[l] = make_float2(rhs_of(d[l].x, h, w[l].x),
                           rhs_of(d[l].y, h, w[l].y));
  }
  store_lanes<VEC>(rc + o0, r, j0, t);
}

__device__ __forceinline__ float dd_of(float ps, float nf) {
  return sqrtf(fmaxf(ps, 0.f) / nf);
}

__device__ __forceinline__ float dinv_of(float dd, float ptjj) {
  return rsqrtf(fmaxf(1.f + dd * dd * ptjj, FLT_MIN));
}

// S_ij = (dd_i dd_j P~_ij + delta_ij) dinv_i dinv_j
__device__ __forceinline__ float2 s_of(float ddi, float dvi, float ddj,
                                       float dvj, float2 p, bool diag) {
  const float outer = ddi * ddj, dscale = dvi * dvj;
  return make_float2((outer * p.x + (diag ? 1.f : 0.f)) * dscale,
                     (outer * p.y) * dscale);
}

// One chain (blockIdx.y) per cluster of SYS_CLUSTER blocks; block r of
// the cluster takes rows r0 .. r1 - 1 (rpb a block): their dd and dinv,
// their n entries of S (in 16-byte pairs when pairs_n) and their t lanes
// of xs (LANES a thread). Dynamic shared memory: dd and dinv of all n
// rows, then of this block's rpb rows.
template <bool KEYED, bool VEC>
__global__ void __cluster_dims__(SYS_CLUSTER, 1, 1)
__launch_bounds__(PASS_THREADS)
system_kernel(const float2* __restrict__ pt, const float* __restrict__ ps,
              const float2* __restrict__ frc, const float2* __restrict__ oa,
              OmegaKey key, float sa, float2* __restrict__ S,
              float2* __restrict__ xs, float* __restrict__ dd_out,
              float* __restrict__ dinv_out, int n, int t, int ntimes,
              const int* __restrict__ row_times, float nf, int rpb, int cpr,
              bool pairs_n) {
  extern __shared__ float sh[];
  float* s_dd = sh;
  float* s_dv = sh + n;
  float* own_dd = sh + 2 * n;
  float* own_dv = own_dd + rpb;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int r0 = rank * rpb, rows = max(0, min(n, r0 + rpb) - r0);
  const float2* ptb = pt + (long long)b * n * n;
  const long long rowb = (long long)b * n;

  // 1. dd and dinv of this block's rows: each computed once a chain
  for (int il = threadIdx.x; il < rows; il += blockDim.x) {
    const int i = r0 + il;
    const float ddi = dd_of(ps[rowb + i], nf);
    const float dvi = dinv_of(ddi, ptb[(long long)i * n + i].x);
    own_dd[il] = ddi;
    own_dv[il] = dvi;
    dd_out[rowb + i] = ddi;
    dinv_out[rowb + i] = dvi;
  }
  cluster.sync();
  // 2. every row's, from the shared memory of the block that owns it
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int rk = j / rpb, jl = j - rk * rpb;
    s_dd[j] = cluster.map_shared_rank(own_dd, rk)[jl];
    s_dv[j] = cluster.map_shared_rank(own_dv, rk)[jl];
  }
  // the other blocks' reads done before this one may exit; s_dd complete
  cluster.sync();

  // 3. this block's rows of S
  if (pairs_n) {
    const int hn = n >> 1;
    for (int e = threadIdx.x; e < rows * hn; e += blockDim.x) {
      const int il = e / hn, j = 2 * (e - il * hn), i = r0 + il;
      const long long o = (long long)i * n + j;
      const float4 p = __ldg(reinterpret_cast<const float4*>(ptb + o));
      const float ddi = s_dd[i], dvi = s_dv[i];
      const float2 a = s_of(ddi, dvi, s_dd[j], s_dv[j],
                            make_float2(p.x, p.y), i == j);
      const float2 c = s_of(ddi, dvi, s_dd[j + 1], s_dv[j + 1],
                            make_float2(p.z, p.w), i == j + 1);
      *reinterpret_cast<float4*>(S + rowb * n + o) =
          make_float4(a.x, a.y, c.x, c.y);
    }
  } else {
    for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
      const int il = e / n, j = e - il * n, i = r0 + il;
      const long long o = (long long)i * n + j;
      S[rowb * n + o] = s_of(s_dd[i], s_dv[i], s_dd[j], s_dv[j], ptb[o],
                             i == j);
    }
  }

  // 4. this block's rows of xs, LANES lanes a thread
  const int ntb = row_times ? row_times[b] : ntimes;
  const int lim = min(ntb, t);
  unsigned sid = 0u, g = 0u;
  if constexpr (KEYED) {
    sid = (unsigned)key.sids[b];
    g = iteration_of(key.g, key.g_dev);
  }
  for (int c = threadIdx.x; c < rows * cpr; c += blockDim.x) {
    const int il = c / cpr, j0 = (c - il * cpr) * LANES, i = r0 + il;
    const long long o0 = (rowb + i) * t + j0;
    float2 r[LANES] = {};
    if (j0 < lim) {
      const float ddi = s_dd[i], dvi = s_dv[i];
      float2 f[LANES] = {}, w[LANES] = {};
      load_lanes<VEC>(f, frc + o0, j0, lim);
      if constexpr (KEYED) {
        draw_lanes<true>(w, key.seed, sid, g, i, j0, sa);
      } else {
        load_lanes<VEC>(w, oa + o0, j0, lim);
      }
#pragma unroll
      for (int l = 0; l < LANES; ++l)
        if (j0 + l < lim)
          r[l] = make_float2(xs_of(dvi, ddi, f[l].x, w[l].x),
                             xs_of(dvi, ddi, f[l].y, w[l].y));
    }
    store_lanes<VEC>(xs + o0, r, j0, t);
  }
}

// Threads of a block that takes `work` items in rounds of at most
// PASS_THREADS: the fewest warps that keep the rounds' count, so a short
// row (the grouped mode's ~80 lanes) does not leave most of a last round
// idle.
int pass_threads(long long work) {
  const long long rounds = (work + PASS_THREADS - 1) / PASS_THREADS;
  long long th = rounds > 0 ? (work + rounds - 1) / rounds : 32;
  th = (th + 31) / 32 * 32;
  return (int)(th < 32 ? 32 : th > PASS_THREADS ? PASS_THREADS : th);
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
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
  const int cpr = (t + LANES - 1) / LANES;
  const long long chunks = (long long)batch * n * cpr;
  if (chunks == 0) return (int)cudaGetLastError();
  const unsigned blocks =
      (unsigned)((chunks + PASS_THREADS - 1) / PASS_THREADS);
  const bool vec = t % 2 == 0 && aligned16(nid) && aligned16(ob) &&
                   aligned16(rc);
  auto go = [&](auto kernel) {
    kernel<<<blocks, PASS_THREADS, 0, stream>>>(nid, nih, ob, key, rc, n, t,
                                                ntimes, row_times, chunks,
                                                cpr);
  };
  if (ob)
    vec ? go(rhs_kernel<false, true>) : go(rhs_kernel<false, false>);
  else
    vec ? go(rhs_kernel<true, true>) : go(rhs_kernel<true, false>);
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
  if (batch == 0 || n == 0) return (int)cudaGetLastError();
  const int rpb = (n + SYS_CLUSTER - 1) / SYS_CLUSTER;
  const int cpr = (t + LANES - 1) / LANES;
  const int threads = pass_threads((long long)rpb * cpr);
  const size_t smem = sizeof(float) * 2 * (size_t)(n + rpb);
  const bool vec = t % 2 == 0 && aligned16(frc) && aligned16(oa) &&
                   aligned16(xs);
  const bool pairs_n = n % 2 == 0 && aligned16(pt) && aligned16(S);
  dim3 grid(SYS_CLUSTER, batch);
  auto go = [&](auto kernel) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    kernel<<<grid, threads, smem, stream>>>(
        pt, ps, frc, oa, key, sa, S, xs, dd, dinv, n, t, ntimes, row_times,
        (float)nfreqs, rpb, cpr, pairs_n);
  };
  if (oa)
    vec ? go(system_kernel<false, true>) : go(system_kernel<false, false>);
  else
    vec ? go(system_kernel<true, true>) : go(system_kernel<true, false>);
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
