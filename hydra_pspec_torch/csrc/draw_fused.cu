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
// (3.35 TB/s). Their rows are short (t = 204 on the main path, 53-80 in
// the grouped time-flags mode, about 15 in the grouped real engine), so
// one 256-thread block a row left most of each block idle and set their
// time by block waves. Design: a row takes 4, 8 or 32 lanes of a warp
// (from t alone), a thread LANES = 4 consecutive time lanes in 16-byte
// pairs where t is even; several rows share a warp or a block, and a
// row's sum is reduced by shuffles in the fixed tree of a 256-thread
// block reduction (see the row passes below), so every result is
// deterministic, independent of the batch, and the same bits as the
// block-a-row kernels these replaced. draw_resid's amplitude rows
// (amps = da + a0) take the flat (row, lane chunk) tiling of the same
// launch.
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

// The LANES omegas of lanes j0.. of row i (philox.cuh's draw_lanes):
// omega_b (HALF_A false) or omega_a, every lane drawn (a lane beyond the
// row's count is drawn and not used)
template <bool HALF_A>
__device__ __forceinline__ void draw_half(float2 (&w)[LANES], unsigned seed,
                                          unsigned sid, unsigned g, int i,
                                          int j0, float sa) {
  int j[LANES];
  consecutive(j, j0);
  draw_lanes<!HALF_A, HALF_A>(w, w, seed, sid, g, i, j, sa);
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
      draw_half<false>(w, key.seed, (unsigned)key.sids[b],
                       iteration_of(key.g, key.g_dev), i, j0, 0.f);
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
        draw_half<true>(w, key.seed, sid, g, i, j0, sa);
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

// --- the row passes: row_scale_sumsq and draw_resid ---------------------
//
// Each row's sum keeps the tree of the block reduction these passes had at
// one 256-thread block a row, so the bits stay the same: virtual thread
// v = j mod 256 adds its elements j ascending to 0.f; an xor butterfly at
// offsets 16, 8, 4, 2, 1 within each segment of 32 virtual threads; the
// 8 segments added in order to 0.f. Here R lanes of a warp take a row
// (row_lanes: from t alone), in groups of 8 (G = R / 8 of them; R = 4
// holds a row of at most 16 lanes). A thread holds LANES = 4 consecutive
// virtual threads v = 32 s + 4 l8 + l of segment s (l8 its lane in the
// group), so levels 16, 8 and 4 are shuffles at lane xor 4, 2 and 1 and
// levels 2 and 1 are its registers; group g takes segments g, g + G, ...
// (its slots h), and the segments' totals are gathered by shuffles and
// added in order. An absent virtual thread holds +0.0 and every summand
// is |.|^2 >= 0 or a masked 0, so a level or segment with no lanes is
// skipped exactly: the tree over a short row is the tree over its own
// lanes. Floating-point addition is commutative bit for bit, so each
// level's pairs may be formed in either order. Each element's roundings
// are written out as the one-block-a-row kernels compiled them (FMUL,
// FFMA, FADD in their SASS), so no contraction can move a bit when a
// thread adds a second element (t > 256).
constexpr int ROW_BLOCK = 256;       // threads of a row-pass block
constexpr unsigned FULL = 0xffffffffu;

// |z|^2 as fmaf(x, x, y * y)
__device__ __forceinline__ float abs2_rn(float2 z) {
  return __fmaf_rn(z.x, z.x, __fmul_rn(z.y, z.y));
}

// The four virtual threads' sums of a thread -> its segment's total, in
// every lane of its group (levels at offsets 16, 8, 4 as shuffles; those
// whose partner lies outside a row of R < 8 lanes hold absent threads)
template <int R>
__device__ __forceinline__ float segment_sum(float (&v)[LANES]) {
#pragma unroll
  for (int o = 4; o >= 1; o >>= 1) {
    if (o < R) {
#pragma unroll
      for (int l = 0; l < LANES; ++l)
        v[l] = __fadd_rn(v[l], __shfl_xor_sync(FULL, v[l], o));
    }
  }
  return __fadd_rn(__fadd_rn(v[0], v[2]), __fadd_rn(v[1], v[3]));
}

template <int R>
struct RowTile {
  static constexpr int G = R < 8 ? 1 : R / 8;   // 8-lane groups a row
  // segments (slots) a group takes; R < 8 lanes cover the first 4 R
  // virtual threads of segment 0 alone
  static constexpr int H = R < 8 ? 1 : 8 / G;
};

// body(h, j0) for each chunk of LANES lanes j0.. of this thread's row
// (group g, lane l8): every slot's first chunk (j0 < 256), then, for
// t > 256, the later chunks of each slot, each virtual thread ascending
template <int R, typename Body>
__device__ __forceinline__ void for_row_chunks(int t, int g, int l8,
                                               Body&& body) {
  constexpr int G = RowTile<R>::G, H = RowTile<R>::H;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int j0 = 32 * (g + G * h) + LANES * l8;
    if (j0 < t) body(h, j0);
  }
  if (t > 256) {
#pragma unroll
    for (int h = 0; h < H; ++h)
      for (int j0 = 32 * (g + G * h) + LANES * l8 + 256; j0 < t; j0 += 256)
        body(h, j0);
  }
}

// The row's total from its threads' virtual sums acc[h][l]: each slot's
// segment total, then segments 0 .. nseg - 1 added in order to 0.f
// (segment g + G h sits in slot h of group g, lane 8 g of the row's R)
template <int R>
__device__ __forceinline__ float row_total(
    float (&acc)[RowTile<R>::H][LANES], int nseg, int base) {
  constexpr int G = RowTile<R>::G, H = RowTile<R>::H;
  float seg[H];
#pragma unroll
  for (int h = 0; h < H; ++h)
    seg[h] = h * G < nseg ? segment_sum<R>(acc[h]) : 0.f;
  float total = 0.f;
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
      if (h * G + gg < nseg)
        total = __fadd_rn(total, G == 1 ? seg[h]
                                        : __shfl_sync(FULL, seg[h],
                                                      base + 8 * gg));
  return total;
}

// segments of 32 virtual threads that hold lanes of a row of t
__device__ __forceinline__ int row_segments(int t) {
  return (min(t, 256) + 31) / 32;
}

// Four float lanes j0.. of a row at p, those below t (VEC: as two 8-byte
// pairs; t even, so a pair that starts below t ends below it)
template <bool VEC>
__device__ __forceinline__ void store_floats(float* __restrict__ p,
                                             const float (&v)[LANES], int j0,
                                             int t) {
#pragma unroll
  for (int l = 0; l < LANES; l += VEC ? 2 : 1) {
    if (j0 + l < t) {
      if constexpr (VEC)
        *reinterpret_cast<float2*>(p + l) = make_float2(v[l], v[l + 1]);
      else
        p[l] = v[l];
    }
  }
}

// y = s2 (s1 x) and sums = sum_t |y|^2 of rows rows, R lanes a row
template <int R, bool VEC>
__global__ void __launch_bounds__(ROW_BLOCK)
scale_sumsq_kernel(const float2* __restrict__ x, const float* __restrict__ s1,
                   const float* __restrict__ s2, float2* __restrict__ y,
                   float* __restrict__ sums, int rows, int t) {
  const int lane = threadIdx.x & 31, lr = lane & (R - 1);
  const long long row =
      ((long long)blockIdx.x * ROW_BLOCK + threadIdx.x) / R;
  const bool live = row < rows;
  float acc[RowTile<R>::H][LANES] = {};
  if (live) {
    const float a = s1 ? s1[row] : 1.f;
    const float c = s2 ? s2[row] : 1.f;
    for_row_chunks<R>(t, lr >> 3, lr & 7, [&](int h, int j0) {
      const long long o0 = row * t + j0;
      float2 v[LANES] = {}, u[LANES];
      load_lanes<VEC>(v, x + o0, j0, t);
#pragma unroll
      for (int l = 0; l < LANES; ++l) {
        u[l] = make_float2(__fmul_rn(c, __fmul_rn(a, v[l].x)),
                           __fmul_rn(c, __fmul_rn(a, v[l].y)));
        if (j0 + l < t) acc[h][l] = __fadd_rn(acc[h][l], abs2_rn(u[l]));
      }
      if (y) store_lanes<VEC>(y + o0, u, j0, t);
    });
  }
  const float total = row_total<R>(acc, row_segments(t), lane & ~(R - 1));
  if (live && lr == 0) sums[row] = total;
}

// Blocks below res_blocks: the residual rows b * n + i, R lanes a row:
// res = dw - sig - fa, chi = |res|^2 ninvf, noise = sum_t |res|^2 w ninvf,
// chit = sum over the row's times of chi, ws = w sig. The others: the
// amplitude rows, amp = da + a0, LANES lanes a thread over the flat
// (row, lane chunk) space (cpr chunks a row).
template <int R, bool VEC>
__global__ void __launch_bounds__(ROW_BLOCK)
resid_kernel(const float2* __restrict__ dw, const float2* __restrict__ sig,
             const float2* __restrict__ fa, const float* __restrict__ ninvf,
             const float* __restrict__ w, const float2* __restrict__ da,
             const float2* __restrict__ a0, float* __restrict__ chi,
             float* __restrict__ noise, float* __restrict__ chit,
             float2* __restrict__ amp, float2* __restrict__ ws, int rows,
             int n, int t, int ntimes, const int* __restrict__ row_times,
             unsigned res_blocks, long long amp_chunks, int cpr) {
  if (blockIdx.x >= res_blocks) {   // amplitude rows: amps = da + a0
    const long long c =
        (long long)(blockIdx.x - res_blocks) * ROW_BLOCK + threadIdx.x;
    if (c >= amp_chunks) return;
    const long long arow = c / cpr;
    const int j0 = (int)(c - arow * cpr) * LANES;
    const long long o0 = arow * t + j0;
    float2 d[LANES] = {}, z[LANES] = {}, r[LANES];
    load_lanes<VEC>(d, da + o0, j0, t);
    load_lanes<VEC>(z, a0 + o0, j0, t);
#pragma unroll
    for (int l = 0; l < LANES; ++l)
      r[l] = make_float2(__fadd_rn(d[l].x, z[l].x),
                         __fadd_rn(d[l].y, z[l].y));
    store_lanes<VEC>(amp + o0, r, j0, t);
    return;
  }
  const int lane = threadIdx.x & 31, lr = lane & (R - 1);
  const long long row =
      ((long long)blockIdx.x * ROW_BLOCK + threadIdx.x) / R;
  const bool live = row < rows;
  float acc_noise[RowTile<R>::H][LANES] = {};
  float acc_chit[RowTile<R>::H][LANES] = {};
  if (live) {
    const int b = (int)(row / n);
    const int ntb = row_times ? row_times[b] : ntimes;
    const float nv = ninvf[row], wv = w[row];
    const float wn = __fmul_rn(wv, nv);
    for_row_chunks<R>(t, lr >> 3, lr & 7, [&](int h, int j0) {
      const long long o0 = row * t + j0;
      float2 d[LANES] = {}, s[LANES] = {}, f[LANES] = {}, sw[LANES];
      float cv[LANES];
      load_lanes<VEC>(d, dw + o0, j0, t);
      load_lanes<VEC>(s, sig + o0, j0, t);
      load_lanes<VEC>(f, fa + o0, j0, t);
#pragma unroll
      for (int l = 0; l < LANES; ++l) {
        const float rr = __fsub_rn(__fsub_rn(d[l].x, s[l].x), f[l].x);
        const float ri = __fsub_rn(__fsub_rn(d[l].y, s[l].y), f[l].y);
        const float res2 = __fmaf_rn(rr, rr, __fmul_rn(ri, ri));
        cv[l] = __fmul_rn(res2, nv);
        sw[l] = make_float2(__fmul_rn(wv, s[l].x), __fmul_rn(wv, s[l].y));
        if (j0 + l < t) {
          acc_noise[h][l] = __fmaf_rn(res2, wn, acc_noise[h][l]);
          acc_chit[h][l] =
              __fadd_rn(acc_chit[h][l], j0 + l < ntb ? cv[l] : 0.f);
        }
      }
      if (chi) store_floats<VEC>(chi + o0, cv, j0, t);
      if (ws) store_lanes<VEC>(ws + o0, sw, j0, t);
    });
  }
  const int nseg = row_segments(t), base = lane & ~(R - 1);
  const float tn = row_total<R>(acc_noise, nseg, base);
  const float tc = chit ? row_total<R>(acc_chit, nseg, base) : 0.f;
  if (live && lr == 0) {
    noise[row] = tn;
    if (chit) chit[row] = tc;
  }
}

// Lanes of a warp a row takes in the row passes, from the row's length
// alone (never the batch, so a subset of rows runs the same tile): 4 for
// a row of at most 16 lanes, 8 for one segment, else 32 (measured on the
// H100 at t = 15, 53, 80, 203 and 204 against 8 and 16 lanes: PERF.md)
int row_lanes(int t) {
  return t <= 4 * LANES ? 4 : t <= 32 ? 8 : 32;
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
  if (rows == 0) return (int)cudaGetLastError();
  const int r = row_lanes(t);
  const unsigned blocks =
      (unsigned)(((long long)rows * r + ROW_BLOCK - 1) / ROW_BLOCK);
  const bool vec = t % 2 == 0 && aligned16(x) && aligned16(y);
  auto go = [&](auto kernel) {
    kernel<<<blocks, ROW_BLOCK, 0, stream>>>(x, s1, s2, y, sums, rows, t);
  };
  if (r == 4)
    vec ? go(scale_sumsq_kernel<4, true>) : go(scale_sumsq_kernel<4, false>);
  else if (r == 8)
    vec ? go(scale_sumsq_kernel<8, true>) : go(scale_sumsq_kernel<8, false>);
  else
    vec ? go(scale_sumsq_kernel<32, true>)
        : go(scale_sumsq_kernel<32, false>);
  return (int)cudaGetLastError();
}

HK_API int hk_draw_resid(const float2* dw, const float2* sig, const float2* fa,
                         const float* ninvf, const float* w, const float2* da,
                         const float2* a0, float* chi, float* noise,
                         float* chit, float2* amp, float2* ws, int batch,
                         int n, int m, int t, int ntimes,
                         const int* row_times, cudaStream_t stream) {
  const int rows = batch * n, r = row_lanes(t);
  const int cpr = (t + LANES - 1) / LANES;
  const long long amp_chunks = amp ? (long long)batch * m * cpr : 0;
  const unsigned res_blocks =
      (unsigned)(((long long)rows * r + ROW_BLOCK - 1) / ROW_BLOCK);
  const unsigned blocks =
      res_blocks + (unsigned)((amp_chunks + ROW_BLOCK - 1) / ROW_BLOCK);
  if (blocks == 0) return (int)cudaGetLastError();
  const bool vec = t % 2 == 0 && aligned16(dw) && aligned16(sig) &&
                   aligned16(fa) && aligned16(da) && aligned16(a0) &&
                   aligned16(amp) && aligned16(ws) &&
                   (reinterpret_cast<uintptr_t>(chi) & 7u) == 0;
  auto go = [&](auto kernel) {
    kernel<<<blocks, ROW_BLOCK, 0, stream>>>(
        dw, sig, fa, ninvf, w, da, a0, chi, noise, chit, amp, ws, rows, n, t,
        ntimes, row_times, res_blocks, amp_chunks, cpr);
  };
  if (r == 4)
    vec ? go(resid_kernel<4, true>) : go(resid_kernel<4, false>);
  else if (r == 8)
    vec ? go(resid_kernel<8, true>) : go(resid_kernel<8, false>);
  else
    vec ? go(resid_kernel<32, true>) : go(resid_kernel<32, false>);
  return (int)cudaGetLastError();
}
