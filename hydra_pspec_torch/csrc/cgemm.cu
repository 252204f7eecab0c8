// cgemm: batched complex64 product C = alpha * op(A) B + beta * X.
//
// Replaces every matrix product inside the TPU kernel gcr_megachain
// (hydra_pspec_tpu/ops/pallas/megastep.py:41 _cmm and its uses at
// :145-152, 191-194, 203-207, 221, 233; ops/pallas/megachain.py:385-388),
// where they were Gauss 3-mult products of 3-pass bf16-split MXU matmuls,
// and the products of the blocked Hermitian inverse and factor-solve
// (ops/pallas/spd_inv.py:57-99 _spd_inv_into).
//
// op(A) is A (opA 0), A^T (1) or A^H (2); A is per batch element or shared
// (a_batched 0: one A for the whole batch, e.g. the DFT matrix F). X may be
// null (then beta is ignored); C may alias X (each element of X is read only
// by the thread that writes that element of C) but not A or B. active
// (optional, int32 per batch element): the blocks of an element whose flag
// is 0 return before their first load and leave its C as it was (the
// warm start's masked rebuild above 128 channels, ops/kernels/herm_inv.py).
//
// Bound on the H100 SXM (132 SMs, 67 TFLOP/s FP32 outside the tensor
// cores, 3.35 TB/s): the main path's large products are 120 x 120 x 204 a
// chain (n = 120 channels, t = 204 times, the data's own widths), 5 of
// them an iteration, plus the Newton-Schulz steps at 120 x 120 x 120. At
// B = 100 one of them is 8 real flops x 2.94 M complex multiply-adds a
// chain, 2.35 GFLOP: 0.0351 ms at the FMA rate, while its operands (20 MB)
// take 0.006 ms even from HBM. So they are bound by the FP32 FMA rate. The
// skinny products (M = 12 or K = 12) are bound by the bytes of B, X and C.
//
// Design (register tiling, an asynchronous ring of K tiles, a tile plan
// made per call from the shape and the batch count):
//   * a block computes a BM x BN tile of C with TM x TN complex
//     accumulators per thread (4 x 4 for the large products): each K step
//     reads TM + TN complex from shared memory, two at a time as float4,
//     for TM * TN complex multiply-adds (4 FMAs each);
//   * K tiles of BK go through a ring of shared-memory stages filled by
//     cp.async (16-byte copies where the base pointer, the row length and
//     the batch stride allow, 8-byte copies otherwise, zero-fill at the
//     ragged edges), so the next tiles load while the current one computes,
//     with one barrier per tile; every ring fits the 48 KB a block gets
//     without the opt-in attribute;
//   * every operand goes to shared memory in its stored order; op T and H
//     are read along m there, and the conjugate of op H is a sign in the
//     FMA; op N's A rows carry two pad columns on the 60-row tiles and
//     the skinny ones, so the rows that the thread rows of one warp read
//     lie on other banks (64 x 64 keeps them unpadded: its ring would pass
//     48 KB);
//   * the tiles fit the data's own widths: 60 x 68 (255 threads, 15 x 17
//     threads of 4 x 4, K tiles of 12, which divide 120 and 180) covers
//     120 x 204 with no pad row, column or k; 60 x 40 (150 threads, K
//     tiles of 8, three blocks an SM)
//     covers 120 x 120 and the grouped rows' t = 80; 64 x 64 stays for the
//     widths that are multiples of 64 (the JAX package's layout, the
//     blocked compositions' 192 and 64);
//   * the plan (plan_tile) is a rule on the shape and the batch count:
//     of 60 x 68, 60 x 40 and 64 x 64 the tile that computes the least
//     pad (rows x columns x K, each rounded up to the tile), and 16 x 64
//     instead when that tile's blocks would fill less than half the SMs.
//     At B = 100 and 120 x 120 x 204 a chain, the 600 tiles of 60 x 68 give
//     the busiest SM 5 for an average of 4.55, where the 64 x 64 tiles over
//     128 x 256 computed 70 % useful FMAs and gave it 7 for 6.06. Measured
//     (python3 chip_smoke.py --cgemm, H100 80GB HBM3 at 700 W): about
//     0.065 ms of device time against the 64 x 64 tiles' 0.088, 54 % of
//     the bound, at the SM clock's maximum (1980 MHz); the same call times
//     every tile at every product (the rule's tile was the fastest at 24
//     of its 30 products);
//   * M <= 16: 16 x 64 tiles of 2 x 4 (128 threads), which the plan also
//     takes for small batches; K <= 16: 32 x 64 tiles of 2 x 4 with X
//     loaded before the K loop, where the bytes of B, X and C set the
//     bound.
// Each output element is one accumulator summed over k in ascending order by
// one thread, with the same fmaf sequence on every load path and every tile
// shape: no split-K, no atomics, so a chain's output depends on its own
// operands only, whatever tile the plan takes, and is bit-identical to the
// earlier kernels' (a zero-filled pad k adds an exact 0).
//
// No tensor cores, deliberately: Hopper's tensor cores have no IEEE FP32
// mode. TF32 keeps 10 mantissa bits, and a 3xTF32 split (wgmma or mma.sync)
// would change the rounding of every product; the reference rejected the
// TPU's reduced-precision passes for this posterior, so such a path must
// first pass the posterior oracle gate (ROADMAP.md).
#include <atomic>
#include <cstdint>

#include "hk_common.cuh"

namespace {
// A block of NY x NX threads computes a BM x BN tile of C, TM x TN complex
// outputs per thread, over K tiles of BK in a ring of STAGES; PREX loads X
// before the K loop; MINB blocks per SM bound the registers
// (__launch_bounds__); APAD pad columns on op N's A rows.
template <int BM_, int BN_, int BK_, int TM_, int TN_, int STAGES_,
          bool PREX_, int MINB_, int APAD_ = 2>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int STAGES = STAGES_, MINB = MINB_;
  static constexpr bool PREX = PREX_;
  static constexpr int NY = BM / TM, NX = BN / TN, THREADS = NX * NY;
  // op N stages A as As[m][LDA]: two pad columns move each row by 8 banks
  static constexpr int LDA = BK + APAD_;
  static_assert(BM % TM == 0 && BN % TN == 0 && TM % 2 == 0 &&
                    TN % 2 == 0 && BK % 2 == 0 && APAD_ % 2 == 0,
                "tile");
  // A's stage: As[BM][LDA] for op N, As[BK][BM] for op T and H
  static constexpr int A_TILE_N = BM * LDA, A_TILE_TH = BK * BM;
  static constexpr int B_TILE = BK * BN;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc += a b, or acc += conj(a) b: the same fmaf sequence as cfma with the
// sign of a.y folded into the FMA (op H)
template <bool CONJ>
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  const float ay = CONJ ? -a.y : a.y;
  acc.x = fmaf(a.x, b.x, fmaf(-ay, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(ay, b.x, acc.y));
}

// Copy the R x C tile at (r0, c0) of the row-major matrix g (row length ld,
// rows < rmax, columns < cmax) into shared s, row length LD; zeros outside.
template <int R, int C, int LD, int THREADS>
__device__ __forceinline__ void load_tile(float2* s, const float2* g, int ld,
                                          int r0, int c0, int rmax, int cmax,
                                          bool vec) {
  if (vec) {  // ld even, g 16-byte aligned: pairs lie wholly in or out
    constexpr int CH = R * C / 2;
#pragma unroll
    for (int e0 = 0; e0 < CH; e0 += THREADS) {
      const int e = e0 + threadIdx.x;
      if (CH % THREADS == 0 || e < CH) {
        const int r = e / (C / 2), c = 2 * (e % (C / 2));
        const int gr = r0 + r, gc = c0 + c;
        const bool ok = gr < rmax && gc < cmax;
        cp_async16(s + r * LD + c, ok ? g + (long long)gr * ld + gc : g, ok);
      }
    }
  } else {
    constexpr int CH = R * C;
#pragma unroll
    for (int e0 = 0; e0 < CH; e0 += THREADS) {
      const int e = e0 + threadIdx.x;
      if (CH % THREADS == 0 || e < CH) {
        const int r = e / C, c = e % C;
        const int gr = r0 + r, gc = c0 + c;
        const bool ok = gr < rmax && gc < cmax;
        cp_async8(s + r * LD + c, ok ? g + (long long)gr * ld + gc : g, ok);
      }
    }
  }
}

struct Args {
  const float2* A;
  const float2* B;
  const float2* X;  // may alias C
  float2* C;
  int M, N, K;
  long long a_bstride;
  float alpha, beta;
  bool vec_a, vec_b, vec_c;  // 16-byte paths of A, B and of X and C
  const int* active;         // null, or a flag per batch element
};

// OPA 0: A stored (M, K), staged as As[BM][LDA]; 1/2: A stored (K, M),
// staged as As[BK][BM]. Thread (ty, tx) owns rows 2ty + {0,1} + 2NY p and
// columns 2tx + {0,1} + 2NX q: every fragment read is a float4 of two
// neighbours, consecutive along tx and a broadcast along ty.
template <class T, int OPA>
__global__ void __launch_bounds__(T::THREADS, T::MINB) cgemm_kernel(Args p) {
  if (p.active && !p.active[blockIdx.z]) return;
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, TM = T::TM, TN = T::TN;
  constexpr int THREADS = T::THREADS, STAGES = T::STAGES;
  constexpr bool PREX = T::PREX;
  constexpr int NX = T::NX, NY = T::NY, LDA = T::LDA;
  constexpr bool CONJ = OPA == 2;
  constexpr int A_TILE = OPA == 0 ? T::A_TILE_N : T::A_TILE_TH;
  constexpr int B_TILE = T::B_TILE;
  extern __shared__ float4 smem4[];
  float2* As = reinterpret_cast<float2*>(smem4);
  float2* Bs = As + STAGES * A_TILE;

  const int tid = threadIdx.x, tx = tid % NX, ty = tid / NX;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int M = p.M, N = p.N, K = p.K;
  const float2* Ab = p.A + (long long)b * p.a_bstride;
  const float2* Bb = p.B + (long long)b * K * N;
  const long long cb = (long long)b * M * N;

  auto row = [&](int r) { return i0 + (r / 2) * 2 * NY + 2 * ty + r % 2; };
  auto col = [&](int q) { return j0 + q * 2 * NX + 2 * tx; };

  auto load_stage = [&](int stage, int k0) {
    if (OPA == 0)
      load_tile<BM, BK, LDA, THREADS>(As + stage * A_TILE, Ab, K, i0, k0, M,
                                      K, p.vec_a);
    else
      load_tile<BK, BM, BM, THREADS>(As + stage * A_TILE, Ab, M, k0, i0, K,
                                     M, p.vec_a);
    load_tile<BK, BN, BN, THREADS>(Bs + stage * B_TILE, Bb, N, k0, j0, K, N,
                                   p.vec_b);
  };

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    cp_async_commit();
  }

  // X before the K loop (the K <= 16 tiles, where X and C set the bound)
  float2 xv[PREX ? TM : 1][PREX ? TN : 1];
  if (PREX && p.X != nullptr) {
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int q = 0; q < TN / 2; ++q) {
        const int gi = row(r), gj = col(q);
        const float2* x = p.X + cb + (long long)gi * N + gj;
        float2 v0 = make_float2(0.f, 0.f), v1 = v0;
        if (gi < M && gj < N) {
          if (p.vec_c) {
            const float4 v = *reinterpret_cast<const float4*>(x);
            v0 = make_float2(v.x, v.y);
            v1 = make_float2(v.z, v.w);
          } else {
            v0 = x[0];
            if (gj + 1 < N) v1 = x[1];
          }
        }
        xv[PREX ? r : 0][PREX ? 2 * q : 0] = v0;
        xv[PREX ? r : 0][PREX ? 2 * q + 1 : 0] = v1;
      }
  }

  float2 acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = make_float2(0.f, 0.f);

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; the stage refilled below is free
    const int next = kt + STAGES - 1;
    if (next < nk) load_stage(next % STAGES, next * BK);
    cp_async_commit();

    const float2* as = As + (kt % STAGES) * A_TILE;
    const float2* bs = Bs + (kt % STAGES) * B_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 2) {
      float2 a0[TM], a1[TM], b0[TN], b1[TN];
#pragma unroll
      for (int q = 0; q < TN / 2; ++q) {
        const int c = q * 2 * NX + 2 * tx;
        const float4 u = *reinterpret_cast<const float4*>(bs + kk * BN + c);
        const float4 v =
            *reinterpret_cast<const float4*>(bs + (kk + 1) * BN + c);
        b0[2 * q] = make_float2(u.x, u.y);
        b0[2 * q + 1] = make_float2(u.z, u.w);
        b1[2 * q] = make_float2(v.x, v.y);
        b1[2 * q + 1] = make_float2(v.z, v.w);
      }
      if (OPA == 0) {  // As[m][k]: one float4 holds k and k + 1 of a row
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const int m = (r / 2) * 2 * NY + 2 * ty + r % 2;
          const float4 u =
              *reinterpret_cast<const float4*>(as + m * LDA + kk);
          a0[r] = make_float2(u.x, u.y);
          a1[r] = make_float2(u.z, u.w);
        }
      } else {  // As[k][m]: one float4 holds rows m and m + 1 at one k
#pragma unroll
        for (int r = 0; r < TM / 2; ++r) {
          const int m = r * 2 * NY + 2 * ty;
          const float4 u = *reinterpret_cast<const float4*>(as + kk * BM + m);
          const float4 v =
              *reinterpret_cast<const float4*>(as + (kk + 1) * BM + m);
          a0[2 * r] = make_float2(u.x, u.y);
          a0[2 * r + 1] = make_float2(u.z, u.w);
          a1[2 * r] = make_float2(v.x, v.y);
          a1[2 * r + 1] = make_float2(v.z, v.w);
        }
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) cmac<CONJ>(acc[r][c], a0[r], b0[c]);
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) cmac<CONJ>(acc[r][c], a1[r], b1[c]);
    }
  }
  cp_async_wait<0>();

  // epilogue: v = alpha acc (+ beta x), two neighbours per store
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gi = row(r);
    if (gi >= M) continue;
#pragma unroll
    for (int q = 0; q < TN / 2; ++q) {
      const int gj = col(q);
      if (gj >= N) continue;
      float2 v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        v[h] = make_float2(p.alpha * acc[r][2 * q + h].x,
                           p.alpha * acc[r][2 * q + h].y);
      const long long o = cb + (long long)gi * N + gj;
      if (p.X != nullptr) {
        float2 x[2];
        if (PREX) {
          x[0] = xv[PREX ? r : 0][PREX ? 2 * q : 0];
          x[1] = xv[PREX ? r : 0][PREX ? 2 * q + 1 : 0];
        } else if (p.vec_c) {
          const float4 u = *reinterpret_cast<const float4*>(p.X + o);
          x[0] = make_float2(u.x, u.y);
          x[1] = make_float2(u.z, u.w);
        } else {
          x[0] = p.X[o];
          x[1] = gj + 1 < N ? p.X[o + 1] : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[h].x = fmaf(p.beta, x[h].x, v[h].x);
          v[h].y = fmaf(p.beta, x[h].y, v[h].y);
        }
      }
      if (p.vec_c) {
        *reinterpret_cast<float4*>(p.C + o) =
            make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
      } else {
        p.C[o] = v[0];
        if (gj + 1 < N) p.C[o + 1] = v[1];
      }
    }
  }
}

template <class T, int OPA>
int launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int smem =
      (int)sizeof(float2) * T::STAGES *
      ((OPA == 0 ? T::A_TILE_N : T::A_TILE_TH) + T::B_TILE);
  // within the 48 KB of dynamic shared memory a kernel gets without opt-in
  static_assert(smem <= 48 * 1024, "tile ring needs the opt-in attribute");
  dim3 grid((a.N + T::BN - 1) / T::BN, (a.M + T::BM - 1) / T::BM, batch);
  cgemm_kernel<T, OPA><<<grid, T::THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class T>
int launch_op(const Args& a, int opA, int batch, cudaStream_t stream) {
  if (opA == 0) return launch<T, 0>(a, batch, stream);
  if (opA == 1) return launch<T, 1>(a, batch, stream);
  return launch<T, 2>(a, batch, stream);
}

// The tiles: (BM, BN, BK, TM, TN, STAGES, PREX, MINB[, APAD])
using SkinnyM = Tile<16, 64, 16, 2, 4, 3, false, 4>;     // M <= 16
using SkinnyK = Tile<32, 64, 16, 2, 4, 3, true, 3>;      // K <= 16
using T64x64 = Tile<64, 64, 16, 4, 4, 3, false, 2, 0>;   // multiples of 64
using T60x68 = Tile<60, 68, 12, 4, 4, 3, false, 2>;      // 120 x 204
using T60x40 = Tile<60, 40, 8, 4, 4, 4, false, 3>;       // 120 x 120, t = 80

// the tiles' indices in hk_cgemm_tile and hk_cgemm_plan (the order of
// ops/kernels/cgemm.py TILES)
enum TileId { SKINNY_M, SKINNY_K, TILE_64X64, TILE_60X68, TILE_60X40,
              N_TILES };

// The tile sizes of the products above 16 rows and 16 k, in the order the
// plan prefers them on a tie.
struct Dims {
  TileId id;
  int bm, bn, bk;
};

template <class T>
constexpr Dims dims(TileId id) {
  return {id, T::BM, T::BN, T::BK};
}

constexpr Dims LARGE[] = {dims<T60x68>(TILE_60X68), dims<T60x40>(TILE_60X40),
                          dims<T64x64>(TILE_64X64)};

long long round_up(int n, int to) { return (long long)(n + to - 1) / to * to; }

int sm_count() {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<int> sms[MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  dev = dev < 0 || dev >= MAX_DEVICES ? 0 : dev;
  int n = sms[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n <= 0)
      n = 132;
    sms[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// The tile of one call. M <= 16 and K <= 16 take their own. Else the tile
// of LARGE that computes the least pad, rows x columns x K each rounded up
// to it (the first on a tie): 60 x 68 at 120 x 204 and n = 180, 60 x 40 at
// 120 x 120 and t = 80, 64 x 64 at the multiples of 64. Where its blocks
// would fill less than half the SMs (a few chains), 16 x 64, whose blocks
// are four times as many, spreads the work over more of them.
TileId plan_tile(int batch, int M, int N, int K) {
  if (M <= 16) return SKINNY_M;
  if (K <= 16) return SKINNY_K;
  const Dims* best = &LARGE[0];
  long long least = -1;
  for (const Dims& t : LARGE) {
    const long long work =
        round_up(M, t.bm) * round_up(N, t.bn) * round_up(K, t.bk);
    if (least < 0 || work < least) {
      best = &t;
      least = work;
    }
  }
  const long long blocks = (long long)batch * ((M + best->bm - 1) / best->bm) *
                           ((N + best->bn - 1) / best->bn);
  return 2 * blocks < sm_count() ? SKINNY_M : best->id;
}

int launch_tile(TileId id, const Args& a, int opA, int batch,
                cudaStream_t stream) {
  switch (id) {
    case SKINNY_M: return launch_op<SkinnyM>(a, opA, batch, stream);
    case SKINNY_K: return launch_op<SkinnyK>(a, opA, batch, stream);
    case TILE_64X64: return launch_op<T64x64>(a, opA, batch, stream);
    case TILE_60X68: return launch_op<T60x68>(a, opA, batch, stream);
    case TILE_60X40: return launch_op<T60x40>(a, opA, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

int run(const float2* A, const float2* B, const float2* X, float2* C,
        int batch, int M, int N, int K, int opA, int a_batched, float alpha,
        float beta, const int* active, int tile, cudaStream_t stream) {
  if (opA < 0 || opA > 2 || batch <= 0 || M <= 0 || N <= 0 || K <= 0 ||
      tile < -1 || tile >= N_TILES)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.A = A;
  a.B = B;
  a.X = X;
  a.C = C;
  a.M = M;
  a.N = N;
  a.K = K;
  a.a_bstride = a_batched ? (long long)M * K : 0;
  a.alpha = alpha;
  a.beta = beta;
  a.active = active;
  // 16-byte copies need the base aligned and an even row length (then every
  // row and every batch element starts 16-byte aligned too)
  a.vec_a = aligned16(A) && (opA == 0 ? K : M) % 2 == 0;
  a.vec_b = aligned16(B) && N % 2 == 0;
  a.vec_c = aligned16(C) && (X == nullptr || aligned16(X)) && N % 2 == 0;
  const TileId id = tile < 0 ? plan_tile(batch, M, N, K) : (TileId)tile;
  return launch_tile(id, a, opA, batch, stream);
}
}  // namespace

HK_API int hk_cgemm(const float2* A, const float2* B, const float2* X,
                    float2* C, int batch, int M, int N, int K, int opA,
                    int a_batched, float alpha, float beta,
                    const int* active, cudaStream_t stream) {
  return run(A, B, X, C, batch, M, N, K, opA, a_batched, alpha, beta, active,
             -1, stream);
}

// The same product on a tile of the caller's choice (a TileId), whatever
// the shape: the check that the bits do not depend on the plan. tile -1 is
// hk_cgemm's plan.
HK_API int hk_cgemm_tile(const float2* A, const float2* B, const float2* X,
                         float2* C, int batch, int M, int N, int K, int opA,
                         int a_batched, float alpha, float beta,
                         const int* active, int tile, cudaStream_t stream) {
  return run(A, B, X, C, batch, M, N, K, opA, a_batched, alpha, beta, active,
             tile, stream);
}

// The tile hk_cgemm's plan takes for a shape on the current device (an
// index of hk_cgemm_tile's), or -1 for a shape it does not take.
HK_API int hk_cgemm_plan(int batch, int M, int N, int K) {
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0) return -1;
  return plan_tile(batch, M, N, K);
}

HK_API const char* hk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
