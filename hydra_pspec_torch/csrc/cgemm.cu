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
// Bound on the H100: at the main path's large products (128 x 128 x 256 per
// chain, B = 100) 8 real flops per complex multiply-add make 3.4 GFLOP, so
// they are bound by the FP32 FMA rate (67 TFLOP/s: 0.050 ms), not by HBM
// (the operands of all chains stay in the 50 MB L2). The skinny products
// (M = 16 or K = 16) are bound by the bytes of B, X and C.
//
// Design (register tiling, an asynchronous ring of K tiles):
//   * a block computes a BM x BN tile of C with TM x TN complex accumulators
//     per thread (64 x 64 and 4 x 4, 256 threads, for the large products):
//     each K step reads TM + TN complex from shared memory, two at a time as
//     float4, for TM * TN complex multiply-adds (4 FMAs each);
//   * K tiles of 16 go through a ring of three shared-memory stages filled
//     by cp.async (16-byte copies where the base pointer, the row length
//     and the batch stride allow, 8-byte copies otherwise, zero-fill at the
//     ragged edges), so the next tiles load while the current one computes,
//     with one barrier per tile;
//   * every operand goes to shared memory in its stored order; op T and H
//     are read along m there, and the conjugate of op H is a sign in the FMA;
//   * the tile shape is picked from (M, K) alone, never from the batch
//     count: 16 x 64 tiles of 2 x 4 (128 threads) for M <= 16; 32 x 64
//     tiles of 2 x 4 with X loaded before the K loop for K <= 16, where the
//     bytes of B, X and C set the bound; else 64 x 64 tiles of 4 x 4 (two
//     blocks an SM). At B = 100 and 128 x 256 outputs a chain, the 800
//     large tiles fill the 132 SMs 3.03 times, so a fourth, nearly empty
//     wave follows three full ones.
// Each output element is one accumulator summed over k in ascending order by
// one thread, with the same fmaf sequence on every load path and every tile
// shape: no split-K, no atomics, so a chain's output depends on its own
// operands only, and is bit-identical to the earlier 32 x 32 tile kernel's.
//
// No tensor cores, deliberately: Hopper's tensor cores have no IEEE FP32
// mode. TF32 keeps 10 mantissa bits, and a 3xTF32 split (wgmma or mma.sync)
// would change the rounding of every product; the reference rejected the
// TPU's reduced-precision passes for this posterior, so such a path must
// first pass the posterior oracle gate (ROADMAP.md).
#include <cstdint>

#include "hk_common.cuh"

namespace {
constexpr int BK = 16;      // K tile
constexpr int STAGES = 3;   // shared-memory ring

// A block of THREADS threads computes a BM x BN tile of C, TM x TN complex
// outputs per thread; PREX loads X before the K loop; MINB blocks per SM
// bound the registers (__launch_bounds__).
template <int BM_, int BN_, int TM_, int TN_, bool PREX_, int THREADS_,
          int MINB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr bool PREX = PREX_;
  static constexpr int THREADS = THREADS_, MINB = MINB_;
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
// rows < rmax, columns < cmax) into shared s[R][C]; zeros outside.
template <int R, int C, int THREADS>
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
        cp_async16(s + r * C + c, ok ? g + (long long)gr * ld + gc : g, ok);
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
        cp_async8(s + r * C + c, ok ? g + (long long)gr * ld + gc : g, ok);
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

// OPA 0: A stored (M, K), staged as As[BM][BK]; 1/2: A stored (K, M),
// staged as As[BK][BM]. Thread (ty, tx) owns rows 2ty + {0,1} + 2NY p and
// columns 2tx + {0,1} + 2NX q: every fragment read is a float4 of two
// neighbours, conflict-free along tx and a broadcast along ty.
template <class T, int OPA>
__global__ void __launch_bounds__(T::THREADS, T::MINB) cgemm_kernel(Args p) {
  if (p.active && !p.active[blockIdx.z]) return;
  constexpr int BM = T::BM, BN = T::BN, TM = T::TM, TN = T::TN;
  constexpr int THREADS = T::THREADS;
  constexpr bool PREX = T::PREX;
  constexpr int NX = BN / TN, NY = BM / TM;
  static_assert(NX * NY == THREADS && TM % 2 == 0 && TN % 2 == 0, "tile");
  constexpr bool CONJ = OPA == 2;
  constexpr int A_TILE = BM * BK, B_TILE = BK * BN;
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
      load_tile<BM, BK, THREADS>(As + stage * A_TILE, Ab, K, i0, k0, M, K,
                                 p.vec_a);
    else
      load_tile<BK, BM, THREADS>(As + stage * A_TILE, Ab, M, k0, i0, K, M,
                                 p.vec_a);
    load_tile<BK, BN, THREADS>(Bs + stage * B_TILE, Bb, N, k0, j0, K, N,
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
          const float4 u = *reinterpret_cast<const float4*>(as + m * BK + kk);
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
  constexpr size_t smem = sizeof(float2) * STAGES * BK * (T::BM + T::BN);
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

// the tile shapes hk_cgemm picks from (M, K)
using SkinnyM = Tile<16, 64, 2, 4, false, 128, 4>;   // M <= 16
using SkinnyK = Tile<32, 64, 2, 4, true, 256, 3>;    // K <= 16
using Large = Tile<64, 64, 4, 4, false, 256, 2>;

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}
}  // namespace

HK_API int hk_cgemm(const float2* A, const float2* B, const float2* X,
                    float2* C, int batch, int M, int N, int K, int opA,
                    int a_batched, float alpha, float beta,
                    const int* active, cudaStream_t stream) {
  if (opA < 0 || opA > 2 || batch <= 0 || M <= 0 || N <= 0 || K <= 0)
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
  if (M <= 16) return launch_op<SkinnyM>(a, opA, batch, stream);
  if (K <= 16) return launch_op<SkinnyK>(a, opA, batch, stream);
  return launch_op<Large>(a, opA, batch, stream);
}

HK_API const char* hk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
