// Philox4x32-10 and the normals drawn from its words, shared by the
// kernels that draw the omegas (rng_bandpower.cu's rng_fields, and the
// keyed modes of draw_fused.cu's draw_rhs and draw_system, all three
// through draw_lanes) and the bandpower conditional. The plain twin is
// hydra_pspec_torch/ops/philox.py.
//
// Omega stream: key (run seed, row stream id), counter (global iteration g,
// 0, row i, time j); words 0-1 give omega_b (Box-Muller, scale sqrt(1/2)),
// words 2-3 omega_a (scale sqrt(1/2) sqrt(nfreqs)). The scaling multiply is
// __fmul_rn, so a field formed in registers by a consumer carries the same
// bits as the one rng_fields stores: no contraction can fold it into the
// consumer's arithmetic.
#pragma once
#include <cuda_runtime.h>
#include <cmath>

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

// (0, 1)-open uniform from the top 24 bits
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

constexpr float OMEGA_B_SCALE = 0.70710678118654752440f;  // sqrt(1/2)

// omega_a's scale sqrt(1/2) sqrt(nfreqs), formed on the host in float32
inline float omega_a_scale(int nfreqs) {
  return OMEGA_B_SCALE * sqrtf((float)nfreqs);
}

// the four omega words of (row stream sid, iteration g, row i, time j)
__device__ __forceinline__ uint4 omega_words(unsigned seed, unsigned sid,
                                             unsigned g, int i, int j) {
  return philox(make_uint4(g, 0u, (unsigned)i, (unsigned)j),
                make_uint2(seed, sid));
}

// one complex omega from two words: Box-Muller, then the scale
__device__ __forceinline__ float2 omega_of(unsigned b1, unsigned b2,
                                          float scale) {
  const float2 z = box_muller(b1, b2);
  return make_float2(__fmul_rn(z.x, scale), __fmul_rn(z.y, scale));
}

// The omegas of L lanes of row i of the stream (seed, sid) at iteration g,
// lane l at time counter j[l]: omega_b (words 0-1, scale sqrt(1/2)) into
// ob when WANT_B, omega_a (words 2-3, scale sa) into oa when WANT_A. Every
// lane is drawn (a caller leaves unstored the lanes it does not use), so
// the unrolled Philox calls share what does not depend on j: the key
// schedule, round 1's two products (of g and i) and round 2's product of
// its first word. rng_fields draws both halves, draw_rhs omega_b and
// draw_system omega_a.
template <bool WANT_B, bool WANT_A, int L>
__device__ __forceinline__ void draw_lanes(float2 (&ob)[L], float2 (&oa)[L],
                                           unsigned seed, unsigned sid,
                                           unsigned g, int i,
                                           const int (&j)[L], float sa) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const uint4 q = omega_words(seed, sid, g, i, j[l]);
    if constexpr (WANT_B) ob[l] = omega_of(q.x, q.y, OMEGA_B_SCALE);
    if constexpr (WANT_A) oa[l] = omega_of(q.z, q.w, sa);
  }
}

// the time counters j0, j0 + 1, .. of L consecutive lanes
template <int L>
__device__ __forceinline__ void consecutive(int (&j)[L], int j0) {
#pragma unroll
  for (int l = 0; l < L; ++l) j[l] = j0 + l;
}
