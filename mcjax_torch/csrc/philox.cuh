// The keyed Philox4x32-10 stream of the sub-step kernels' in-kernel form
// (mcjax's in-kernel PRNG, mcjax/ops/pallas_sweep.py:226-350), generated in
// registers. The layout of keys, counters and words, and the plain version
// that gives the same floats bit for bit, are in
// mcjax_torch/ops/random.py (PhiloxRandoms, philox4x32).
//
// Floating point: built with --fmad=false. uniform_01 and the 2u - 1 of a
// uniform step are exact; the step's product rounds once; a gaussian
// component is one written-out fma of the exact integer sum of its halves.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace mcjax_philox {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr uint32_t kTagMoves = 1;  // random.py TAG_MOVES

// Random123's philox4x32_10: ten rounds, the key bumped before each round
// after the first.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// A word's uniform in [0, 1): the top 24 bits times 2^-24 (exact).
__device__ __forceinline__ float uniform_01(uint32_t w) {
  return __fmul_rn(static_cast<float>(w >> 8), 0x1p-24f);
}

// A uniform proposal step * (2u - 1) in [-step, step).
__device__ __forceinline__ float uniform_step(uint32_t w, float step) {
  return __fmul_rn(step, __fsub_rn(__fmul_rn(2.f, uniform_01(w)), 1.f));
}

// A gaussian proposal from the sum s of ih_k 16-bit halves: fma(c1, s,
// -c0), with (c1, c0) from random.py irwin_hall_constants.
__device__ __forceinline__ float irwin_hall(uint32_t s, float c1, float c0) {
  return __fmaf_rn(c1, static_cast<float>(s), -c0);
}

// The stream of a run as a kernel argument, passed by value.
struct Args {
  uint32_t k0, k1;  // the seed's low and high 32 bits
  uint32_t sweep;
  int ih_k;         // halves a gaussian component; 0: uniform proposals
  float step;       // uniform proposals: the step
  float c1, c0;     // gaussian proposals: irwin_hall's constants
  int calls;        // Philox calls a move
};

// The words of one move in order: each call's four, from call m * calls.
struct Words {
  uint4 buf;
  int left;
  uint32_t c0, c1, c2, c3, k0, k1;

  __device__ __forceinline__ Words(const Args& a, uint32_t gcell, int sub,
                                   int m)
      : buf(make_uint4(0u, 0u, 0u, 0u)), left(0),
        c0(static_cast<uint32_t>(m) * static_cast<uint32_t>(a.calls)),
        c1(gcell), c2(a.sweep),
        c3((kTagMoves << 16) | static_cast<uint32_t>(sub)), k0(a.k0),
        k1(a.k1) {}

  __device__ __forceinline__ uint32_t next() {
    if (left == 0) {
      buf = philox4x32_10(make_uint4(c0++, c1, c2, c3), k0, k1);
      left = 4;
    }
    const uint32_t w = buf.x;
    buf = make_uint4(buf.y, buf.z, buf.w, 0u);
    --left;
    return w;
  }
};

// Move m of cell gcell in sub-step `sub`: its pick uniform, its acceptance
// uniform (if kAcc) and its DIM displacement components.
template <int DIM, bool kAcc>
__device__ __forceinline__ void move_draws(const Args& a, uint32_t gcell,
                                           int sub, int m, float* pick,
                                           float* acc, float* disp) {
  Words w(a, gcell, sub, m);
  *pick = uniform_01(w.next());
  if constexpr (kAcc) *acc = uniform_01(w.next());
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    if (a.ih_k == 0) {
      disp[d] = uniform_step(w.next(), a.step);
    } else {
      uint32_t s = 0;
#pragma unroll 1
      for (int k = a.ih_k; k > 0; k -= 2) {
        const uint32_t v = w.next();
        s += v >> 16;
        if (k > 1) s += v & 0xFFFFu;
      }
      disp[d] = irwin_hall(s, a.c1, a.c0);
    }
  }
}

}  // namespace mcjax_philox
