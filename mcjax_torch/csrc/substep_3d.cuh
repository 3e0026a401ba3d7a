// The 3D warp-per-cell sub-step kernel, templated on the pair model (a
// functor of pair.cuh): its body, launch shape and launch, for every form
// (NVT, NPT, field, Philox). substep_lj.cu instantiates it with the
// Lennard-Jones functor in all four forms; substep_pair.cu with the other
// single-species models (hard spheres, square wells, WCA, soft spheres,
// Yukawa, Morse, polynomials) in their host-random NVT form. substep_lj.cu's
// header comment describes the design; what a model changes:
//
// * M::kEnergy: the frozen-neighbor energy cache, the compaction of the
//   pairs within the cutoff (p.rc2) and their full terms (M::term), the
//   acceptance uniform and the exp test. A model without energy (hard
//   spheres) builds no cache and reads no acc_u: a move is taken when it
//   stays in its cell and overlaps nothing.
// * M::kHardCore: every staged and own slot is tested for r2 < p.core2 at
//   the mover's new position, on the same r2 the energy uses; on any
//   overlap in the warp (__any_sync) the move is rejected before the
//   Metropolis test, as the plain version's accept = ~overlap & (acc_u < a).
//
// The culling reach (cuda_substep.cull_constants) is the model's farthest
// interaction: the cutoff, or the hard core's diameter where that is
// larger (the only one for hard spheres).

#pragma once

#include <cuda_runtime.h>

#include "field.cuh"
#include "pair.cuh"
#include "philox.cuh"

namespace {

constexpr int kWarps = 4;          // cells per block
constexpr int kTargetWarps = 32;   // resident warps an SM to size for
constexpr int kNeighbors = 26;
constexpr int kPrefetch = 4;       // raw rounds read at once when staging
constexpr int kScratch = 96;       // candidate r2 of a warp
constexpr int kTableInts = 80;     // starts[26], bases[26], unwrap[26]
// Shared memory of a warp besides its staged slots, in float4.
constexpr int kExtraF4 = (kScratch + kTableInts) / 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFar = 1.0e30f;    // empty slot: r2 overflows to +inf

using mcjax_pair::Params;

// The frozen slots of a warp's cell as they lie in device memory: raw
// slot c (0 <= c < total) is slot c - starts[k] of neighbor k, the last k
// with starts[k] <= c.
struct Frozen {
  const float* pos;
  const int* starts;
  const int* bases;
  const int* unwrap;  // per neighbor: (a0 + 1) | (a1 + 1) << 2 | (a2 + 1) << 4
  int total;
  int P;
  int plane;
  float box_l;
};

__device__ __forceinline__ int floor_half(int t) {  // floor(t / 2)
  return t >= 0 ? t / 2 : -((1 - t) / 2);
}

__device__ __forceinline__ float sq_dist(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
  const float e0 = __fsub_rn(a0, b0);
  const float e1 = __fsub_rn(a1, b1);
  const float e2 = __fsub_rn(a2, b2);
  return __fmaf_rn(e2, e2, __fmaf_rn(e1, e1, __fmul_rn(e0, e0)));
}

// The pair's squared distance as its terms see it: s^2 r2 in the NPT form.
template <bool kScale>
__device__ __forceinline__ float pair_r2(float s2, float a0, float a1,
                                         float a2, float b0, float b1,
                                         float b2) {
  const float r2 = sq_dist(a0, a1, a2, b0, b1, b2);
  if constexpr (kScale) {
    return __fmul_rn(s2, r2);
  } else {
    return r2;
  }
}

// Distance from v to the interval [lo, up] (0 inside it).
__device__ __forceinline__ float axis_gap(float v, float lo, float up) {
  return fmaxf(fmaxf(__fsub_rn(lo, v), __fsub_rn(v, up)), 0.f);
}

__device__ __forceinline__ float unwrap_add(float v, int code, float box_l) {
  return code == 0 ? __fsub_rn(v, box_l)
                   : (code == 2 ? __fadd_rn(v, box_l) : v);
}

// Raw frozen slot c < f.total, unwrapped into the own cell's frame.
__device__ __forceinline__ float4 raw_slot(const Frozen& f, int c) {
  int k = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    if (k + step < kNeighbors && f.starts[k + step] <= c) k += step;
  }
  const float* s = f.pos + f.bases[k] + (c - f.starts[k]) * f.P;
  const int u = f.unwrap[k];
  return make_float4(unwrap_add(__ldg(s), u & 3, f.box_l),
                     unwrap_add(__ldg(s + f.plane), (u >> 2) & 3, f.box_l),
                     unwrap_add(__ldg(s + 2 * f.plane), (u >> 4) & 3, f.box_l),
                     0.f);
}

// Candidate compaction: r2 values within the cutoff collect in the warp's
// scratch (at most 31 waiting plus 64 new); every 32 of them get the full
// term at once.
template <class M>
struct Candidates {
  float* scr;
  unsigned lt;  // lanes below this one
  int lane;
  int cnt;      // warp-uniform: entries waiting in scr
  int done;     // warp-uniform: entries evaluated
  float part;   // this lane's share of the energy

  // Two slots a lane: one flush test for 64 slots.
  __device__ __forceinline__ void offer2(float ra, float rb, const Params& pp) {
    const bool ca = ra <= pp.rc2;
    const bool cb = rb <= pp.rc2;
    const unsigned ba = __ballot_sync(kFull, ca);
    const unsigned bb = __ballot_sync(kFull, cb);
    const int na = __popc(ba);
    if (ca) scr[cnt + __popc(ba & lt)] = ra;
    if (cb) scr[cnt + na + __popc(bb & lt)] = rb;
    cnt += na + __popc(bb);
#pragma unroll 1
    while (cnt >= 32) {  // warp-uniform
      __syncwarp();
      part = __fadd_rn(part, M::term(scr[lane], pp));
      const float carry0 = scr[lane + 32];
      const float carry1 = scr[lane + 64];
      __syncwarp();
      scr[lane] = carry0;
      scr[lane + 32] = carry1;
      __syncwarp();
      cnt -= 32;
      done += 32;
    }
  }

  __device__ __forceinline__ void finish(const Params& pp) {
    __syncwarp();
    if (lane < cnt) part = __fadd_rn(part, M::term(scr[lane], pp));
    __syncwarp();  // scr is written again by the next energy
    done += cnt;
    cnt = 0;
  }
};

// This lane's share of the energy of a particle at (x, y, z) against every
// frozen slot: the staged ones, then (rarely) the raw rounds from
// ovf_round on, which did not fit in shared memory. Adds the number of
// full terms to *terms (lane 0's count is the warp's). A hard-core model
// also ORs into *ov whether one of this lane's slots overlaps; a model
// without energy only tests that.
template <class M, bool kScale>
__device__ __forceinline__ float frozen_part(float x, float y, float z,
                                             const float4* stage, int staged,
                                             const Frozen& f, int ovf_round,
                                             float* scr, int lane,
                                             const Params& pp, float s2,
                                             unsigned long long* terms,
                                             bool* ov) {
  Candidates<M> cand{scr, (1u << lane) - 1u, lane, 0, 0, 0.f};
  bool hit = false;
  for (int s = lane; s < staged; s += 64) {
    const float4 qa = stage[s];
    const float4 qb = stage[s + 32];
    const float ra = pair_r2<kScale>(s2, x, y, z, qa.x, qa.y, qa.z);
    const float rb = pair_r2<kScale>(s2, x, y, z, qb.x, qb.y, qb.z);
    if constexpr (M::kHardCore) {
      hit |= mcjax_pair::overlap<M>(ra, pp) | mcjax_pair::overlap<M>(rb, pp);
    }
    if constexpr (M::kEnergy) cand.offer2(ra, rb, pp);
  }
#pragma unroll 1
  for (int c = 32 * ovf_round + lane; c - lane < f.total; c += 32) {
    float r2 = kFar;
    if (c < f.total) {
      const float4 q = raw_slot(f, c);
      r2 = pair_r2<kScale>(s2, x, y, z, q.x, q.y, q.z);
    }
    if constexpr (M::kHardCore) hit |= mcjax_pair::overlap<M>(r2, pp);
    if constexpr (M::kEnergy) cand.offer2(r2, kFar, pp);
  }
  if constexpr (M::kHardCore) *ov |= hit;
  if constexpr (M::kEnergy) {
    cand.finish(pp);
    *terms += cand.done;
  }
  return cand.part;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  }
  return v;
}

// One cell of the active color, by one warp. Dynamic shared memory: per
// warp, `cap` staged slots (float4), then the candidate scratch and the
// neighbor table. s2: the NPT form's s^2 (unused by the NVT form); reach2
// is already the stored-frame reach.
template <class M, bool kScale, bool kField, bool kPhilox>
__device__ __forceinline__ void
cell_substep(int cell, float* __restrict__ pos, const int* __restrict__ occ,
             const int* __restrict__ perm, int sub,
             const float* __restrict__ pick_u,
             const float* __restrict__ disp,
             const float* __restrict__ acc_u, float* __restrict__ de_map,
             int* __restrict__ acc_map,
             unsigned long long* __restrict__ stats, int B, int nmax,
             int n_moves, int cap, float w, float half_l, float box_l,
             float beta, Params pp, float pad, float reach2, float s2,
             const mcjax_field::Args& fa, const mcjax_philox::Args& ph) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int P = B * B * B;
  const int b0 = cell / (B * B);
  const int b1 = (cell / B) % B;
  const int b2 = cell % B;
  const int color = perm[sub];
  const int o0 = color & 1;
  const int o1 = (color >> 1) & 1;
  const int o2 = (color >> 2) & 1;
  const int plane = nmax * P;     // [nmax, B, B, B]
  const int cstride = 3 * plane;  // [3, nmax, B, B, B]

  const int my_occ = occ[color * P + cell];
  if (my_occ == 0) {  // no proposals, nothing moves
    if (lane == 0) {
      de_map[cell] = 0.f;
      acc_map[cell] = 0;
    }
    return;
  }

  float4* stage = smem + warp * (cap + kExtraF4);
  float* scr = reinterpret_cast<float*>(stage + cap);
  int* starts = reinterpret_cast<int*>(scr + kScratch);
  int* bases = starts + kNeighbors;
  int* unwrap = bases + kNeighbors;

  // Lane k < 26 describes neighbor cell k (offsets over (-1, 0, 1)^3 in
  // lexicographic order, center skipped): its source color, slot base,
  // occupancy and periodic unwrap.
  int nb_occ = 0;
  if (lane < kNeighbors) {
    const int off = lane < 13 ? lane : lane + 1;
    const int t0 = o0 + off / 9 - 1;
    const int t1 = o1 + (off / 3) % 3 - 1;
    const int t2 = o2 + off % 3 - 1;
    const int src = (t0 & 1) | ((t1 & 1) << 1) | ((t2 & 1) << 2);
    int n0 = b0 + floor_half(t0);
    int n1 = b1 + floor_half(t1);
    int n2 = b2 + floor_half(t2);
    int u0 = 1, u1 = 1, u2 = 1;
    if (n0 < 0) { n0 += B; u0 = 0; } else if (n0 >= B) { n0 -= B; u0 = 2; }
    if (n1 < 0) { n1 += B; u1 = 0; } else if (n1 >= B) { n1 -= B; u1 = 2; }
    if (n2 < 0) { n2 += B; u2 = 0; } else if (n2 >= B) { n2 -= B; u2 = 2; }
    const int ncell = (n0 * B + n1) * B + n2;
    nb_occ = occ[src * P + ncell];
    bases[lane] = src * cstride + ncell;
    unwrap[lane] = u0 | (u1 << 2) | (u2 << 4);
  }
  // Exclusive prefix of the occupancies: where each neighbor's live slots
  // start in the raw list.
  int incl = nb_occ;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane < kNeighbors) starts[lane] = incl - nb_occ;
  const Frozen fz{pos, starts, bases, unwrap, __shfl_sync(kFull, incl, 31),
                  P, plane, box_l};
  __syncwarp();

  const float lb0 = __fmaf_rn(static_cast<float>(2 * b0 + o0), w, -half_l);
  const float lb1 = __fmaf_rn(static_cast<float>(2 * b1 + o1), w, -half_l);
  const float lb2 = __fmaf_rn(static_cast<float>(2 * b2 + o2), w, -half_l);
  const float hi0 = __fadd_rn(lb0, w);
  const float hi1 = __fadd_rn(lb1, w);
  const float hi2 = __fadd_rn(lb2, w);

  // Stage the frozen slots within reach of the own cell, in raw order;
  // from the first raw round that would overflow `cap`, they stay in
  // device memory.
  int staged = 0;
  int ovf_round = (fz.total + 31) >> 5;
  {
    const float lo0 = __fsub_rn(lb0, pad), up0 = __fadd_rn(hi0, pad);
    const float lo1 = __fsub_rn(lb1, pad), up1 = __fadd_rn(hi1, pad);
    const float lo2 = __fsub_rn(lb2, pad), up2 = __fadd_rn(hi2, pad);
    const unsigned lt = (1u << lane) - 1u;
    const int rounds = ovf_round;
    // kPrefetch raw rounds are read before any is tested, so their
    // device-memory latencies overlap.
    for (int t0 = 0; t0 < rounds && ovf_round == rounds; t0 += kPrefetch) {
      float4 q[kPrefetch];
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int c = 32 * (t0 + u) + lane;
        q[u] = c < fz.total ? raw_slot(fz, c)
                            : make_float4(kFar, kFar, kFar, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const float d0 = axis_gap(q[u].x, lo0, up0);
        const float d1 = axis_gap(q[u].y, lo1, up1);
        const float d2 = axis_gap(q[u].z, lo2, up2);
        const bool keep =
            __fmaf_rn(d2, d2, __fmaf_rn(d1, d1, __fmul_rn(d0, d0))) <= reach2;
        const unsigned b = __ballot_sync(kFull, keep);
        if (ovf_round == rounds) {  // warp-uniform
          if (staged + __popc(b) > cap) {
            ovf_round = t0 + u;
          } else {
            if (keep) stage[staged + __popc(b & lt)] = q[u];
            staged += __popc(b);
          }
        }
      }
    }
    // Far slots up to a whole pair of rounds: the scans need no bound
    // check.
    const int padded = (staged + 63) & ~63;
    if (staged + lane < padded) {
      stage[staged + lane] = make_float4(kFar, kFar, kFar, 0.f);
    }
    if (staged + 32 + lane < padded) {
      stage[staged + 32 + lane] = make_float4(kFar, kFar, kFar, 0.f);
    }
    staged = padded;
    __syncwarp();
  }

  // Own slot `lane`.
  float* own = pos + color * cstride + lane * P + cell;
  float ox = 0.f, oy = 0.f, oz = 0.f;
  if (lane < my_occ) {
    ox = own[0];
    oy = own[plane];
    oz = own[2 * plane];
  }

  // Frozen-neighbor cache: lane j's entry is own slot j's energy against
  // every frozen slot.
  unsigned long long terms = 0;
  float ef = 0.f;
  if constexpr (M::kEnergy) {
    bool unused = false;
    for (int j = 0; j < my_occ; ++j) {
      const float xj = __shfl_sync(kFull, ox, j);
      const float yj = __shfl_sync(kFull, oy, j);
      const float zj = __shfl_sync(kFull, oz, j);
      const float sum = warp_sum(frozen_part<M, kScale>(
          xj, yj, zj, stage, staged, fz, ovf_round, scr, lane, pp, s2, &terms,
          &unused));
      if (lane == j) ef = sum;
    }
  }

  const float occ_f = static_cast<float>(my_occ);
  const float neg_beta = -beta;
  float org0 = 0.f, org1 = 0.f, org2 = 0.f;
  if constexpr (kField) {
    org0 = __ldg(fa.origin);
    org1 = __ldg(fa.origin + 1);
    org2 = __ldg(fa.origin + 2);
  }
  const unsigned own_terms = 2u * static_cast<unsigned>(my_occ - 1);

  float de_sum = 0.f;
  int accepted = 0;
  for (int m0 = 0; m0 < n_moves; m0 += 32) {
    // Lane l fetches (Philox form: generates) the random numbers of move
    // m0 + l.
    const int ml = m0 + lane;
    float r_pick = 0.f, r_dx = 0.f, r_dy = 0.f, r_dz = 0.f, r_acc = 0.f;
    if (ml < n_moves) {
      if constexpr (kPhilox) {
        float dd[3];
        mcjax_philox::move_draws<3, true>(
            ph, static_cast<uint32_t>(color * P + cell), sub, ml, &r_pick,
            &r_acc, dd);
        r_dx = dd[0];
        r_dy = dd[1];
        r_dz = dd[2];
      } else {
        const size_t mp = static_cast<size_t>(ml) * P + cell;
        const size_t md = static_cast<size_t>(ml) * 3 * P + cell;
        r_pick = pick_u[mp];
        r_dx = disp[md];
        r_dy = disp[md + P];
        r_dz = disp[md + 2 * static_cast<size_t>(P)];
        if constexpr (M::kEnergy || kField) r_acc = acc_u[mp];
      }
    }
    const int m_end = min(32, n_moves - m0);
    for (int mm = 0; mm < m_end; ++mm) {
      const float u = __shfl_sync(kFull, r_pick, mm);
      const float dx = __shfl_sync(kFull, r_dx, mm);
      const float dy = __shfl_sync(kFull, r_dy, mm);
      const float dz = __shfl_sync(kFull, r_dz, mm);
      const float ua = __shfl_sync(kFull, r_acc, mm);
      const int p = min(static_cast<int>(floorf(__fmul_rn(u, occ_f))),
                        my_occ - 1);
      const float old0 = __shfl_sync(kFull, ox, p);
      const float old1 = __shfl_sync(kFull, oy, p);
      const float old2 = __shfl_sync(kFull, oz, p);
      const float ef_old = __shfl_sync(kFull, ef, p);
      const float new0 = __fadd_rn(old0, dx);
      const float new1 = __fadd_rn(old1, dy);
      const float new2 = __fadd_rn(old2, dz);
      if (new0 < lb0 || new0 >= hi0 || new1 < lb1 || new1 >= hi1 ||
          new2 < lb2 || new2 >= hi2) {
        continue;  // leaves the cell: rejected, no pair work
      }
      float pn0 = 0.f, pn1 = 0.f, pn2 = 0.f;
      if constexpr (kField) {
        // The mover's physical position: forbidden is rejected, like a
        // move out of the cell, before any pair work (warp-uniform).
        pn0 = mcjax_field::wrap_axis(fa.fp, 0, new0, org0, half_l, box_l);
        pn1 = mcjax_field::wrap_axis(fa.fp, 1, new1, org1, half_l, box_l);
        pn2 = mcjax_field::wrap_axis(fa.fp, 2, new2, org2, half_l, box_l);
        if (mcjax_field::forbidden(fa.fp, pn0, pn1, pn2, 0)) continue;
      }
      bool ov = false;
      const float e_froz = frozen_part<M, kScale>(new0, new1, new2, stage,
                                                  staged, fz, ovf_round, scr,
                                                  lane, pp, s2, &terms, &ov);
      float e_own = 0.f;
      if (lane < my_occ && lane != p) {
        const float r2n = pair_r2<kScale>(s2, new0, new1, new2, ox, oy, oz);
        if constexpr (M::kHardCore) ov |= mcjax_pair::overlap<M>(r2n, pp);
        if constexpr (M::kEnergy) {
          e_own = __fsub_rn(
              mcjax_pair::energy<M>(r2n, pp),
              mcjax_pair::energy<M>(
                  pair_r2<kScale>(s2, old0, old1, old2, ox, oy, oz), pp));
        }
      }
      if constexpr (M::kHardCore) {
        if (__any_sync(kFull, ov)) continue;  // an overlap: rejected
      }
      if constexpr (!M::kEnergy) {  // hard spheres: no overlap is a move
        if (lane == p) {
          ox = new0;
          oy = new1;
          oz = new2;
        }
        ++accepted;
        continue;
      }
      terms += own_terms;
      // One butterfly for dE; the mover's new cache entry, the frozen part
      // alone, is summed only when the move is taken.
      float de = __fsub_rn(warp_sum(__fadd_rn(e_froz, e_own)), ef_old);
      if constexpr (kField) {
        if (fa.fp.energetic) {  // the one-body term, once a move
          const float po0 =
              mcjax_field::wrap_axis(fa.fp, 0, old0, org0, half_l, box_l);
          const float po1 =
              mcjax_field::wrap_axis(fa.fp, 1, old1, org1, half_l, box_l);
          const float po2 =
              mcjax_field::wrap_axis(fa.fp, 2, old2, org2, half_l, box_l);
          de = mcjax_field::delta_single<3>(fa.fp, de, pn0, pn1, pn2, po0, po1, po2);
        }
      }
      if (ua < expf(__fmul_rn(neg_beta, de))) {
        const float ef_new = warp_sum(e_froz);
        if (lane == p) {
          ox = new0;
          oy = new1;
          oz = new2;
          ef = ef_new;
        }
        de_sum = __fadd_rn(de_sum, de);
        ++accepted;
      }
    }
  }

  if (lane < my_occ) {
    own[0] = ox;
    own[plane] = oy;
    own[2 * plane] = oz;
  }
  if (lane == 0) {
    de_map[cell] = de_sum;
    acc_map[cell] = accepted;
    atomicAdd(&stats[1], terms);
    if (ovf_round < ((fz.total + 31) >> 5)) atomicAdd(&stats[0], 1ull);
  }
}

// One warp a cell, four cells a block. The NPT form reads s^2 from s2p.
template <class M, bool kScale, bool kField, bool kPhilox>
__global__ void __launch_bounds__(kWarps * 32, kTargetWarps / kWarps)
substep_3d_kernel(float* __restrict__ pos, const int* __restrict__ occ,
                  const int* __restrict__ perm, int sub,
                  const float* __restrict__ pick_u,
                  const float* __restrict__ disp,
                  const float* __restrict__ acc_u, float* __restrict__ de_map,
                  int* __restrict__ acc_map,
                  unsigned long long* __restrict__ stats, int B, int nmax,
                  int n_moves, int cap, float w, float half_l, float box_l,
                  float beta, Params pp, float pad, float reach2,
                  const float* __restrict__ s2p, mcjax_field::Args fa,
                  mcjax_philox::Args ph) {
  const int cell = blockIdx.x * kWarps + (threadIdx.x >> 5);
  float s2 = 1.f;
  if constexpr (kScale) {
    s2 = __ldg(s2p);
    reach2 = __fdiv_rn(reach2, s2);
  }
  if (cell < B * B * B) {
    cell_substep<M, kScale, kField, kPhilox>(
        cell, pos, occ, perm, sub, pick_u, disp, acc_u, de_map, acc_map,
        stats, B, nmax, n_moves, cap, w, half_l, box_l, beta, pp, pad, reach2,
        s2, fa, ph);
  }
}

// Launch shape for one nmax: the staged-slot capacity `cap` (a multiple of
// 64) and the dynamic shared memory of a block, sized so that the
// registers' limit on resident warps, at most kTargetWarps, is also met by
// the shared memory.
struct Shape {
  int cap = 0;
  int smem = 0;
  int warps_per_sm = 0;
  int regs = 0;
  int static_smem = 0;
  int local_bytes = 0;
};

template <class M, bool kScale, bool kField, bool kPhilox>
int shape_for(int nmax, Shape* out) {
  static Shape cache[33];
  static int cache_dev[33];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Shape& s = cache[nmax];
  if (s.cap > 0 && cache_dev[nmax] == dev) {
    *out = s;
    return 0;
  }
  cudaFuncAttributes fa;
  constexpr auto kernel = substep_3d_kernel<M, kScale, kField, kPhilox>;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int smem_sm = 0, reserved = 0, optin = 0, reg_blocks = 0;
  cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                         dev);
  cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                         dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &reg_blocks, kernel, kWarps * 32, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = max(1, min(reg_blocks, kTargetWarps / kWarps));
  const int per_block = min(smem_sm / blocks - reserved, optin) -
                        static_cast<int>(fa.sharedSizeBytes);
  const int per_warp_f4 = per_block / (16 * kWarps) - kExtraF4;
  const int need = (kNeighbors * nmax + 63) & ~63;  // never overflows
  s.cap = max(64, min(per_warp_f4 & ~63, need));
  s.smem = 16 * kWarps * (s.cap + kExtraF4);
  // Above 48 KB a block's dynamic shared memory must be allowed first;
  // allow all of it, so that every nmax's shape launches.
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(fa.sharedSizeBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, kernel, kWarps * 32, s.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  s.warps_per_sm = resident * kWarps;
  s.regs = fa.numRegs;
  s.static_smem = static_cast<int>(fa.sharedSizeBytes);
  s.local_bytes = static_cast<int>(fa.localSizeBytes);
  cache_dev[nmax] = dev;
  *out = s;
  return 0;
}

// out[0..5] of a shape entry: registers a thread, static shared memory,
// dynamic shared memory a block (bytes), local memory a thread (bytes),
// resident warps an SM, staged-slot capacity a warp.
void write_shape(const Shape& s, void* out) {
  int* o = static_cast<int*>(out);
  o[0] = s.regs;
  o[1] = s.static_smem;
  o[2] = s.smem;
  o[3] = s.local_bytes;
  o[4] = s.warps_per_sm;
  o[5] = s.cap;
}

template <class M, bool kScale, bool kField, bool kPhilox = false>
int launch(float* pos, const int* occ, const int* perm, int sub,
           const float* pick_u, const float* disp, const float* acc_u,
           float* de_map, int* acc_map, unsigned long long* stats, int B,
           int nmax, int n_moves, float w, float half_l, float box_l,
           float beta, const Params& pp, float pad, float reach2,
           const float* s2, const mcjax_field::Args& fa, cudaStream_t stream,
           const mcjax_philox::Args& ph = mcjax_philox::Args{}) {
  Shape s;
  const int err = shape_for<M, kScale, kField, kPhilox>(nmax, &s);
  if (err != 0) return err;
  const int cells = B * B * B;
  const int blocks = (cells + kWarps - 1) / kWarps;
  substep_3d_kernel<M, kScale, kField, kPhilox>
      <<<blocks, kWarps * 32, s.smem, stream>>>(
      pos, occ, perm, sub, pick_u, disp, acc_u, de_map, acc_map, stats, B,
      nmax, n_moves, s.cap, w, half_l, box_l, beta, pp, pad, reach2, s2, fa,
      ph);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
