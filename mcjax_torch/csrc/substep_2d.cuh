// The 2D hard-disk sub-step kernel (see substep.cu for its design): the
// kernel template, its launch shape and its launch, for every form (NVT,
// NPT, field, Philox). substep.cu instantiates the NVT and NPT forms,
// substep_field.cu the field form and substep_philox.cu the Philox form,
// so that nvcc builds the three translation units side by side.

#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "field.cuh"
#include "philox.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;      // cells a block
constexpr int kBlocksPerSm = 8;    // launch bounds: at most 64 registers
// The field form's launch bounds: the 6 blocks its shared memory lets an
// SM hold (at nmax 7), so up to 80 registers at no loss of occupancy.
constexpr int kBlocksPerSmField = 6;
// The Philox form's: 7 blocks an SM (up to 72 registers, for the Philox
// state), which still hold the 800 blocks of 102,400 cells a color at once
// on 132 SMs; at 8 (64 registers) it spilled 72 bytes a thread.
constexpr int kBlocksPerSmPhilox = 7;
constexpr int kFrozenCap = 16;     // kept frozen slots staged a thread
constexpr int kAhead = 4;          // moves whose draws are in flight
constexpr int kMaxSubsteps = 4;    // the colors of a 2D sweep
constexpr int kNeighbors = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFar = 1.0e30f;    // a parked slot: r2 overflows to +inf

// The random inputs of each sub-step of a launch: separate tensors.
struct Draws {
  const float* pick_u[kMaxSubsteps];
  const float* disp[kMaxSubsteps];
};

// The field form's arguments: the field and its origin, each sub-step's
// acceptance uniforms (a field with energy) and the per-cell dE maps
// de_map[n, H, W] (written by a field with energy).
struct FieldDraws {
  mcjax_field::Args fa;
  const float* acc_u[kMaxSubsteps];
  float* de_map;
  float neg_beta;
};

// Floats a move in the draw ring: (pick_u, dx, dy), and acc_u in the
// field form; the Philox form has no ring.
template <bool kField, bool kPhilox>
constexpr int kRingFloats = kPhilox ? 0 : (kField ? 4 : 3);

// The field's verdict on a move (field form): false if new is forbidden
// or, for a field with energy, fails the Metropolis test with uniform ua;
// de is then the move's dE. The move loop passes the field as the kernel
// argument (constant memory, read in place), the overflow pass the
// block's copy in shared memory (a noinline function cannot take the
// argument's address without a copy in local memory).
__device__ __forceinline__ bool field_admits(const mcjax_field::Params& fp,
                                             float neg_beta, float org0,
                                             float org1, float half_l,
                                             float box_l, float old0,
                                             float old1, float new0,
                                             float new1, float ua,
                                             float* de) {
  const float pn0 = mcjax_field::wrap_axis(fp, 0, new0, org0, half_l, box_l);
  const float pn1 = mcjax_field::wrap_axis(fp, 1, new1, org1, half_l, box_l);
  if (mcjax_field::forbidden(fp, pn0, pn1, 0.f, 0)) return false;
  if (!fp.energetic) return true;
  const float po0 = mcjax_field::wrap_axis(fp, 0, old0, org0, half_l, box_l);
  const float po1 = mcjax_field::wrap_axis(fp, 1, old1, org1, half_l, box_l);
  *de = mcjax_field::delta_hard<2>(fp, pn0, pn1, 0.f, po0, po1, 0.f);
  return ua < expf(__fmul_rn(neg_beta, *de));
}

struct Geometry {
  int H, W, n_moves;
  float w, half_l, box_l, dia2;
  float pad, reach2;  // frozen-slot culling (cuda_substep.cull_constants)
};

// The cell a thread owns in one sub-step: block indices, color bits, the
// cell's bounds [lb, hi) and its culling box [lo, up].
struct Cell {
  int b0, b1, o0, o1;
  float lb0, lb1, hi0, hi1, lo0, lo1, up0, up1;
};

__device__ __forceinline__ int floor_half(int t) {  // floor(t / 2)
  return t >= 0 ? t / 2 : -((1 - t) / 2);
}

__device__ __forceinline__ float sq_dist(float a0, float a1, float b0,
                                         float b1) {
  const float e0 = __fsub_rn(a0, b0);
  const float e1 = __fsub_rn(a1, b1);
  return __fmaf_rn(e1, e1, __fmul_rn(e0, e0));
}

// The pair's squared distance as the overlap test sees it: s^2 r2 in the
// NPT form.
template <bool kScale>
__device__ __forceinline__ float pair_r2(float s2, float a0, float a1,
                                         float b0, float b1) {
  const float r2 = sq_dist(a0, a1, b0, b1);
  if constexpr (kScale) {
    return __fmul_rn(s2, r2);
  } else {
    return r2;
  }
}

__device__ __forceinline__ Cell make_cell(int cell, int color,
                                          const Geometry& g) {
  Cell c;
  c.b0 = cell / g.W;
  c.b1 = cell - c.b0 * g.W;
  c.o0 = color & 1;
  c.o1 = (color >> 1) & 1;
  c.lb0 = __fmaf_rn(static_cast<float>(2 * c.b0 + c.o0), g.w, -g.half_l);
  c.lb1 = __fmaf_rn(static_cast<float>(2 * c.b1 + c.o1), g.w, -g.half_l);
  c.hi0 = __fadd_rn(c.lb0, g.w);
  c.hi1 = __fadd_rn(c.lb1, g.w);
  c.lo0 = __fsub_rn(c.lb0, g.pad);
  c.lo1 = __fsub_rn(c.lb1, g.pad);
  c.up0 = __fadd_rn(c.hi0, g.pad);
  c.up1 = __fadd_rn(c.hi1, g.pad);
  return c;
}

// Squared box distance of a slot to the culling box, within the reach:
// the float32 twin is cuda_substep.keep_frozen.
__device__ __forceinline__ bool keep(const Cell& c, float x0, float x1,
                                     float reach2) {
  const float d0 = fmaxf(fmaxf(__fsub_rn(c.lo0, x0), __fsub_rn(x0, c.up0)),
                         0.f);
  const float d1 = fmaxf(fmaxf(__fsub_rn(c.lo1, x1), __fsub_rn(x1, c.up1)),
                         0.f);
  return __fmaf_rn(d1, d1, __fmul_rn(d0, d0)) <= reach2;
}

// Calls fn(k, x0, x1) for the k-th kept frozen slot of the cell, in a
// fixed order (neighbor, then slot); returns the number kept.
template <int NMAX, class Fn>
__device__ __forceinline__ int visit_frozen(const float* pos,
                                            const int* __restrict__ occ,
                                            const Cell& c, const Geometry& g,
                                            Fn&& fn) {
  const int P = g.H * g.W;
  const size_t plane = static_cast<size_t>(NMAX) * P;  // [nmax, H, W]
  int kept = 0;
#pragma unroll
  for (int k = 0; k < kNeighbors; ++k) {
    const int off = k < 4 ? k : k + 1;  // skip the center of the 3x3 block
    const int t0 = c.o0 + off / 3 - 1;
    const int t1 = c.o1 + off % 3 - 1;
    const int src = (t0 & 1) | ((t1 & 1) << 1);
    int n0 = c.b0 + floor_half(t0);
    int n1 = c.b1 + floor_half(t1);
    float add0 = 0.f, add1 = 0.f;
    if (n0 < 0) { n0 += g.H; add0 = -g.box_l; } else if (n0 >= g.H) { n0 -= g.H; add0 = g.box_l; }
    if (n1 < 0) { n1 += g.W; add1 = -g.box_l; } else if (n1 >= g.W) { n1 -= g.W; add1 = g.box_l; }
    const int nbr = n0 * g.W + n1;
    const int nocc = occ[src * P + nbr];
    const float* base = pos + src * 2 * plane + nbr;
    for (int s = 0; s < nocc; ++s) {
      float x0 = base[s * P];
      float x1 = base[plane + s * P];
      if (add0 != 0.f) x0 = __fadd_rn(x0, add0);
      if (add1 != 0.f) x1 = __fadd_rn(x1, add1);
      if (keep(c, x0, x1, g.reach2)) fn(kept++, x0, x1);
    }
  }
  return kept;
}

// A cell whose kept frozen slots overflow the staged capacity: its moves,
// with the frozen slots read again from device memory on every move (the
// overflow pass). Kept apart from the kernel's move loop, which stays
// lean in registers; the decisions are the same. The field form passes
// the block's copy of the field (fp, in shared memory) and its scalars;
// the other forms pass nullptr and zeros. The Philox form generates each
// move's draws from ph for cell gcell of sub-step `sub`.
template <int NMAX, bool kScale, bool kField, bool kPhilox>
__device__ __noinline__ unsigned overflow_moves(const float* pos,
                                                const int* __restrict__ occ,
                                                int cell, int color,
                                                int my_occ, float2* mine,
                                                const float* pick_u,
                                                const float* disp,
                                                Geometry g, float s2,
                                                const mcjax_field::Params* fp,
                                                float neg_beta,
                                                const float* acc_u,
                                                float org0, float org1,
                                                float* de_sum,
                                                mcjax_philox::Args ph,
                                                uint32_t gcell, int sub) {
  const Cell c = make_cell(cell, color, g);
  const int P = g.H * g.W;
  const float occ_f = static_cast<float>(my_occ);
  unsigned accepted = 0;
  for (int m = 0; m < g.n_moves; ++m) {
    const size_t at = static_cast<size_t>(m) * P + cell;
    float u, dx, dy;
    if constexpr (kPhilox) {
      float dd[2];
      mcjax_philox::move_draws<2, false>(ph, gcell, sub, m, &u, nullptr, dd);
      dx = dd[0];
      dy = dd[1];
    } else {
      u = __ldg(pick_u + at);
      dx = __ldg(disp + at + static_cast<size_t>(m) * P);
      dy = __ldg(disp + at + static_cast<size_t>(m + 1) * P);
    }
    const int p = min(static_cast<int>(floorf(__fmul_rn(u, occ_f))),
                      my_occ - 1);
    const float2 old = mine[p * kThreads];
    const float new0 = __fadd_rn(old.x, dx);
    const float new1 = __fadd_rn(old.y, dy);
    if (new0 < c.lb0 || new0 >= c.hi0 || new1 < c.lb1 || new1 >= c.hi1) {
      continue;
    }
    float de = 0.f;
    if constexpr (kField) {
      const float ua = fp->energetic ? __ldg(acc_u + at) : 0.f;
      if (!field_admits(*fp, neg_beta, org0, org1, g.half_l, g.box_l, old.x,
                        old.y, new0, new1, ua, &de)) {
        continue;
      }
    }
    bool overlap = false;
    for (int s = 0; s < my_occ; ++s) {
      const float2 o = mine[s * kThreads];
      overlap |= s != p && pair_r2<kScale>(s2, new0, new1, o.x, o.y) < g.dia2;
    }
    visit_frozen<NMAX>(pos, occ, c, g, [&](int, float x0, float x1) {
      overlap |= pair_r2<kScale>(s2, new0, new1, x0, x1) < g.dia2;
    });
    if (!overlap) {
      mine[p * kThreads] = make_float2(new0, new1);
      ++accepted;
      if constexpr (kField) *de_sum = __fadd_rn(*de_sum, de);
    }
  }
  return accepted;
}

// The NPT form reads s^2 from s2p; the field form reads its field, origin
// and acceptance uniforms from f; the Philox form generates its draws from
// ph and reads no draws (the other forms ignore what is not theirs).
template <int NMAX, bool kScale, bool kField, bool kPhilox>
__global__ void __launch_bounds__(
    kThreads, kField ? kBlocksPerSmField
                     : (kPhilox ? kBlocksPerSmPhilox : kBlocksPerSm))
substeps_kernel(float* pos, const int* __restrict__ occ,
                const int* __restrict__ perm, int start, int n, Draws draws,
                unsigned long long* __restrict__ counts,
                unsigned long long* __restrict__ stats, Geometry g,
                const float* __restrict__ s2p, FieldDraws f,
                mcjax_philox::Args ph) {
  // Slot s of a thread at slots[s * kThreads + threadIdx.x], NMAX +
  // kFrozenCap rows: the own slots, then the kept frozen slots; after them
  // the ring of draws, kAhead + 1 moves of (pick_u, dx, dy[, acc_u]) (none
  // in the Philox form); in the field form then the block's copy of the
  // field.
  constexpr int kRing = kRingFloats<kField, kPhilox>;
  extern __shared__ float2 slots[];
  __shared__ unsigned long long block_sum[2];
  const int tid = threadIdx.x;
  float2* mine = slots + tid;
  float* ring = reinterpret_cast<float*>(slots + (NMAX + kFrozenCap) *
                                                     kThreads) + tid;
  const int P = g.H * g.W;
  const size_t plane = static_cast<size_t>(NMAX) * P;
  float s2 = 1.f;
  if constexpr (kScale) {
    s2 = __ldg(s2p);
    g.reach2 = __fdiv_rn(g.reach2, s2);
  }
  float org0 = 0.f, org1 = 0.f;
  bool field_energy = false;
  mcjax_field::Params* fp = nullptr;
  if constexpr (kField) {
    org0 = __ldg(f.fa.origin);
    org1 = __ldg(f.fa.origin + 1);
    field_energy = f.fa.fp.energetic != 0;
    fp = reinterpret_cast<mcjax_field::Params*>(
        reinterpret_cast<float*>(slots + (NMAX + kFrozenCap) * kThreads) +
        kRing * (kAhead + 1) * kThreads);
    if (tid == 0) *fp = f.fa.fp;
  }
  if (tid == 0) block_sum[0] = block_sum[1] = 0;
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    if (j > 0) cg::this_grid().sync();  // sub-step j reads j - 1's slots
    const int color = perm[start + j];
    const float* pick_u = draws.pick_u[j];
    const float* disp = draws.disp[j];
    const float* acc_u = kField ? f.acc_u[j] : nullptr;
    unsigned accepted = 0, proposed = 0;
    for (int cell = blockIdx.x * kThreads + tid; cell < P;
         cell += gridDim.x * kThreads) {
      const int my_occ = occ[color * P + cell];
      float de_sum = 0.f;
      if (my_occ == 0 || g.n_moves == 0) {  // no move is taken
        if (field_energy) f.de_map[j * P + cell] = 0.f;
        continue;
      }
      proposed += g.n_moves;
      const int sub = start + j;
      const uint32_t gcell = static_cast<uint32_t>(color * P + cell);
      // The draws of the first kAhead moves go in flight first.
      const int last = g.n_moves - 1;
      const float* pu = pick_u + cell;
      const float* dp = disp + cell;
      const float* au = acc_u + cell;
      if constexpr (!kPhilox) {
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          const unsigned at = min(k, last) * P;
          __pipeline_memcpy_async(ring + kRing * k * kThreads, pu + at, 4);
          __pipeline_memcpy_async(ring + (kRing * k + 1) * kThreads,
                                  dp + 2 * at, 4);
          __pipeline_memcpy_async(ring + (kRing * k + 2) * kThreads,
                                  dp + 2 * at + P, 4);
          if (field_energy) {
            __pipeline_memcpy_async(ring + (kRing * k + 3) * kThreads,
                                    au + at, 4);
          }
          __pipeline_commit();
        }
      }
      float* own = pos + color * 2 * plane + cell;
      for (int s = 0; s < my_occ; ++s) {
        mine[s * kThreads] = make_float2(own[s * P], own[plane + s * P]);
      }
      // The kept frozen slots follow the own slots, so one loop tests both.
      const Cell c = make_cell(cell, color, g);
      float2* frozen = mine + my_occ * kThreads;
      const int kept = visit_frozen<NMAX>(
          pos, occ, c, g, [&](int k, float x0, float x1) {
            if (k < kFrozenCap) frozen[k * kThreads] = make_float2(x0, x1);
          });
      if (kept > kFrozenCap) {
        atomicAdd(&stats[0], 1ull);
        if constexpr (!kPhilox) __pipeline_wait_prior(0);
        accepted += overflow_moves<NMAX, kScale, kField, kPhilox>(
            pos, occ, cell, color, my_occ, mine, pick_u, disp, g, s2, fp,
            f.neg_beta, acc_u, org0, org1, &de_sum, ph, gcell, sub);
      } else {
        const float occ_f = static_cast<float>(my_occ);
        const int n_test = my_occ + kept;
        // Offsets of move m + kAhead's draws, and the ring slots of the
        // move read and the move refilled.
        unsigned next = min(kAhead, last) * P;
        int r_slot = 0, w_slot = kAhead;
        for (int m = 0; m < g.n_moves; ++m) {
          float u, dx, dy, ua = 0.f;
          if constexpr (kPhilox) {
            // The move's one Philox call (uniform proposals), in registers.
            float dd[2];
            mcjax_philox::move_draws<2, false>(ph, gcell, sub, m, &u,
                                               nullptr, dd);
            dx = dd[0];
            dy = dd[1];
          } else {
            // Move m's draws have arrived; move m + kAhead's go in flight
            // into the slot that move m - 1 read.
            __pipeline_wait_prior(kAhead - 1);
            const float* r = ring + kRing * r_slot * kThreads;
            u = r[0];
            dx = r[kThreads];
            dy = r[2 * kThreads];
            if constexpr (kField) ua = r[(kRing - 1) * kThreads];
            float* w = ring + kRing * w_slot * kThreads;
            __pipeline_memcpy_async(w, pu + next, 4);
            __pipeline_memcpy_async(w + kThreads, dp + 2 * next, 4);
            __pipeline_memcpy_async(w + 2 * kThreads, dp + 2 * next + P, 4);
            if (field_energy) {
              __pipeline_memcpy_async(w + 3 * kThreads, au + next, 4);
            }
            __pipeline_commit();
            if (m + kAhead < last) next += P;
            r_slot = r_slot == kAhead ? 0 : r_slot + 1;
            w_slot = w_slot == kAhead ? 0 : w_slot + 1;
          }
          const int p = min(static_cast<int>(floorf(__fmul_rn(u, occ_f))),
                            my_occ - 1);
          const float2 old = mine[p * kThreads];
          const float new0 = __fadd_rn(old.x, dx);
          const float new1 = __fadd_rn(old.y, dy);
          if (new0 < c.lb0 || new0 >= c.hi0 || new1 < c.lb1 ||
              new1 >= c.hi1) {
            continue;  // rejected whatever it overlaps
          }
          float de = 0.f;
          if constexpr (kField) {
            if (!field_admits(f.fa.fp, f.neg_beta, org0, org1, g.half_l,
                              g.box_l, old.x, old.y, new0, new1, ua, &de)) {
              continue;  // forbidden, or fails the Metropolis test
            }
          }
          // The mover's own slot is parked far away while the others are
          // tested (its squared distance overflows to +inf), so the loop
          // needs no test of s != p.
          mine[p * kThreads] = make_float2(kFar, kFar);
          bool overlap = false;
#pragma unroll 4
          for (int s = 0; s < n_test; ++s) {
            const float2 o = mine[s * kThreads];
            overlap |= pair_r2<kScale>(s2, new0, new1, o.x, o.y) < g.dia2;
          }
          if (!overlap) {
            mine[p * kThreads] = make_float2(new0, new1);
            ++accepted;
            if constexpr (kField) de_sum = __fadd_rn(de_sum, de);
          } else {
            mine[p * kThreads] = old;
          }
        }
      }
      if constexpr (!kPhilox) {
        __pipeline_wait_prior(0);  // the ring is free for the next cell
      }
      for (int s = 0; s < my_occ; ++s) {
        const float2 o = mine[s * kThreads];
        own[s * P] = o.x;
        own[plane + s * P] = o.y;
      }
      if (field_energy) f.de_map[j * P + cell] = de_sum;
    }
    // Counts: per warp, per block, then one 64-bit atomic a block.
    accepted = __reduce_add_sync(kFull, accepted);
    proposed = __reduce_add_sync(kFull, proposed);
    if ((tid & 31) == 0) {
      atomicAdd(&block_sum[0], static_cast<unsigned long long>(accepted));
      atomicAdd(&block_sum[1], static_cast<unsigned long long>(proposed));
    }
    __syncthreads();
    if (tid == 0) {
      atomicAdd(&counts[2 * j], block_sum[0]);
      atomicAdd(&counts[2 * j + 1], block_sum[1]);
      block_sum[0] = block_sum[1] = 0;
    }
  }
}

// Launch shape for one nmax on the current device.
struct Shape {
  int smem = 0;          // dynamic shared memory a block
  int blocks_per_sm = 0;
  int sms = 0;
  int regs = 0;
  int static_smem = 0;
  int local_bytes = 0;
};

template <int NMAX, bool kScale, bool kField, bool kPhilox = false>
int shape_for(Shape* out) {
  static Shape cache;
  static int cache_dev = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cache_dev == dev) {
    *out = cache;
    return 0;
  }
  Shape s;
  s.smem = ((NMAX + kFrozenCap) * 2 +
            kRingFloats<kField, kPhilox> * (kAhead + 1)) *
               kThreads * static_cast<int>(sizeof(float)) +
           (kField ? static_cast<int>(sizeof(mcjax_field::Params)) : 0);
  err = cudaFuncSetAttribute(substeps_kernel<NMAX, kScale, kField, kPhilox>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa,
                              substeps_kernel<NMAX, kScale, kField, kPhilox>);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &s.blocks_per_sm, substeps_kernel<NMAX, kScale, kField, kPhilox>,
      kThreads, s.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  s.regs = fa.numRegs;
  s.static_smem = static_cast<int>(fa.sharedSizeBytes);
  s.local_bytes = static_cast<int>(fa.localSizeBytes);
  cache = s;
  cache_dev = dev;
  *out = s;
  return 0;
}

// The cooperative grid: every block co-resident, at most one thread a cell.
int grid_blocks(const Shape& s, int cells) {
  return min(s.blocks_per_sm * s.sms, (cells + kThreads - 1) / kThreads);
}

template <int NMAX, bool kScale, bool kField, bool kPhilox = false>
int launch(float* pos, const int* occ, const int* perm, int start, int n,
           const Draws& draws, unsigned long long* counts,
           unsigned long long* stats, const Geometry& g, const float* s2,
           const FieldDraws& field, cudaStream_t stream,
           const mcjax_philox::Args& philox = mcjax_philox::Args{}) {
  Shape s;
  const int err = shape_for<NMAX, kScale, kField, kPhilox>(&s);
  if (err != 0) return err;
  const int blocks = grid_blocks(s, g.H * g.W);
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Draws d = draws;
  Geometry geo = g;
  FieldDraws f = field;
  mcjax_philox::Args ph = philox;
  void* args[] = {&pos,   &occ,  &perm, &start, &n,  &d,
                  &counts, &stats, &geo, &s2,    &f,  &ph};
  // A launch the runtime refuses returns its error; nothing falls back.
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(
          substeps_kernel<NMAX, kScale, kField, kPhilox>),
      dim3(blocks),
      dim3(kThreads), args, static_cast<size_t>(s.smem), stream));
}

// out[0..6] of a shape entry (mcjax_substep_2d_shape,
// mcjax_substep_2d_field_shape, mcjax_substep_2d_philox_shape):
// registers a thread, static and dynamic shared memory a block (bytes),
// local memory a thread (bytes), resident warps an SM, frozen slots staged
// a thread, and the blocks of the cooperative grid for `cells` cells a
// color.
void write_shape(const Shape& s, int cells, void* out) {
  int* o = static_cast<int*>(out);
  o[0] = s.regs;
  o[1] = s.static_smem;
  o[2] = s.smem;
  o[3] = s.local_bytes;
  o[4] = s.blocks_per_sm * kThreads / 32;
  o[5] = kFrozenCap;
  o[6] = grid_blocks(s, cells);
}

#define MCJAX_NMAX_CASES(X)                                               \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13)    \
  X(14) X(15) X(16)

}  // namespace
