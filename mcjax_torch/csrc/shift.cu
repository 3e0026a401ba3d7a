// Random grid shift of the checkerboard cell slabs (2D and 3D).
//
// Replaces the TPU kernels mcjax/ops/pallas_ring.py::ring_shift (2D, the
// ring layout) and mcjax/ops/pallas_shift.py::pallas_shift_rebin (2D and 3D,
// the packed layout): both compute mcjax/ops/cells.py::shift_rebin. Plain
// version: mcjax_torch/ops/cells.py::shift_rebin.
//
// Every coordinate on the shift axis moves x -> wrap(x - d) (every coordinate
// plane goes through the wrap, as in the JAX package; attribute planes after
// the DIM coordinate planes, such as a mixture's species id, move with their
// slot untouched, as in ring_shift); since |d| <= w/2 a particle stays
// in its cell or moves one cell opposite the shift, so each destination
// cell's new slab is its own slab merged with one donor neighbor's slab. A
// coordinate that stays in its cell is never carried across the periodic
// seam (seam_guard below); otherwise this is the JAX package's arithmetic.
//
// Layout (the JAX package's color-blocked slab, B cells per side of a color
// block, P = B^DIM cells per color, 2^DIM colors, NP planes: the DIM
// coordinates, then NP - DIM = 0 or 1 attribute planes):
//   pos[color, NP, nmax, B, ..., B] f32, occ[color, B, ..., B] i32.
//
// Design. One block per tile of kTile consecutive destination cells of one
// color, one thread per cell. The axis and d are read from device memory,
// so the host never waits. A thread first reads its own and its donor
// cell's occupancies, then stages both slabs' live slots, every plane, in
// shared memory with asynchronous copies (cp.async), all in flight before
// any is used; one (plane, slot) row of the tile is kTile contiguous floats
// in device memory and in shared memory. It then merges from shared memory
// in the JAX package's order (own slots, then donor slots): the receiver
// claims a donor candidate whose cell index equals its own, the owner keeps
// every candidate the receiver does not claim, and kept candidates are
// compacted in order into the first nmax rows, in place (a kept candidate
// never lands after the row it came from). Last, the rows go out
// coalesced, every row of the output tile, with unused slots written as 0,
// as the JAX package's merge leaves them. The cell index is
// floor((x + L/2) * f32(1/w)): a reciprocal multiply, never a division.
// Results go to second buffers; a cell that keeps more than nmax
// candidates raises the overflow flag.
//
// Bound. Each slot is read once and written once: device-memory bandwidth
// bounds the kernel (2D disks at N = 1,048,576, nmax 7: 8.4 MB of live
// slots read, 23 MB written; 3D LJ at N = 1,000,000, nmax 24: 12 MB and
// 21 MB; the Kob-Andersen mixture at N = 1,000,000, nmax 34, 4 planes: 16
// MB and 25 MB). The kernel takes 2.6-4 times its bound: a thread's walk
// over its cell's candidates, at the few warps an SM that the staged slabs
// leave room for.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;  // destination cells a block

__device__ __forceinline__ int floor_half(int t) {  // floor(t / 2)
  return t >= 0 ? t / 2 : -((1 - t) / 2);
}

__device__ __forceinline__ int pmod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// jnp.mod(x + L/2, L) - L/2: fmod, then add L to a nonzero negative remainder.
__device__ __forceinline__ float wrap_into_box(float x, float half_l,
                                              float box_l) {
  float r = fmodf(__fadd_rn(x, half_l), box_l);
  if (r != 0.f && r < 0.f) r = __fadd_rn(r, box_l);
  return __fsub_rn(r, half_l);
}

// Seam guard, the port's one departure from the JAX package: a slot at (or
// an ulp past) +L/2 wraps to -L/2, the far side of the box, while it stays
// in its cell, and neighbor reads then unwrap it the wrong way. A
// coordinate that stays in its cell is never carried across the seam: a
// jump of more than L/2 from the old value x is undone by adding back +-L.
__device__ __forceinline__ float seam_guard(float wrapped, float x,
                                           float half_l, float box_l) {
  if (fabsf(__fsub_rn(wrapped, x)) <= half_l) return wrapped;
  return __fadd_rn(wrapped, x > 0.f ? box_l : -box_l);
}

// Stage rows [k * nmax + s] (s < n) of a cell's slab, every plane, into
// the thread's column of a shared tile: asynchronous 4-byte copies.
template <int NP>
__device__ __forceinline__ void stage(float* col, const float* src, int n,
                                      int nmax, size_t plane, int P) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    for (int s = 0; s < n; ++s) {
      __pipeline_memcpy_async(col + (k * nmax + s) * kTile,
                              src + k * plane + static_cast<size_t>(s) * P,
                              sizeof(float));
    }
  }
}

// The plane count is a template parameter: a runtime count leaves the plane
// loops rolled, which slowed the single-species shifts.
template <int DIM, int NP>
__global__ void __launch_bounds__(kTile)
shift_kernel(const float* __restrict__ pos, const int* __restrict__ occ,
             float* __restrict__ pos_out, int* __restrict__ occ_out,
             int* __restrict__ overflow, const int* __restrict__ axis_p,
             const float* __restrict__ d_p, int B, int nmax, int cps,
             int tiles, float box_l, float half_l, float inv_w) {
  // Own tile [NP][nmax][kTile], then donor tile [NP][nmax][kTile].
  extern __shared__ float tiles_smem[];
  int P = 1;
#pragma unroll
  for (int k = 0; k < DIM; ++k) P *= B;
  const int color = blockIdx.x / tiles;
  const int cell = (blockIdx.x - color * tiles) * kTile + threadIdx.x;
  if (cell >= P) return;  // the kernel has no block barrier
  const int gid = color * P + cell;
  const int axis = *axis_p;
  const float d = *d_p;
  // Block index and row-major stride of this cell along the shift axis
  // (the last axis is contiguous).
  int ba = 0, sa = 1;
  {
    int rest = cell;
    int stride = 1;
#pragma unroll
    for (int k = DIM - 1; k >= 0; --k) {
      const int q = k > 0 ? rest / B : 0;
      if (k == axis) {
        ba = rest - q * B;
        sa = stride;
      }
      rest = q;
      stride *= B;
    }
  }
  const int donor_dir = d > 0.f ? 1 : -1;
  const int o_a = (color >> axis) & 1;
  const int src = color ^ (1 << axis);
  const int db = pmod(ba + floor_half(o_a + donor_dir), B);
  const int don_cell = cell + (db - ba) * sa;
  const int my_k = 2 * ba + o_a;
  const int recv_k = pmod(my_k - donor_dir, cps);

  const size_t plane = static_cast<size_t>(nmax) * P;
  const size_t cstride = NP * plane;
  const int own_n = occ[gid];
  const int don_n = occ[src * P + don_cell];
  float* own_t = tiles_smem + threadIdx.x;  // row r at own_t[r * kTile]
  float* don_t = own_t + NP * nmax * kTile;
  stage<NP>(own_t, pos + color * cstride + cell, own_n, nmax, plane, P);
  stage<NP>(don_t, pos + src * cstride + don_cell, don_n, nmax, plane, P);
  __pipeline_commit();
  __pipeline_wait_prior(0);

  // Merge, in place in the own tile: row `count` is never past the row
  // the candidate came from.
  int count = 0;
  for (int j = 0; j < own_n + don_n; ++j) {
    const bool is_own = j < own_n;
    const float* c = is_own ? own_t + j * kTile : don_t + (j - own_n) * kTile;
    float x[DIM], wr[DIM];
    float xa = 0.f;
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      x[k] = c[k * nmax * kTile];
      wr[k] = wrap_into_box(k == axis ? __fsub_rn(x[k], d) : x[k], half_l,
                            box_l);
      if (k == axis) xa = wr[k];
    }
    int ck = static_cast<int>(floorf(__fmul_rn(__fadd_rn(xa, half_l), inv_w)));
    ck = min(max(ck, 0), cps - 1);
    const bool keep = is_own ? ck != recv_k : ck == my_k;
    if (keep) {
      if (count < nmax) {
        float* out = own_t + count * kTile;
        // A donor slot's shift-axis coordinate really crosses cells; every
        // other coordinate stays in its cell and is seam-guarded.
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          const bool moves = !is_own && k == axis;
          out[k * nmax * kTile] =
              moves ? wr[k] : seam_guard(wr[k], x[k], half_l, box_l);
        }
#pragma unroll
        for (int k = DIM; k < NP; ++k) {
          out[k * nmax * kTile] = c[k * nmax * kTile];
        }
      }
      ++count;
    }
  }

  // The output tile, row by row: a warp writes kTile contiguous floats.
  const int kept = min(count, nmax);
  float* out = pos_out + color * cstride + cell;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    for (int s = 0; s < nmax; ++s) {
      out[k * plane + static_cast<size_t>(s) * P] =
          s < kept ? own_t[(k * nmax + s) * kTile] : 0.f;
    }
  }
  occ_out[gid] = kept;
  if (count > nmax) atomicOr(overflow, 1);
}

template <int DIM, int NP>
int launch(const float* pos, const int* occ, float* pos_out, int* occ_out,
           int* overflow, const int* axis, const float* d, int B, int nmax,
           int cps, float box_l, float half_l, float inv_w,
           cudaStream_t stream) {
  static int smem_allowed = 0;  // dynamic shared memory allowed so far
  const int smem = 2 * NP * nmax * kTile * static_cast<int>(sizeof(float));
  if (smem > smem_allowed) {
    // Above 48 KB a block's dynamic shared memory must be allowed first.
    cudaError_t err = cudaFuncSetAttribute(
        shift_kernel<DIM, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        shift_kernel<DIM, NP>, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  int P = 1;
  for (int k = 0; k < DIM; ++k) P *= B;
  const int tiles = (P + kTile - 1) / kTile;
  shift_kernel<DIM, NP><<<(1 << DIM) * tiles, kTile, smem, stream>>>(
      pos, occ, pos_out, occ_out, overflow, axis, d, B, nmax, cps, tiles,
      box_l, half_l, inv_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_planes: dim coordinate planes, or dim + 1 with an attribute plane.
extern "C" int mcjax_shift(void* pos, void* occ, void* pos_out, void* occ_out,
                           void* overflow, void* axis, void* d, int dim,
                           int B, int nmax, int n_planes, int cps,
                           float box_l, float half_l, float inv_w,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<const float*>(pos);
  auto* o = static_cast<const int*>(occ);
  auto* po = static_cast<float*>(pos_out);
  auto* oo = static_cast<int*>(occ_out);
  auto* ov = static_cast<int*>(overflow);
  auto* ax = static_cast<const int*>(axis);
  auto* dd = static_cast<const float*>(d);
  const int extra = n_planes - dim;
  if (dim == 2 && extra == 0) {
    return launch<2, 2>(p, o, po, oo, ov, ax, dd, B, nmax, cps, box_l,
                        half_l, inv_w, s);
  } else if (dim == 2 && extra == 1) {
    return launch<2, 3>(p, o, po, oo, ov, ax, dd, B, nmax, cps, box_l,
                        half_l, inv_w, s);
  } else if (dim == 3 && extra == 0) {
    return launch<3, 3>(p, o, po, oo, ov, ax, dd, B, nmax, cps, box_l,
                        half_l, inv_w, s);
  } else if (dim == 3 && extra == 1) {
    return launch<3, 4>(p, o, po, oo, ov, ax, dd, B, nmax, cps, box_l,
                        half_l, inv_w, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
