// Random grid shift of the checkerboard cell slabs (2D and 3D).
//
// Replaces the TPU kernels mcjax/ops/pallas_ring.py::ring_shift (2D, the
// ring layout) and mcjax/ops/pallas_shift.py::pallas_shift_rebin (2D and 3D,
// the packed layout): both compute mcjax/ops/cells.py::shift_rebin. Plain
// version: mcjax_torch/ops/cells.py::shift_rebin.
//
// Every coordinate on the shift axis moves x -> wrap(x - d) (every plane goes
// through the wrap, as in the JAX package); since |d| <= w/2 a particle stays
// in its cell or moves one cell opposite the shift, so each destination
// cell's new slab is its own slab merged with one donor neighbor's slab. A
// coordinate that stays in its cell is never carried across the periodic
// seam (seam_guard below); otherwise this is the JAX package's arithmetic.
//
// Layout (the JAX package's color-blocked slab, B cells per side of a color
// block, P = B^DIM cells per color, 2^DIM colors):
//   pos[color, DIM, nmax, B, ..., B] f32, occ[color, B, ..., B] i32.
//
// Design. One thread per destination cell over all colors. The axis and d
// are read from device memory, so the host never waits. Candidates are
// visited in the JAX package's order (own slots, then donor slots); the
// receiver claims a donor candidate whose cell index equals its own, the
// owner keeps every candidate the receiver does not claim, and kept
// candidates are compacted in order into the first nmax slots. Unused slots
// are written as 0, as the JAX package's merge leaves them. The cell index
// is floor((x + L/2) * f32(1/w)): a reciprocal multiply, never a division.
// Results go to second buffers; a cell that keeps more than nmax candidates
// raises the overflow flag.
//
// Bound. Each slot is read once and written once: device-memory bandwidth
// bounds the kernel (2 x 23 MB for 2D disks at N = 1,048,576, nmax 7;
// 2 x 21 MB for 3D LJ at N = 1,000,000, nmax 24).

#include <cuda_runtime.h>

namespace {

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

template <int DIM>
__global__ void __launch_bounds__(128)
shift_kernel(const float* __restrict__ pos, const int* __restrict__ occ,
             float* __restrict__ pos_out, int* __restrict__ occ_out,
             int* __restrict__ overflow, const int* __restrict__ axis_p,
             const float* __restrict__ d_p, int B, int nmax, int cps,
             float box_l, float half_l, float inv_w) {
  constexpr int kColors = 1 << DIM;
  int P = 1;
#pragma unroll
  for (int k = 0; k < DIM; ++k) P *= B;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= kColors * P) return;
  const int color = gid / P;
  const int cell = gid - color * P;
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
  const size_t cstride = DIM * plane;
  const float* own = pos + color * cstride + cell;
  const float* don = pos + src * cstride + don_cell;
  const int own_n = occ[gid];
  const int don_n = occ[src * P + don_cell];
  float* out = pos_out + color * cstride + cell;

  int count = 0;
  for (int j = 0; j < 2 * nmax; ++j) {
    const bool is_own = j < nmax;
    const int slot = is_own ? j : j - nmax;
    if (slot >= (is_own ? own_n : don_n)) continue;
    const float* c = is_own ? own : don;
    float x[DIM], wr[DIM];
    float xa = 0.f;
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      x[k] = c[k * plane + slot * P];
      wr[k] = wrap_into_box(k == axis ? __fsub_rn(x[k], d) : x[k], half_l,
                            box_l);
      if (k == axis) xa = wr[k];
    }
    int ck = static_cast<int>(floorf(__fmul_rn(__fadd_rn(xa, half_l), inv_w)));
    ck = min(max(ck, 0), cps - 1);
    const bool keep = is_own ? ck != recv_k : ck == my_k;
    if (keep) {
      if (count < nmax) {
        // A donor slot's shift-axis coordinate really crosses cells; every
        // other coordinate stays in its cell and is seam-guarded.
#pragma unroll
        for (int k = 0; k < DIM; ++k) {
          const bool moves = !is_own && k == axis;
          out[k * plane + count * P] =
              moves ? wr[k] : seam_guard(wr[k], x[k], half_l, box_l);
        }
      }
      ++count;
    }
  }
  for (int slot = count; slot < nmax; ++slot) {
#pragma unroll
    for (int k = 0; k < DIM; ++k) out[k * plane + slot * P] = 0.f;
  }
  occ_out[gid] = min(count, nmax);
  if (count > nmax) atomicOr(overflow, 1);
}

}  // namespace

extern "C" int mcjax_shift(void* pos, void* occ, void* pos_out, void* occ_out,
                           void* overflow, void* axis, void* d, int dim,
                           int B, int nmax, int cps, float box_l,
                           float half_l, float inv_w, void* stream) {
  const int threads = 128;
  int cells = 1;
  for (int k = 0; k < dim; ++k) cells *= 2 * B;  // all colors
  const int blocks = (cells + threads - 1) / threads;
  auto s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<const float*>(pos);
  auto* o = static_cast<const int*>(occ);
  auto* po = static_cast<float*>(pos_out);
  auto* oo = static_cast<int*>(occ_out);
  auto* ov = static_cast<int*>(overflow);
  auto* ax = static_cast<const int*>(axis);
  auto* dd = static_cast<const float*>(d);
  if (dim == 2) {
    shift_kernel<2><<<blocks, threads, 0, s>>>(p, o, po, oo, ov, ax, dd, B,
                                               nmax, cps, box_l, half_l,
                                               inv_w);
  } else if (dim == 3) {
    shift_kernel<3><<<blocks, threads, 0, s>>>(p, o, po, oo, ov, ax, dd, B,
                                               nmax, cps, box_l, half_l,
                                               inv_w);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
