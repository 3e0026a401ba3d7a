// Random grid shift of the checkerboard cell slabs (2D).
//
// Replaces the TPU kernel mcjax/ops/pallas_ring.py::ring_shift. Plain
// version: mcjax_torch/ops/cells.py::shift_rebin.
//
// Every coordinate on the shift axis moves x -> wrap(x - d) (every plane goes
// through the wrap, as in the JAX package); since |d| <= w/2 a particle stays
// in its cell or moves one cell opposite the shift, so each destination
// cell's new slab is its own slab merged with one donor neighbor's slab. A
// coordinate that stays in its cell is never carried across the periodic
// seam (seam_guard below); otherwise this is the JAX package's arithmetic.
//
// Design. One thread per destination cell over all four colors. The axis and
// d are read from device memory, so the host never waits. Candidates are
// visited in the JAX package's order (own slots, then donor slots); the
// receiver claims a donor candidate whose cell index equals its own, the
// owner keeps every candidate the receiver does not claim, and kept
// candidates are compacted in order into the first nmax slots. Unused slots
// are written as 0, as the JAX package's merge leaves them. The cell index
// is floor((x + L/2) * f32(1/w)): a reciprocal multiply, never a division.
// Results go to second buffers; a cell that keeps more than nmax candidates
// raises the overflow flag.
//
// Bound. Each slot is read once and written once: 2 x 23 MB at
// N = 1,048,576, nmax = 7, so device-memory bandwidth bounds the kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kDim = 2;
constexpr int kColors = 4;

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

__global__ void __launch_bounds__(128)
shift_kernel(const float* __restrict__ pos, const int* __restrict__ occ,
             float* __restrict__ pos_out, int* __restrict__ occ_out,
             int* __restrict__ overflow, const int* __restrict__ axis_p,
             const float* __restrict__ d_p, int H, int W, int nmax, int cps,
             float box_l, float half_l, float inv_w) {
  const int P = H * W;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= kColors * P) return;
  const int color = gid / P;
  const int cell = gid - color * P;
  const int b0 = cell / W;
  const int b1 = cell - b0 * W;
  const int axis = *axis_p;
  const float d = *d_p;
  const int donor_dir = d > 0.f ? 1 : -1;
  const int o_a = (color >> axis) & 1;
  const int src = color ^ (1 << axis);
  const int s = floor_half(o_a + donor_dir);
  const int d0 = axis == 0 ? pmod(b0 + s, H) : b0;
  const int d1 = axis == 1 ? pmod(b1 + s, W) : b1;
  const int my_k = 2 * (axis == 0 ? b0 : b1) + o_a;
  const int recv_k = pmod(my_k - donor_dir, cps);

  const size_t plane = static_cast<size_t>(nmax) * P;
  const size_t cstride = kDim * plane;
  const float* own = pos + color * cstride + cell;
  const float* don = pos + src * cstride + d0 * W + d1;
  const int own_n = occ[gid];
  const int don_n = occ[src * P + d0 * W + d1];
  float* out = pos_out + color * cstride + cell;

  int count = 0;
  for (int j = 0; j < 2 * nmax; ++j) {
    const bool is_own = j < nmax;
    const int slot = is_own ? j : j - nmax;
    if (slot >= (is_own ? own_n : don_n)) continue;
    const float* c = is_own ? own : don;
    const float x0 = c[slot * P];
    const float x1 = c[plane + slot * P];
    const float w0 = wrap_into_box(axis == 0 ? __fsub_rn(x0, d) : x0, half_l,
                                   box_l);
    const float w1 = wrap_into_box(axis == 1 ? __fsub_rn(x1, d) : x1, half_l,
                                   box_l);
    const float xa = axis == 0 ? w0 : w1;
    int ck = static_cast<int>(floorf(__fmul_rn(__fadd_rn(xa, half_l), inv_w)));
    ck = min(max(ck, 0), cps - 1);
    const bool keep = is_own ? ck != recv_k : ck == my_k;
    if (keep) {
      // A donor slot's shift-axis coordinate really crosses cells; every
      // other coordinate stays in its cell and is seam-guarded.
      const bool moves0 = !is_own && axis == 0;
      const bool moves1 = !is_own && axis == 1;
      if (count < nmax) {
        out[count * P] = moves0 ? w0 : seam_guard(w0, x0, half_l, box_l);
        out[plane + count * P] =
            moves1 ? w1 : seam_guard(w1, x1, half_l, box_l);
      }
      ++count;
    }
  }
  for (int slot = count; slot < nmax; ++slot) {
    out[slot * P] = 0.f;
    out[plane + slot * P] = 0.f;
  }
  occ_out[gid] = min(count, nmax);
  if (count > nmax) atomicOr(overflow, 1);
}

}  // namespace

extern "C" int mcjax_shift_2d(void* pos, void* occ, void* pos_out,
                              void* occ_out, void* overflow, void* axis,
                              void* d, int H, int W, int nmax, int cps,
                              float box_l, float half_l, float inv_w,
                              void* stream) {
  const int threads = 128;
  const int blocks = (kColors * H * W + threads - 1) / threads;
  shift_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const int*>(occ),
      static_cast<float*>(pos_out), static_cast<int*>(occ_out),
      static_cast<int*>(overflow), static_cast<const int*>(axis),
      static_cast<const float*>(d), H, W, nmax, cps, box_l, half_l, inv_w);
  return static_cast<int>(cudaGetLastError());
}
