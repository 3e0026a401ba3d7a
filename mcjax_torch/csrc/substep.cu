// One color sub-step of the checkerboard hard-disk Metropolis sweep (2D).
//
// Replaces the move chain of the TPU kernel
// mcjax/ops/pallas_ring.py::ring_sweep_onecall (body:
// mcjax/ops/pallas_sweep.py::_make_kernel) in its 2D, hard-core, host-random
// form; one launch does one color, so a sweep is four launches. Plain
// version: mcjax_torch/ops/cuda_substep.py::color_substep.
//
// Layout (the JAX package's color-blocked slab, P = H*W cells per color):
//   pos[color, 2, nmax, H, W] f32, occ[color, H, W] i32,
//   pick_u[n_moves, H, W] f32, disp[n_moves, 2, H, W] f32.
//
// Design. One thread owns one cell of the active color (read from perm[sub]
// in device memory, so the host never waits). Its own slots and the 8
// frozen neighbor cells (nmax slots each, pre-unwrapped across the periodic
// box by +-L as neighbor_stack does) sit in registers for all n_moves
// moves; empty neighbor slots hold a far-away sentinel, whose squared
// distance overflows to +inf and never counts as an overlap. Random inputs
// are read at [m, cell], so neighboring threads load neighboring addresses.
//
// Bound. The random tensors are 12 bytes per cell per move: 78.6 MB per
// sub-step at N = 1,048,576 and n_moves = 64, against 23 MB of state, so
// device-memory bandwidth bounds the kernel. Drawing the numbers inside the
// kernel (a counter-based Philox) removes those bytes; that is later work.
//
// Floating point. Built with --fmad=false; the only fused multiply-adds are
// the two XLA on the CPU forms (the squared distance and the cell lower
// bound), written out with __fmaf_rn, so results match the JAX package bit
// for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kDim = 2;
constexpr int kNeighbors = 8;
constexpr float kFar = 1.0e30f;

__device__ __forceinline__ int floor_half(int t) {  // floor(t / 2)
  return t >= 0 ? t / 2 : -((1 - t) / 2);
}

__device__ __forceinline__ float sq_dist(float a0, float a1, float b0,
                                         float b1) {
  const float e0 = __fsub_rn(a0, b0);
  const float e1 = __fsub_rn(a1, b1);
  return __fmaf_rn(e1, e1, __fmul_rn(e0, e0));
}

template <int NMAX>
__global__ void __launch_bounds__(128)
substep_kernel(float* __restrict__ pos, const int* __restrict__ occ,
               const int* __restrict__ perm, int sub,
               const float* __restrict__ pick_u,
               const float* __restrict__ disp, int* __restrict__ acc_map,
               int H, int W, int n_moves, float w, float half_l,
               float box_l, float dia2) {
  const int P = H * W;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= P) return;
  const int b0 = cell / W;
  const int b1 = cell - b0 * W;
  const int color = perm[sub];
  const int o0 = color & 1;
  const int o1 = (color >> 1) & 1;
  const size_t plane = static_cast<size_t>(NMAX) * P;  // [nmax, H, W]
  const size_t cstride = kDim * plane;                  // [2, nmax, H, W]

  // Frozen neighbor slots, in registers.
  float nx[kNeighbors][NMAX];
  float ny[kNeighbors][NMAX];
#pragma unroll
  for (int k = 0; k < kNeighbors; ++k) {
    const int off = k < 4 ? k : k + 1;  // skip the center of the 3x3 block
    const int t0 = o0 + off / 3 - 1;
    const int t1 = o1 + off % 3 - 1;
    const int src = (t0 & 1) | ((t1 & 1) << 1);
    int n0 = b0 + floor_half(t0);
    int n1 = b1 + floor_half(t1);
    float add0 = 0.f, add1 = 0.f;
    if (n0 < 0) { n0 += H; add0 = -box_l; } else if (n0 >= H) { n0 -= H; add0 = box_l; }
    if (n1 < 0) { n1 += W; add1 = -box_l; } else if (n1 >= W) { n1 -= W; add1 = box_l; }
    const int nocc = occ[src * P + n0 * W + n1];
    const float* base = pos + src * cstride + n0 * W + n1;
#pragma unroll
    for (int s = 0; s < NMAX; ++s) {
      float x0 = kFar, x1 = kFar;
      if (s < nocc) {
        x0 = base[s * P];
        x1 = base[plane + s * P];
        if (add0 != 0.f) x0 = __fadd_rn(x0, add0);
        if (add1 != 0.f) x1 = __fadd_rn(x1, add1);
      }
      nx[k][s] = x0;
      ny[k][s] = x1;
    }
  }

  // Own cell.
  const int my_occ = occ[color * P + cell];
  float* own = pos + color * cstride + cell;
  float ox[NMAX], oy[NMAX];
#pragma unroll
  for (int s = 0; s < NMAX; ++s) {
    ox[s] = own[s * P];
    oy[s] = own[plane + s * P];
  }
  const float lb0 = __fmaf_rn(static_cast<float>(2 * b0 + o0), w, -half_l);
  const float lb1 = __fmaf_rn(static_cast<float>(2 * b1 + o1), w, -half_l);
  const float hi0 = __fadd_rn(lb0, w);
  const float hi1 = __fadd_rn(lb1, w);
  const float occ_f = static_cast<float>(my_occ);
  const int p_max = my_occ > 0 ? my_occ - 1 : 0;

  int accepted = 0;
  for (int m = 0; m < n_moves; ++m) {
    const float u = pick_u[static_cast<size_t>(m) * P + cell];
    const float dx = disp[(static_cast<size_t>(m) * kDim) * P + cell];
    const float dy = disp[(static_cast<size_t>(m) * kDim + 1) * P + cell];
    const int p = min(static_cast<int>(floorf(__fmul_rn(u, occ_f))), p_max);
    float old0 = 0.f, old1 = 0.f;
#pragma unroll
    for (int s = 0; s < NMAX; ++s) {
      if (s == p) { old0 = ox[s]; old1 = oy[s]; }
    }
    const float new0 = __fadd_rn(old0, dx);
    const float new1 = __fadd_rn(old1, dy);
    const bool oob = new0 < lb0 || new0 >= hi0 || new1 < lb1 || new1 >= hi1;
    bool overlap = false;
#pragma unroll
    for (int s = 0; s < NMAX; ++s) {
      if (s < my_occ && s != p) {
        overlap |= sq_dist(new0, new1, ox[s], oy[s]) < dia2;
      }
    }
#pragma unroll
    for (int k = 0; k < kNeighbors; ++k) {
#pragma unroll
      for (int s = 0; s < NMAX; ++s) {
        overlap |= sq_dist(new0, new1, nx[k][s], ny[k][s]) < dia2;
      }
    }
    if (my_occ > 0 && !oob && !overlap) {
#pragma unroll
      for (int s = 0; s < NMAX; ++s) {
        if (s == p) { ox[s] = new0; oy[s] = new1; }
      }
      ++accepted;
    }
  }

#pragma unroll
  for (int s = 0; s < NMAX; ++s) {
    own[s * P] = ox[s];
    own[plane + s * P] = oy[s];
  }
  acc_map[cell] = accepted;
}

template <int NMAX>
void launch(float* pos, const int* occ, const int* perm, int sub,
            const float* pick_u, const float* disp, int* acc_map, int H,
            int W, int n_moves, float w, float half_l, float box_l,
            float dia2, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (H * W + threads - 1) / threads;
  substep_kernel<NMAX><<<blocks, threads, 0, stream>>>(
      pos, occ, perm, sub, pick_u, disp, acc_map, H, W, n_moves, w, half_l,
      box_l, dia2);
}

}  // namespace

extern "C" int mcjax_substep_2d(void* pos, void* occ, void* perm, int sub,
                                void* pick_u, void* disp, void* acc_map,
                                int H, int W, int nmax, int n_moves, float w,
                                float half_l, float box_l, float dia2,
                                void* stream) {
  auto* p = static_cast<float*>(pos);
  auto* o = static_cast<const int*>(occ);
  auto* pm = static_cast<const int*>(perm);
  auto* pu = static_cast<const float*>(pick_u);
  auto* dp = static_cast<const float*>(disp);
  auto* am = static_cast<int*>(acc_map);
  auto s = static_cast<cudaStream_t>(stream);
  switch (nmax) {
#define MCJAX_CASE(N) \
  case N: launch<N>(p, o, pm, sub, pu, dp, am, H, W, n_moves, w, half_l, box_l, dia2, s); break;
    MCJAX_CASE(1) MCJAX_CASE(2) MCJAX_CASE(3) MCJAX_CASE(4)
    MCJAX_CASE(5) MCJAX_CASE(6) MCJAX_CASE(7) MCJAX_CASE(8)
    MCJAX_CASE(9) MCJAX_CASE(10) MCJAX_CASE(11) MCJAX_CASE(12)
    MCJAX_CASE(13) MCJAX_CASE(14) MCJAX_CASE(15) MCJAX_CASE(16)
#undef MCJAX_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
