// Color sub-steps of the checkerboard hard-disk Metropolis sweep (2D).
//
// Replaces the TPU kernel mcjax/ops/pallas_ring.py::ring_sweep_onecall
// (body: mcjax/ops/pallas_sweep.py::_make_kernel) in its 2D, hard-core,
// host-random form, and with a range of one sub-step the 2D form of
// mcjax/ops/pallas_ring.py::ring_color_substep. One launch runs sub-steps
// [start, start + n) of a sweep, as ring_sweep_onecall runs all of them in
// one call; sub-step j works on color perm[j]. Plain version:
// mcjax_torch/ops/cuda_substep.py::color_substep, once per sub-step.
//
// Layout (the JAX package's color-blocked slab, P = H*W cells per color):
//   pos[color, 2, nmax, H, W] f32, occ[color, H, W] i32; for sub-step j
//   pick_u[n_moves, H, W] f32 and disp[n_moves, 2, H, W] f32 (separate
//   tensors, their pointers passed by value); counts[n, 2] i64, added to:
//   accepted and proposed moves of each sub-step; stats[0] i64, added to:
//   cells that took the overflow pass.
//
// Design. A persistent grid, co-resident by a cooperative launch (sized
// from the occupancy of this kernel and the SM count, at most one thread a
// cell); threads take the cells of the active color by a grid-stride loop,
// and a grid barrier separates consecutive sub-steps, since sub-step j + 1
// reads the slots sub-step j wrote. After that barrier pos is read through
// the coherent path only (no __ldg, no const __restrict__ on pos).
// One thread owns one cell. It reads its frozen neighbor slots once, pre-
// unwrapped across the periodic box by +-L as neighbor_stack does, and
// keeps only the ones whose box distance to its cell is within the
// diameter, grown as cuda_substep.cull_constants grows a cutoff: a dropped
// slot fails r2 < dia2 from every position a mover can take without being
// rejected as out of its cell, so the decisions, and the bits, are those
// of testing every slot. Own slots and the kept frozen slots sit in shared
// memory as float2, one list (own, then frozen), slot-major so that a
// warp's reads are conflict free, up to kFrozenCap frozen slots a thread.
// At phi 0.5 a cell keeps about 7 frozen slots, so a move tests about 9
// slots where testing all of them takes 63 (nmax 7); the mover's own slot
// is parked far away during its test, so one loop with no branch tests the
// list. A cell whose kept slots exceed the capacity runs its moves apart,
// reading its frozen slots from device memory on every move (the overflow
// pass, counted in stats[0]), which keeps the main loop lean in registers.
// The draws of the next kAhead moves are in flight in a ring in shared
// memory (cp.async), where they take no registers. Accepted and proposed
// counts are reduced per warp and per block and added to counts[j] with
// 64-bit atomics.
//
// Bound. The random inputs are 12 bytes per cell per move: 78.6 MB per
// sub-step at N = 1,048,576 and n_moves = 64, against 17 MB of state read
// and written once, so device-memory bandwidth bounds the work (about 0.1
// ms a sweep's launch). The kernel takes about 3.8 times that: the move
// loop's issue rate and shared-memory loads, at the 24 warps an SM that
// 102,400 cells give, set its pace. Drawing the numbers inside the kernel
// (a counter-based Philox) removes the draws' bytes; that is later work.
//
// Floating point. Built with --fmad=false; the only fused multiply-adds are
// the two XLA on the CPU forms (the squared distance and the cell lower
// bound), written out with __fmaf_rn, so results match the JAX package bit
// for bit. Pick, proposal, out-of-cell and overlap tests are the plain
// version's operations in its order.
//
// NPT form (kScale, a template parameter; the NVT kernel is compiled
// without it, as mcjax's static use_scale compiles it out): s^2 = f32(s *
// s) of the box scale, read from device memory once per thread, multiplies
// every squared distance (__fmul_rn(s2, r2)) before the overlap test, as
// the plain version and mcjax do; the stored-frame culling reach is the
// host's reach2 / s^2 (__fdiv_rn), which ops/cuda_substep.py shows stays
// exact.
//
// Field form (kField, a template parameter beside kScale, never with it:
// mcjax has no NPT run under a field). An external one-body field
// (field.cuh), the 2D hard-core form of mcjax/ops/pallas_sweep.py::
// pallas_color_substep with `field` (K4, mcjax/ops/pallas_sweep.py:706),
// evaluated at physical x = wrap(stored + origin) with the origin read
// from device memory. After the in-cell test, and before the overlap loop
// since both only reject, a move into the field's forbidden region is
// rejected. A field with energy turns the hard-core kernel energetic, as
// mcjax/ops/pallas_sweep.py:140-145 does: an acceptance uniform per move
// joins the draws in the ring (four floats a move), dE = E(new) - E(old)
// and the move must pass acc_u < expf(-beta dE) before its overlap test;
// each cell's summed dE of accepted moves goes to de_map[j] of its
// sub-step. A walls-only field reads no acceptance uniform and stays bit
// for bit with the plain version. The field form is instantiated in
// substep_field.cu, a library of its own, so that nvcc builds it beside
// this file; the kernel itself is in substep_2d.cuh.


#include "substep_2d.cuh"

// The kernel's shape at this nmax for `cells` cells a color on the current
// device, of its NVT (form 0) or NPT (1) form: out[0..6] as write_shape
// fills it.
extern "C" int mcjax_substep_2d_shape(int nmax, int cells, int form,
                                      void* out) {
  Shape s;
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (form != 0 && form != 1) return err;
  switch (nmax) {
#define MCJAX_CASE(N)                                                    \
  case N:                                                                \
    err = form == 1 ? shape_for<N, true, false>(&s)                      \
                    : shape_for<N, false, false>(&s);                    \
    break;
    MCJAX_NMAX_CASES(MCJAX_CASE)
#undef MCJAX_CASE
    default:
      break;
  }
  if (err != 0) return err;
  write_shape(s, cells, out);
  return 0;
}

// Sub-steps [start, start + n) of a sweep in one cooperative launch.
// pick_u and disp point to n device pointers each (host arrays); counts
// (int64 [n, 2]) must be zeroed by the caller. A null s2 selects the NVT
// form; otherwise the NPT form reads s^2 there.
extern "C" int mcjax_substep_2d(void* pos, void* occ, void* perm, int start,
                                int n, void* const* pick_u,
                                void* const* disp, void* counts, void* stats,
                                int H, int W, int nmax, int n_moves, float w,
                                float half_l, float box_l, float dia2,
                                float pad, float reach2, void* s2,
                                void* stream) {
  if (n < 1 || n > kMaxSubsteps || start < 0 || start + n > kMaxSubsteps ||
      n_moves < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Draws d{};
  for (int j = 0; j < n; ++j) {
    d.pick_u[j] = static_cast<const float*>(pick_u[j]);
    d.disp[j] = static_cast<const float*>(disp[j]);
  }
  const Geometry g{H, W, n_moves, w, half_l, box_l, dia2, pad, reach2};
  auto* p = static_cast<float*>(pos);
  auto* o = static_cast<const int*>(occ);
  auto* pm = static_cast<const int*>(perm);
  auto* c = static_cast<unsigned long long*>(counts);
  auto* st = static_cast<unsigned long long*>(stats);
  auto* sq = static_cast<const float*>(s2);
  auto s = static_cast<cudaStream_t>(stream);
  const FieldDraws f{};
  int err = static_cast<int>(cudaErrorInvalidValue);
  switch (nmax) {
#define MCJAX_CASE(N)                                                        \
  case N:                                                                    \
    err = sq ? launch<N, true, false>(p, o, pm, start, n, d, c, st, g, sq, f, \
                                      s)                                     \
             : launch<N, false, false>(p, o, pm, start, n, d, c, st, g, sq,  \
                                       f, s);                                \
    break;
    MCJAX_NMAX_CASES(MCJAX_CASE)
#undef MCJAX_CASE
    default:
      break;
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
