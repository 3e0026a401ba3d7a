// The energetic pair form of the 2D one-launch sub-step kernel: square
// wells, Lennard-Jones, WCA, soft spheres, Yukawa, Morse and polynomials
// in 1/r^2 (the functors of pair.cuh) in 2D, host-random NVT.
//
// Replaces mcjax/ops/pallas_ring.py::ring_sweep_onecall (K1) for
// energetic single-species models, and with a range of one sub-step the 2D
// energetic form of mcjax/ops/pallas_ring.py::ring_color_substep (K3); both
// are built on mcjax/ops/pallas_sweep.py::_make_kernel. One cooperative
// launch runs sub-steps [start, start + n) of a sweep, with a grid barrier
// between them, as substep.cu does for hard disks. Plain version:
// mcjax_torch/ops/cuda_substep.py::color_substep, once per sub-step.
//
// Design. The kernel of substep_2d.cuh (one thread a cell, its own and
// culled frozen slots in shared memory, the draws in flight in a ring)
// with its pair form: the frozen slots kept are those within the model's
// reach, up to kFrozenCapPair a thread (the rest of a cell's moves take the
// overflow pass); the acceptance uniform rides the ring; each move sums
// the mover's pair energy at the new and the old position over the own
// and kept frozen slots (the mover parked far away), rejects an overlap
// with a hard core and accepts when acc_u < expf(-beta dE). The capacity
// is a launch argument, so one instantiation a model covers nmax <= 16.
//
// Bound. The random inputs, 16 bytes a cell and move (78.6 MB of pick,
// displacement and acceptance draws at 409,600 cells a color and 64
// moves, with the state read and written once), against the pair work:
// 2 (occ - 1 + kept) pair tests a move, full terms only within the cutoff.
//
// Floating point. Built with --fmad=false; the fused multiply-adds are the
// XLA ones (squared distance, cell bound, pair.cuh's). Square-well
// energies are integer multiples of eps, so every sum is exact in any
// order and the form equals its plain version bit for bit; for the smooth
// models dE is summed in another order, so a decision can flip only at a
// near tie.
//
// The NPT, field and Philox forms of these models are later work: the
// wrapper raises for them.

#include "substep_2d.cuh"

namespace {

// Calls fn(M{}) with the functor M of the model id; returns
// cudaErrorInvalidValue for one this library does not hold (2D hard disks
// are substep.cu's).
template <class Fn>
int dispatch(int model, Fn&& fn) {
  switch (model) {
    case mcjax_pair::kLennardJones:
      return fn(mcjax_pair::LennardJones{});
    case mcjax_pair::kSquareWell:
      return fn(mcjax_pair::SquareWell{});
    case mcjax_pair::kWCA:
      return fn(mcjax_pair::WCA{});
    case mcjax_pair::kSoftSphere:
      return fn(mcjax_pair::SoftSphere{});
    case mcjax_pair::kYukawa:
      return fn(mcjax_pair::Yukawa{});
    case mcjax_pair::kMorse:
      return fn(mcjax_pair::Morse{});
    case mcjax_pair::kPolynomial:
      return fn(mcjax_pair::Polynomial{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The pair form's shape for `model` (mcjax_pair::ModelId) at this nmax for
// `cells` cells a color on the current device: out[0..6] as write_shape
// fills it (its staged-slot entry is kFrozenCap's; the pair form stages
// kFrozenCapPair).
extern "C" int mcjax_substep_pair2d_shape(int model, int nmax, int cells,
                                          void* out) {
  Shape s;
  const int err = dispatch(model, [&](auto m) {
    return shape_for<0, false, false, false, decltype(m)>(&s, nmax);
  });
  if (err != 0) return err;
  write_shape(s, cells, out);
  static_cast<int*>(out)[5] = kFrozenCapPair;
  return 0;
}

// Sub-steps [start, start + n) of a sweep in one cooperative launch, as
// substep.cu's mcjax_substep_2d: pick_u, disp and acc_u point to n device
// pointers each (host arrays); counts (int64 [n, 2]) must be zeroed by the
// caller; de_map[n, H, W] receives each cell's summed dE of accepted
// moves; `params` is the model (mcjax_pair::Params in host memory, copied
// into the launch).
extern "C" int mcjax_substep_pair2d(
    void* pos, void* occ, void* perm, int start, int n, void* const* pick_u,
    void* const* disp, void* const* acc_u, void* counts, void* stats,
    void* de_map, int H, int W, int nmax, int n_moves, float w, float half_l,
    float box_l, float pad, float reach2, float neg_beta, const void* params,
    void* stream) {
  if (n < 1 || n > kMaxSubsteps || start < 0 || start + n > kMaxSubsteps ||
      n_moves < 0 || nmax < 1 || nmax > kMaxNmax || params == nullptr ||
      de_map == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PairArgs pa{*static_cast<const mcjax_pair::Params*>(params), nmax};
  if (pa.pp.model == mcjax_pair::kPolynomial &&
      (pa.pp.n < 1 || pa.pp.n > mcjax_pair::kMaxCoeffs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Draws d{};
  FieldDraws f{};
  f.de_map = static_cast<float*>(de_map);
  f.neg_beta = neg_beta;
  for (int j = 0; j < n; ++j) {
    d.pick_u[j] = static_cast<const float*>(pick_u[j]);
    d.disp[j] = static_cast<const float*>(disp[j]);
    f.acc_u[j] = static_cast<const float*>(acc_u[j]);
    if (f.acc_u[j] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  // The disk diameter of Geometry is unused: the model carries its core.
  const Geometry g{H, W, n_moves, w, half_l, box_l, 0.f, pad, reach2};
  const int err = dispatch(pa.pp.model, [&](auto m) {
    return launch<0, false, false, false, decltype(m)>(
        static_cast<float*>(pos), static_cast<const int*>(occ),
        static_cast<const int*>(perm), start, n, d,
        static_cast<unsigned long long*>(counts),
        static_cast<unsigned long long*>(stats), g, nullptr, f,
        static_cast<cudaStream_t>(stream), mcjax_philox::Args{}, pa);
  });
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
