// One color sub-step of the checkerboard Metropolis sweep (3D) for the
// single-species pair models other than Lennard-Jones: hard spheres,
// square wells, WCA, soft spheres, Yukawa, Morse and polynomials in 1/r^2
// (mcjax_torch/models/potentials.py; the functors of pair.cuh).
//
// Replaces, in their host-random NVT form, the same TPU kernels as
// substep_lj.cu for these models: mcjax/ops/pallas_sweep.py::_fused_core
// (K5, with the frozen-neighbor energy cache), mcjax/ops/pallas_sweep.py::
// pallas_color_substep (K4) and the 3D form of mcjax/ops/pallas_ring.py::
// ring_color_substep (K3), all built on the body mcjax/ops/pallas_sweep.py::
// _make_kernel. The kernel is substep_3d.cuh's, substep_lj.cu's design
// templated on the pair functor: one warp a cell, culled frozen slots
// staged in shared memory, the frozen-neighbor cache and the compaction of
// the pairs within the cutoff for the energetic models, and an __any_sync
// overlap test for the hard-core ones (a model without energy builds no
// cache and reads no acceptance uniform). One launch does one color.
// Plain version: mcjax_torch/ops/cuda_substep.py::color_substep.
//
// Bound. As substep_lj.cu: the FP32 issue rate of the pair tests and full
// terms (hard spheres: the r2 tests alone, so the bytes of the state and
// the draws come closer).
//
// Floating point. Built with --fmad=false; the fused multiply-adds are the
// ones XLA on the CPU forms (the squared distance, the cell bound, WCA's
// and the polynomial's, pair.cuh). Square-well energies are integer
// multiples of eps, so every sum is exact whatever its order, and the
// kernel equals its plain version bit for bit; for the smooth models dE is
// summed in another order than the plain version, so a decision can flip
// only at a near tie.
//
// The NPT, field and Philox forms of these models are later work: the
// wrapper raises for them, and only the NVT form is instantiated here.

#include "substep_3d.cuh"

namespace {

template <class M>
int launch_pair(const Params& pp, float* pos, const int* occ, const int* perm,
                int sub, const float* pick_u, const float* disp,
                const float* acc_u, float* de_map, int* acc_map,
                unsigned long long* stats, int B, int nmax, int n_moves,
                float w, float half_l, float box_l, float beta, float pad,
                float reach2, cudaStream_t stream) {
  if (M::kEnergy && acc_u == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<M, false, false>(pos, occ, perm, sub, pick_u, disp, acc_u,
                                 de_map, acc_map, stats, B, nmax, n_moves, w,
                                 half_l, box_l, beta, pp, pad, reach2, nullptr,
                                 mcjax_field::Args{}, stream);
}

// Calls fn(M{}) with the functor M of the model id; returns
// cudaErrorInvalidValue for one this library does not hold.
template <class Fn>
int dispatch(int model, Fn&& fn) {
  switch (model) {
    case mcjax_pair::kHardSphere:
      return fn(mcjax_pair::HardSphere{});
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

// The kernel's shape for `model` (mcjax_pair::ModelId) at this nmax on the
// current device: out[0..5] as write_shape fills it.
extern "C" int mcjax_substep_pair3d_shape(int model, int nmax, void* out) {
  if (nmax < 1 || nmax > 32) return static_cast<int>(cudaErrorInvalidValue);
  Shape s;
  const int err = dispatch(model, [&](auto m) {
    return shape_for<decltype(m), false, false, false>(nmax, &s);
  });
  if (err != 0) return err;
  write_shape(s, out);
  return 0;
}

// One color sub-step: substep_lj.cu's mcjax_substep_lj3d without s2, the
// model's constants in `params` (mcjax_pair::Params in host memory, copied
// into the launch). acc_u may be null for a model without energy.
extern "C" int mcjax_substep_pair3d(void* pos, void* occ, void* perm, int sub,
                                    void* pick_u, void* disp, void* acc_u,
                                    void* de_map, void* acc_map, void* stats,
                                    int B, int nmax, int n_moves, float w,
                                    float half_l, float box_l, float beta,
                                    float pad, float reach2,
                                    const void* params, void* stream) {
  if (nmax < 1 || nmax > 32 || n_moves < 0 || params == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params pp = *static_cast<const Params*>(params);
  if (pp.model == mcjax_pair::kPolynomial &&
      (pp.n < 1 || pp.n > mcjax_pair::kMaxCoeffs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(pp.model, [&](auto m) {
    return launch_pair<decltype(m)>(
        pp, static_cast<float*>(pos), static_cast<const int*>(occ),
        static_cast<const int*>(perm), sub, static_cast<const float*>(pick_u),
        static_cast<const float*>(disp), static_cast<const float*>(acc_u),
        static_cast<float*>(de_map), static_cast<int*>(acc_map),
        static_cast<unsigned long long*>(stats), B, nmax, n_moves, w, half_l,
        box_l, beta, pad, reach2, static_cast<cudaStream_t>(stream));
  });
}
