// The field form of the 2D hard-disk sub-step kernel (substep.cu, whose
// header comment describes it; the kernel is in substep_2d.cuh): K4
// mcjax/ops/pallas_sweep.py::pallas_color_substep with `field` (:706) in
// the one-launch form of mcjax/ops/pallas_ring.py::ring_sweep_onecall.
// Plain version: mcjax_torch/ops/cuda_substep.py::color_substep with
// field= / origin=, once per sub-step. Its 16 instantiations are a
// translation unit, and a library, of their own, so that nvcc builds them
// beside substep.cu's 32.

#include "substep_2d.cuh"

// The field form's shape at this nmax for `cells` cells a color on the
// current device: out[0..6] as write_shape fills it.
extern "C" int mcjax_substep_2d_field_shape(int nmax, int cells, void* out) {
  Shape s;
  int err = static_cast<int>(cudaErrorInvalidValue);
  switch (nmax) {
#define MCJAX_CASE(N)                           \
  case N:                                       \
    err = shape_for<N, false, true>(&s);        \
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

// The field form of mcjax_substep_2d: its arguments, then the field
// (mcjax_field::Params in host memory), the device pointer to the frame
// origin (float32 [2]), n device pointers to the sub-steps' acceptance
// uniforms (host array; read when the field has energy), the per-cell dE
// maps de_map[n, H, W] (written when it has energy) and -beta.
extern "C" int mcjax_substep_2d_field(
    void* pos, void* occ, void* perm, int start, int n, void* const* pick_u,
    void* const* disp, void* counts, void* stats, int H, int W, int nmax,
    int n_moves, float w, float half_l, float box_l, float dia2, float pad,
    float reach2, const void* field, void* origin, void* const* acc_u,
    void* de_map, float neg_beta, void* stream) {
  if (n < 1 || n > kMaxSubsteps || start < 0 || start + n > kMaxSubsteps ||
      n_moves < 0 || field == nullptr || origin == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Draws d{};
  FieldDraws f{};
  f.fa.fp = *static_cast<const mcjax_field::Params*>(field);
  f.fa.origin = static_cast<const float*>(origin);
  f.de_map = static_cast<float*>(de_map);
  f.neg_beta = neg_beta;
  if (f.fa.fp.energetic && de_map == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int j = 0; j < n; ++j) {
    d.pick_u[j] = static_cast<const float*>(pick_u[j]);
    d.disp[j] = static_cast<const float*>(disp[j]);
    f.acc_u[j] = static_cast<const float*>(acc_u[j]);
    if (f.fa.fp.energetic && f.acc_u[j] == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const Geometry g{H, W, n_moves, w, half_l, box_l, dia2, pad, reach2};
  auto* p = static_cast<float*>(pos);
  auto* o = static_cast<const int*>(occ);
  auto* pm = static_cast<const int*>(perm);
  auto* c = static_cast<unsigned long long*>(counts);
  auto* st = static_cast<unsigned long long*>(stats);
  auto s = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaErrorInvalidValue);
  switch (nmax) {
#define MCJAX_CASE(N)                                                       \
  case N:                                                                   \
    err = launch<N, false, true>(p, o, pm, start, n, d, c, st, g, nullptr, f, \
                                 s);                                        \
    break;
    MCJAX_NMAX_CASES(MCJAX_CASE)
#undef MCJAX_CASE
    default:
      break;
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
