// The Philox form of the 2D hard-disk sub-step kernel (substep.cu, whose
// header comment describes it; the kernel is in substep_2d.cuh): mcjax's
// in-kernel PRNG form of mcjax/ops/pallas_ring.py::ring_sweep_onecall (K1,
// :518) and of the 2D ring_color_substep (K3, :126), body mcjax/ops/
// pallas_sweep.py::_make_kernel(in_kernel_rng=True) (:226-350). Plain
// version: mcjax_torch/ops/cuda_substep.py::color_substep fed
// PhiloxRandoms.substep's draws, once per sub-step.
//
// The thread that owns a cell makes each move's one Philox4x32-10 call in
// registers (philox.cuh): pick, dx, dy from the counter (move, global cell
// id, sweep, sub-step), so the kernel reads no draws at all; the draw ring
// and its shared memory are gone, and the rest of the kernel is the NVT
// form's. Its 16 instantiations (the NVT form's nmax values) are a
// translation unit, and a library, of their own, so that nvcc builds them
// beside substep.cu's.
//
// The library also holds mcjax_philox_words, the stream's words for given
// counters, which holds philox.cuh against the plain version.

#include "substep_2d.cuh"

namespace {

__global__ void philox_words_kernel(const uint32_t* __restrict__ ctr,
                                    uint32_t k0, uint32_t k1, long long n,
                                    uint32_t* __restrict__ out) {
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < n; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint4 w = mcjax_philox::philox4x32_10(
        make_uint4(ctr[t], ctr[n + t], ctr[2 * n + t], ctr[3 * n + t]), k0,
        k1);
    out[t] = w.x;
    out[n + t] = w.y;
    out[2 * n + t] = w.z;
    out[3 * n + t] = w.w;
  }
}

}  // namespace

// The Philox form's shape at this nmax for `cells` cells a color on the
// current device: out[0..6] as write_shape fills it.
extern "C" int mcjax_substep_2d_philox_shape(int nmax, int cells, void* out) {
  Shape s;
  int err = static_cast<int>(cudaErrorInvalidValue);
  switch (nmax) {
#define MCJAX_CASE(N)                              \
  case N:                                          \
    err = shape_for<N, false, false, true>(&s);    \
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

// Sub-steps [start, start + n) of a sweep in one cooperative launch, with
// the draws generated in the kernel from `philox` (mcjax_philox::Args in
// host memory). counts (int64 [n, 2]) must be zeroed by the caller.
extern "C" int mcjax_substep_2d_philox(void* pos, void* occ, void* perm,
                                       int start, int n, void* counts,
                                       void* stats, int H, int W, int nmax,
                                       int n_moves, float w, float half_l,
                                       float box_l, float dia2, float pad,
                                       float reach2, const void* philox,
                                       void* stream) {
  if (n < 1 || n > kMaxSubsteps || start < 0 || start + n > kMaxSubsteps ||
      n_moves < 0 || philox == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto& ph = *static_cast<const mcjax_philox::Args*>(philox);
  if (ph.calls < 1 || (ph.ih_k != 0 && (ph.ih_k < 2 || ph.ih_k > 64))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{H, W, n_moves, w, half_l, box_l, dia2, pad, reach2};
  auto* p = static_cast<float*>(pos);
  auto* o = static_cast<const int*>(occ);
  auto* pm = static_cast<const int*>(perm);
  auto* c = static_cast<unsigned long long*>(counts);
  auto* st = static_cast<unsigned long long*>(stats);
  auto s = static_cast<cudaStream_t>(stream);
  const Draws d{};
  const FieldDraws f{};
  int err = static_cast<int>(cudaErrorInvalidValue);
  switch (nmax) {
#define MCJAX_CASE(N)                                                       \
  case N:                                                                   \
    err = launch<N, false, false, true>(p, o, pm, start, n, d, c, st, g,    \
                                        nullptr, f, s, ph);                 \
    break;
    MCJAX_NMAX_CASES(MCJAX_CASE)
#undef MCJAX_CASE
    default:
      break;
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// The stream's words: out[4, n] (uint32) = philox4x32_10 of the counters
// ctr[4, n] (uint32) under the key (k0, k1).
extern "C" int mcjax_philox_words(void* ctr, unsigned k0, unsigned k1,
                                  long long n, void* out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long blocks = (n + 255) / 256;
  philox_words_kernel<<<static_cast<unsigned>(blocks < 65535 ? blocks
                                                             : 65535),
                        256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ctr), k0, k1, n,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
