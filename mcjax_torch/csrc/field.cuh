// External one-body fields in the sub-step kernels' field forms.
//
// The device twin of mcjax_torch/models/fields.py (the JAX package's
// mcjax/models/fields.py, evaluated in its TPU kernels at
// mcjax/ops/pallas_sweep.py:395-416 and added to dE at :574-580). A field is
// a flat composition of at most kMaxTerms terms, passed by value: harmonic
// traps, linear fields (gravity) and slit walls, each on its axis, the
// energetic ones optionally scaled per species (a SpeciesField around
// them). It is evaluated at physical x = wrap(stored + origin), with the
// frame origin read from device memory, so it moves on the device with no
// host sync.
//
// Rounding. Energies are the plain version's float32 operations in its
// order, with a fused multiply-add exactly where XLA on the CPU makes one
// (tests/test_torch_sweep.py::test_contraction_sites_match_xla): a product
// that a sum may still absorb travels as an Ex and is rounded only when
// used elsewhere (ex_add / ex_sub pick the operand XLA folds, as
// fields.py's add_terms / sub_terms do). Wall bounds arrive rounded on the
// host exactly as the plain version rounds them, one float32 pair a
// species. The wrap is fmodf with the sign fix-up of jnp.mod.

#pragma once

#include <cuda_runtime.h>

namespace mcjax_field {

constexpr int kMaxTerms = 4;
constexpr int kTrap = 0;
constexpr int kLinear = 1;
constexpr int kWalls = 2;

// One term; the host fills it (ops/cuda_substep.py::field_params).
struct Term {
  int kind;
  int axis;           // linear field, walls
  int species;        // energy times coupling[s] (a SpeciesField around it)
  int unit;           // linear field with g = 1: x itself, not a product
  float k[3];         // trap: f32(0.5 k_a)
  float c[3];         // trap: f32(c_a)
  float g;            // linear field
  float coupling[2];  // species ids 0 and 1
  float lo[2];        // walls: allowed centers [lo, hi], species 0 and 1
  float hi[2];
};

struct Params {
  int n;          // terms
  int energetic;  // some term has energy
  int axes;       // bit a: some term reads axis a
  Term t[kMaxTerms];
};

// What a field form's launch adds to its kernel's arguments.
struct Args {
  Params fp;
  const float* origin;  // float32 [dim], device memory
};

// A value (kind < 0), or the product a * b not rounded yet: kind 0 a plain
// product, kind 1 a species-scaled one.
struct Ex {
  float a, b;
  int kind;
};

__device__ __forceinline__ Ex ex_value(float v) { return Ex{v, 0.f, -1}; }

__device__ __forceinline__ float ex_round(const Ex& e) {
  return e.kind < 0 ? e.a : __fmul_rn(e.a, e.b);
}

// XLA folds x (not y) into x + y or x - y: x is a product, and y is none,
// or x is a plain one, or both are species-scaled.
__device__ __forceinline__ bool ex_pick(const Ex& x, const Ex& y) {
  return x.kind >= 0 && (y.kind < 0 || x.kind == 0 || y.kind == 1);
}

__device__ __forceinline__ Ex ex_add(const Ex& x, const Ex& y) {
  if (ex_pick(x, y)) return ex_value(__fmaf_rn(x.a, x.b, ex_round(y)));
  if (y.kind >= 0) return ex_value(__fmaf_rn(y.a, y.b, ex_round(x)));
  return ex_value(__fadd_rn(x.a, y.a));
}

__device__ __forceinline__ Ex ex_sub(const Ex& x, const Ex& y) {
  if (ex_pick(x, y)) return ex_value(__fmaf_rn(x.a, x.b, -ex_round(y)));
  if (y.kind >= 0) return ex_value(__fmaf_rn(-y.a, y.b, ex_round(x)));
  return ex_value(__fsub_rn(x.a, y.a));
}

// Physical coordinate: wrap(stored + origin) into [-L/2, L/2), as
// jnp.mod(v + half, box) - half: fmodf(t, box) with the sign fix-up. For
// t in [-box, 2 box), which a stored coordinate and a wrapped origin give,
// fmodf's exact result is t, t - box (exact: t and box within a factor 2)
// or, for t < 0, t itself before the fix-up adds box; only other t take
// the fmodf call.
__device__ __forceinline__ float wrap(float v, float org, float half,
                                      float box) {
  const float t = __fadd_rn(__fadd_rn(v, org), half);
  float r;
  if (t >= 0.f && t < box) {
    r = t;
  } else if (t >= box && t < __fmul_rn(2.f, box)) {
    r = __fsub_rn(t, box);
  } else if (t < 0.f && t > -box) {
    r = __fadd_rn(t, box);
  } else {
    r = fmodf(t, box);
    if (r < 0.f) r = __fadd_rn(r, box);
  }
  return __fsub_rn(r, half);
}

// wrap() on an axis some term reads; 0 on the others, which no term reads.
__device__ __forceinline__ float wrap_axis(const Params& fp, int a, float v,
                                           float org, float half, float box) {
  return (fp.axes >> a) & 1 ? wrap(v, org, half, box) : 0.f;
}

// x[axis] without a dynamic index (which would put x in local memory).
__device__ __forceinline__ float on_axis(int axis, float x0, float x1,
                                         float x2) {
  return axis == 0 ? x0 : (axis == 1 ? x1 : x2);
}

// Term t's energy at x (species id s, used when `resolved`).
template <int DIM>
__device__ __forceinline__ Ex term_energy(const Term& t, float x0, float x1,
                                          float x2, int s, bool resolved) {
  Ex e;
  if (t.kind == kTrap) {
    const float d0 = __fsub_rn(x0, t.c[0]);
    const float d1 = __fsub_rn(x1, t.c[1]);
    e = ex_add(Ex{__fmul_rn(t.k[0], d0), d0, 0},
               Ex{__fmul_rn(t.k[1], d1), d1, 0});
    if constexpr (DIM == 3) {
      const float d2 = __fsub_rn(x2, t.c[2]);
      e = ex_add(e, Ex{__fmul_rn(t.k[2], d2), d2, 0});
    }
  } else {
    const float v = on_axis(t.axis, x0, x1, x2);
    e = t.unit ? ex_value(v) : Ex{t.g, v, 0};
  }
  if (resolved && t.species) {
    const float sel = s == 0 ? t.coupling[0] : (s == 1 ? t.coupling[1] : 0.f);
    e = Ex{sel, ex_round(e), 1};
  }
  return e;
}

// The composition's energy at x: its energetic terms summed in order.
template <int DIM>
__device__ __forceinline__ Ex energy(const Params& fp, float x0, float x1,
                                     float x2, int s, bool resolved) {
  Ex e = ex_value(0.f);
  bool first = true;
#pragma unroll
  for (int i = 0; i < kMaxTerms; ++i) {
    if (i < fp.n && fp.t[i].kind != kWalls) {
      const Ex ti = term_energy<DIM>(fp.t[i], x0, x1, x2, s, resolved);
      e = first ? ti : ex_add(e, ti);
      first = false;
    }
  }
  return e;
}

// Inside the forbidden region of some walls term (species s's bounds).
__device__ __forceinline__ bool forbidden(const Params& fp, float x0,
                                          float x1, float x2, int s) {
  bool bad = false;
#pragma unroll
  for (int i = 0; i < kMaxTerms; ++i) {
    if (i < fp.n && fp.t[i].kind == kWalls) {
      const Term& t = fp.t[i];
      const float v = on_axis(t.axis, x0, x1, x2);
      bad |= s == 0 ? (v < t.lo[0] || v > t.hi[0])
                    : (v < t.lo[1] || v > t.hi[1]);
    }
  }
  return bad;
}

// A move's dE with the field term (fields.py::field_delta): with a pair
// energy de, single-species (de + E(new)) - E(old); species-resolved
// de + (E(new) - E(old)); without one (hard core), E(new) - E(old).
template <int DIM>
__device__ __forceinline__ float delta_hard(const Params& fp, float n0,
                                            float n1, float n2, float o0,
                                            float o1, float o2) {
  return ex_round(ex_sub(energy<DIM>(fp, n0, n1, n2, 0, false),
                         energy<DIM>(fp, o0, o1, o2, 0, false)));
}

template <int DIM>
__device__ __forceinline__ float delta_single(const Params& fp, float de,
                                              float n0, float n1, float n2,
                                              float o0, float o1, float o2) {
  return ex_round(ex_sub(ex_add(ex_value(de),
                                energy<DIM>(fp, n0, n1, n2, 0, false)),
                         energy<DIM>(fp, o0, o1, o2, 0, false)));
}

template <int DIM>
__device__ __forceinline__ float delta_species(const Params& fp, float de,
                                               int s, float n0, float n1,
                                               float n2, float o0, float o1,
                                               float o2) {
  return __fadd_rn(de, ex_round(ex_sub(energy<DIM>(fp, n0, n1, n2, s, true),
                                       energy<DIM>(fp, o0, o1, o2, s, true))));
}

}  // namespace mcjax_field
