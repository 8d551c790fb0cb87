// The oblique score epilogue of the geodesic-attention kernels redesigned
// for the H100, shared by the small-shape forward (small_fwd.cuh, weight:
// kernels A's small-S mode and P), the small-S backward (small_bwd.cuh,
// pair_terms: kernel C) and the oblique flash backward sweeps
// (flash_mhgsa_bwd.cu, sweep_p: Fdq, Fdkv).
//
// It is the TPU kernel's own (sttode_tpu/kernels/mhgsa.py: _acos, :121,
// through _scores, :177, and the backward's gate): with the Gram entry g of
// unit rows and gc = clip(g, ±(1 − 1e-4)),
//
//   acos(|gc|) = √(1 − |gc|)·Σ a_i |gc|^i      (Abramowitz & Stegun 4.4.46,
//                                               |error| ≤ 2e-8 on [0, 1])
//   s = −acos(gc) = −acos(|gc|), or acos(|gc|) − π where gc < 0
//   gate = rsqrt(max(1 − gc², 1e-12)) where the unclipped |g| < 1 − 1e-4,
//          else 0 (the acos' factor through the clip)
//
// with √x as x·rsqrt(x) and every exp as one ex2, on the SFU's native
// approximations (sfu.cuh; each argument a normal number: 1 − |gc| ≥ 1e-4,
// and an excluded mask entry's −1e30·log2 e gives +0). The clip keeps
// |gc| ≤ 0.9999, so q = k rows (g ≈ 1) get gate 0: an exactly zero, finite
// gradient. Each function takes IEEE, a timing variant's switch: acosf,
// expf and rsqrtf instead, the kernels' arithmetic of before.

#pragma once

#include <math.h>

#include "sfu.cuh"

namespace oblique {

constexpr float kClip = 0.9999f;        // 1 - 1e-4
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPi = 3.14159265358979f;
constexpr float kExpNegPi = 0.04321391826377226f;   // e^(−π)

__device__ __forceinline__ float clip(float g) {
  return fminf(fmaxf(g, -kClip), kClip);
}

// acos(|gc|) of a clipped Gram entry
__device__ __forceinline__ float acos_abs(float gc) {
  const float a = fabsf(gc);
  float p = fmaf(-0.0012624911f, a, 0.0066700901f);
  p = fmaf(p, a, -0.0170881256f);
  p = fmaf(p, a, 0.0308918810f);
  p = fmaf(p, a, -0.0501743046f);
  p = fmaf(p, a, 0.0889789874f);
  p = fmaf(p, a, -0.2145988016f);
  p = fmaf(p, a, 1.5707963050f);
  const float x = 1.f - a;               // ≥ 1e-4 after the clip
  return x * sfu::rsqrt_approx(x) * p;
}

// the gate of the unclipped g and its clipped gc
template <bool IEEE>
__device__ __forceinline__ float gate(float g, float gc) {
  const float t = fmaxf(1.f - gc * gc, 1e-12f);
  return fabsf(g) < kClip ? (IEEE ? rsqrtf(t) : sfu::rsqrt_approx(t)) : 0.f;
}

// exp(−acos(clip(g))) (small_fwd.cuh): a negative Gram takes
// e^(−π)·2^(acos(|gc|)·log2 e)
template <bool IEEE>
__device__ __forceinline__ float weight(float g) {
  const float gc = clip(g);
  if (IEEE) return expf(-acosf(gc));
  const float r = acos_abs(gc);
  const float e = sfu::ex2_approx((gc >= 0.f ? -r : r) * kLog2e);
  return gc >= 0.f ? e : kExpNegPi * e;
}

// e = exp(−acos(gc) + m), m the pair's mask entry, and the gate
// (small_bwd.cuh)
template <bool IEEE>
__device__ __forceinline__ void pair_terms(float g, float m, float* e,
                                           float* gt) {
  const float gc = clip(g);
  if (IEEE) {
    *e = expf(-acosf(gc) + m);
  } else {
    const float r = acos_abs(gc);
    const float s = gc >= 0.f ? -r : r - kPi;       // −acos(gc)
    *e = sfu::ex2_approx((s + m) * kLog2e);
  }
  *gt = gate<IEEE>(g, gc);
}

// What sweep_p takes of a row's lse: lse·log2 e, once per row
template <bool IEEE>
__device__ __forceinline__ float sweep_row(float lse) {
  return IEEE ? lse : lse * kLog2e;
}

// The flash sweeps' replayed p = exp(−acos(gc) − lse) as one ex2,
// 2^(s·log2 e − lse·log2 e), with `row` = sweep_row(lse_i); the gate in *gt
template <bool IEEE>
__device__ __forceinline__ float sweep_p(float g, float row, float* gt) {
  const float gc = clip(g);
  *gt = gate<IEEE>(g, gc);
  if (IEEE) return expf(-acosf(gc) - row);
  const float r = acos_abs(gc);
  const float s = gc >= 0.f ? -r : r - kPi;         // −acos(gc)
  return sfu::ex2_approx(fmaf(s, kLog2e, -row));
}

}  // namespace oblique
