// The poincaré score epilogue of the geodesic-attention kernels, shared by
// mhgsa_fwd.cu, mhgsa_bwd.cu, flash_mhgsa_fwd.cu and flash_mhgsa_bwd.cu
// (whose register sweeps take sweep_grad), by the small-shape forward
// (small_fwd.cuh, fwd_weight) and by the small-S backward (small_bwd.cuh,
// bwd_terms, at the end of this file).
//
// Device form of sttode_tpu/kernels/mhgsa.py::_poincare_pieces (:211),
// _poincare_score_from_pieces (:228) and _poincare_grad_pieces (:241),
// one (query row i, key j) pair at a time. The inputs are ball points (the
// caller applies project(expmap0(·)) outside the kernels), staged raw, with
// x2 = ‖q_i‖² and y2 = ‖k_j‖² kept beside them; g = q_i·k_j comes from fp32
// FMAs (no TF32, no tensor cores: x2 − 2g + y2 cancels for close points and
// artanh amplifies the error up to 1/(2·1e-5) near the ball's edge):
//
//   m   = max(x2 − 2g + y2, 0),   den = 1 − 2c·g + c²·x2·y2
//   n²  = m·den / (den + 1e-5)²,  n = √(n² + 1e-15)
//   zc  = min(√c·n, 1 − 1e-5),    s = −(2/√c)·½·log((1 + zc)/(1 − zc))
//
// and, for the score cotangent ds of the pair,
//
//   dn  = ds · (−2 / max(1 − zc², 1e-12))      (through the clamp)
//   dn2 = dn · ½ / n
//   A   = den/(den + ε)²,  Bd = m·(ε − den)/(den + ε)³,  gate = 1{x2−2g+y2 > 0}
//   dg  = dn2·(−2·A·gate − 2c·Bd)
//   dx2 += dn2·(A·gate + c²·Bd·y2),  dy2 += dn2·(A·gate + c²·Bd·x2)
//
// The caller assembles dq_i = Σ_j dg_ij k_j + 2·dx2_i·q_i and
// dk_j = Σ_i dg_ij q_i + 2·dy2_j·k_j; there is no normalize VJP. The scores
// are ≥ −12.21/√c, which keeps the kernels' maxless softmax valid for
// c ≥ 0.032 (the wrappers refuse smaller c).

#pragma once

#include <math.h>

#include "sfu.cuh"

namespace poincare {

constexpr float kArtanhEps = 1e-5f;
constexpr float kDenomEps = 1e-5f;

// the curvature and what the epilogue derives from it, once per launch
struct Curv {
  float c, c2, sqrt_c, inv_sqrt_c;
};

inline Curv make_curv(float c) {
  const float s = sqrtf(c);
  return Curv{c, c * c, s, 1.f / s};
}

// the recompute of one pair, kept for its gradient (t = n²)
struct Pair {
  float raw, m, den, t, n, zc;
};

__device__ __forceinline__ Pair pair(float g, float x2, float y2,
                                     const Curv& k) {
  Pair p;
  p.raw = x2 - 2.f * g + y2;
  p.m = fmaxf(p.raw, 0.f);
  p.den = 1.f - 2.f * k.c * g + k.c2 * x2 * y2;
  const float de = p.den + kDenomEps;
  p.t = p.m * p.den / (de * de) + 1e-15f;
  p.n = sqrtf(p.t);
  p.zc = fminf(k.sqrt_c * p.n, 1.f - kArtanhEps);
  return p;
}

__device__ __forceinline__ float score(const Pair& p, const Curv& k) {
  return -k.inv_sqrt_c * logf((1.f + p.zc) / (1.f - p.zc));
}

// dg of the pair for its score cotangent ds; a = dn2·A·gate and
// b = dn2·c²·Bd, so that dx2 += a + b·y2 and dy2 += a + b·x2
__device__ __forceinline__ float grad(const Pair& p, float ds, const Curv& k,
                                      float* a, float* b) {
  const float dn = ds * (-2.f / fmaxf(1.f - p.zc * p.zc, 1e-12f));
  const float dn2 = dn * (0.5f / p.n);
  const float de = p.den + kDenomEps;
  const float A = p.den / (de * de);
  const float Bd = p.m * (kDenomEps - p.den) / (de * de * de);
  *a = p.raw > 0.f ? dn2 * A : 0.f;
  *b = dn2 * k.c2 * Bd;
  return -2.f * *a - 2.f * k.c * dn2 * Bd;
}

// ---------------------------------------------------------------------------
// The flash backward sweeps' form of pair + score + grad (flash_mhgsa_bwd.cu).
// The sweeps replay every pair twice and are bound by issuing the epilogue's
// instructions: an IEEE division, sqrtf, logf or expf is a sequence of many
// instructions around one SFU (MUFU) op. Here the SFU's own approximations
// (PTX rcp/rsqrt/lg2/ex2 .approx.ftz, ~2 ulp; every argument is a normal
// number: den + ε ≥ 1e-5, n² + 1e-15, 1 − zc² ≥ 2e-5) carry the epilogue:
//
//   r   = 1/(den + ε)                       A = den·r²,  n² = m·A
//   ρ   = 1/√(n² + 1e-15)                   n = (n² + 1e-15)·ρ, ½/n = ½ρ
//   w   = 1/max((1 − zc)(1 + zc), 1e-12)    (1 + zc)/(1 − zc) = (1 + zc)²·w
//   p   = 2^(−log2((1 + zc)/(1 − zc))/√c − lse·log2 e)
//       = e^(−lse)·(1 − zc)²·w               at c = 1 (no log, no exp)
//   dn2 = −p·(dp − δ)·w·ρ,  Bd = m·(ε − den)·r³
//
// with the row's lse·log2 e (or, at c = 1, e^(−lse)) computed once per row
// by the caller (sweep_row). The Gram g, the squared norms, x2 − 2g + y2,
// den, its gate and the clamps are those of pair() and grad(), in fp32.

using sfu::ex2_approx;
using sfu::lg2_approx;
using sfu::rcp_approx;
using sfu::rsqrt_approx;

// what sweep_grad takes of a row's lse: e^(−lse) at c = 1, else lse·log2 e
template <bool C1>
__device__ __forceinline__ float sweep_row(float lse) {
  return C1 ? expf(-lse) : lse * 1.4426950408889634f;
}

// dg of the pair and its replayed probability p, with a and b as in grad();
// `row` is sweep_row<C1>(lse_i), C1 the curvature c = 1
template <bool C1>
__device__ __forceinline__ float sweep_grad(float g, float x2, float y2,
                                            float row, float delta, float dp,
                                            const Curv& k, float* p, float* a,
                                            float* b) {
  const float raw = x2 - 2.f * g + y2;
  const float m = fmaxf(raw, 0.f);
  const float den = 1.f - 2.f * k.c * g + k.c2 * x2 * y2;
  const float r = rcp_approx(den + kDenomEps);
  const float r2 = r * r;
  const float A = den * r2;
  const float t = m * A + 1e-15f;
  const float rho = rsqrt_approx(t);
  const float zc = fminf(k.sqrt_c * (t * rho), 1.f - kArtanhEps);
  const float om = 1.f - zc, op = 1.f + zc;
  const float w = rcp_approx(fmaxf(om * op, 1e-12f));
  *p = C1 ? row * (om * om * w)
          : ex2_approx(fmaf(-k.inv_sqrt_c, lg2_approx(op * op * w), -row));
  const float dn2 = -(*p * (dp - delta)) * (w * rho);
  const float Bd = m * (kDenomEps - den) * (r2 * r);
  *a = raw > 0.f ? dn2 * A : 0.f;
  *b = dn2 * k.c2 * Bd;
  return -2.f * *a - 2.f * k.c * dn2 * Bd;
}

// The small-shape forward's weight of one pair, e = exp(s) (small_fwd.cuh):
// zc from pair(), in IEEE fp32 as the other kernels compute it, then the
// transcendental tail on the SFU, with no log or exp at c = 1:
//
//   e = (1 − zc)·rcp(1 + zc)                           at c = 1 (C1)
//   e = 2^(−log2((1 + zc)·rcp(1 − zc))/√c)             otherwise
//
// since exp(−(2/√c)·artanh(zc)) = ((1 − zc)/(1 + zc))^(1/√c); 1 ± zc lie in
// [1e-5, 2]. zc keeps pair()'s division and sqrtf: near the ball's edge
// 1 − zc magnifies zc's rounding by zc/(1 − zc), and zc from sweep_grad's
// rcp and rsqrt (about twice pair()'s rounding) moved the NBA recipe's
// B = 32 poincaré step across a decoder ReLU at rounding against the dense
// route where the IEEE zc does not (PERF.md §6). weight_of is the tail
// alone, of a zc the caller keeps.
template <bool C1>
__device__ __forceinline__ float weight_of(float zc, const Curv& k) {
  if (C1) return (1.f - zc) * rcp_approx(1.f + zc);
  return ex2_approx(-k.inv_sqrt_c * lg2_approx((1.f + zc) *
                                               rcp_approx(1.f - zc)));
}

template <bool C1>
__device__ __forceinline__ float fwd_weight(float g, float x2, float y2,
                                            const Curv& k) {
  return weight_of<C1>(pair(g, x2, y2, k).zc, k);
}

// ---------------------------------------------------------------------------
// The small-S backward's form (small_bwd.cuh, kernel 2p). grad() is linear
// in ds, so a pair gives its weight e = exp(s + mask) and its gradient
// factors per unit of ds once, and the body sums them over a row before δ
// is known:
//
//   dg = ds·f,   dx2_i += ds·(a + b·y2_j),   dy2_j += ds·(a + b·x2_i)
//
// with F = −2·w·½/n, w = 1/max(1 − zc², 1e-12), a = F·A·gate,
// b = F·c²·Bd and f = −2a − 2c·F·Bd (A, Bd and the gate as in grad()). zc
// is pair()'s, in IEEE fp32 (fwd_weight says why); the tail takes the SFU:
// e as weight_of (an additive mask entry m as one more ex2), w as
// rcp((1 − zc)(1 + zc)) (sweep_grad's), ½/n as ½·rsqrt(n²) and
// r = rcp(den + ε) for A = den·r², Bd = m·(ε − den)·r³. Every argument is
// a normal number (den + ε ≥ 1e-5, n² ≥ 1e-15, (1 − zc)(1 + zc) ≥ 2e-5),
// and an excluded entry's ex2(−1e30·log2 e) gives e = +0. Each bit of IEEE
// takes one piece as score(), expf and grad() compute it: 1 the weight
// (expf(score + m)), 2 w, 4 ½/n, 8 r.
struct BwdTerms {
  float e, f, a, b;
};

template <bool C1, int IEEE>
__device__ __forceinline__ BwdTerms bwd_terms(float g, float x2, float y2,
                                              float mask, bool masked,
                                              const Curv& k) {
  const Pair p = pair(g, x2, y2, k);
  BwdTerms t;
  if (IEEE & 1) {
    t.e = expf(score(p, k) + mask);
  } else {
    t.e = weight_of<C1>(p.zc, k);
    if (masked) t.e *= ex2_approx(mask * 1.4426950408889634f);
  }
  const float de = p.den + kDenomEps;
  float A, Bd;
  if (IEEE & 8) {
    A = p.den / (de * de);
    Bd = p.m * (kDenomEps - p.den) / (de * de * de);
  } else {
    const float r = rcp_approx(de), r2 = r * r;
    A = p.den * r2;
    Bd = p.m * (kDenomEps - p.den) * (r2 * r);
  }
  const float w2 = (IEEE & 2)
      ? -2.f / fmaxf(1.f - p.zc * p.zc, 1e-12f)
      : -2.f * rcp_approx(fmaxf((1.f - p.zc) * (1.f + p.zc), 1e-12f));
  const float hn = (IEEE & 4) ? 0.5f / p.n : 0.5f * rsqrt_approx(p.t);
  const float F = w2 * hn;
  t.a = p.raw > 0.f ? F * A : 0.f;
  t.b = F * k.c2 * Bd;
  t.f = -2.f * t.a - 2.f * k.c * F * Bd;
  return t;
}

}  // namespace poincare
