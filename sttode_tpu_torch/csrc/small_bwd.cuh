// Small-S mode of the whole-S attention backward (mhgsa_bwd.cu, kernels C
// and 2p at the shapes small_bwd::mode takes): the function of
// mhgsa_bwd.cu's header, both metrics, with the same contract (masks,
// dmask, an all-excluded row's exactly zero gradients). The metric enters
// as a policy of the body: Oblique (C) or Poincare<C1> (2p, ball points).
// The packed backward (packed_mhgsa_bwd.cu, kernel Q) runs the oblique body
// with a key validity in place of the mask: e_ij = exp(−acos(gc_ij))·val[b,
// j], the row val[p / H] of a problem's batch row staged once into shared
// memory, no mask and no dmask; an all-invalid problem gets exactly zero
// gradients.
//
// What bounds it on the H100: at the bench recipe a call is 88 problems of
// 128 × 128 × 8, ~130 M operations on 2.5 MB, about two microseconds of the
// card's fp32 rate; at the poincaré NBA recipe (2p) 88 of 32 × 32 × 8,
// ~11 M operations on 0.6 MB, a fraction of a microsecond. The kernel of
// before (one warp per row or key, a lane per head-dim entry) left 24 of
// 32 lanes idle at Dh = 8 and ran serial chains of S (and L) FMAs through
// shared memory: C 166–205 µs, 2p 19 µs (PERF.md §6). Here:
// - one block per problem, so that the block holds every row's denominator
//   and δ before pass 2 and the k-side normalize VJP sees the whole dk̂:
//   no atomics, and the summation order is the same on every run;
// - pass 1, threads own query rows (lane = row; `rows1` at a time) and the
//   keys are split across warps into `slices1` slices (key j ≡ slice mod
//   slices1), the row, do_i and the row's sums in registers. Since
//   ds = p (dp − δ) and δ = Σ_j p dp, and the gradient of a pair's score is
//   linear in ds (dg = ds·f_ij, oblique f = the clip gate), one pass over
//   the keys gives den = Σ e, Σ e·dp, A = Σ f·e·dp·k_j and B = Σ f·e·k_j
//   (poincaré also X = Σ (α + β·y2_j)·e·dp and Y = Σ (α + β·y2_j)·e, the
//   squared norm's terms), all linear in the keys, so the slices' partial
//   sums add once through shared memory; then δ = Σ e·dp / den,
//   dq̂_i = (A − δ·B) / den (and dx2_i = (X − δ·Y) / den), and the q-side
//   normalize VJP (poincaré: + 2·dx2_i·q_i) ends the row;
// - pass 2, threads own keys (`keys2` at a time) and the rows are split
//   into `slices2` slices, k_j, v_j and the running dk_j and dv_j (and
//   dy2_j) in registers; each pair replays p = e / den_i and
//   ds = p (dp − δ_i) (and writes dmask = ds, lanes on consecutive keys);
//   the slices' partials add through shared memory and the k-side
//   normalize VJP (poincaré: + 2·dy2_j·k_j) ends the key;
// - the staged rows (unit rows and their norms, or raw ball rows and their
//   squared norms) are read as broadcasts (a warp shares its slice) from
//   rows padded to an odd stride; no lane idles on the head dim and no
//   chain of S runs through shared memory;
// - the oblique epilogue is the TPU kernel's own (sttode_tpu/kernels/
//   mhgsa.py: _acos, :121, the scores at :183, the gate at :360),
//   oblique.cuh's pair_terms: acos from the Abramowitz & Stegun 4.4.46
//   polynomial with √(1 − |g|) as x·rsqrt(x), the exp (of the score plus
//   the mask entry) as one ex2 on the SFU, and the clip gate
//   rsqrt(max(1 − gc², 1e-12)) of the unclipped test |g| < 1 − 1e-4; the
//   poincaré one is poincare.cuh's bwd_terms: zc in IEEE fp32, the weight
//   and the gradient factors from rcp, rsqrt, lg2 and ex2 on the SFU.
// The Gram stays fp32 FMAs (acos' amplifies Gram error near ±1; the
// poincaré x2 − 2g + y2 cancels for close points).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "oblique.cuh"
#include "poincare.cuh"
#include "smem_attr.cuh"

// timing variants of the design (see scripts/torch_3p_c_bench.py): the mode
// (-1 where mode() says, the default; 0 never; 1 wherever it fits), the
// IEEE epilogue (acosf, expf, rsqrtf; poincaré: every piece below) in place
// of the SFU one, and one slice (each thread all the keys of its row, then
// all the rows of its key)
#ifndef STTODE_SMALL_BWD_MODE
#define STTODE_SMALL_BWD_MODE -1
#endif
#ifndef STTODE_SMALL_BWD_IEEE_EPILOGUE
#define STTODE_SMALL_BWD_IEEE_EPILOGUE 0
#endif
#ifndef STTODE_SMALL_BWD_ONE_SLICE
#define STTODE_SMALL_BWD_ONE_SLICE 0
#endif
// the poincaré epilogue's SFU pieces taken back to IEEE, a bit each
// (poincare::bwd_terms: 1 the weight, 2 w, 4 ½/n, 8 r)
#ifndef STTODE_SMALL_BWD_IEEE_PIECES
#define STTODE_SMALL_BWD_IEEE_PIECES (STTODE_SMALL_BWD_IEEE_EPILOGUE ? 15 : 0)
#endif
// and the threads of a block at Dh ≤ 8, oblique (0: the design's,
// max_threads) and poincaré
#ifndef STTODE_SMALL_BWD_THREADS_DH8
#define STTODE_SMALL_BWD_THREADS_DH8 0
#endif
#ifndef STTODE_SMALL_BWD_BALL_THREADS_DH8
#define STTODE_SMALL_BWD_BALL_THREADS_DH8 512
#endif

// internal linkage: each including source keeps its own copy
namespace {
namespace small_bwd {

constexpr float kNormFloor = 1e-12f;
constexpr float kDenFloor = 1e-30f;
constexpr int kKeysPerThread = 4;
constexpr size_t kSmemOptin = 232448;  // H100: shared memory a block

// The metric policies of the body: the oblique metric (kernels C and Q),
// and the poincaré one of ball points (kernel 2p), its c = 1 form chosen at
// launch
struct Oblique {
  static constexpr bool kBall = false;
  static constexpr bool kC1 = false;
};
template <bool C1>
struct Poincare {
  static constexpr bool kBall = true;
  static constexpr bool kC1 = C1;
};

// threads of a block at most: 1024 at Dh ≤ 8 (poincaré 512: 87 registers
// a thread, where 1024 cap them at 64; 2 % faster at 88 × 128² × 8, the
// same layout below 128 rows, PERF.md §6), 512 at 16, 256 at 32 (a thread
// holds four DH-vectors in registers in either pass)
template <int DH, bool BALL = false>
__host__ __device__ constexpr int max_threads() {
  return DH <= 8 ? (BALL ? STTODE_SMALL_BWD_BALL_THREADS_DH8
                         : STTODE_SMALL_BWD_THREADS_DH8
                               ? STTODE_SMALL_BWD_THREADS_DH8 : 1024)
                 : DH <= 16 ? 512 : 256;
}

__host__ __device__ constexpr int ld(int dh) { return dh | 1; }

// floats a thread leaves for the slices' combine: pass 1 2·DH + 2
// (poincaré + 2: X and Y), pass 2 2·DH (poincaré + 1: dy2), at an odd
// stride
__host__ __device__ constexpr int part_stride(int dh, bool ball = false) {
  return 2 * dh + (ball ? 5 : 3);
}

// e = exp(−acos(gc) + m) and the clip-gated acos' factor, 0 outside the clip
__device__ __forceinline__ void pair_terms(float g, float m, float* e,
                                           float* gate) {
  oblique::pair_terms<STTODE_SMALL_BWD_IEEE_EPILOGUE>(g, m, e, gate);
}

__host__ __device__ __forceinline__ int pow2_ceil(int x) {
  int y = 1;
  while (y < x) y <<= 1;
  return y;
}

// the block's layout (kernels/mhgsa.py::small_bwd_layout is its Python
// form): of at most nt threads, pass 1 takes rows1 = min(L rounded up to a
// power of two, nt) rows at a time and splits the keys into slices1 slices
// of about kKeysPerThread keys, within nt; pass 2 likewise with keys2 keys
// and slices2 slices of rows; the block's threads cover the larger of the
// two, in whole warps. nt is max_threads<DH, BALL>(), halved while the
// block's shared memory (smem_bytes) would pass the H100's 232,448 bytes.
struct Layout {
  int rows1, slices1, keys2, slices2, threads;
};

template <int DH>
__host__ __device__ Layout layout_of(int L, int S, int nt) {
  Layout y;
  y.rows1 = pow2_ceil(L) < nt ? pow2_ceil(L) : nt;
  y.slices1 = pow2_ceil((S + kKeysPerThread - 1) / kKeysPerThread);
  if (y.slices1 > nt / y.rows1) y.slices1 = nt / y.rows1;
  y.keys2 = pow2_ceil(S) < nt ? pow2_ceil(S) : nt;
  y.slices2 = pow2_ceil((L + kKeysPerThread - 1) / kKeysPerThread);
  if (y.slices2 > nt / y.keys2) y.slices2 = nt / y.keys2;
  if (STTODE_SMALL_BWD_ONE_SLICE) y.slices1 = y.slices2 = 1;
  const int n1 = y.rows1 * y.slices1, n2 = y.keys2 * y.slices2;
  y.threads = ((n1 > n2 ? n1 : n2) + 31) / 32 * 32;
  return y;
}

// shared memory of a block: the rows of q and do [L][ld], of k and v
// [S][ld], the row norms (poincaré: squared norms), 1/den, δ [L], the key
// norms (squared norms) [S], with VAL the key validity [S], and the slices'
// partial sums
template <int DH, bool VAL, bool BALL = false>
__host__ __device__ size_t smem_bytes(int L, int S, const Layout& y) {
  const int n1 = y.rows1 * y.slices1, n2 = y.keys2 * y.slices2;
  return sizeof(float) *
         (2 * ((size_t)L + S) * ld(DH) + 3 * (size_t)L + (VAL ? 2 : 1) *
          (size_t)S + (size_t)(n1 > n2 ? n1 : n2) * part_stride(DH, BALL));
}

template <int DH, bool VAL, bool BALL = false>
__host__ __device__ Layout layout(int L, int S) {
  int nt = max_threads<DH, BALL>();
  Layout y = layout_of<DH>(L, S, nt);
  while (nt > 32 && smem_bytes<DH, VAL, BALL>(L, S, y) > kSmemOptin)
    y = layout_of<DH>(L, S, nt /= 2);
  return y;
}

// a row of width Dh zero-padded to DH into shared memory at stride ld(DH),
// unit-normalized (norm floored) with its unfloored norm returned, or raw
template <int DH, bool UNIT>
__device__ __forceinline__ float stage_row(const float* __restrict__ x,
                                           int Dh, float* dst) {
  float r[DH];
  float ss = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    r[d] = d < Dh ? x[d] : 0.f;
    ss = fmaf(r[d], r[d], ss);
  }
  const float n = sqrtf(ss);
  const float f = fmaxf(n, kNormFloor);
#pragma unroll
  for (int d = 0; d < DH; ++d) dst[d] = UNIT ? r[d] / f : r[d];
  return n;
}

// a raw ball row, zero-padded, with its squared norm returned
template <int DH>
__device__ __forceinline__ float stage_ball(const float* __restrict__ x,
                                            int Dh, float* dst) {
  float ss = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    const float r = d < Dh ? x[d] : 0.f;
    ss = fmaf(r, r, ss);
    dst[d] = r;
  }
  return ss;
}

template <int DH>
__device__ __forceinline__ void load(const float* __restrict__ src,
                                     float (&r)[DH]) {
#pragma unroll
  for (int d = 0; d < DH; ++d) r[d] = src[d];
}

template <int DH>
__device__ __forceinline__ float dot(const float (&a)[DH],
                                     const float* __restrict__ b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// the row-normalize VJP (dx̂ − x̂ (dx̂·x̂)) / max(n, floor) written to out
template <int DH>
__device__ __forceinline__ void normalize_vjp(const float (&dxh)[DH],
                                              const float* __restrict__ xh,
                                              float n, int Dh,
                                              float* __restrict__ out) {
  float r = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) r = fmaf(dxh[d], xh[d], r);
  const float f = fmaxf(n, kNormFloor);
#pragma unroll
  for (int d = 0; d < DH; ++d)
    if (d < Dh) out[d] = (dxh[d] - xh[d] * r) / f;
}

// the poincaré row's end: dx + 2·dx2·x, x the raw ball row
template <int DH>
__device__ __forceinline__ void ball_end(const float (&dxh)[DH],
                                         const float (&x)[DH], float dx2,
                                         int Dh, float* __restrict__ out) {
#pragma unroll
  for (int d = 0; d < DH; ++d)
    if (d < Dh) out[d] = fmaf(2.f * dx2, x[d], dxh[d]);
}

// The block's work on problem blockIdx.x under the metric policy M: q
// [·,L,Dh], k/v [·,S,Dh], dout [·,L,Dh], the additive mask [·,L,S]
// (canonicalized) or null, and with VAL (oblique only) the key validity
// val [·/H, S] (a problem's batch row p / H; null: every key valid)
// multiplying each pair's e; dq, dk, dv and, where dmask is not null,
// dmask [·,L,S]; curv the poincaré curvature.
template <int DH, bool VAL, class M = Oblique>
__device__ __forceinline__ void body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ mask,
    const float* __restrict__ val, const float* __restrict__ dout,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dmask, int H, int L, int S, int Dh, Layout y,
    const poincare::Curv& curv = poincare::Curv{}) {
  static_assert(!(VAL && M::kBall), "the key validity is oblique only");
  constexpr int IEEE = STTODE_SMALL_BWD_IEEE_PIECES;
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = ld(DH);
  constexpr int PS = part_stride(DH, M::kBall);
  float* qn = smem;                       // [L][LD] q̂ (poincaré: q)
  float* dos = qn + L * LD;               // [L][LD] do
  float* kn = dos + L * LD;               // [S][LD] k̂ (poincaré: k)
  float* vs = kn + S * LD;                // [S][LD] v
  float* qnorm = vs + S * LD;             // [L] ‖q_i‖ (poincaré: ‖q_i‖²)
  float* rden = qnorm + L;                // [L] 1 / den_i
  float* delta = rden + L;                // [L] δ_i
  float* knorm = delta + L;               // [S] ‖k_j‖ (poincaré: ‖k_j‖²)
  float* kval = knorm + S;                // [S] validity (VAL)
  float* part = kval + (VAL ? S : 0);     // [slices][rows][PS] partial sums

  const int b = blockIdx.x;
  const int t = threadIdx.x, nt = blockDim.x;
  const size_t qo = (size_t)b * L * Dh, ko = (size_t)b * S * Dh;
  const float* mp = mask ? mask + (size_t)b * L * S : nullptr;
  float* dmp = dmask ? dmask + (size_t)b * L * S : nullptr;
  const float* valp = VAL && val ? val + (size_t)(b / H) * S : nullptr;

  // stage: a thread per row of q and do, then of k and v (and validity)
  for (int r = t; r < L + S; r += nt) {
    if (r < L) {
      if constexpr (M::kBall)
        qnorm[r] = stage_ball<DH>(q + qo + (size_t)r * Dh, Dh, qn + r * LD);
      else
        qnorm[r] = stage_row<DH, true>(q + qo + (size_t)r * Dh, Dh,
                                       qn + r * LD);
      stage_row<DH, false>(dout + qo + (size_t)r * Dh, Dh, dos + r * LD);
    } else {
      const int j = r - L;
      if constexpr (M::kBall)
        knorm[j] = stage_ball<DH>(k + ko + (size_t)j * Dh, Dh, kn + j * LD);
      else
        knorm[j] = stage_row<DH, true>(k + ko + (size_t)j * Dh, Dh,
                                       kn + j * LD);
      stage_row<DH, false>(v + ko + (size_t)j * Dh, Dh, vs + j * LD);
      if (VAL) kval[j] = valp ? valp[j] : 1.f;
    }
  }
  __syncthreads();

  // pass 1: rows, the keys split into slices
  {
    const int rr = t % y.rows1, s = t / y.rows1;
    const bool mine = s < y.slices1;
    for (int ib = 0; ib < L; ib += y.rows1) {
      const int i = ib + rr;
      float qh[DH], dr[DH], A[DH], Bv[DH];
      float den = 0.f, edp = 0.f, X = 0.f, Y = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) A[d] = Bv[d] = 0.f;
      if (mine && i < L) {
        load(qn + i * LD, qh);
        load(dos + i * LD, dr);
        const float* mrow = mp ? mp + (size_t)i * S : nullptr;
        const float x2 = M::kBall ? qnorm[i] : 0.f;
        for (int j = s; j < S; j += y.slices1) {
          const float* kr = kn + j * LD;
          const float g = dot(qh, kr);
          const float dp = dot(dr, vs + j * LD);
          float e, w;                     // w: f·e, the weight of k_j in A, B
          if constexpr (M::kBall) {
            const float y2 = knorm[j];
            const poincare::BwdTerms tm = poincare::bwd_terms<M::kC1, IEEE>(
                g, x2, y2, mrow ? __ldg(mrow + j) : 0.f, mrow != nullptr,
                curv);
            e = tm.e;
            const float wab = fmaf(tm.b, y2, tm.a) * e;
            X = fmaf(wab, dp, X);
            Y += wab;
            w = tm.f * e;
          } else {
            float gate;
            pair_terms(g, mrow ? __ldg(mrow + j) : 0.f, &e, &gate);
            if (VAL) e *= kval[j];
            w = gate * e;
          }
          den += e;
          edp = fmaf(e, dp, edp);
          const float wd = w * dp;
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            A[d] = fmaf(wd, kr[d], A[d]);
            Bv[d] = fmaf(w, kr[d], Bv[d]);
          }
        }
      }
      if (mine) {
        float* mine_p = part + (size_t)t * PS;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          mine_p[d] = A[d];
          mine_p[DH + d] = Bv[d];
        }
        mine_p[2 * DH] = den;
        mine_p[2 * DH + 1] = edp;
        if constexpr (M::kBall) {
          mine_p[2 * DH + 2] = X;
          mine_p[2 * DH + 3] = Y;
        }
      }
      __syncthreads();
      if (s == 0 && i < L) {               // the row's sums, in slice order
        for (int sl = 1; sl < y.slices1; ++sl) {
          const float* pr = part + (size_t)(sl * y.rows1 + rr) * PS;
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            A[d] += pr[d];
            Bv[d] += pr[DH + d];
          }
          den += pr[2 * DH];
          edp += pr[2 * DH + 1];
          if constexpr (M::kBall) {
            X += pr[2 * DH + 2];
            Y += pr[2 * DH + 3];
          }
        }
        const float dn = fmaxf(den, kDenFloor);
        const float dl = edp / dn;
        float dqh[DH];
#pragma unroll
        for (int d = 0; d < DH; ++d) dqh[d] = (A[d] - dl * Bv[d]) / dn;
        if constexpr (M::kBall)
          ball_end(dqh, qh, (X - dl * Y) / dn, Dh, dq + qo + (size_t)i * Dh);
        else
          normalize_vjp(dqh, qn + i * LD, qnorm[i], Dh,
                        dq + qo + (size_t)i * Dh);
        rden[i] = 1.f / dn;
        delta[i] = dl;
      }
      __syncthreads();
    }
  }

  // pass 2: keys, the rows split into slices
  {
    const int c = t % y.keys2, s = t / y.keys2;
    const bool mine = s < y.slices2;
    for (int jb = 0; jb < S; jb += y.keys2) {
      const int j = jb + c;
      float kh[DH], vr[DH], dkh[DH], dvr[DH];
      float dy2 = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) dkh[d] = dvr[d] = 0.f;
      if (mine && j < S) {
        load(kn + j * LD, kh);
        load(vs + j * LD, vr);
        const float vj = VAL ? kval[j] : 1.f;
        const float y2 = M::kBall ? knorm[j] : 0.f;
        for (int i = s; i < L; i += y.slices2) {
          const float* qr = qn + i * LD;
          const float* dr = dos + i * LD;
          float g = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            g = fmaf(qr[d], kh[d], g);
            dp = fmaf(dr[d], vr[d], dp);
          }
          const float m = mp ? __ldg(mp + (size_t)i * S + j) : 0.f;
          float e, f;                     // f: the gradient factor, dg = f·ds
          poincare::BwdTerms tm;
          if constexpr (M::kBall) {
            tm = poincare::bwd_terms<M::kC1, IEEE>(g, qnorm[i], y2, m,
                                                   mp != nullptr, curv);
            e = tm.e;
            f = tm.f;
          } else {
            pair_terms(g, m, &e, &f);
            if (VAL) e *= vj;
          }
          const float p = e * rden[i];
          const float ds = p * (dp - delta[i]);
          if (dmp) dmp[(size_t)i * S + j] = ds;
          const float dg = f * ds;
          if constexpr (M::kBall) dy2 = fmaf(ds, fmaf(tm.b, qnorm[i], tm.a),
                                             dy2);
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            dvr[d] = fmaf(p, dr[d], dvr[d]);
            dkh[d] = fmaf(dg, qr[d], dkh[d]);
          }
        }
      }
      if (mine) {
        float* mine_p = part + (size_t)t * PS;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          mine_p[d] = dkh[d];
          mine_p[DH + d] = dvr[d];
        }
        if constexpr (M::kBall) mine_p[2 * DH] = dy2;
      }
      __syncthreads();
      if (s == 0 && j < S) {               // the key's sums, in slice order
        for (int sl = 1; sl < y.slices2; ++sl) {
          const float* pr = part + (size_t)(sl * y.keys2 + c) * PS;
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            dkh[d] += pr[d];
            dvr[d] += pr[DH + d];
          }
          if constexpr (M::kBall) dy2 += pr[2 * DH];
        }
        if constexpr (M::kBall)
          ball_end(dkh, kh, dy2, Dh, dk + ko + (size_t)j * Dh);
        else
          normalize_vjp(dkh, kn + j * LD, knorm[j], Dh,
                        dk + ko + (size_t)j * Dh);
#pragma unroll
        for (int d = 0; d < DH; ++d)
          if (d < Dh) dv[ko + (size_t)j * Dh + d] = dvr[d];
      }
      __syncthreads();
    }
  }
}

// the whole-S backward's small-S mode: the body with the mask and no
// validity, oblique (kernel C) or poincaré (2p; C1 its c = 1 form)
template <int DH, bool BALL, bool C1>
__global__ void __launch_bounds__(max_threads<DH, BALL>())
mhgsa_small_bwd_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ mask,
                       const float* __restrict__ dout, float* __restrict__ dq,
                       float* __restrict__ dk, float* __restrict__ dv,
                       float* __restrict__ dmask, int L, int S, int Dh,
                       Layout y, poincare::Curv curv) {
  if constexpr (BALL)
    body<DH, false, Poincare<C1>>(q, k, v, mask, nullptr, dout, dq, dk, dv,
                                  dmask, 1, L, S, Dh, y, curv);
  else
    body<DH, false>(q, k, v, mask, nullptr, dout, dq, dk, dv, dmask, 1, L,
                    S, Dh, y);
}

template <int DH, bool BALL, bool C1>
int launch_dh(const float* q, const float* k, const float* v,
              const float* mask, const float* dout, float* dq, float* dk,
              float* dv, float* dmask, int B, int L, int S, int Dh,
              const poincare::Curv& curv, cudaStream_t stream) {
  const Layout y = layout<DH, false, BALL>(L, S);
  const size_t smem = smem_bytes<DH, false, BALL>(L, S, y);
  cudaError_t err =
      smem_attr::allow(mhgsa_small_bwd_kernel<DH, BALL, C1>, smem);
  if (err != cudaSuccess) return err;
  mhgsa_small_bwd_kernel<DH, BALL, C1><<<B, y.threads, smem, stream>>>(
      q, k, v, mask, dout, dq, dk, dv, dmask, L, S, Dh, y, curv);
  return cudaGetLastError();
}

// the metric's instantiation: 0 oblique, 1 poincaré at curvature c (its
// c = 1 form where c is 1)
template <int DH>
int launch_metric(const float* q, const float* k, const float* v,
                  const float* mask, const float* dout, float* dq, float* dk,
                  float* dv, float* dmask, int B, int L, int S, int Dh,
                  int metric, float c, cudaStream_t stream) {
  if (metric == 0)
    return launch_dh<DH, false, false>(q, k, v, mask, dout, dq, dk, dv,
                                       dmask, B, L, S, Dh, poincare::Curv{},
                                       stream);
  const poincare::Curv curv = poincare::make_curv(c);
  return c == 1.f
             ? launch_dh<DH, true, true>(q, k, v, mask, dout, dq, dk, dv,
                                         dmask, B, L, S, Dh, curv, stream)
             : launch_dh<DH, true, false>(q, k, v, mask, dout, dq, dk, dv,
                                          dmask, B, L, S, Dh, curv, stream);
}

// the head dim a problem runs at (0: beyond the mode's 32)
__host__ __forceinline__ int head_dim(int Dh) {
  return Dh <= 8 ? 8 : Dh <= 16 ? 16 : Dh <= 32 ? 32 : 0;
}

template <int DH, bool VAL, bool BALL = false>
__host__ inline bool fits(int L, int S) {
  return smem_bytes<DH, VAL, BALL>(L, S, layout<DH, VAL, BALL>(L, S)) <=
         kSmemOptin;
}

template <bool BALL>
__host__ inline bool fits_dh(int DH, int L, int S) {
  return DH == 8 ? fits<8, false, BALL>(L, S)
                 : DH == 16 ? fits<16, false, BALL>(L, S)
                            : fits<32, false, BALL>(L, S);
}

// whether the small-S mode takes a problem of L rows, S keys at head dim
// Dh, metric 0 oblique or 1 poincaré (kernels/mhgsa.py::small_bwd_mode is
// its Python form): its staging must fit the H100's 232,448 bytes of
// shared memory a block, and within that the measured crossover of both
// metrics (88 × S² × Dh, PERF.md §6): at Dh ≤ 8 every S, at Dh ≤ 16 from
// S = 16, at Dh ≤ 32 from S = 32
__host__ inline bool mode(int L, int S, int Dh, int metric) {
  const int DH = head_dim(Dh);
  if (DH == 0) return false;
  if (!(metric == 1 ? fits_dh<true>(DH, L, S) : fits_dh<false>(DH, L, S)))
    return false;
  if (STTODE_SMALL_BWD_MODE >= 0) return STTODE_SMALL_BWD_MODE == 1;
  return Dh <= 8 || (Dh <= 16 && S >= 16) || S >= 32;
}

int launch(const float* q, const float* k, const float* v, const float* mask,
           const float* dout, float* dq, float* dk, float* dv, float* dmask,
           int B, int L, int S, int Dh, int metric, float c,
           cudaStream_t stream) {
  switch (head_dim(Dh)) {
    case 8:
      return launch_metric<8>(q, k, v, mask, dout, dq, dk, dv, dmask, B, L,
                              S, Dh, metric, c, stream);
    case 16:
      return launch_metric<16>(q, k, v, mask, dout, dq, dk, dv, dmask, B, L,
                               S, Dh, metric, c, stream);
    case 32:
      return launch_metric<32>(q, k, v, mask, dout, dq, dk, dv, dmask, B, L,
                               S, Dh, metric, c, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace small_bwd
}  // namespace
