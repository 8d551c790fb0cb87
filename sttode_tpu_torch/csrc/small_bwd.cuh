// Small-S mode of the oblique whole-S attention backward (mhgsa_bwd.cu,
// kernel C at the shapes small_bwd::mode takes): the function of
// mhgsa_bwd.cu's header, for the oblique metric, with the same contract
// (masks, dmask, an all-excluded row's exactly zero gradient). The packed
// backward (packed_mhgsa_bwd.cu, kernel Q) runs the same body with a key
// validity in place of the mask: e_ij = exp(−acos(gc_ij))·val[b, j], the
// row val[p / H] of a problem's batch row staged once into shared memory,
// no mask and no dmask; an all-invalid problem gets exactly zero gradients.
//
// What bounds it on the H100: at the bench recipe a call is 88 problems of
// 128 × 128 × 8, ~130 M operations on 2.5 MB, about two microseconds of the
// card's fp32 rate; the kernel of before (one warp per row or key, a lane
// per head-dim entry) left 24 of 32 lanes idle at Dh = 8 and ran serial
// chains of S (and L) FMAs through shared memory, 166–205 µs (PERF.md §6).
// Here:
// - one block per problem, so that the block holds every row's denominator
//   and δ before pass 2 and the k-side normalize VJP sees the whole dk̂:
//   no atomics, and the summation order is the same on every run;
// - pass 1, threads own query rows (lane = row; `rows1` at a time) and the
//   keys are split across warps into `slices1` slices (key j ≡ slice mod
//   slices1), q̂_i, do_i and the row's sums in registers. Since
//   ds = p (dp − δ) and δ = Σ_j p dp, one pass over the keys gives
//   den = Σ e, Σ e·dp, A = Σ gate·e·dp·k̂_j and B = Σ gate·e·k̂_j, all linear
//   in the keys, so the slices' partial sums add once through shared
//   memory; then δ = Σ e·dp / den and dq̂_i = (A − δ·B) / den, and the
//   q-side normalize VJP ends the row;
// - pass 2, threads own keys (`keys2` at a time) and the rows are split
//   into `slices2` slices, k̂_j, v_j and the running dk̂_j and dv_j in
//   registers; each pair replays p = e / den_i and ds = p (dp − δ_i) (and
//   writes dmask = ds, lanes on consecutive keys); the slices' partials
//   add through shared memory and the k-side normalize VJP ends the key;
// - the staged rows are read as broadcasts (a warp shares its slice) from
//   rows padded to an odd stride; no lane idles on the head dim and no
//   chain of S runs through shared memory;
// - the epilogue is the TPU kernel's own (sttode_tpu/kernels/mhgsa.py:
//   _acos, :121, the scores at :183, the gate at :360), oblique.cuh's
//   pair_terms: acos from the Abramowitz & Stegun 4.4.46 polynomial with
//   √(1 − |g|) as x·rsqrt(x), the exp (of the score plus the mask entry) as
//   one ex2 on the SFU, and the clip gate rsqrt(max(1 − gc², 1e-12)) of the
//   unclipped test |g| < 1 − 1e-4.
// The Gram stays fp32 FMAs (acos' amplifies Gram error near ±1). The
// poincaré instantiation (2p) keeps mhgsa_bwd.cu's kernel.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "oblique.cuh"
#include "smem_attr.cuh"

// timing variants of the design (see scripts/torch_3p_c_bench.py): the mode
// (-1 where mode() says, the default; 0 never; 1 wherever it fits), the
// IEEE epilogue (acosf, expf, rsqrtf) in place of the SFU one, and one
// slice (each thread all the keys of its row, then all the rows of its key)
#ifndef STTODE_SMALL_BWD_MODE
#define STTODE_SMALL_BWD_MODE -1
#endif
#ifndef STTODE_SMALL_BWD_IEEE_EPILOGUE
#define STTODE_SMALL_BWD_IEEE_EPILOGUE 0
#endif
#ifndef STTODE_SMALL_BWD_ONE_SLICE
#define STTODE_SMALL_BWD_ONE_SLICE 0
#endif
// and the threads of a block at Dh ≤ 8 (0: the design's, max_threads)
#ifndef STTODE_SMALL_BWD_THREADS_DH8
#define STTODE_SMALL_BWD_THREADS_DH8 0
#endif

// internal linkage: each including source keeps its own copy
namespace {
namespace small_bwd {

constexpr float kNormFloor = 1e-12f;
constexpr float kDenFloor = 1e-30f;
constexpr int kKeysPerThread = 4;
constexpr size_t kSmemOptin = 232448;  // H100: shared memory a block

// threads of a block at most: 1024 at Dh ≤ 8, 512 at 16, 256 at 32 (a
// thread holds four DH-vectors in registers in either pass)
template <int DH>
__host__ __device__ constexpr int max_threads() {
  return DH <= 8 ? (STTODE_SMALL_BWD_THREADS_DH8 ? STTODE_SMALL_BWD_THREADS_DH8
                                                 : 1024)
                 : DH <= 16 ? 512 : 256;
}

__host__ __device__ constexpr int ld(int dh) { return dh | 1; }

// floats a thread leaves for the slices' combine: pass 1 2·DH + 2, pass 2
// 2·DH, at an odd stride
__host__ __device__ constexpr int part_stride(int dh) { return 2 * dh + 3; }

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
// two, in whole warps. nt is max_threads<DH>(), halved while the block's
// shared memory (smem_bytes) would pass the H100's 232,448 bytes.
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

// shared memory of a block: q̂, do [L][ld], k̂, v [S][ld], ‖q‖, 1/den, δ [L],
// ‖k‖ [S], with VAL the key validity [S], and the slices' partial sums
template <int DH, bool VAL>
__host__ __device__ size_t smem_bytes(int L, int S, const Layout& y) {
  const int n1 = y.rows1 * y.slices1, n2 = y.keys2 * y.slices2;
  return sizeof(float) *
         (2 * ((size_t)L + S) * ld(DH) + 3 * (size_t)L + (VAL ? 2 : 1) *
          (size_t)S + (size_t)(n1 > n2 ? n1 : n2) * part_stride(DH));
}

template <int DH, bool VAL>
__host__ __device__ Layout layout(int L, int S) {
  int nt = max_threads<DH>();
  Layout y = layout_of<DH>(L, S, nt);
  while (nt > 32 && smem_bytes<DH, VAL>(L, S, y) > kSmemOptin)
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

// The block's work on problem blockIdx.x: q [·,L,Dh], k/v [·,S,Dh], dout
// [·,L,Dh], the additive mask [·,L,S] (canonicalized) or null, and with VAL
// the key validity val [·/H, S] (a problem's batch row p / H; null: every
// key valid) multiplying each pair's e; dq, dk, dv and, where dmask is not
// null, dmask [·,L,S].
template <int DH, bool VAL>
__device__ __forceinline__ void body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ mask,
    const float* __restrict__ val, const float* __restrict__ dout,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dmask, int H, int L, int S, int Dh, Layout y) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = ld(DH);
  constexpr int PS = part_stride(DH);
  float* qn = smem;                       // [L][LD] q̂
  float* dos = qn + L * LD;               // [L][LD] do
  float* kn = dos + L * LD;               // [S][LD] k̂
  float* vs = kn + S * LD;                // [S][LD] v
  float* qnorm = vs + S * LD;             // [L] ‖q_i‖
  float* rden = qnorm + L;                // [L] 1 / den_i
  float* delta = rden + L;                // [L] δ_i
  float* knorm = delta + L;               // [S] ‖k_j‖
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
      qnorm[r] = stage_row<DH, true>(q + qo + (size_t)r * Dh, Dh,
                                     qn + r * LD);
      stage_row<DH, false>(dout + qo + (size_t)r * Dh, Dh, dos + r * LD);
    } else {
      const int j = r - L;
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
      float den = 0.f, edp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) A[d] = Bv[d] = 0.f;
      if (mine && i < L) {
        load(qn + i * LD, qh);
        load(dos + i * LD, dr);
        const float* mrow = mp ? mp + (size_t)i * S : nullptr;
        for (int j = s; j < S; j += y.slices1) {
          const float* kr = kn + j * LD;
          const float g = dot(qh, kr);
          const float dp = dot(dr, vs + j * LD);
          float e, gate;
          pair_terms(g, mrow ? __ldg(mrow + j) : 0.f, &e, &gate);
          if (VAL) e *= kval[j];
          den += e;
          edp = fmaf(e, dp, edp);
          const float w = gate * e, wd = w * dp;
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
        }
        const float dn = fmaxf(den, kDenFloor);
        const float dl = edp / dn;
        float dqh[DH];
#pragma unroll
        for (int d = 0; d < DH; ++d) dqh[d] = (A[d] - dl * Bv[d]) / dn;
        normalize_vjp(dqh, qn + i * LD, qnorm[i], Dh, dq + qo + (size_t)i * Dh);
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
#pragma unroll
      for (int d = 0; d < DH; ++d) dkh[d] = dvr[d] = 0.f;
      if (mine && j < S) {
        load(kn + j * LD, kh);
        load(vs + j * LD, vr);
        const float vj = VAL ? kval[j] : 1.f;
        for (int i = s; i < L; i += y.slices2) {
          const float* qr = qn + i * LD;
          const float* dr = dos + i * LD;
          float g = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            g = fmaf(qr[d], kh[d], g);
            dp = fmaf(dr[d], vr[d], dp);
          }
          float e, gate;
          pair_terms(g, mp ? __ldg(mp + (size_t)i * S + j) : 0.f, &e, &gate);
          if (VAL) e *= vj;
          const float p = e * rden[i];
          const float ds = p * (dp - delta[i]);
          if (dmp) dmp[(size_t)i * S + j] = ds;
          const float dg = gate * ds;
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
        }
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

// kernel C's small-S mode: the body with the mask and no validity
template <int DH>
__global__ void __launch_bounds__(max_threads<DH>())
mhgsa_small_bwd_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ mask,
                       const float* __restrict__ dout, float* __restrict__ dq,
                       float* __restrict__ dk, float* __restrict__ dv,
                       float* __restrict__ dmask, int L, int S, int Dh,
                       Layout y) {
  body<DH, false>(q, k, v, mask, nullptr, dout, dq, dk, dv, dmask, 1, L, S,
                  Dh, y);
}

template <int DH>
int launch_dh(const float* q, const float* k, const float* v,
              const float* mask, const float* dout, float* dq, float* dk,
              float* dv, float* dmask, int B, int L, int S, int Dh,
              cudaStream_t stream) {
  const Layout y = layout<DH, false>(L, S);
  const size_t smem = smem_bytes<DH, false>(L, S, y);
  cudaError_t err = smem_attr::allow(mhgsa_small_bwd_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  mhgsa_small_bwd_kernel<DH><<<B, y.threads, smem, stream>>>(
      q, k, v, mask, dout, dq, dk, dv, dmask, L, S, Dh, y);
  return cudaGetLastError();
}

// the head dim a problem runs at (0: beyond the mode's 32)
__host__ __forceinline__ int head_dim(int Dh) {
  return Dh <= 8 ? 8 : Dh <= 16 ? 16 : Dh <= 32 ? 32 : 0;
}

template <int DH, bool VAL>
__host__ inline bool fits(int L, int S) {
  return smem_bytes<DH, VAL>(L, S, layout<DH, VAL>(L, S)) <= kSmemOptin;
}

// whether the small-S mode takes an oblique problem of L rows, S keys at
// head dim Dh (kernels/mhgsa.py::small_bwd_mode is its Python form): its
// staging must fit the H100's 232,448 bytes of shared memory a block, and
// within that the measured crossover (88 × S² × Dh, PERF.md §6): at
// Dh ≤ 8 every S, at Dh ≤ 16 from S = 16, at Dh ≤ 32 from S = 32
__host__ inline bool mode(int L, int S, int Dh) {
  const int DH = head_dim(Dh);
  if (DH == 0) return false;
  if (!(DH == 8 ? fits<8, false>(L, S) : DH == 16 ? fits<16, false>(L, S)
                                                  : fits<32, false>(L, S)))
    return false;
  if (STTODE_SMALL_BWD_MODE >= 0) return STTODE_SMALL_BWD_MODE == 1;
  return Dh <= 8 || (Dh <= 16 && S >= 16) || S >= 32;
}

int launch(const float* q, const float* k, const float* v, const float* mask,
           const float* dout, float* dq, float* dk, float* dv, float* dmask,
           int B, int L, int S, int Dh, cudaStream_t stream) {
  switch (head_dim(Dh)) {
    case 8:
      return launch_dh<8>(q, k, v, mask, dout, dq, dk, dv, dmask, B, L, S,
                          Dh, stream);
    case 16:
      return launch_dh<16>(q, k, v, mask, dout, dq, dk, dv, dmask, B, L, S,
                           Dh, stream);
    case 32:
      return launch_dh<32>(q, k, v, mask, dout, dq, dk, dv, dmask, B, L, S,
                           Dh, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace small_bwd
}  // namespace
