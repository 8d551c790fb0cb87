// S-tiled (flash) geodesic attention backward for Hopper (sm_90a), fp32, both
// metrics: the dq sweep and the dk/dv sweep.
//
// Replace the TPU kernels of sttode_tpu/kernels/mhgsa.py::_flash_bwd (:811):
// the dq sweep (kernel body _make_flash_dq_kernel, :681, and for the
// poincaré metric _make_flash_poincare_dq_kernel, :605) and the dk/dv sweep
// (_make_flash_dkv_kernel, :712, and _make_flash_poincare_dkv_kernel,
// :641). Both replay the forward's scores from its per-row lse instead of
// storing the L × S probabilities. With the cotangent do of out:
//
//   p_ij  = exp(s_ij − lse_i)                 (0 where val[b,j] ≤ 0)
//   ds_ij = p_ij (do_i·v_j − δ_i),   δ_i = do_i·out_i (the caller's rowsum)
//   dv_j  = Σ_i p_ij do_i
//
// oblique (x̂ = x / max(‖x‖, 1e-12), g_ij = q̂_i·k̂_j, gc = clip(g, ±(1 −
// 1e-4)), s = −acos(gc)):
//
//   dg_ij = ds_ij / √(1 − gc²) · 1{|g_ij| < 1 − 1e-4}   (the unclipped g)
//   dq̂_i = Σ_j dg_ij k̂_j,   dk̂_j = Σ_i dg_ij q̂_i
//   dq_i  = (dq̂_i − q̂_i (dq̂_i·q̂_i)) / max(‖q_i‖, 1e-12), dk alike;
//
// poincaré (ball points, g_ij = q_i·k_j, the epilogue of poincare.cuh):
//
//   dq_i  = Σ_j dg_ij k_j + 2·dx2_i·q_i,   dk_j = Σ_i dg_ij q_i + 2·dy2_j·k_j
//
// with dx2_i the row sum and dy2_j the column sum of the epilogue's
// squared-norm cotangents (the TPU carries them in (tile, 128) VMEM
// scratch across its sequential grid axis).
//
// What bounds them on the H100: at the NBA recipe at B = 2304 a call is 88
// problems of 2304 × 2304 × 8; each sweep replays the Gram, the score and
// exp of every pair, so together they do 6.3e10 operations on 2.5 MB of
// inputs and outputs (chip_smoke.py, flash_dq_work and flash_dkv_work; the
// poincaré epilogue and its VJP, their metric "poincare", add ~25 per pair
// and sweep): bound by operations, ~0.9 ms at the fp32 peak; in practice
// by issuing each pair's epilogue, whose instructions outnumber its FMAs
// at Dh = 8 (24 in the dq sweep, 32 in the dk/dv sweep). On the TPU each
// sweep is a grid whose innermost axis runs in order and carries the sum in
// VMEM scratch; on Hopper blocks run in parallel, so each sweep gives a
// thread its own output rows and loops over the other axis inside the
// block, and nothing needs atomics or anything of size L·S:
//   dq sweep: a block per (problem, 128·R query rows), a thread per R query
//     rows i holding q̂_i, do_i and dq̂_i in registers; the keys, values and
//     validity are staged a tile at a time in shared memory and read as
//     broadcasts; the q-side normalize VJP ends each row;
//   dk/dv sweep: a block per (problem, 128·R keys), a thread per R keys j
//     holding k̂_j, v_j, dk̂_j and dv_j in registers; the query rows, do,
//     lse and δ are staged a tile at a time; the k-side normalize VJP ends
//     each key;
// the oblique register sweeps (flash_mhgsa_dq_kernel, _dkv_kernel),
// redesigned for the H100:
//   - the epilogue is the TPU kernel's own, oblique.cuh's sweep_p: the
//     A&S 4.4.46 acos with √(1 − |gc|) as x·rsqrt(x), p = exp(−acos − lse)
//     as one ex2 with the row's lse·log2 e folded once a row, and the gate
//     rsqrt(max(1 − gc², 1e-12)) of the unclipped g: three MUFU ops and
//     seven polynomial FMAs a pair, where acosf and expf are long,
//     branchy IEEE sequences;
//   - the other axis is staged raw with cp.async (flash_tile.cuh) and each
//     staged row's unit form computed from shared memory once the tile has
//     landed, a thread a row, dividing by max(‖x‖, 1e-12) as to_unit does;
//   - two rows (keys) a thread at DH ≤ 16, so that each staged row read
//     from shared memory serves two pairs and the rows' independent
//     epilogue chains hide the MUFU latency, with no register cap: the
//     fastest measured (oblique_rows, oblique_min_blocks; PERF.md §6);
//   poincaré (flash_poincare_dq_kernel, flash_poincare_dkv_kernel, below):
//     the same with ball rows and their x2 / y2, the running dx2 / dy2, and
//     the design the section before them describes (two rows per thread,
//     cp.async staging, the SFU epilogue of poincare.cuh); the 2·dx2_i·q_i
//     (2·dy2_j·k_j) term ends the row (key).
// fp32 FMAs throughout, no TF32 (acos' amplifies Gram error near ±1; the
// poincaré x2 − 2g + y2 cancels for close points). The oblique gate is 0
// outside the clip, so q = k rows (g ≈ 1) get an exactly zero, finite
// gradient; poincaré q = k rows stay finite through n ≥ √1e-15; an
// invalid key has p ≡ 0 and zero dk and dv; a row with no valid key gets
// dq = 0. These register kernels hold the head dim rounded up to
// 8/16/32/64/128; a head dim above 128 (JAX pads any Dh to a multiple of
// 128) runs the wide sweeps below, both metrics, which keep the row's
// vectors in shared memory instead.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_tile.cuh"
#include "oblique.cuh"
#include "poincare.cuh"
#include "smem_attr.cuh"

// timing variants of the oblique register sweeps' design (see
// scripts/torch_flash_bench.py): the IEEE epilogue (acosf, expf, rsqrtf, the
// kernels' arithmetic of before) in place of oblique.cuh's; the other axis
// staged through the threads' registers, normalized there, in place of
// cp.async; and at DH ≤ 16 the rows (dq) or keys (dk/dv) a thread owns and
// the launch bounds' minimum of resident blocks an SM, which caps the
// registers (0: the design's, oblique_rows and oblique_min_blocks)
#ifndef STTODE_FLASH_BWD_IEEE_EPILOGUE
#define STTODE_FLASH_BWD_IEEE_EPILOGUE 0
#endif
#ifndef STTODE_FLASH_BWD_REG_STAGING
#define STTODE_FLASH_BWD_REG_STAGING 0
#endif
#ifndef STTODE_FLASH_BWD_ROWS
#define STTODE_FLASH_BWD_ROWS 0
#endif
#ifndef STTODE_FLASH_BWD_MIN_BLOCKS
#define STTODE_FLASH_BWD_MIN_BLOCKS 0
#endif

namespace {

constexpr int kThreads = flash_tile::kThreads;   // row slots per block
constexpr float kNormFloor = 1e-12f;

template <int DH>
__device__ __forceinline__ void load_row(const float* __restrict__ x, int Dh,
                                         float (&r)[DH]) {
#pragma unroll
  for (int d = 0; d < DH; ++d) r[d] = d < Dh ? x[d] : 0.f;
}

// the squared norm of r
template <int DH>
__device__ __forceinline__ float sq_norm(const float (&r)[DH]) {
  float ss = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) ss = fmaf(r[d], r[d], ss);
  return ss;
}

// scale r to unit norm (floored); returns the unfloored norm
template <int DH>
__device__ __forceinline__ float to_unit(float (&r)[DH]) {
  const float n = sqrtf(sq_norm(r));
  const float f = fmaxf(n, kNormFloor);
#pragma unroll
  for (int d = 0; d < DH; ++d) r[d] = r[d] / f;
  return n;
}

// a · b[0..DH) with b a 16-byte aligned row of shared memory
template <int DH>
__device__ __forceinline__ float dot_smem(const float (&a)[DH],
                                          const float* __restrict__ b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DH / 4; ++d) {
    const float4 x = b4[d];
    s = fmaf(a[4 * d], x.x, s);
    s = fmaf(a[4 * d + 1], x.y, s);
    s = fmaf(a[4 * d + 2], x.z, s);
    s = fmaf(a[4 * d + 3], x.w, s);
  }
  return s;
}

// acc += e · b[0..DH)
template <int DH>
__device__ __forceinline__ void axpy_smem(float e, const float* __restrict__ b,
                                          float (&acc)[DH]) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
  for (int d = 0; d < DH / 4; ++d) {
    const float4 x = b4[d];
    acc[4 * d] = fmaf(e, x.x, acc[4 * d]);
    acc[4 * d + 1] = fmaf(e, x.y, acc[4 * d + 1]);
    acc[4 * d + 2] = fmaf(e, x.z, acc[4 * d + 2]);
    acc[4 * d + 3] = fmaf(e, x.w, acc[4 * d + 3]);
  }
}

// (p, dg) of one pair of the wide sweeps from its Gram entry, the row's lse
// and δ and the pair's do·v: the replayed probability and the score-Gram
// cotangent, in IEEE fp32 (the oblique one oblique.cuh's IEEE form).
// Poincaré also takes the pair's x2 and y2 and returns in (a, b) what the
// squared norms' cotangents gather (poincare::grad).
template <bool POINCARE>
__device__ __forceinline__ void pair_grad(float g, float x2, float y2,
                                          float lse, float delta, float dp,
                                          const poincare::Curv& curv,
                                          float* p, float* dg, float* a,
                                          float* b) {
  if (POINCARE) {
    const poincare::Pair pp = poincare::pair(g, x2, y2, curv);
    *p = expf(poincare::score(pp, curv) - lse);
    *dg = poincare::grad(pp, *p * (dp - delta), curv, a, b);
  } else {
    float gate;
    *p = oblique::sweep_p<true>(g, lse, &gate);
    *dg = *p * (dp - delta) * gate;
  }
}

// The row's gradient from its accumulated Gram cotangent dxh, its unit row
// xh and its norm n, written to out[0..Dh): (dx̂ − x̂ (dx̂·x̂)) / max(n, floor).
template <int DH>
__device__ __forceinline__ void finish_row(const float (&dxh)[DH],
                                           const float (&xh)[DH], float n,
                                           int Dh, float* __restrict__ out) {
  float r = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) r = fmaf(dxh[d], xh[d], r);
  const float f = fmaxf(n, kNormFloor);
#pragma unroll
  for (int d = 0; d < DH; ++d)
    if (d < Dh) out[d] = (dxh[d] - xh[d] * r) / f;
}

using flash_tile::cp_async;
using flash_tile::cp_async_commit;
using flash_tile::cp_async_wait;
using flash_tile::sq_norm_smem;
using flash_tile::stage_rows;
using flash_tile::sweep_rows;
using flash_tile::sweep_tile;
using flash_tile::unit_smem;
using flash_tile::vec_rows;

// rows (dq) or keys (dk/dv) an oblique sweep's thread owns, and the minimum
// of resident blocks an SM its launch bounds ask for: the fastest measured
// at the NBA recipe's 88 × 2304² × 8 (PERF.md §6): two rows a thread
// at DH ≤ 16, flash_tile::sweep_rows as in the poincaré sweeps, and no
// minimum (a cap of 4 to 8 blocks an SM, 128 to 64 registers, measured
// level or slower: it trades the rows' independent chains for occupancy);
// a timing variant's defines set them at DH ≤ 16
constexpr int oblique_rows(int dh) {
  return dh <= 16 && STTODE_FLASH_BWD_ROWS ? STTODE_FLASH_BWD_ROWS
                                           : sweep_rows(dh);
}

constexpr int oblique_min_blocks(int dh) {
  return dh <= 16 && STTODE_FLASH_BWD_MIN_BLOCKS ? STTODE_FLASH_BWD_MIN_BLOCKS
                                                 : 1;
}

// floats of shared memory of an oblique sweep: a [T][DH] tile of rows of
// the other axis, its second [T][DH] array (values, or do rows) and two [T]
// arrays (validity as staged and as used, or lse and δ)
template <int DH>
constexpr size_t oblique_sweep_floats() {
  return (size_t)sweep_tile(DH) * (2 * DH + 2);
}

template <int DH, int R, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
flash_mhgsa_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ val,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq,
                      int L, int S, int Dh, int row_tiles) {
  constexpr bool IEEE = STTODE_FLASH_BWD_IEEE_EPILOGUE;
  constexpr int T = sweep_tile(DH);
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // [T][DH] unit keys
  float* vs = ks + T * DH;                // [T][DH] values
  float* vt = vs + T * DH;                // [T] validity, as staged
  float* ok = vt + T;                     // [T] 1 = valid key

  const int t = threadIdx.x;
  const int b = blockIdx.x / row_tiles;
  const int i0 = (blockIdx.x % row_tiles) * kThreads * R + t;
  const float* kb = k + (size_t)b * S * Dh;
  const float* vb = v + (size_t)b * S * Dh;
  const float* valb = val ? val + (size_t)b * S : nullptr;
  const bool vec = vec_rows(kb, vb, Dh);

  // R rows i0 + r·kThreads: q̂_i, do_i, the row's lse·log2 e and δ, dq̂_i
  float qh[R][DH], dor[R][DH], dqh[R][DH], qn[R], lr[R], di[R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * kThreads;
    const size_t ri = (size_t)b * L + i;
    lr[r] = di[r] = 0.f;
    if (i < L) {
      load_row(q + ri * Dh, Dh, qh[r]);
      load_row(dout + ri * Dh, Dh, dor[r]);
      lr[r] = oblique::sweep_row<IEEE>(lse[ri]);
      di[r] = delta[ri];
      any = true;
    } else {
#pragma unroll
      for (int d = 0; d < DH; ++d) qh[r][d] = dor[r][d] = 0.f;
    }
    qn[r] = to_unit(qh[r]);
#pragma unroll
    for (int d = 0; d < DH; ++d) dqh[r][d] = 0.f;
  }

  for (int j0 = 0; j0 < S; j0 += T) {
    const int n = min(T, S - j0);
#if STTODE_FLASH_BWD_REG_STAGING
    if (t < n) {                          // thread t stages key j0 + t
      const int j = j0 + t;
      float x[DH];
      load_row(kb + (size_t)j * Dh, Dh, x);
      to_unit(x);
#pragma unroll
      for (int d = 0; d < DH; ++d) ks[t * DH + d] = x[d];
      load_row(vb + (size_t)j * Dh, Dh, x);
#pragma unroll
      for (int d = 0; d < DH; ++d) vs[t * DH + d] = x[d];
      ok[t] = (valb == nullptr || valb[j] > 0.f) ? 1.f : 0.f;
    }
#else
    stage_rows<DH>(ks, kb + (size_t)j0 * Dh, n, Dh, vec);
    stage_rows<DH>(vs, vb + (size_t)j0 * Dh, n, Dh, vec);
    if (valb != nullptr && t < n) cp_async(vt + t, valb + j0 + t, true, 4);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();                      // the tile has landed
    if (t < n) {
      unit_smem<DH>(ks + t * DH);
      ok[t] = (valb == nullptr || vt[t] > 0.f) ? 1.f : 0.f;
    }
#endif
    __syncthreads();
    if (any) {
      for (int jj = 0; jj < n; ++jj) {
        if (ok[jj] == 0.f) continue;      // the same key for every thread
        const float* kr = ks + jj * DH;
        const float* vr = vs + jj * DH;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float gate;
          const float p = oblique::sweep_p<IEEE>(dot_smem(qh[r], kr), lr[r],
                                                 &gate);
          const float dg = p * (dot_smem(dor[r], vr) - di[r]) * gate;
          axpy_smem(dg, kr, dqh[r]);
        }
      }
    }
    __syncthreads();                      // the tile is consumed
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * kThreads;
    if (i < L)
      finish_row<DH>(dqh[r], qh[r], qn[r], Dh, dq + ((size_t)b * L + i) * Dh);
  }
}

template <int DH, int R, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
flash_mhgsa_dkv_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ val,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int L,
                       int S, int Dh, int col_tiles) {
  constexpr bool IEEE = STTODE_FLASH_BWD_IEEE_EPILOGUE;
  constexpr int T = sweep_tile(DH);
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [T][DH] unit query rows
  float* ds = qs + T * DH;                // [T][DH] their do rows
  float* ls = ds + T * DH;                // [T] lse, then its lse·log2 e
  float* dl = ls + T;                     // [T] δ

  const int t = threadIdx.x;
  const int b = blockIdx.x / col_tiles;
  const int j0 = (blockIdx.x % col_tiles) * kThreads * R + t;
  const float* qb = q + (size_t)b * L * Dh;
  const float* db = dout + (size_t)b * L * Dh;
  const bool vec = vec_rows(qb, db, Dh);

  // R keys j0 + r·kThreads: k̂_j, v_j and the running dk̂_j and dv_j
  float kh[R][DH], vr[R][DH], dkh[R][DH], dva[R][DH], kn[R];
  bool live[R], any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + r * kThreads;
    const size_t rj = (size_t)b * S + j;
    live[r] = j < S && (val == nullptr || val[rj] > 0.f);
    any |= live[r];
    if (j < S) {
      load_row(k + rj * Dh, Dh, kh[r]);
      load_row(v + rj * Dh, Dh, vr[r]);
    } else {
#pragma unroll
      for (int d = 0; d < DH; ++d) kh[r][d] = vr[r][d] = 0.f;
    }
    kn[r] = to_unit(kh[r]);
#pragma unroll
    for (int d = 0; d < DH; ++d) dkh[r][d] = dva[r][d] = 0.f;
  }

  for (int i0 = 0; i0 < L; i0 += T) {
    const int n = min(T, L - i0);
#if STTODE_FLASH_BWD_REG_STAGING
    if (t < n) {                          // thread t stages row i0 + t
      const size_t ri = (size_t)b * L + i0 + t;
      float x[DH];
      load_row(q + ri * Dh, Dh, x);
      to_unit(x);
#pragma unroll
      for (int d = 0; d < DH; ++d) qs[t * DH + d] = x[d];
      load_row(dout + ri * Dh, Dh, x);
#pragma unroll
      for (int d = 0; d < DH; ++d) ds[t * DH + d] = x[d];
      ls[t] = oblique::sweep_row<IEEE>(lse[ri]);
      dl[t] = delta[ri];
    }
#else
    stage_rows<DH>(qs, qb + (size_t)i0 * Dh, n, Dh, vec);
    stage_rows<DH>(ds, db + (size_t)i0 * Dh, n, Dh, vec);
    if (t < n) {
      const size_t ri = (size_t)b * L + i0 + t;
      cp_async(ls + t, lse + ri, true, 4);
      cp_async(dl + t, delta + ri, true, 4);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();                      // the tile has landed
    if (t < n) {
      unit_smem<DH>(qs + t * DH);
      ls[t] = oblique::sweep_row<IEEE>(ls[t]);
    }
#endif
    __syncthreads();
    if (any) {
      for (int ii = 0; ii < n; ++ii) {
        const float* qr = qs + ii * DH;
        const float* dr = ds + ii * DH;
        const float li = ls[ii], di = dl[ii];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float gate;
          const float p = oblique::sweep_p<IEEE>(dot_smem(kh[r], qr), li,
                                                 &gate);
          const float dg = p * (dot_smem(vr[r], dr) - di) * gate;
          axpy_smem(p, dr, dva[r]);
          axpy_smem(dg, qr, dkh[r]);
        }
      }
    }
    __syncthreads();                      // the tile is consumed
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + r * kThreads;
    if (j >= S) continue;
    const size_t rj = (size_t)b * S + j;
    // an invalid key has p ≡ 0: exact zeros
    if (live[r]) {
      finish_row<DH>(dkh[r], kh[r], kn[r], Dh, dk + rj * Dh);
    } else {
#pragma unroll
      for (int d = 0; d < DH; ++d)
        if (d < Dh) dk[rj * Dh + d] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < DH; ++d)
      if (d < Dh) dv[rj * Dh + d] = live[r] ? dva[r][d] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// The poincaré register sweeps (head dims up to 128), redesigned for the
// H100. Both replay each pair's epilogue, and at the NBA recipe's Dh = 8 a
// pair's FMAs (the Gram, do·v and the accumulations, 24–32) are few beside
// its epilogue, so the sweeps are bound by issuing the epilogue's
// instructions, not by memory or the FMA rate. So:
//   - the epilogue is poincare::sweep_grad, on the SFU's native reciprocal,
//     rsqrt, log2 and exp2 (three to five MUFU ops and ~45 other
//     instructions a pair, against six IEEE divisions, sqrtf, logf and
//     expf), with no log or exp at all at c = 1 (a template parameter
//     chosen at launch from the curvature's value);
//   - each thread owns sweep_rows(DH) output rows (dq) or keys (dk/dv), so
//     each staged row read from shared memory serves that many pairs, and
//     the rows' independent epilogue chains hide the MUFU latency;
//   - the other axis is staged with cp.async, raw, into a ring of kStages
//     tiles of shared memory, with no registers or instructions of the
//     threads; the squared norms (and the rows' lse constants) are
//     computed from shared memory once a tile has landed. One stage: a
//     second, which overlaps the next tile's copies with this tile's pairs,
//     measured no faster at the recipe's c = 1, Dh = 8 (PERF.md §6, PR 7).
// The rows a thread owns, the tile and the cp.async staging are
// flash_tile.cuh's, which the poincaré forward shares.

constexpr int kStages = 1;

// floats of shared memory of a poincaré sweep: the ring's stages, each two
// [T][DH] arrays and `scalars` [T] arrays staged raw, and two [T] arrays
// derived once a tile has landed
template <int DH>
constexpr size_t poincare_sweep_floats(int scalars) {
  return (size_t)sweep_tile(DH) * (kStages * (2 * DH + scalars) + 2);
}

template <int DH, int R, bool C1>
__global__ void __launch_bounds__(kThreads)
flash_poincare_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ val,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int L, int S, int Dh,
                         int row_tiles, poincare::Curv curv) {
  constexpr int T = sweep_tile(DH);
  constexpr int kStage = T * (2 * DH + 1);
  extern __shared__ __align__(16) float smem[];
  float* y2 = smem;                       // [T] ‖k_j‖² of the tile
  float* ok = y2 + T;                     // [T] 1 = valid key
  float* ring = ok + T;                   // [kStages] × (keys [T][DH],
                                          //   values [T][DH], validity [T])

  const int t = threadIdx.x;
  const int b = blockIdx.x / row_tiles;
  const int i0 = (blockIdx.x % row_tiles) * kThreads * R + t;
  const float* kb = k + (size_t)b * S * Dh;
  const float* vb = v + (size_t)b * S * Dh;
  const float* valb = val ? val + (size_t)b * S : nullptr;
  const bool vec = vec_rows(kb, vb, Dh);

  // R rows i0 + r·kThreads: the ball row, do, and the running dq and dx2
  float qb[R][DH], dor[R][DH], dqa[R][DH], x2[R], lr[R], di[R], dx2[R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * kThreads;
    const size_t ri = (size_t)b * L + i;
    lr[r] = di[r] = dx2[r] = 0.f;
    if (i < L) {
      load_row(q + ri * Dh, Dh, qb[r]);
      load_row(dout + ri * Dh, Dh, dor[r]);
      lr[r] = poincare::sweep_row<C1>(lse[ri]);
      di[r] = delta[ri];
      any = true;
    } else {
#pragma unroll
      for (int d = 0; d < DH; ++d) qb[r][d] = dor[r][d] = 0.f;
    }
    x2[r] = sq_norm(qb[r]);
#pragma unroll
    for (int d = 0; d < DH; ++d) dqa[r][d] = 0.f;
  }

  const int tiles = (S + T - 1) / T;
  auto stage = [&](int it) {
    float* st = ring + (it % kStages) * kStage;
    const int j0 = it * T, n = min(T, S - j0);
    stage_rows<DH>(st, kb + (size_t)j0 * Dh, n, Dh, vec);
    stage_rows<DH>(st + T * DH, vb + (size_t)j0 * Dh, n, Dh, vec);
    if (valb != nullptr && t < n) cp_async(st + 2 * T * DH + t, valb + j0 + t,
                                           true, 4);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) stage(s);
    cp_async_commit();
  }
  for (int it = 0; it < tiles; ++it) {
    if (it + kStages - 1 < tiles) stage(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();                      // tile `it` has landed
    const float* ks = ring + (it % kStages) * kStage;
    const float* vs = ks + T * DH;
    const int n = min(T, S - it * T);
    if (t < n) {
      y2[t] = sq_norm_smem<DH>(ks + t * DH);
      ok[t] = (valb == nullptr || vs[T * DH + t] > 0.f) ? 1.f : 0.f;
    }
    __syncthreads();
    if (any) {
      for (int jj = 0; jj < n; ++jj) {
        if (ok[jj] == 0.f) continue;      // the same key for every thread
        const float* kr = ks + jj * DH;
        const float* vr = vs + jj * DH;
        const float yj = y2[jj];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float p, a, bb;
          const float dg = poincare::sweep_grad<C1>(
              dot_smem(qb[r], kr), x2[r], yj, lr[r], di[r],
              dot_smem(dor[r], vr), curv, &p, &a, &bb);
          dx2[r] += a + bb * yj;
          axpy_smem(dg, kr, dqa[r]);
        }
      }
    }
    __syncthreads();                      // tile `it` is consumed
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * kThreads;
    if (i >= L) continue;
    float* out = dq + ((size_t)b * L + i) * Dh;
#pragma unroll
    for (int d = 0; d < DH; ++d)
      if (d < Dh) out[d] = dqa[r][d] + 2.f * dx2[r] * qb[r][d];
  }
}

template <int DH, int R, bool C1>
__global__ void __launch_bounds__(kThreads)
flash_poincare_dkv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ val,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int L, int S, int Dh, int col_tiles,
                          poincare::Curv curv) {
  constexpr int T = sweep_tile(DH);
  constexpr int kStage = T * (2 * DH + 2);
  extern __shared__ __align__(16) float smem[];
  float* x2 = smem;                       // [T] ‖q_i‖² of the tile
  float* lr = x2 + T;                     // [T] sweep_row(lse_i)
  float* ring = lr + T;                   // [kStages] × (ball rows [T][DH],
                                          //   do rows [T][DH], lse [T], δ [T])

  const int t = threadIdx.x;
  const int b = blockIdx.x / col_tiles;
  const int j0 = (blockIdx.x % col_tiles) * kThreads * R + t;
  const float* qb = q + (size_t)b * L * Dh;
  const float* db = dout + (size_t)b * L * Dh;
  const bool vec = vec_rows(qb, db, Dh);

  // R keys j0 + r·kThreads: the ball row, v, and the running dk, dv, dy2
  float kb[R][DH], vr[R][DH], dka[R][DH], dva[R][DH], y2[R], dy2[R];
  bool live[R], any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + r * kThreads;
    const size_t rj = (size_t)b * S + j;
    live[r] = j < S && (val == nullptr || val[rj] > 0.f);
    any |= live[r];
    if (j < S) {
      load_row(k + rj * Dh, Dh, kb[r]);
      load_row(v + rj * Dh, Dh, vr[r]);
    } else {
#pragma unroll
      for (int d = 0; d < DH; ++d) kb[r][d] = vr[r][d] = 0.f;
    }
    y2[r] = sq_norm(kb[r]);
    dy2[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) dka[r][d] = dva[r][d] = 0.f;
  }

  const int tiles = (L + T - 1) / T;
  auto stage = [&](int it) {
    float* st = ring + (it % kStages) * kStage;
    const int i0 = it * T, n = min(T, L - i0);
    stage_rows<DH>(st, qb + (size_t)i0 * Dh, n, Dh, vec);
    stage_rows<DH>(st + T * DH, db + (size_t)i0 * Dh, n, Dh, vec);
    if (t < n) {
      const size_t ri = (size_t)b * L + i0 + t;
      cp_async(st + 2 * T * DH + t, lse + ri, true, 4);
      cp_async(st + 2 * T * DH + T + t, delta + ri, true, 4);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) stage(s);
    cp_async_commit();
  }
  for (int it = 0; it < tiles; ++it) {
    if (it + kStages - 1 < tiles) stage(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();                      // tile `it` has landed
    const float* qs = ring + (it % kStages) * kStage;
    const float* ds = qs + T * DH;
    const float* dl = ds + T * DH + T;
    const int n = min(T, L - it * T);
    if (t < n) {
      x2[t] = sq_norm_smem<DH>(qs + t * DH);
      lr[t] = poincare::sweep_row<C1>(ds[T * DH + t]);
    }
    __syncthreads();
    if (any) {
      for (int ii = 0; ii < n; ++ii) {
        const float* qr = qs + ii * DH;
        const float* dr = ds + ii * DH;
        const float xi = x2[ii], li = lr[ii], di = dl[ii];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float p, a, bb;
          const float dg = poincare::sweep_grad<C1>(
              dot_smem(kb[r], qr), xi, y2[r], li, di, dot_smem(vr[r], dr),
              curv, &p, &a, &bb);
          dy2[r] += a + bb * xi;
          axpy_smem(p, dr, dva[r]);
          axpy_smem(dg, qr, dka[r]);
        }
      }
    }
    __syncthreads();                      // tile `it` is consumed
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + r * kThreads;
    if (j >= S) continue;
    const size_t rj = (size_t)b * S + j;
    // an invalid key has p ≡ 0: exact zeros
#pragma unroll
    for (int d = 0; d < DH; ++d)
      if (d < Dh) {
        dk[rj * Dh + d] = live[r] ? dka[r][d] + 2.f * dy2[r] * kb[r][d] : 0.f;
        dv[rj * Dh + d] = live[r] ? dva[r][d] : 0.f;
      }
  }
}

// ---------------------------------------------------------------------------
// Head dims above 128: the row's vectors would not fit a thread's registers,
// so both sweeps keep them in shared memory (sized by Dh, `rows` rows per
// block) and give a warp one output row at a time and a lane one row of the
// other axis of a `tile` ≤ 32 tile: lane jj's Gram and do·v are dot products
// over staged rows (an odd stride, conflict-free), pair_grad turns them into
// (p, dg), the warp's row of shared memory holds them, and the lanes then
// split the head dim to accumulate. The same functions, validity and
// finishing as the register kernels above.

constexpr int kWideWarps = 4;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage row x[0..Dh) into dst, unit-normalized (oblique) or raw (poincaré),
// a warp's lanes over the head dim; returns the norm (oblique, unfloored)
// or the squared norm (poincaré) to every lane.
template <bool POINCARE>
__device__ __forceinline__ float stage_row(const float* __restrict__ x,
                                           int Dh, float* __restrict__ dst,
                                           int lane) {
  float ss = 0.f;
  for (int d = lane; d < Dh; d += 32) ss = fmaf(x[d], x[d], ss);
  ss = warp_sum(ss);
  const float n = POINCARE ? ss : sqrtf(ss);
  const float f = POINCARE ? 1.f : fmaxf(n, kNormFloor);
  for (int d = lane; d < Dh; d += 32) dst[d] = POINCARE ? x[d] : x[d] / f;
  return n;
}

// finish_row for a row in shared memory, a warp's lanes over the head dim
template <bool POINCARE>
__device__ __forceinline__ void finish_row_warp(const float* __restrict__ dxh,
                                                const float* __restrict__ xh,
                                                float n, int Dh,
                                                float* __restrict__ out,
                                                int lane) {
  if (POINCARE) {
    for (int d = lane; d < Dh; d += 32) out[d] = dxh[d] + 2.f * n * xh[d];
    return;
  }
  float r = 0.f;
  for (int d = lane; d < Dh; d += 32) r = fmaf(dxh[d], xh[d], r);
  r = warp_sum(r);
  const float f = fmaxf(n, kNormFloor);
  for (int d = lane; d < Dh; d += 32) out[d] = (dxh[d] - xh[d] * r) / f;
}

inline size_t wide_dq_floats(int rows, int tile, int Dh) {
  return 3 * (size_t)rows * Dh + 4 * (size_t)rows
         + (size_t)tile * (2 * (Dh | 1) + 2) + (size_t)kWideWarps * tile;
}

inline size_t wide_dkv_floats(int rows, int tile, int Dh) {
  return 4 * (size_t)rows * Dh + 3 * (size_t)rows
         + (size_t)tile * (2 * (Dh | 1) + 3) + 2 * (size_t)kWideWarps * tile;
}

template <bool POINCARE>
__global__ void __launch_bounds__(kWideWarps * 32)
wide_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ val,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dq, int L,
               int S, int Dh, int rows, int tile, int row_tiles,
               poincare::Curv curv) {
  extern __shared__ __align__(16) float smem[];
  const int ld = Dh | 1;
  float* qs = smem;                       // [rows][Dh] unit (ball) q rows
  float* dos = qs + rows * Dh;            // [rows][Dh] do rows
  float* dqh = dos + rows * Dh;           // [rows][Dh] dq̂ accumulators
  float* qn = dqh + rows * Dh;            // [rows] norm (poincaré: x2)
  float* li = qn + rows;                  // [rows] lse
  float* di = li + rows;                  // [rows] δ
  float* dx2 = di + rows;                 // [rows] poincaré: Σ dx2
  float* ks = dx2 + rows;                 // [tile][ld] unit (ball) keys
  float* vs = ks + tile * ld;             // [tile][ld] values
  float* y2 = vs + tile * ld;             // [tile] poincaré: ‖k_j‖²
  float* ok = y2 + tile;                  // [tile] 1 = valid key
  float* pg = ok + tile;                  // [kWideWarps][tile] dg of a row

  const int b = blockIdx.x / row_tiles;
  const int i0 = (blockIdx.x % row_tiles) * rows;
  const int nr = min(rows, L - i0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* kb = k + (size_t)b * S * Dh;
  const float* vb = v + (size_t)b * S * Dh;
  const float* valb = val ? val + (size_t)b * S : nullptr;

  for (int r = warp; r < nr; r += kWideWarps) {
    const size_t ri = (size_t)b * L + i0 + r;
    const float n = stage_row<POINCARE>(q + ri * Dh, Dh, qs + r * Dh, lane);
    for (int d = lane; d < Dh; d += 32) {
      dos[r * Dh + d] = dout[ri * Dh + d];
      dqh[r * Dh + d] = 0.f;
    }
    if (lane == 0) {
      qn[r] = n;
      li[r] = lse[ri];
      di[r] = delta[ri];
      dx2[r] = 0.f;
    }
  }

  float* pw = pg + warp * tile;
  for (int j0 = 0; j0 < S; j0 += tile) {
    const int n = min(tile, S - j0);
    __syncthreads();                      // the previous tile is consumed
    for (int jj = warp; jj < n; jj += kWideWarps) {
      const size_t j = (size_t)j0 + jj;
      const float kn = stage_row<POINCARE>(kb + j * Dh, Dh, ks + jj * ld,
                                           lane);
      for (int d = lane; d < Dh; d += 32) vs[jj * ld + d] = vb[j * Dh + d];
      if (lane == 0) {
        y2[jj] = kn;
        ok[jj] = (valb == nullptr || valb[j] > 0.f) ? 1.f : 0.f;
      }
    }
    __syncthreads();
    for (int r = warp; r < nr; r += kWideWarps) {
      const float* qr = qs + r * Dh;
      const float* dr = dos + r * Dh;
      float dg = 0.f, part = 0.f;
      if (lane < n && ok[lane] != 0.f) {
        const float* kr = ks + lane * ld;
        const float* vr = vs + lane * ld;
        float g = 0.f, dp = 0.f;
        for (int d = 0; d < Dh; ++d) {
          g = fmaf(qr[d], kr[d], g);
          dp = fmaf(dr[d], vr[d], dp);
        }
        const float yj = POINCARE ? y2[lane] : 0.f;
        float p, a = 0.f, bb = 0.f;
        pair_grad<POINCARE>(g, qn[r], yj, li[r], di[r], dp, curv, &p, &dg,
                            &a, &bb);
        part = a + bb * yj;
      }
      if (lane < n) pw[lane] = dg;
      if (POINCARE) {
        part = warp_sum(part);
        if (lane == 0) dx2[r] += part;
      }
      __syncwarp();
      float* ar = dqh + r * Dh;
      for (int d = lane; d < Dh; d += 32) {
        float a = ar[d];
        for (int jj = 0; jj < n; ++jj) a = fmaf(pw[jj], ks[jj * ld + d], a);
        ar[d] = a;
      }
      __syncwarp();
    }
  }
  __syncwarp();
  for (int r = warp; r < nr; r += kWideWarps)
    finish_row_warp<POINCARE>(dqh + r * Dh, qs + r * Dh,
                              POINCARE ? dx2[r] : qn[r], Dh,
                              dq + ((size_t)b * L + i0 + r) * Dh, lane);
}

template <bool POINCARE>
__global__ void __launch_bounds__(kWideWarps * 32)
wide_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ val,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int L, int S, int Dh, int rows,
                int tile, int col_tiles, poincare::Curv curv) {
  extern __shared__ __align__(16) float smem[];
  const int ld = Dh | 1;
  float* kh = smem;                       // [rows][Dh] unit (ball) keys
  float* vr = kh + rows * Dh;             // [rows][Dh] values
  float* dkh = vr + rows * Dh;            // [rows][Dh] dk̂ accumulators
  float* dvr = dkh + rows * Dh;           // [rows][Dh] dv accumulators
  float* kn = dvr + rows * Dh;            // [rows] norm (poincaré: y2)
  float* dy2 = kn + rows;                 // [rows] poincaré: Σ dy2
  float* live = dy2 + rows;               // [rows] 1 = a valid key
  float* qs = live + rows;                // [tile][ld] unit (ball) q rows
  float* ds = qs + tile * ld;             // [tile][ld] their do rows
  float* ls = ds + tile * ld;             // [tile] lse
  float* dl = ls + tile;                  // [tile] δ
  float* x2 = dl + tile;                  // [tile] poincaré: ‖q_i‖²
  float* pp = x2 + tile;                  // [kWideWarps][tile] p of a key
  float* pg = pp + kWideWarps * tile;     // [kWideWarps][tile] dg of a key

  const int b = blockIdx.x / col_tiles;
  const int j0 = (blockIdx.x % col_tiles) * rows;
  const int nc = min(rows, S - j0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qo = (size_t)b * L;

  for (int r = warp; r < nc; r += kWideWarps) {
    const size_t rj = (size_t)b * S + j0 + r;
    const float n = stage_row<POINCARE>(k + rj * Dh, Dh, kh + r * Dh, lane);
    for (int d = lane; d < Dh; d += 32) {
      vr[r * Dh + d] = v[rj * Dh + d];
      dkh[r * Dh + d] = 0.f;
      dvr[r * Dh + d] = 0.f;
    }
    if (lane == 0) {
      kn[r] = n;
      dy2[r] = 0.f;
      live[r] = (val == nullptr || val[rj] > 0.f) ? 1.f : 0.f;
    }
  }

  float* pw = pp + warp * tile;
  float* gw = pg + warp * tile;
  for (int i0 = 0; i0 < L; i0 += tile) {
    const int n = min(tile, L - i0);
    __syncthreads();                      // the previous tile is consumed
    for (int ii = warp; ii < n; ii += kWideWarps) {
      const size_t ri = qo + i0 + ii;
      const float qn = stage_row<POINCARE>(q + ri * Dh, Dh, qs + ii * ld,
                                           lane);
      for (int d = lane; d < Dh; d += 32) ds[ii * ld + d] = dout[ri * Dh + d];
      if (lane == 0) {
        x2[ii] = qn;
        ls[ii] = lse[ri];
        dl[ii] = delta[ri];
      }
    }
    __syncthreads();
    for (int r = warp; r < nc; r += kWideWarps) {
      if (live[r] == 0.f) continue;       // warp-uniform
      const float* kr = kh + r * Dh;
      const float* vv = vr + r * Dh;
      float p = 0.f, dg = 0.f, part = 0.f;
      if (lane < n) {
        const float* qr = qs + lane * ld;
        const float* dr = ds + lane * ld;
        float g = 0.f, dp = 0.f;
        for (int d = 0; d < Dh; ++d) {
          g = fmaf(kr[d], qr[d], g);
          dp = fmaf(vv[d], dr[d], dp);
        }
        const float xi = POINCARE ? x2[lane] : 0.f;
        float a = 0.f, bb = 0.f;
        pair_grad<POINCARE>(g, xi, kn[r], ls[lane], dl[lane], dp, curv, &p,
                            &dg, &a, &bb);
        part = a + bb * xi;
        pw[lane] = p;
        gw[lane] = dg;
      }
      if (POINCARE) {
        part = warp_sum(part);
        if (lane == 0) dy2[r] += part;
      }
      __syncwarp();
      float* ak = dkh + r * Dh;
      float* av = dvr + r * Dh;
      for (int d = lane; d < Dh; d += 32) {
        float a = ak[d], c = av[d];
        for (int ii = 0; ii < n; ++ii) {
          a = fmaf(gw[ii], qs[ii * ld + d], a);
          c = fmaf(pw[ii], ds[ii * ld + d], c);
        }
        ak[d] = a;
        av[d] = c;
      }
      __syncwarp();
    }
  }
  __syncwarp();
  for (int r = warp; r < nc; r += kWideWarps) {
    const size_t rj = (size_t)b * S + j0 + r;
    finish_row_warp<POINCARE>(dkh + r * Dh, kh + r * Dh,
                              POINCARE ? dy2[r] : kn[r], Dh, dk + rj * Dh,
                              lane);
    for (int d = lane; d < Dh; d += 32) dv[rj * Dh + d] = dvr[r * Dh + d];
  }
}

// The largest (rows, tile) — rows from 16 down to kWideWarps, then tile
// from 32 down to 1 — whose `floats(rows, tile, Dh)` fit the block's opt-in
// shared memory; false when none does.
template <typename Floats>
int wide_config(Floats floats, int Dh, int* rows, int* tile, size_t* smem) {
  int max_smem = 0;
  cudaError_t err = smem_attr::optin_limit(&max_smem);
  if (err != cudaSuccess) return err;
  for (int r = 16; r >= kWideWarps; r /= 2)
    for (int t = 32; t >= 1; t /= 2) {
      *smem = sizeof(float) * floats(r, t, Dh);
      if (*smem <= (size_t)max_smem) {
        *rows = r;
        *tile = t;
        return cudaSuccess;
      }
    }
  return cudaErrorInvalidValue;
}

template <bool POINCARE>
int launch_wide_dq(const float* q, const float* k, const float* v,
                   const float* val, const float* dout, const float* lse,
                   const float* delta, float* dq, int B, int L, int S, int Dh,
                   float c, cudaStream_t stream) {
  int rows = 0, tile = 0;
  size_t smem = 0;
  int err = wide_config(wide_dq_floats, Dh, &rows, &tile, &smem);
  if (err != cudaSuccess) return err;
  err = smem_attr::allow(wide_dq_kernel<POINCARE>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (L + rows - 1) / rows;
  const long long blocks = (long long)B * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  wide_dq_kernel<POINCARE><<<(unsigned)blocks, kWideWarps * 32, smem,
                             stream>>>(q, k, v, val, dout, lse, delta, dq, L,
                                       S, Dh, rows, tile, tiles,
                                       poincare::make_curv(c));
  return cudaGetLastError();
}

template <bool POINCARE>
int launch_wide_dkv(const float* q, const float* k, const float* v,
                    const float* val, const float* dout, const float* lse,
                    const float* delta, float* dk, float* dv, int B, int L,
                    int S, int Dh, float c, cudaStream_t stream) {
  int rows = 0, tile = 0;
  size_t smem = 0;
  int err = wide_config(wide_dkv_floats, Dh, &rows, &tile, &smem);
  if (err != cudaSuccess) return err;
  err = smem_attr::allow(wide_dkv_kernel<POINCARE>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (S + rows - 1) / rows;
  const long long blocks = (long long)B * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  wide_dkv_kernel<POINCARE><<<(unsigned)blocks, kWideWarps * 32, smem,
                              stream>>>(q, k, v, val, dout, lse, delta, dk,
                                        dv, L, S, Dh, rows, tile, tiles,
                                        poincare::make_curv(c));
  return cudaGetLastError();
}

template <int DH>
int launch_dq(const float* q, const float* k, const float* v,
              const float* val, const float* dout, const float* lse,
              const float* delta, float* dq, int B, int L, int S, int Dh,
              cudaStream_t stream) {
  constexpr int R = oblique_rows(DH);
  constexpr int MINB = oblique_min_blocks(DH);
  constexpr size_t smem = sizeof(float) * oblique_sweep_floats<DH>();
  int err = smem_attr::allow(flash_mhgsa_dq_kernel<DH, R, MINB>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (L + kThreads * R - 1) / (kThreads * R);
  const long long blocks = (long long)B * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_mhgsa_dq_kernel<DH, R, MINB>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
          q, k, v, val, dout, lse, delta, dq, L, S, Dh, tiles);
  return cudaGetLastError();
}

template <int DH>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* val, const float* dout, const float* lse,
               const float* delta, float* dk, float* dv, int B, int L, int S,
               int Dh, cudaStream_t stream) {
  constexpr int R = oblique_rows(DH);
  constexpr int MINB = oblique_min_blocks(DH);
  constexpr size_t smem = sizeof(float) * oblique_sweep_floats<DH>();
  int err = smem_attr::allow(flash_mhgsa_dkv_kernel<DH, R, MINB>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kThreads * R - 1) / (kThreads * R);
  const long long blocks = (long long)B * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_mhgsa_dkv_kernel<DH, R, MINB>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
          q, k, v, val, dout, lse, delta, dk, dv, L, S, Dh, tiles);
  return cudaGetLastError();
}

template <int DH, bool C1>
int launch_poincare_dq(const float* q, const float* k, const float* v,
                       const float* val, const float* dout, const float* lse,
                       const float* delta, float* dq, int B, int L, int S,
                       int Dh, float c, cudaStream_t stream) {
  constexpr int R = sweep_rows(DH);
  constexpr size_t smem = sizeof(float) * poincare_sweep_floats<DH>(1);
  int err = smem_attr::allow(flash_poincare_dq_kernel<DH, R, C1>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (L + kThreads * R - 1) / (kThreads * R);
  const long long blocks = (long long)B * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_poincare_dq_kernel<DH, R, C1>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
          q, k, v, val, dout, lse, delta, dq, L, S, Dh, tiles,
          poincare::make_curv(c));
  return cudaGetLastError();
}

template <int DH, bool C1>
int launch_poincare_dkv(const float* q, const float* k, const float* v,
                        const float* val, const float* dout,
                        const float* lse, const float* delta, float* dk,
                        float* dv, int B, int L, int S, int Dh, float c,
                        cudaStream_t stream) {
  constexpr int R = sweep_rows(DH);
  constexpr size_t smem = sizeof(float) * poincare_sweep_floats<DH>(2);
  int err = smem_attr::allow(flash_poincare_dkv_kernel<DH, R, C1>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kThreads * R - 1) / (kThreads * R);
  const long long blocks = (long long)B * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_poincare_dkv_kernel<DH, R, C1>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
          q, k, v, val, dout, lse, delta, dk, dv, L, S, Dh, tiles,
          poincare::make_curv(c));
  return cudaGetLastError();
}

int dispatch_dq(const float* q, const float* k, const float* v,
                const float* val, const float* dout, const float* lse,
                const float* delta, float* dq, int B, int L, int S, int Dh,
                cudaStream_t st) {
  if (Dh <= 8)
    return launch_dq<8>(q, k, v, val, dout, lse, delta, dq, B, L, S, Dh, st);
  if (Dh <= 16)
    return launch_dq<16>(q, k, v, val, dout, lse, delta, dq, B, L, S, Dh, st);
  if (Dh <= 32)
    return launch_dq<32>(q, k, v, val, dout, lse, delta, dq, B, L, S, Dh, st);
  if (Dh <= 64)
    return launch_dq<64>(q, k, v, val, dout, lse, delta, dq, B, L, S, Dh, st);
  if (Dh <= 128)
    return launch_dq<128>(q, k, v, val, dout, lse, delta, dq, B, L, S, Dh,
                          st);
  return launch_wide_dq<false>(q, k, v, val, dout, lse, delta, dq, B, L, S,
                               Dh, 1.f, st);
}

// C1: the curvature is 1 (the sweeps' c = 1 form)
template <bool C1>
int dispatch_poincare_dq(const float* q, const float* k, const float* v,
                         const float* val, const float* dout,
                         const float* lse, const float* delta, float* dq,
                         int B, int L, int S, int Dh, float c,
                         cudaStream_t st) {
  if (Dh <= 8)
    return launch_poincare_dq<8, C1>(q, k, v, val, dout, lse, delta, dq, B,
                                     L, S, Dh, c, st);
  if (Dh <= 16)
    return launch_poincare_dq<16, C1>(q, k, v, val, dout, lse, delta, dq, B,
                                      L, S, Dh, c, st);
  if (Dh <= 32)
    return launch_poincare_dq<32, C1>(q, k, v, val, dout, lse, delta, dq, B,
                                      L, S, Dh, c, st);
  if (Dh <= 64)
    return launch_poincare_dq<64, C1>(q, k, v, val, dout, lse, delta, dq, B,
                                      L, S, Dh, c, st);
  if (Dh <= 128)
    return launch_poincare_dq<128, C1>(q, k, v, val, dout, lse, delta, dq, B,
                                       L, S, Dh, c, st);
  return launch_wide_dq<true>(q, k, v, val, dout, lse, delta, dq, B, L, S,
                              Dh, c, st);
}

int dispatch_dkv(const float* q, const float* k, const float* v,
                 const float* val, const float* dout, const float* lse,
                 const float* delta, float* dk, float* dv, int B, int L,
                 int S, int Dh, cudaStream_t st) {
  if (Dh <= 8)
    return launch_dkv<8>(q, k, v, val, dout, lse, delta, dk, dv, B, L, S, Dh,
                         st);
  if (Dh <= 16)
    return launch_dkv<16>(q, k, v, val, dout, lse, delta, dk, dv, B, L, S,
                          Dh, st);
  if (Dh <= 32)
    return launch_dkv<32>(q, k, v, val, dout, lse, delta, dk, dv, B, L, S,
                          Dh, st);
  if (Dh <= 64)
    return launch_dkv<64>(q, k, v, val, dout, lse, delta, dk, dv, B, L, S,
                          Dh, st);
  if (Dh <= 128)
    return launch_dkv<128>(q, k, v, val, dout, lse, delta, dk, dv, B, L, S,
                           Dh, st);
  return launch_wide_dkv<false>(q, k, v, val, dout, lse, delta, dk, dv, B, L,
                                S, Dh, 1.f, st);
}

template <bool C1>
int dispatch_poincare_dkv(const float* q, const float* k, const float* v,
                          const float* val, const float* dout,
                          const float* lse, const float* delta, float* dk,
                          float* dv, int B, int L, int S, int Dh, float c,
                          cudaStream_t st) {
  if (Dh <= 8)
    return launch_poincare_dkv<8, C1>(q, k, v, val, dout, lse, delta, dk, dv,
                                      B, L, S, Dh, c, st);
  if (Dh <= 16)
    return launch_poincare_dkv<16, C1>(q, k, v, val, dout, lse, delta, dk,
                                       dv, B, L, S, Dh, c, st);
  if (Dh <= 32)
    return launch_poincare_dkv<32, C1>(q, k, v, val, dout, lse, delta, dk,
                                       dv, B, L, S, Dh, c, st);
  if (Dh <= 64)
    return launch_poincare_dkv<64, C1>(q, k, v, val, dout, lse, delta, dk,
                                       dv, B, L, S, Dh, c, st);
  if (Dh <= 128)
    return launch_poincare_dkv<128, C1>(q, k, v, val, dout, lse, delta, dk,
                                        dv, B, L, S, Dh, c, st);
  return launch_wide_dkv<true>(q, k, v, val, dout, lse, delta, dk, dv, B, L,
                               S, Dh, c, st);
}

}  // namespace

// The dq sweep. q [B,L,Dh], k/v [B,S,Dh], val [B,S] (> 0 marks a real key)
// or null, dout [B,L,Dh], lse and delta [B,L]; output dq [B,L,Dh]. All fp32,
// contiguous, on the current device; metric 0 = oblique, 1 = poincaré at
// curvature c (q and k ball points). Launches on `stream` and returns
// cudaGetLastError() (0 on success). Any head dim from 1 to the wide
// sweeps' shared-memory limit (~4,300 for dk/dv) runs; another metric is
// refused with cudaErrorInvalidValue.
extern "C" int flash_mhgsa_dq(const float* q, const float* k, const float* v,
                              const float* val, const float* dout,
                              const float* lse, const float* delta, float* dq,
                              int B, int L, int S, int Dh, int metric,
                              float c, void* stream) {
  if (B < 0 || L < 0 || S < 0 || Dh < 1 || (metric != 0 && metric != 1))
    return cudaErrorInvalidValue;
  if (B == 0 || L == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (metric == 0)
    return dispatch_dq(q, k, v, val, dout, lse, delta, dq, B, L, S, Dh, st);
  return c == 1.f ? dispatch_poincare_dq<true>(q, k, v, val, dout, lse,
                                               delta, dq, B, L, S, Dh, c, st)
                  : dispatch_poincare_dq<false>(q, k, v, val, dout, lse,
                                                delta, dq, B, L, S, Dh, c,
                                                st);
}

// The dk/dv sweep: the same operands; outputs dk and dv [B,S,Dh].
extern "C" int flash_mhgsa_dkv(const float* q, const float* k, const float* v,
                               const float* val, const float* dout,
                               const float* lse, const float* delta,
                               float* dk, float* dv, int B, int L, int S,
                               int Dh, int metric, float c, void* stream) {
  if (B < 0 || L < 0 || S < 0 || Dh < 1 || (metric != 0 && metric != 1))
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (metric == 0)
    return dispatch_dkv(q, k, v, val, dout, lse, delta, dk, dv, B, L, S, Dh,
                        st);
  return c == 1.f ? dispatch_poincare_dkv<true>(q, k, v, val, dout, lse,
                                                delta, dk, dv, B, L, S, Dh, c,
                                                st)
                  : dispatch_poincare_dkv<false>(q, k, v, val, dout, lse,
                                                 delta, dk, dv, B, L, S, Dh,
                                                 c, st);
}
