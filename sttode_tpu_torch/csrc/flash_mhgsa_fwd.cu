// S-tiled (flash) geodesic attention forward for Hopper (sm_90a), fp32, both
// metrics.
//
// Replaces the TPU kernel sttode_tpu/kernels/mhgsa.py::_flash_fwd (kernel
// body _make_flash_fwd_kernel, :558), both of its metrics. For each problem
// b and query row i:
//
//   e_ij     = exp(s_ij)                    (0 where val[b,j] ≤ 0)
//   l_i      = max(Σ_j e_ij, 1e-30)
//   out[b,i] = Σ_j e_ij v[b,j] / l_i,    lse[b,i] = log(l_i)
//
// with the oblique score s_ij = −acos(clip(q̂_i·k̂_j, ±(1 − 1e-4))),
// x̂ = x / max(‖x‖, 1e-12), or the poincaré score of ball points at
// curvature c (poincare.cuh; the TPU body's poincaré branch, :584-588).
// The scores are bounded (oblique in [−π, 0], poincaré in [−12.21/√c, 0]
// with c ≥ 0.032), so the streaming softmax needs no running max and no
// rescaling (as on the TPU): Σ e and Σ e·v accumulate over the key tiles and
// one division ends the row. An invalid key adds nothing; a row with no
// valid key outputs exactly 0 with lse = log(1e-30). The per-row lse is what
// the backward sweeps (flash_mhgsa_bwd.cu) replay the scores from.
//
// What bounds it on the H100: at the NBA recipe at B = 2304 a call is 88
// problems of 2304 × 2304 × 8 — 1.4 MB in and out but 1.8e10 operations
// (chip_smoke.py, flash_fwd_work; the poincaré epilogue, its metric
// "poincare", adds ~16 per pair), so it is bound by operations: 0.26 ms at
// the fp32 peak; in practice by issuing each pair's epilogue, whose
// instructions outnumber its 16 FMAs (the Gram and p·V) at Dh = 8. Unlike
// the whole-S kernel (mhgsa_fwd.cu), which stages every key of a problem in
// shared memory and refuses S > 2765 at Dh = 8, this one streams them, so
// any L and S run.
//
// One register kernel serves both metrics (flash_fwd_kernel), designed for
// the H100; a metric is a policy (ObliqueFwd, PoincareFwd) that says how a
// query row is held, what is derived from a staged key and the pair weight:
//   - a block per (problem, 128·R query rows), a thread per R query rows i
//     holding the row (q̂_i, or the ball row and its x2) and the running
//     Σ e·v and Σ e in registers (the head dim rounded up to a compile-time
//     8/16/32/64/128);
//   - the keys, values and validity are staged raw with cp.async,
//     flash_tile::sweep_tile(DH) keys at a time, and what a pair needs of a
//     key computed from shared memory once the tile has landed, a thread a
//     key: its unit form k̂_j (flash_tile::unit_smem, dividing by
//     max(‖k‖, 1e-12) as the rows do) or its squared norm y2; every thread
//     then reads the same key, a broadcast with no bank conflict;
//   - the epilogue runs on the SFU: oblique, oblique.cuh's weight, the TPU
//     kernel's own (the A&S 4.4.46 acos with √x as x·rsqrt(x), one ex2; a
//     negative Gram takes e^(−π)·2^(acos|gc|·log2 e)), so that the forward
//     and the sweeps that replay its lse share one acos, as on the TPU;
//     poincaré, poincare::fwd_weight: zc from poincare::pair in IEEE fp32
//     (its division and sqrtf: near the ball's edge 1 − zc magnifies zc's
//     rounding, PERF.md §6), then the tail on the SFU — at c = 1 one
//     reciprocal and no log or exp, else rcp, lg2 and ex2 — with C1 a
//     template parameter chosen at launch from the curvature's value; the
//     row's lse = logf(l) stays IEEE, once a row;
//   - rows a thread and the launch bounds' minimum of resident blocks an SM
//     (which caps the registers) are each metric's fastest measured at the
//     recipe's shape (fwd_rows, fwd_min_blocks; PERF.md §6): poincaré one
//     row a thread held to 64 registers at DH ≤ 8, so that 8 blocks stay
//     resident (two rows took 102 registers and measured 1.27× slower);
//     oblique two rows a thread held to 80 registers, 6 blocks an SM.
// F as a kernel of its own measured level with its instantiation here
// (0.8 % apart, PERF.md §6), so the two metrics share this one kernel.
// A head dim above 128 (JAX pads any Dh to a multiple of 128) would not fit
// a thread's registers: both metrics run the key-streaming forward of
// stream_fwd.cuh instead — a warp per query row, q and the accumulator in
// shared memory, a lane per key of a 32-key tile — the same function with
// the validity and the lse, for any Dh up to ~5,800. The Gram uses fp32
// FMAs, no TF32 and no tensor cores: acos' amplifies Gram error near ±1, the
// poincaré x2 − 2g + y2 cancels for close points (the TPU kernel's
// compensated 3-pass bf16 Gram, kept at HIGHEST for the poincaré scores, is
// an MXU device; the card's analogue, tf32x3 mma, is later work).
//
// The score orientation is scores[i,j] = score(q_i, k_j); the
// reference-compat transposed square case (quirk Q3) is the caller swapping
// q and k.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_tile.cuh"
#include "oblique.cuh"
#include "poincare.cuh"
#include "smem_attr.cuh"
#include "stream_fwd.cuh"

// timing variants of the register forward's design, both metrics (see
// scripts/torch_flash_bench.py for F, scripts/torch_3p_c_bench.py for 3p):
// the IEEE epilogue (oblique acosf and expf, the kernel's arithmetic of
// before; poincaré poincare::pair, score and expf) in place of the SFU
// one; each key staged through a thread's registers, normalized there, in
// place of cp.async; and at DH ≤ 16 the query rows a thread owns and the
// minimum of resident blocks per SM in the launch bounds, which caps the
// registers (0: the design's, fwd_rows and fwd_min_blocks)
#ifndef STTODE_FLASH_FWD_IEEE_EPILOGUE
#define STTODE_FLASH_FWD_IEEE_EPILOGUE 0
#endif
#ifndef STTODE_FLASH_FWD_ROWS
#define STTODE_FLASH_FWD_ROWS 0
#endif
#ifndef STTODE_FLASH_FWD_REG_STAGING
#define STTODE_FLASH_FWD_REG_STAGING 0
#endif
#ifndef STTODE_FLASH_FWD_MIN_BLOCKS
#define STTODE_FLASH_FWD_MIN_BLOCKS 0
#endif

namespace {

constexpr int kThreads = flash_tile::kThreads;   // row slots per block
constexpr float kDenFloor = 1e-30f;
constexpr bool kIEEE = STTODE_FLASH_FWD_IEEE_EPILOGUE;

// r = x[0..Dh) zero-padded to DH, scaled to unit norm (norm floored), or
// kept RAW (poincaré ball rows); returns the squared norm
template <int DH, bool RAW>
__device__ __forceinline__ float load_row(const float* __restrict__ x, int Dh,
                                          float (&r)[DH]) {
  float ss = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    r[d] = d < Dh ? x[d] : 0.f;
    ss = fmaf(r[d], r[d], ss);
  }
  if (!RAW) {
    const float f = fmaxf(sqrtf(ss), flash_tile::kNormFloor);
#pragma unroll
    for (int d = 0; d < DH; ++d) r[d] = r[d] / f;
  }
  return ss;
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

// The metric policies of flash_fwd_kernel. kRaw: rows and keys stay raw
// ball points and a pair takes the rows' squared norms x2, y2 (poincaré);
// else both are scaled to unit norm and the squared norms go unused
// (oblique). weight(g, x2, y2) is the pair's e = exp(s).
struct ObliqueFwd {
  static constexpr bool kRaw = false;
  __device__ __forceinline__ float weight(float g, float, float) const {
    return oblique::weight<kIEEE>(g);
  }
};

template <bool C1>
struct PoincareFwd {
  static constexpr bool kRaw = true;
  poincare::Curv c;
  __device__ __forceinline__ float weight(float g, float x2, float y2) const {
    if (kIEEE) return expf(poincare::score(poincare::pair(g, x2, y2, c), c));
    return poincare::fwd_weight<C1>(g, x2, y2, c);
  }
};

// query rows a thread and the minimum of resident blocks an SM its launch
// bounds ask for, each metric's fastest measured at the NBA recipe's
// 88 × 2304² × 8 (PERF.md §6); a timing variant's defines set them at
// DH ≤ 16.
// - Poincaré (3p): one row, 8 blocks at DH ≤ 8 (64 registers a thread, no
//   spills: 32 warps an SM); two rows took 102 registers and lost 27 %.
// - Oblique (F): two rows at DH ≤ 16, each staged key serving two pairs,
//   and 6 blocks at DH ≤ 8 (80 registers): the recipe's 792 blocks then
//   run in one wave of 6 an SM, where uncapped (92 registers, 5 an SM) a
//   second wave of 132 blocks trails, 5 % slower; one row a thread was
//   5–16 % slower at every cap.
template <class M>
__host__ __device__ constexpr int fwd_rows(int dh) {
  return dh <= 16 && STTODE_FLASH_FWD_ROWS ? STTODE_FLASH_FWD_ROWS
         : M::kRaw                         ? 1
         : dh <= 16                        ? 2
                                           : 1;
}

template <class M>
__host__ __device__ constexpr int fwd_min_blocks(int dh) {
  return dh <= 16 && STTODE_FLASH_FWD_MIN_BLOCKS ? STTODE_FLASH_FWD_MIN_BLOCKS
         : dh > 8                                ? 1
         : M::kRaw                               ? 8
                                                 : 6;
}

// the register forward: R query rows a thread (rows i0 + r·kThreads), the
// keys, values and validity staged raw with cp.async, T at a time
template <int DH, int R, int MINB, class M>
__global__ void __launch_bounds__(kThreads, MINB)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ val,
                 float* __restrict__ out, float* __restrict__ lse, int L,
                 int S, int Dh, int row_tiles, M m) {
  constexpr int T = flash_tile::sweep_tile(DH);
  extern __shared__ __align__(16) float smem[];
  float* y2 = smem;                       // [T] ‖k_j‖² of the tile (kRaw)
  float* ok = y2 + T;                     // [T] 1 = valid key
  float* ks = ok + T;                     // [T][DH] keys (unit or ball)
  float* vs = ks + T * DH;                // [T][DH] values
  float* vt = vs + T * DH;                // [T] validity, as staged

  const int t = threadIdx.x;
  const int b = blockIdx.x / row_tiles;
  const int i0 = (blockIdx.x % row_tiles) * kThreads * R + t;
  const float* kb = k + (size_t)b * S * Dh;
  const float* vb = v + (size_t)b * S * Dh;
  const float* valb = val ? val + (size_t)b * S : nullptr;
  const bool vec = flash_tile::vec_rows(kb, vb, Dh);

  // R rows: the row (q̂ or the ball row), its x2, the running Σ e·v and Σ e
  float qr[R][DH], acc[R][DH], x2[R], l[R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * kThreads;
    if (i < L) {
      x2[r] = load_row<DH, M::kRaw>(q + ((size_t)b * L + i) * Dh, Dh,
                                    qr[r]);
      any = true;
    } else {
      x2[r] = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) qr[r][d] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[r][d] = 0.f;
    l[r] = 0.f;
  }

  for (int j0 = 0; j0 < S; j0 += T) {
    const int n = min(T, S - j0);
#if STTODE_FLASH_FWD_REG_STAGING
    if (t < n) {                          // thread t stages key j0 + t
      const int j = j0 + t;
      float kr[DH];
      const float ss = load_row<DH, M::kRaw>(kb + (size_t)j * Dh, Dh, kr);
      if (M::kRaw) y2[t] = ss;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        ks[t * DH + d] = kr[d];
        vs[t * DH + d] = d < Dh ? vb[(size_t)j * Dh + d] : 0.f;
      }
      ok[t] = (valb == nullptr || valb[j] > 0.f) ? 1.f : 0.f;
    }
    __syncthreads();
#else
    flash_tile::stage_rows<DH>(ks, kb + (size_t)j0 * Dh, n, Dh, vec);
    flash_tile::stage_rows<DH>(vs, vb + (size_t)j0 * Dh, n, Dh, vec);
    if (valb != nullptr && t < n)
      flash_tile::cp_async(vt + t, valb + j0 + t, true, 4);
    flash_tile::cp_async_commit();
    flash_tile::cp_async_wait<0>();
    __syncthreads();                      // the tile has landed
    if (t < n) {
      if (M::kRaw)
        y2[t] = flash_tile::sq_norm_smem<DH>(ks + t * DH);
      else
        flash_tile::unit_smem<DH>(ks + t * DH);
      ok[t] = (valb == nullptr || vt[t] > 0.f) ? 1.f : 0.f;
    }
    __syncthreads();
#endif
    if (any) {
      for (int jj = 0; jj < n; ++jj) {
        if (ok[jj] == 0.f) continue;      // the same key for every thread
        const float* kr = ks + jj * DH;
        const float* vr = vs + jj * DH;
        const float yj = M::kRaw ? y2[jj] : 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float e = m.weight(dot_smem(qr[r], kr), x2[r], yj);
          l[r] += e;
          axpy_smem(e, vr, acc[r]);
        }
      }
    }
    __syncthreads();                      // the tile is consumed
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * kThreads;
    if (i >= L) continue;
    const float lf = fmaxf(l[r], kDenFloor);
    float* o = out + ((size_t)b * L + i) * Dh;
#pragma unroll
    for (int d = 0; d < DH; ++d)
      if (d < Dh) o[d] = acc[r][d] / lf;
    lse[(size_t)b * L + i] = logf(lf);
  }
}

template <int DH, class M>
int launch(const float* q, const float* k, const float* v, const float* val,
           float* out, float* lse, int B, int L, int S, int Dh, M m,
           cudaStream_t stream) {
  constexpr int R = fwd_rows<M>(DH);
  constexpr int MINB = fwd_min_blocks<M>(DH);
  constexpr size_t smem =
      sizeof(float) * flash_tile::sweep_tile(DH) * (2 * DH + 3);
  const int row_tiles = (L + kThreads * R - 1) / (kThreads * R);
  const long long blocks = (long long)B * row_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = smem_attr::allow(flash_fwd_kernel<DH, R, MINB, M>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<DH, R, MINB, M>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
          q, k, v, val, out, lse, L, S, Dh, row_tiles, m);
  return cudaGetLastError();
}

// the register forward at the head dim rounded up to 8/16/32/64/128, or the
// key-streaming one above 128
template <class M>
int dispatch(const float* q, const float* k, const float* v, const float* val,
             float* out, float* lse, int B, int L, int S, int Dh, M m,
             float c, cudaStream_t st) {
  if (Dh <= 8) return launch<8>(q, k, v, val, out, lse, B, L, S, Dh, m, st);
  if (Dh <= 16) return launch<16>(q, k, v, val, out, lse, B, L, S, Dh, m, st);
  if (Dh <= 32) return launch<32>(q, k, v, val, out, lse, B, L, S, Dh, m, st);
  if (Dh <= 64) return launch<64>(q, k, v, val, out, lse, B, L, S, Dh, m, st);
  if (Dh <= 128)
    return launch<128>(q, k, v, val, out, lse, B, L, S, Dh, m, st);
  return stream_fwd::launch<M::kRaw>(q, k, v, nullptr, val, out, lse, B, L,
                                     S, Dh, c, st);
}

}  // namespace

// q [B,L,Dh], k/v [B,S,Dh], val [B,S] (key validity: > 0 marks a real key)
// or null; outputs out [B,L,Dh] and lse [B,L]. All fp32, contiguous, on the
// current device; metric 0 = oblique, 1 = poincaré at curvature c (q and k
// ball points). Launches on `stream` and returns cudaGetLastError() (0 on
// success). Any L and S run, and any head dim from 1 to the key-streaming
// mode's shared-memory limit (~5,800); another metric is refused with
// cudaErrorInvalidValue.
extern "C" int flash_mhgsa_fwd(const float* q, const float* k, const float* v,
                               const float* val, float* out, float* lse,
                               int B, int L, int S, int Dh, int metric,
                               float c, void* stream) {
  if (B < 0 || L < 0 || S < 0 || Dh < 1 || (metric != 0 && metric != 1))
    return cudaErrorInvalidValue;
  if (B == 0 || L == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (metric == 0)
    return dispatch(q, k, v, val, out, lse, B, L, S, Dh, ObliqueFwd{}, 1.f,
                    st);
  const poincare::Curv curv = poincare::make_curv(c);
  return c == 1.f ? dispatch(q, k, v, val, out, lse, B, L, S, Dh,
                             PoincareFwd<true>{curv}, c, st)
                  : dispatch(q, k, v, val, out, lse, B, L, S, Dh,
                             PoincareFwd<false>{curv}, c, st);
}
