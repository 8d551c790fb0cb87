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
// "poincare", adds ~16 per pair), so it is bound by operations: 0.26 ms at the
// fp32 peak, and acosf alone — or the poincaré epilogue's sqrtf, logf and
// two divisions — costs tens of instructions per pair. Unlike the whole-S
// kernel (mhgsa_fwd.cu), which stages every key of a problem in shared
// memory and refuses S > 2765 at Dh = 8, this one streams them, so any L
// and S run. Design: a block per (problem, tile of 128 query rows), one
// thread per row; q̂_i (or the ball row and its x2) and the output
// accumulator live in registers (the head dim rounded up to a compile-time
// 8/16/32/64/128); the keys are normalized (or, poincaré, kept raw with
// their squared norms y2) and staged with their values 128 at a time in
// shared memory, each thread staging one key, and every thread then reads
// the same key, a broadcast with no bank conflict and no reduction in the
// inner loop. A head dim above 128 (JAX pads any Dh to a multiple of 128)
// would not fit a thread's registers: it runs the key-streaming forward of
// stream_fwd.cuh instead — a warp per query row, q and the accumulator in
// shared memory, a lane per key of a 32-key tile — the same function with
// the validity and the lse, for any Dh up to ~5,800. The Gram uses fp32 FMAs, no TF32 and no tensor cores: acos'
// amplifies Gram error near ±1, the poincaré x2 − 2g + y2 cancels for close
// points (the TPU kernel's compensated 3-pass bf16 Gram, kept at HIGHEST
// for the poincaré scores, is an MXU device; the card's analogue, tf32x3
// mma, is later work). acosf and logf are CUDA's (≤ 2 ulp), where the TPU
// needed a polynomial for acos. The metric is a template parameter: the
// oblique instantiation is the kernel of before.
//
// The score orientation is scores[i,j] = score(q_i, k_j); the
// reference-compat transposed square case (quirk Q3) is the caller swapping
// q and k.

#include <cuda_runtime.h>
#include <math.h>

#include "poincare.cuh"
#include "smem_attr.cuh"
#include "stream_fwd.cuh"

namespace {

constexpr int kThreads = 128;          // query rows per block
constexpr int kTile = kThreads;        // keys staged per step, one per thread
constexpr float kClip = 0.9999f;       // 1 - 1e-4
constexpr float kNormFloor = 1e-12f;
constexpr float kDenFloor = 1e-30f;

// r = x[0..Dh) zero-padded to DH, scaled to unit norm (norm floored) for
// oblique, kept raw for poincaré; returns the squared norm
template <int DH, bool POINCARE>
__device__ __forceinline__ float load_row(const float* __restrict__ x, int Dh,
                                          float (&r)[DH]) {
  float ss = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    r[d] = d < Dh ? x[d] : 0.f;
    ss = fmaf(r[d], r[d], ss);
  }
  if (!POINCARE) {
    const float f = fmaxf(sqrtf(ss), kNormFloor);
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

template <int DH, bool POINCARE>
__global__ void __launch_bounds__(kThreads)
flash_mhgsa_fwd_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ val, float* __restrict__ out,
                       float* __restrict__ lse, int L, int S, int Dh,
                       int row_tiles, poincare::Curv curv) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // [kTile][DH] unit (ball) keys
  float* vs = ks + kTile * DH;            // [kTile][DH] values
  float* ok = vs + kTile * DH;            // [kTile] 1 = valid key
  float* y2 = ok + kTile;                 // [kTile] poincaré: ‖k_j‖²

  const int t = threadIdx.x;
  const int b = blockIdx.x / row_tiles;
  const int i = (blockIdx.x % row_tiles) * kThreads + t;
  const bool row = i < L;
  const float* kb = k + (size_t)b * S * Dh;
  const float* vb = v + (size_t)b * S * Dh;
  const float* valb = val ? val + (size_t)b * S : nullptr;

  float qh[DH];
  float x2 = 0.f;
  if (row) {
    x2 = load_row<DH, POINCARE>(q + ((size_t)b * L + i) * Dh, Dh, qh);
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) qh[d] = 0.f;
  }
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float l = 0.f;

  for (int j0 = 0; j0 < S; j0 += kTile) {
    const int n = min(kTile, S - j0);
    __syncthreads();                      // the previous tile is consumed
    if (t < n) {
      const int j = j0 + t;
      float kr[DH];
      const float ss = load_row<DH, POINCARE>(kb + (size_t)j * Dh, Dh, kr);
      if (POINCARE) y2[t] = ss;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        ks[t * DH + d] = kr[d];
        vs[t * DH + d] = d < Dh ? vb[(size_t)j * Dh + d] : 0.f;
      }
      ok[t] = (valb == nullptr || valb[j] > 0.f) ? 1.f : 0.f;
    }
    __syncthreads();
    if (row) {
      for (int jj = 0; jj < n; ++jj) {
        if (ok[jj] == 0.f) continue;      // the same key for every thread
        const float g = dot_smem(qh, ks + jj * DH);
        const float e = expf(
            POINCARE
                ? poincare::score(poincare::pair(g, x2, y2[jj], curv), curv)
                : -acosf(fminf(fmaxf(g, -kClip), kClip)));
        l += e;
        axpy_smem(e, vs + jj * DH, acc);
      }
    }
  }
  if (row) {
    const float lf = fmaxf(l, kDenFloor);
    float* o = out + ((size_t)b * L + i) * Dh;
#pragma unroll
    for (int d = 0; d < DH; ++d)
      if (d < Dh) o[d] = acc[d] / lf;
    lse[(size_t)b * L + i] = logf(lf);
  }
}

template <int DH, bool POINCARE>
int launch(const float* q, const float* k, const float* v, const float* val,
           float* out, float* lse, int B, int L, int S, int Dh, float c,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kTile * DH + (POINCARE ? 2 : 1) * kTile);
  cudaError_t err =
      smem_attr::allow(flash_mhgsa_fwd_kernel<DH, POINCARE>, smem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (L + kThreads - 1) / kThreads;
  const long long blocks = (long long)B * row_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_mhgsa_fwd_kernel<DH, POINCARE>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(
          q, k, v, val, out, lse, L, S, Dh, row_tiles,
          poincare::make_curv(c));
  return cudaGetLastError();
}

template <bool POINCARE>
int dispatch(const float* q, const float* k, const float* v, const float* val,
             float* out, float* lse, int B, int L, int S, int Dh, float c,
             cudaStream_t st) {
  if (Dh <= 8)
    return launch<8, POINCARE>(q, k, v, val, out, lse, B, L, S, Dh, c, st);
  if (Dh <= 16)
    return launch<16, POINCARE>(q, k, v, val, out, lse, B, L, S, Dh, c, st);
  if (Dh <= 32)
    return launch<32, POINCARE>(q, k, v, val, out, lse, B, L, S, Dh, c, st);
  if (Dh <= 64)
    return launch<64, POINCARE>(q, k, v, val, out, lse, B, L, S, Dh, c, st);
  if (Dh <= 128)
    return launch<128, POINCARE>(q, k, v, val, out, lse, B, L, S, Dh, c, st);
  return stream_fwd::launch<POINCARE>(q, k, v, nullptr, val, out, lse, B, L,
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
  return metric == 1
             ? dispatch<true>(q, k, v, val, out, lse, B, L, S, Dh, c, st)
             : dispatch<false>(q, k, v, val, out, lse, B, L, S, Dh, c, st);
}
