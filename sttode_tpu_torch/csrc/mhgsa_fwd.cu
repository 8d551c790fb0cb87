// Geodesic attention forward for Hopper (sm_90a), fp32, both metrics.
//
// Replaces the TPU kernel sttode_tpu/kernels/mhgsa.py::_fused_fwd (kernel body
// _make_fwd_kernel, :294), both of its metrics. For each problem b and query
// row i:
//
//   out[b,i] = Σ_j p_ij · v[b,j],   p_ij = e_ij / max(Σ_j e_ij, 1e-30),
//   e_ij     = exp(s_ij + mask[b,i,j])
//
// with the oblique score s_ij = -acos(clip(q̂_i · k̂_j, ±(1 − 1e-4))),
// x̂ = x / max(‖x‖, 1e-12), or the poincaré score of ball points, the
// negated Möbius distance at curvature c from the Gram closed form
// (poincare.cuh; the TPU body's _poincare_scores branch, :236 and :301-302).
// The softmax is maxless, as on the TPU: the scores are bounded (oblique in
// [-π, 0], poincaré in [−12.21/√c, 0] with c ≥ 0.032) and the caller
// canonicalizes the mask (row-max shift, floor −30, excluded entries =
// −1e30), so exp cannot overflow and an all-excluded row gets denominator
// 1e-30 and outputs exactly 0.
//
// What bounds it on the H100: on the serving path the problems are tiny
// (L = S ≤ 32, Dh = 8 — one problem per (scene or agent slot) × head), so
// the kernel is bound by latency and launch overhead, not by bytes or FLOPs:
// the whole input is a few hundred KB; at the NBA recipe's evaluation
// (88 × 128² × 8) it does ~1.5 M pairs, each a handful of FMAs and one
// transcendental chain (acosf, or the poincaré epilogue's sqrtf, logf and
// two divisions), tens of instructions a pair against one fp32 FMA counted
// by the bound. The design keeps one problem per block with all its keys and
// values staged once in shared memory (normalized k rows for oblique, raw
// ball rows plus their squared norms y2 for poincaré, padded to an odd
// stride so the per-lane Gram loop hits no bank conflicts), one warp per
// query row (its norm or its x2 a warp sum), scores held in a per-warp
// shared row, and the Gram computed with fp32 FMAs: no TF32 and no tensor
// cores, because acos' amplifies Gram error near ±1 and the poincaré
// epilogue's x2 − 2g + y2 cancels for close points. acosf and logf are
// CUDA's (≤ 2 ulp), where the TPU needed a polynomial for acos. The metric is
// a template parameter: the oblique instantiation is the kernel of before.
//
// Beyond shared memory — a problem whose keys and values pass the block's
// 232,448 bytes: oblique from S ≥ 1569 at Dh = 16, S ≥ 436 at Dh = 64; any
// masked problem up to S = 2048 that the route keeps here, as JAX keeps it
// on its fused kernel — the same function runs in the key-streaming mode of
// stream_fwd.cuh: a block per (problem, 16 query rows), the keys, values and
// the mask's row segment streamed 32 keys at a time, q and the accumulator
// in shared memory sized by Dh, so any head dim fits.
//
// Small S — at Dh ≤ 8 up to S = 2048 keys (the NBA recipe's 88 × 32² × 8 in
// both metrics and its evaluation's 88 × 128² × 8, the agent-axis server's
// masked 512 × 8² × 8, the scene axis up to the flash route), at Dh ≤ 64
// from S = 32 to 256 (small_s_mode) — runs
// the small-shape body of small_fwd.cuh instead: a block per (problem, 32
// query rows), lane = query row, the keys split across the block's warps,
// the partial sums combined once, and the SFU epilogues (the TPU kernel's
// acos polynomial; poincare::fwd_weight, no log or exp at c = 1). The range
// is the measured crossover (scripts/torch_small_attn_bench.py at
// 88 × S² × Dh, PERF.md §6): at Dh = 8 the mode is 2–14× faster from
// S = 16 to 2048 and 4–6 % slower at S = 8; at Dh = 64, 1.3–2.9× faster from
// S = 32 to 256, level at 16, and 2.3–2.6× slower at 8.
//
// The score orientation is always scores[i,j] = score(q_i, k_j); the
// reference-compat transposed square case (quirk Q3) is the caller swapping
// q and k.

#include <cuda_runtime.h>
#include <math.h>

#include "poincare.cuh"
#include "small_fwd.cuh"
#include "smem_attr.cuh"
#include "stream_fwd.cuh"

// the small-S mode: -1 where small_s_mode says (the default), 0 never, 1 at
// every S (Dh ≤ 128); the last two for timing its crossover
#ifndef STTODE_SMALL_MODE
#define STTODE_SMALL_MODE -1
#endif

namespace {

constexpr int kWarps = 4;
constexpr float kClip = 0.9999f;       // 1 - 1e-4
constexpr float kNormFloor = 1e-12f;
constexpr float kDenFloor = 1e-30f;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <bool POINCARE>
__global__ void __launch_bounds__(kWarps * 32)
mhgsa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 float* __restrict__ out, int L, int S, int Dh,
                 poincare::Curv curv) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = Dh | 1;                 // odd stride: conflict-free rows
  float* kn = smem;                       // [S][ldk] unit (ball) keys
  float* vs = kn + S * ldk;               // [S][Dh]
  float* qn = vs + S * Dh;                // [kWarps][Dh]
  float* p = qn + kWarps * Dh;            // [kWarps][S]
  float* y2 = p + kWarps * S;             // [S] poincaré: ‖k_j‖²

  const int b = blockIdx.x;
  const float* qb = q + (size_t)b * L * Dh;
  const float* kb = k + (size_t)b * S * Dh;
  const float* vb = v + (size_t)b * S * Dh;

  for (int i = threadIdx.x; i < S * Dh; i += blockDim.x) vs[i] = vb[i];
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const float* kr = kb + (size_t)j * Dh;
    float ss = 0.f;
    for (int d = 0; d < Dh; ++d) ss = fmaf(kr[d], kr[d], ss);
    if (POINCARE) {
      for (int d = 0; d < Dh; ++d) kn[j * ldk + d] = kr[d];
      y2[j] = ss;
    } else {
      const float nrm = fmaxf(sqrtf(ss), kNormFloor);
      for (int d = 0; d < Dh; ++d) kn[j * ldk + d] = kr[d] / nrm;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = qn + warp * Dh;
  float* pw = p + warp * S;
  for (int i = warp; i < L; i += kWarps) {
    const float* qr = qb + (size_t)i * Dh;
    float ss = 0.f;
    for (int d = lane; d < Dh; d += 32) ss = fmaf(qr[d], qr[d], ss);
    const float x2 = warp_sum(ss);
    const float nrm = POINCARE ? 1.f : fmaxf(sqrtf(x2), kNormFloor);
    for (int d = lane; d < Dh; d += 32) qw[d] = POINCARE ? qr[d] : qr[d] / nrm;
    __syncwarp();

    const float* mrow = mask ? mask + ((size_t)b * L + i) * S : nullptr;
    float den = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float* kr = kn + j * ldk;
      float g = 0.f;
      for (int d = 0; d < Dh; ++d) g = fmaf(qw[d], kr[d], g);
      float s = POINCARE
          ? poincare::score(poincare::pair(g, x2, y2[j], curv), curv)
          : -acosf(fminf(fmaxf(g, -kClip), kClip));
      if (mrow) s += mrow[j];
      const float e = expf(s);
      pw[j] = e;
      den += e;
    }
    den = fmaxf(warp_sum(den), kDenFloor);
    __syncwarp();

    for (int d = lane; d < Dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(pw[j], vs[j * Dh + d], acc);
      out[((size_t)b * L + i) * Dh + d] = acc / den;
    }
    __syncwarp();
  }
}

template <bool POINCARE>
int launch(const float* q, const float* k, const float* v, const float* mask,
           float* out, int B, int L, int S, int Dh, float c,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)S * (Dh | 1) + (size_t)S * Dh +
                       (size_t)kWarps * Dh + (size_t)kWarps * S +
                       (POINCARE ? (size_t)S : 0));
  int max_smem = 0;
  cudaError_t err = smem_attr::optin_limit(&max_smem);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem)   // beyond shared memory: stream the keys
    return stream_fwd::launch<POINCARE>(q, k, v, mask, nullptr, out, nullptr,
                                        B, L, S, Dh, c, stream);
  err = smem_attr::allow(mhgsa_fwd_kernel<POINCARE>, smem);
  if (err != cudaSuccess) return err;
  mhgsa_fwd_kernel<POINCARE><<<B, kWarps * 32, smem, stream>>>(
      q, k, v, mask, out, L, S, Dh, poincare::make_curv(c));
  return cudaGetLastError();
}

template <int DH, bool POINCARE, bool C1>
__global__ void __launch_bounds__(small_fwd::max_threads<DH>())
mhgsa_small_fwd_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ val,
                       const float* __restrict__ mask,
                       float* __restrict__ out, int H, int L, int S, int Dh,
                       int rows, int slices, poincare::Curv curv) {
  small_fwd::body<DH, POINCARE, C1>(q, k, v, val, mask, out, H, L, S, Dh,
                                    rows, slices, curv);
}

template <int DH>
int launch_small(const float* q, const float* k, const float* v,
                 const float* mask, float* out, int B, int L, int S, int Dh,
                 int metric, float c, cudaStream_t stream) {
  auto kernel = metric == 0 ? mhgsa_small_fwd_kernel<DH, false, false>
                : c == 1.f  ? mhgsa_small_fwd_kernel<DH, true, true>
                            : mhgsa_small_fwd_kernel<DH, true, false>;
  return small_fwd::launch<DH>(kernel, q, k, v, nullptr, mask, out, B, 1, L,
                               S, Dh, c, stream);
}

// whether the small-S mode takes a problem of S keys at head dim Dh
// (kernels/mhgsa.py::small_s_mode is its Python form), with a grid of
// ceil(L / 32) ≤ 65535 row chunks
bool small_s_mode(int L, int S, int Dh) {
  if ((L + 31) / 32 > 65535 || Dh > 128) return false;
  if (STTODE_SMALL_MODE >= 0) return STTODE_SMALL_MODE == 1;
  return Dh <= 8 ? S <= 2048 : Dh <= 64 && S >= 32 && S <= 256;
}

int small_s(const float* q, const float* k, const float* v, const float* mask,
            float* out, int B, int L, int S, int Dh, int metric, float c,
            cudaStream_t stream) {
  if (Dh <= 8)
    return launch_small<8>(q, k, v, mask, out, B, L, S, Dh, metric, c, stream);
  if (Dh <= 16)
    return launch_small<16>(q, k, v, mask, out, B, L, S, Dh, metric, c,
                            stream);
  if (Dh <= 32)
    return launch_small<32>(q, k, v, mask, out, B, L, S, Dh, metric, c,
                            stream);
  if (Dh <= 64)
    return launch_small<64>(q, k, v, mask, out, B, L, S, Dh, metric, c,
                            stream);
  return launch_small<128>(q, k, v, mask, out, B, L, S, Dh, metric, c,
                           stream);
}

}  // namespace

// q [B,L,Dh], k/v [B,S,Dh], mask [B,L,S] or null (already canonicalized),
// out [B,L,Dh]; all fp32, contiguous, on the current device; metric 0 =
// oblique, 1 = poincaré at curvature c (q and k ball points). Launches on
// `stream` and returns cudaGetLastError() (0 on success). An S whose keys and
// values do not fit in shared memory runs in the key-streaming mode, a small
// S in the small-S mode; another metric is refused with
// cudaErrorInvalidValue.
extern "C" int mhgsa_fwd(const float* q, const float* k, const float* v,
                         const float* mask, float* out, int B, int L, int S,
                         int Dh, int metric, float c, void* stream) {
  if (metric != 0 && metric != 1) return cudaErrorInvalidValue;
  if (B <= 0 || L <= 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (small_s_mode(L, S, Dh))
    return small_s(q, k, v, mask, out, B, L, S, Dh, metric, c, st);
  return metric == 1 ? launch<true>(q, k, v, mask, out, B, L, S, Dh, c, st)
                     : launch<false>(q, k, v, mask, out, B, L, S, Dh, c, st);
}
