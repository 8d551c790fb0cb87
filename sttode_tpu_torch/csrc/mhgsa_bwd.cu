// Geodesic attention backward for Hopper (sm_90a), fp32, both metrics.
//
// Replaces the TPU kernel sttode_tpu/kernels/mhgsa.py::_fused_bwd (kernel body
// _make_bwd_kernel, :321, plus the k-side row-normalize VJP that the TPU
// applies outside the kernel, :514-518), both of its metrics. For each
// problem b, with p_ij = exp(s_ij + mask_ij) / max(Σ_j exp(·), 1e-30), it
// recomputes p and returns, for the cotangent do of out = p·V:
//
//   dv_j   = Σ_i p_ij do_i
//   ds_ij  = p_ij (do_i·v_j − δ_i),   δ_i = Σ_j p_ij (do_i·v_j)
//   dmask  = ds                                  (only when asked for)
//
// oblique (x̂ = x / max(‖x‖, 1e-12), g_ij = q̂_i·k̂_j, gc = clip(g, ±(1 −
// 1e-4)), s = −acos(gc)):
//
//   dg_ij  = ds_ij / √(1 − gc²) · 1{|g_ij| < 1 − 1e-4}   (the unclipped g)
//   dq̂_i  = Σ_j dg_ij k̂_j,   dk̂_j = Σ_i dg_ij q̂_i
//   dq_i   = (dq̂_i − q̂_i (dq̂_i·q̂_i)) / max(‖q_i‖, 1e-12), dk alike;
//
// poincaré (ball points, g_ij = q_i·k_j, the epilogue of poincare.cuh; the
// TPU body's _poincare_bwd_terms branch, :273 and :355-357):
//
//   dq_i   = Σ_j dg_ij k_j + 2·dx2_i·q_i,   dk_j = Σ_i dg_ij q_i + 2·dy2_j·k_j
//
// with dx2_i a sum over the row and dy2_j over the column, and no normalize
// VJP (the TPU's per-tile dk is already complete for this metric).
//
// What bounds it on the H100: on the training path a problem is one
// (agent slot, head) of the scene-axis attention, L = S = 32 (the NBA
// recipe) or 128 (the bench recipe) scenes, Dh = 8, 88 problems per call:
// at 128, 2.5 MB in and out and ~130 M operations (~3 M of them
// transcendentals), about two microseconds of the card's fp32 rate
// (chip_smoke.py, attn_bwd_work; the poincaré epilogue, its metric
// "poincare", roughly doubles the elementwise share). Launch latency and the
// serial dependency inside a problem bound it. On the TPU the grid walks q-row
// tiles in order and accumulates dk̂ and dv across them; on Hopper blocks
// run in parallel, so one block owns a whole problem and makes two passes
// over it instead, with no atomics:
//   pass 1, one warp per query row i: recompute the row of p, its
//     denominator and δ_i (δ_i is the softmax VJP's rowsum(dp⊙p), taken
//     directly in the same loop); then dq_i (the q-side normalize VJP, or
//     the poincaré row sum dx2_i), and d(mask)_i;
//   pass 2, one warp per key row j: recompute the column of p from the
//     stored denominators, accumulate dv_j and dk̂_j (or dk_j with the
//     column sum dy2_j), and apply the k-side normalize VJP inside the
//     block, which owns all of S.
// The staged rows — normalized (oblique) or raw ball (poincaré) q and k, v,
// do, the row norms (oblique) or squared norms (poincaré), denominators, δ
// and two per-warp rows of max(L, S) — live in shared memory: a few tens of
// KB at S = 128, 224·S + 256 bytes at L = S and Dh = 8. Where that passes
// the block's opt-in limit (L = S > 1036 at Dh = 8; a masked problem up to
// S = 2048, which the route keeps on this kernel as JAX keeps it on its
// fused kernel) the same kernel stages each problem in a device workspace
// the wrapper allocates (~0.46 MB a problem at S = 2048, read back from L2)
// instead: flash, the maskless alternative, would read an additive mask
// with a stride of S per thread. At small shapes a problem of either metric
// runs the small-S mode of small_bwd.cuh instead (small_bwd::mode, the
// crossover measured for both metrics; the bench recipe's 88 × 128² × 8, the
// poincaré NBA recipe's 88 × 32² × 8 and the agent-axis server's masked
// 512 × 8² × 8): threads own rows, then keys, the other axis split across
// warps, one pass over a row's keys, and the epilogue on the SFU (oblique:
// the TPU kernel's own; poincaré: zc in IEEE, the tail on the SFU). This
// kernel keeps what the mode does not take: head dims above 32, and
// staging beyond shared memory (the workspace mode).
// The Gram uses fp32 FMAs, no TF32: acos'
// amplifies Gram error near ±1, and the poincaré x2 − 2g + y2 cancels for
// close points. The oblique gate tests the unclipped g and takes
// rsqrtf(max(1 − gc², 1e-12)), so q = k rows (g ≈ 1) get an exactly zero,
// finite gradient; poincaré q = k rows stay finite through n ≥ √1e-15; an
// all-excluded row has p ≡ 0 and a zero gradient.

#include <cuda_runtime.h>
#include <math.h>

#include "poincare.cuh"
#include "small_bwd.cuh"
#include "smem_attr.cuh"

namespace {

constexpr int kWarps = 8;
constexpr float kClip = 0.9999f;       // 1 - 1e-4
constexpr float kNormFloor = 1e-12f;
constexpr float kDenFloor = 1e-30f;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage `rows` rows of width Dh from global src into dst (row stride ld),
// normalized with their norms (unfloored) in nrm (oblique), or raw with
// their squared norms in nrm (poincaré). One warp per row.
template <bool POINCARE>
__device__ void stage_rows(const float* __restrict__ src, int rows, int Dh,
                           float* dst, int ld, float* nrm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const float* x = src + (size_t)r * Dh;
    float ss = 0.f;
    for (int d = lane; d < Dh; d += 32) ss = fmaf(x[d], x[d], ss);
    ss = warp_sum(ss);
    const float n = POINCARE ? ss : sqrtf(ss);
    const float f = POINCARE ? 1.f : fmaxf(n, kNormFloor);
    for (int d = lane; d < Dh; d += 32)
      dst[r * ld + d] = POINCARE ? x[d] : x[d] / f;
    if (lane == 0) nrm[r] = n;
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float s = 0.f;
  for (int d = 0; d < n; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// (oblique score-path pieces of one (i, j) pair) e = exp(−acos(gc) + mask)
// and the clip-gated acos' factor, 0 outside the clip
__device__ __forceinline__ void pair_terms(float g, float m, float* e,
                                           float* gate) {
  const float gc = fminf(fmaxf(g, -kClip), kClip);
  *e = expf(-acosf(gc) + m);
  *gate = fabsf(g) < kClip ? rsqrtf(fmaxf(1.f - gc * gc, 1e-12f)) : 0.f;
}

// Row-normalize VJP of one row written to out: (dx̂ − x̂ (dx̂·x̂)) / max(n, floor).
// dxh is a per-warp row of Dh floats in shared memory.
__device__ void normalize_vjp_row(const float* dxh, const float* xh, float n,
                                  int Dh, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  float r = 0.f;
  for (int d = lane; d < Dh; d += 32) r = fmaf(dxh[d], xh[d], r);
  r = warp_sum(r);
  const float f = fmaxf(n, kNormFloor);
  for (int d = lane; d < Dh; d += 32) out[d] = (dxh[d] - xh[d] * r) / f;
}

// Floats staged per problem, in shared memory or in the workspace; the
// layout is the one mhgsa_bwd_kernel carves.
__host__ __device__ size_t staged_floats(int L, int S, int Dh) {
  const size_t ld = (size_t)(Dh | 1), W = (size_t)(L > S ? L : S);
  return 2 * ((size_t)L + S) * ld + 3 * (size_t)L + S + 2 * (size_t)kWarps * W
         + (size_t)kWarps * Dh;
}

template <bool POINCARE>
__global__ void __launch_bounds__(kWarps * 32)
mhgsa_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 const float* __restrict__ dout, float* __restrict__ dq,
                 float* __restrict__ dk, float* __restrict__ dv,
                 float* __restrict__ dmask, float* __restrict__ workspace,
                 int L, int S, int Dh, poincare::Curv curv) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  float* base = workspace ? workspace + (size_t)b * staged_floats(L, S, Dh)
                          : smem;
  const int ld = Dh | 1;                  // odd stride: conflict-free rows
  const int W = L > S ? L : S;
  float* qn = base;                       // [L][ld]  normalized (ball) q
  float* kn = qn + L * ld;                // [S][ld]  normalized (ball) k
  float* vs = kn + S * ld;                // [S][ld]  v
  float* dos = vs + S * ld;               // [L][ld]  do
  float* qnorm = dos + L * ld;            // [L]  ‖q_i‖ (poincaré: ‖q_i‖²)
  float* knorm = qnorm + L;               // [S]  ‖k_j‖ (poincaré: ‖k_j‖²)
  float* den = knorm + S;                 // [L]  softmax denominators
  float* delta = den + L;                 // [L]  δ_i
  float* rowa = delta + L;                // [kWarps][W]  p (pass 1: e)
  float* rowb = rowa + kWarps * W;        // [kWarps][W]  dg
  float* vec = rowb + kWarps * W;         // [kWarps][Dh]  dq̂ / dk̂ rows

  const size_t qo = (size_t)b * L * Dh, ko = (size_t)b * S * Dh;
  stage_rows<POINCARE>(q + qo, L, Dh, qn, ld, qnorm);
  stage_rows<POINCARE>(k + ko, S, Dh, kn, ld, knorm);
  for (int i = threadIdx.x; i < S * Dh; i += blockDim.x)
    vs[(i / Dh) * ld + i % Dh] = v[ko + i];
  for (int i = threadIdx.x; i < L * Dh; i += blockDim.x)
    dos[(i / Dh) * ld + i % Dh] = dout[qo + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pa = rowa + warp * W;
  float* pb = rowb + warp * W;
  float* va = vec + warp * Dh;

  // pass 1: one warp per query row i
  for (int i = warp; i < L; i += kWarps) {
    const float* qi = qn + i * ld;
    const float* doi = dos + i * ld;
    const float* mrow = mask ? mask + ((size_t)b * L + i) * S : nullptr;
    float sum_e = 0.f, sum_edp = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float g = dot(qi, kn + j * ld, Dh);
      const float m = mrow ? mrow[j] : 0.f;
      float e, gate;
      if (POINCARE) {
        e = expf(poincare::score(poincare::pair(g, qnorm[i], knorm[j], curv),
                                 curv) + m);
        gate = g;                         // pass 1 keeps g for the VJP
      } else {
        pair_terms(g, m, &e, &gate);
      }
      const float dp = dot(doi, vs + j * ld, Dh);
      pa[j] = e;
      pb[j] = gate;
      sum_e += e;
      sum_edp = fmaf(e, dp, sum_edp);
    }
    const float dn = fmaxf(warp_sum(sum_e), kDenFloor);
    const float dl = warp_sum(sum_edp) / dn;
    if (lane == 0) {
      den[i] = dn;
      delta[i] = dl;
    }
    float* dmrow = dmask ? dmask + ((size_t)b * L + i) * S : nullptr;
    float dx2 = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float ds = pa[j] / dn * (dot(doi, vs + j * ld, Dh) - dl);
      if (dmrow) dmrow[j] = ds;
      if (POINCARE) {
        float a, bb;
        pb[j] = poincare::grad(poincare::pair(pb[j], qnorm[i], knorm[j], curv),
                               ds, curv, &a, &bb);
        dx2 += a + bb * knorm[j];
      } else {
        pb[j] *= ds;                      // dg
      }
    }
    if (POINCARE) dx2 = warp_sum(dx2);
    __syncwarp();
    for (int d = lane; d < Dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(pb[j], kn[j * ld + d], acc);
      if (POINCARE)
        dq[qo + (size_t)i * Dh + d] = acc + 2.f * dx2 * qi[d];
      else
        va[d] = acc;
    }
    __syncwarp();
    if (!POINCARE) {
      normalize_vjp_row(va, qi, qnorm[i], Dh, dq + qo + (size_t)i * Dh);
      __syncwarp();
    }
  }
  __syncthreads();

  // pass 2: one warp per key row j
  for (int j = warp; j < S; j += kWarps) {
    const float* kj = kn + j * ld;
    const float* vj = vs + j * ld;
    float dy2 = 0.f;
    for (int i = lane; i < L; i += 32) {
      const float* mrow = mask ? mask + ((size_t)b * L + i) * S : nullptr;
      const float g = dot(qn + i * ld, kj, Dh);
      const float m = mrow ? mrow[j] : 0.f;
      float e, gate = 0.f;
      poincare::Pair pp{};
      if (POINCARE) {
        pp = poincare::pair(g, qnorm[i], knorm[j], curv);
        e = expf(poincare::score(pp, curv) + m);
      } else {
        pair_terms(g, m, &e, &gate);
      }
      const float p = e / den[i];
      const float ds = p * (dot(dos + i * ld, vj, Dh) - delta[i]);
      pa[i] = p;
      if (POINCARE) {
        float a, bb;
        pb[i] = poincare::grad(pp, ds, curv, &a, &bb);
        dy2 += a + bb * qnorm[i];
      } else {
        pb[i] = gate * ds;
      }
    }
    if (POINCARE) dy2 = warp_sum(dy2);
    __syncwarp();
    for (int d = lane; d < Dh; d += 32) {
      float acc_k = 0.f, acc_v = 0.f;
      for (int i = 0; i < L; ++i) {
        acc_k = fmaf(pb[i], qn[i * ld + d], acc_k);
        acc_v = fmaf(pa[i], dos[i * ld + d], acc_v);
      }
      if (POINCARE)
        dk[ko + (size_t)j * Dh + d] = acc_k + 2.f * dy2 * kj[d];
      else
        va[d] = acc_k;
      dv[ko + (size_t)j * Dh + d] = acc_v;
    }
    __syncwarp();
    if (!POINCARE) {
      normalize_vjp_row(va, kj, knorm[j], Dh, dk + ko + (size_t)j * Dh);
      __syncwarp();
    }
  }
}

template <bool POINCARE>
int launch(const float* q, const float* k, const float* v, const float* mask,
           const float* dout, float* dq, float* dk, float* dv, float* dmask,
           float* workspace, int B, int L, int S, int Dh, float c,
           cudaStream_t stream) {
  size_t smem = 0;
  if (workspace == nullptr) {
    smem = sizeof(float) * staged_floats(L, S, Dh);
    int max_smem = 0;
    cudaError_t err = smem_attr::optin_limit(&max_smem);
    if (err != cudaSuccess) return err;
    if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
    err = smem_attr::allow(mhgsa_bwd_kernel<POINCARE>, smem);
    if (err != cudaSuccess) return err;
  }
  mhgsa_bwd_kernel<POINCARE><<<B, kWarps * 32, smem, stream>>>(
      q, k, v, mask, dout, dq, dk, dv, dmask, workspace, L, S, Dh,
      poincare::make_curv(c));
  return cudaGetLastError();
}

}  // namespace

// q [B,L,Dh], k/v [B,S,Dh], mask [B,L,S] or null (already canonicalized),
// dout [B,L,Dh]; outputs dq [B,L,Dh], dk/dv [B,S,Dh] and, when dmask is not
// null, dmask [B,L,S]. All fp32, contiguous, on the current device; metric
// 0 = oblique, 1 = poincaré at curvature c (q and k ball points). With
// workspace null each problem is staged in shared memory, and an L or S
// whose rows do not fit is refused with cudaErrorInvalidValue; otherwise
// workspace holds B × staged_floats(L, S, Dh) floats (the wrapper's
// whole_s_smem_bytes) and each problem is staged there; a problem that
// small_bwd::mode takes runs the small-S mode (small_bwd.cuh), which leaves
// the workspace unused (the wrapper allocates none for it). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mhgsa_bwd(const float* q, const float* k, const float* v,
                         const float* mask, const float* dout, float* dq,
                         float* dk, float* dv, float* dmask, float* workspace,
                         int B, int L, int S, int Dh, int metric, float c,
                         void* stream) {
  if (metric != 0 && metric != 1) return cudaErrorInvalidValue;
  if (B <= 0 || L <= 0 || S <= 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (small_bwd::mode(L, S, Dh, metric))
    return small_bwd::launch(q, k, v, mask, dout, dq, dk, dv, dmask, B, L, S,
                             Dh, metric, c, st);
  return metric == 1
             ? launch<true>(q, k, v, mask, dout, dq, dk, dv, dmask, workspace,
                            B, L, S, Dh, c, st)
             : launch<false>(q, k, v, mask, dout, dq, dk, dv, dmask,
                             workspace, B, L, S, Dh, c, st);
}
