// Geodesic attention backward for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel sttode_tpu/kernels/mhgsa.py::_fused_bwd (kernel body
// _make_bwd_kernel, plus the k-side row-normalize VJP that the TPU applies
// outside the kernel), oblique metric. For each problem b, with
// x̂ = x / max(‖x‖, 1e-12), g_ij = q̂_i·k̂_j, gc = clip(g, ±(1 − 1e-4)) and
// p_ij = exp(−acos(gc_ij) + mask_ij) / max(Σ_j exp(·), 1e-30), it recomputes
// p and returns, for the cotangent do of out = p·V:
//
//   dv_j   = Σ_i p_ij do_i
//   ds_ij  = p_ij (do_i·v_j − δ_i),   δ_i = Σ_j p_ij (do_i·v_j)
//   dmask  = ds                                  (only when asked for)
//   dg_ij  = ds_ij / √(1 − gc²) · 1{|g_ij| < 1 − 1e-4}   (the unclipped g)
//   dq̂_i  = Σ_j dg_ij k̂_j,   dk̂_j = Σ_i dg_ij q̂_i
//   dq_i   = (dq̂_i − q̂_i (dq̂_i·q̂_i)) / max(‖q_i‖, 1e-12), dk alike.
//
// What bounds it on the H100: on the training path a problem is one
// (agent slot, head) of the scene-axis attention, L = S = 128 scenes,
// Dh = 8, 88 problems per call: 2.5 MB in and out and ~130 M operations
// (~3 M of them transcendentals), about two microseconds of the card's
// fp32 rate (chip_smoke.py, attn_bwd_work).
// Launch latency and the serial dependency inside a problem bound it. On the
// TPU the grid walks q-row tiles in order and accumulates dk̂ and dv across
// them; on Hopper blocks run in parallel, so one block owns a whole problem
// and makes two passes over it instead, with no atomics:
//   pass 1, one warp per query row i: recompute the row of p, its
//     denominator and δ_i (δ_i is the softmax VJP's rowsum(dp⊙p), taken
//     directly in the same loop); then dq_i with the q-side normalize VJP,
//     and d(mask)_i;
//   pass 2, one warp per key row j: recompute the column of p from the
//     stored denominators, accumulate dv_j and dk̂_j, and apply the k-side
//     normalize VJP inside the block, which owns all of S.
// Normalized q and k, v, do, the row norms, denominators and δ are staged
// in shared memory (a few tens of KB at S = 128); the Gram uses fp32 FMAs,
// no TF32: acos' amplifies Gram error near ±1. The gate tests the unclipped
// g and takes rsqrtf(max(1 − gc², 1e-12)), so q = k rows (g ≈ 1) get an
// exactly zero, finite gradient; an all-excluded row has p ≡ 0 and a zero
// gradient.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr float kClip = 0.9999f;       // 1 - 1e-4
constexpr float kNormFloor = 1e-12f;
constexpr float kDenFloor = 1e-30f;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Normalize `rows` rows of width Dh from global src into dst (row stride
// ld); row norms (unfloored) into nrm. One warp per row.
__device__ void stage_normalized(const float* __restrict__ src, int rows,
                                 int Dh, float* dst, int ld, float* nrm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const float* x = src + (size_t)r * Dh;
    float ss = 0.f;
    for (int d = lane; d < Dh; d += 32) ss = fmaf(x[d], x[d], ss);
    const float n = sqrtf(warp_sum(ss));
    const float f = fmaxf(n, kNormFloor);
    for (int d = lane; d < Dh; d += 32) dst[r * ld + d] = x[d] / f;
    if (lane == 0) nrm[r] = n;
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float s = 0.f;
  for (int d = 0; d < n; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// (score-path pieces of one (i, j) pair) e = exp(−acos(gc) + mask) and the
// clip-gated acos' factor, 0 outside the clip
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

__global__ void __launch_bounds__(kWarps * 32)
mhgsa_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 const float* __restrict__ dout, float* __restrict__ dq,
                 float* __restrict__ dk, float* __restrict__ dv,
                 float* __restrict__ dmask, int L, int S, int Dh) {
  extern __shared__ __align__(16) float smem[];
  const int ld = Dh | 1;                  // odd stride: conflict-free rows
  const int W = L > S ? L : S;
  float* qn = smem;                       // [L][ld]  normalized q
  float* kn = qn + L * ld;                // [S][ld]  normalized k
  float* vs = kn + S * ld;                // [S][ld]  v
  float* dos = vs + S * ld;               // [L][ld]  do
  float* qnorm = dos + L * ld;            // [L]
  float* knorm = qnorm + L;               // [S]
  float* den = knorm + S;                 // [L]  softmax denominators
  float* delta = den + L;                 // [L]  δ_i
  float* rowa = delta + L;                // [kWarps][W]  p (pass 1: e)
  float* rowb = rowa + kWarps * W;        // [kWarps][W]  dg
  float* vec = rowb + kWarps * W;         // [kWarps][Dh]  dq̂ / dk̂ rows

  const int b = blockIdx.x;
  const size_t qo = (size_t)b * L * Dh, ko = (size_t)b * S * Dh;
  stage_normalized(q + qo, L, Dh, qn, ld, qnorm);
  stage_normalized(k + ko, S, Dh, kn, ld, knorm);
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
      float e, gate;
      pair_terms(dot(qi, kn + j * ld, Dh), mrow ? mrow[j] : 0.f, &e, &gate);
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
    for (int j = lane; j < S; j += 32) {
      const float ds = pa[j] / dn * (dot(doi, vs + j * ld, Dh) - dl);
      if (dmrow) dmrow[j] = ds;
      pb[j] *= ds;                        // dg
    }
    __syncwarp();
    for (int d = lane; d < Dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc = fmaf(pb[j], kn[j * ld + d], acc);
      va[d] = acc;
    }
    __syncwarp();
    normalize_vjp_row(va, qi, qnorm[i], Dh, dq + qo + (size_t)i * Dh);
    __syncwarp();
  }
  __syncthreads();

  // pass 2: one warp per key row j
  for (int j = warp; j < S; j += kWarps) {
    const float* kj = kn + j * ld;
    const float* vj = vs + j * ld;
    for (int i = lane; i < L; i += 32) {
      const float* mrow = mask ? mask + ((size_t)b * L + i) * S : nullptr;
      float e, gate;
      pair_terms(dot(qn + i * ld, kj, Dh), mrow ? mrow[j] : 0.f, &e, &gate);
      const float p = e / den[i];
      const float ds = p * (dot(dos + i * ld, vj, Dh) - delta[i]);
      pa[i] = p;
      pb[i] = gate * ds;
    }
    __syncwarp();
    for (int d = lane; d < Dh; d += 32) {
      float acc_k = 0.f, acc_v = 0.f;
      for (int i = 0; i < L; ++i) {
        acc_k = fmaf(pb[i], qn[i * ld + d], acc_k);
        acc_v = fmaf(pa[i], dos[i * ld + d], acc_v);
      }
      va[d] = acc_k;
      dv[ko + (size_t)j * Dh + d] = acc_v;
    }
    __syncwarp();
    normalize_vjp_row(va, kj, knorm[j], Dh, dk + ko + (size_t)j * Dh);
    __syncwarp();
  }
}

}  // namespace

// q [B,L,Dh], k/v [B,S,Dh], mask [B,L,S] or null (already canonicalized),
// dout [B,L,Dh]; outputs dq [B,L,Dh], dk/dv [B,S,Dh] and, when dmask is not
// null, dmask [B,L,S]. All fp32, contiguous, on the current device.
// Launches on `stream` and returns cudaGetLastError() (0 on success). An
// L or S whose rows do not fit in shared memory is refused with
// cudaErrorInvalidValue.
extern "C" int mhgsa_bwd(const float* q, const float* k, const float* v,
                         const float* mask, const float* dout, float* dq,
                         float* dk, float* dv, float* dmask, int B, int L,
                         int S, int Dh, void* stream) {
  if (B <= 0 || L <= 0 || S <= 0) return cudaSuccess;
  const size_t ld = (size_t)(Dh | 1), W = (size_t)(L > S ? L : S);
  const size_t smem = sizeof(float) *
      (2 * ((size_t)L + S) * ld + 3 * (size_t)L + S +
       2 * (size_t)kWarps * W + (size_t)kWarps * Dh);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(mhgsa_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  mhgsa_bwd_kernel<<<B, kWarps * 32, smem, (cudaStream_t)stream>>>(
      q, k, v, mask, dout, dq, dk, dv, dmask, L, S, Dh);
  return cudaGetLastError();
}
