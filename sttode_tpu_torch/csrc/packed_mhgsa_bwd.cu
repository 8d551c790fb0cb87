// Small-shape geodesic attention backward with key validity, Hopper
// (sm_90a), fp32.
//
// Replaces the TPU kernel sttode_tpu/kernels/packed_mhgsa.py::_packed_bwd
// (kernel body _make_packed_bwd_kernel). For each problem p = (b, h), with
// x̂ = x / max(‖x‖, 1e-12), g_ij = q̂_i·k̂_j, gc = clip(g, ±(1 − 1e-4)),
// e_ij = exp(−acos(gc_ij)) · val[b,j] and p_ij = e_ij / max(Σ_j e_ij, 1e-30),
// it recomputes p and returns, for the cotangent do of out = p·V:
//
//   dv_j  = Σ_i p_ij do_i
//   ds_ij = p_ij (do_i·v_j − δ_i),   δ_i = Σ_j p_ij (do_i·v_j)
//   dg_ij = ds_ij / √(1 − gc²) · 1{|g_ij| < 1 − 1e-4}   (the unclipped g)
//   dq̂_i = Σ_j dg_ij k̂_j,   dk̂_j = Σ_i dg_ij q̂_i
//   dq_i  = (dq̂_i − q̂_i (dq̂_i·q̂_i)) / max(‖q_i‖, 1e-12), dk alike.
//
// The validity gets no cotangent (the TPU kernel returns zeros for it).
//
// What bounds it on the H100: at the NBA recipe a call is 88 problems of
// 32 × 32 × 8: 631 KB in and out and 8.2 M operations, a bound of ~0.2 µs
// (chip_smoke.py, attn_bwd_work); launch latency and the serial chain
// inside a problem bound it. The TPU kernel packs heads into lanes and sums
// dk̂ and dv over query rows inside one grid step; on Hopper one warp owns a
// whole problem and makes two passes over it, each lane owning one row of
// the axis it sums over, so no atomics and no warp reductions are needed:
//   pass 1, lane = query row i (32 rows at a time): walk the keys twice,
//     staged 32 at a time in the warp's shared memory — once for the
//     denominator and δ_i (Σ_j e_ij dp_ij / den, summed directly), once for
//     dq̂_i; apply the q-side normalize VJP; keep den_i and δ_i in the
//     caller's scratch [B·H, L, 2];
//   pass 2, lane = key j: walk the query rows (q̂, do, den and δ staged 32
//     at a time), recompute p_ij, and accumulate dv_j and dk̂_j in registers;
//     apply the k-side normalize VJP.
// A lane reads back in pass 2 exactly the scratch entries it wrote in pass
// 1 (row i is lane i mod 32 in both). The clip gate tests the unclipped g
// with rsqrtf(max(1 − gc², 1e-12)), so q = k rows get an exactly zero,
// finite gradient; an all-invalid problem has p ≡ 0 and zero gradients.
// fp32 FMAs throughout, no TF32.

#include <cuda_runtime.h>
#include <math.h>

#include "smem_attr.cuh"

namespace {

constexpr int kWarps = 4;
constexpr float kClip = 0.9999f;       // 1 - 1e-4
constexpr float kNormFloor = 1e-12f;
constexpr float kDenFloor = 1e-30f;

template <int DH>
__device__ __forceinline__ void load_row(const float* __restrict__ x, int Dh,
                                         float (&r)[DH]) {
#pragma unroll
  for (int d = 0; d < DH; ++d) r[d] = d < Dh ? x[d] : 0.f;
}

// scale r to unit norm (floored); returns the unfloored norm
template <int DH>
__device__ __forceinline__ float to_unit(float (&r)[DH]) {
  float ss = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) ss = fmaf(r[d], r[d], ss);
  const float n = sqrtf(ss);
  const float f = fmaxf(n, kNormFloor);
#pragma unroll
  for (int d = 0; d < DH; ++d) r[d] = r[d] / f;
  return n;
}

template <int DH>
__device__ __forceinline__ float dot(const float (&a)[DH],
                                     const float* __restrict__ b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// e = exp(−acos(gc)) · valid and the clip-gated acos' factor
__device__ __forceinline__ void pair_terms(float g, float valid, float* e,
                                           float* gate) {
  const float gc = fminf(fmaxf(g, -kClip), kClip);
  *e = expf(-acosf(gc)) * valid;
  *gate = fabsf(g) < kClip ? rsqrtf(fmaxf(1.f - gc * gc, 1e-12f)) : 0.f;
}

// (dx̂ − x̂ (dx̂·x̂)) / max(n, floor) written to out[0..Dh)
template <int DH>
__device__ __forceinline__ void normalize_vjp(const float (&dxh)[DH],
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

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
packed_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ val,
                  const float* __restrict__ dout, float* __restrict__ dq,
                  float* __restrict__ dk, float* __restrict__ dv,
                  float* __restrict__ stats, int P, int H, int L, int S,
                  int Dh) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ta = smem + warp * (2 * 32 * DH + 64);   // [32][DH] k̂ / q̂ rows
  float* tb = ta + 32 * DH;                       // [32][DH] v / do rows
  float* tc = tb + 32 * DH;                       // [32] validity / den
  float* td = tc + 32;                            // [32] δ

  const int p = blockIdx.x * kWarps + warp;
  if (p >= P) return;                             // whole warp leaves
  const size_t qo = (size_t)p * L * Dh, ko = (size_t)p * S * Dh;
  const float* valp = val ? val + (size_t)(p / H) * S : nullptr;
  float* st = stats + (size_t)p * L * 2;

  // stage keys j0 .. j0+n−1: unit k̂ into ta, v into tb, validity into tc
  auto stage_keys = [&](int j0, int n) {
    if (lane < n) {
      const int j = j0 + lane;
      float r[DH];
      load_row(k + ko + (size_t)j * Dh, Dh, r);
      to_unit(r);
#pragma unroll
      for (int d = 0; d < DH; ++d) ta[lane * DH + d] = r[d];
      load_row(v + ko + (size_t)j * Dh, Dh, r);
#pragma unroll
      for (int d = 0; d < DH; ++d) tb[lane * DH + d] = r[d];
      tc[lane] = valp ? valp[j] : 1.f;
    }
    __syncwarp();
  };

  // pass 1: lane = query row
  for (int i0 = 0; i0 < L; i0 += 32) {
    const int i = i0 + lane;
    const bool row = i < L;
    float qh[DH], dor[DH];
    if (row) {
      load_row(q + qo + (size_t)i * Dh, Dh, qh);
      load_row(dout + qo + (size_t)i * Dh, Dh, dor);
    } else {
#pragma unroll
      for (int d = 0; d < DH; ++d) qh[d] = dor[d] = 0.f;
    }
    const float qn = to_unit(qh);
    float sum_e = 0.f, sum_edp = 0.f;
    for (int j0 = 0; j0 < S; j0 += 32) {
      const int n = min(32, S - j0);
      stage_keys(j0, n);
      for (int jj = 0; jj < n; ++jj) {
        float e, gate;
        pair_terms(dot(qh, ta + jj * DH), tc[jj], &e, &gate);
        sum_e += e;
        sum_edp = fmaf(e, dot(dor, tb + jj * DH), sum_edp);
      }
      __syncwarp();
    }
    const float den = fmaxf(sum_e, kDenFloor);
    const float delta = sum_edp / den;
    float dqh[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) dqh[d] = 0.f;
    for (int j0 = 0; j0 < S; j0 += 32) {
      const int n = min(32, S - j0);
      stage_keys(j0, n);
      for (int jj = 0; jj < n; ++jj) {
        const float* kr = ta + jj * DH;
        float e, gate;
        pair_terms(dot(qh, kr), tc[jj], &e, &gate);
        const float dg = gate * (e / den) * (dot(dor, tb + jj * DH) - delta);
#pragma unroll
        for (int d = 0; d < DH; ++d) dqh[d] = fmaf(dg, kr[d], dqh[d]);
      }
      __syncwarp();
    }
    if (row) {
      normalize_vjp(dqh, qh, qn, Dh, dq + qo + (size_t)i * Dh);
      st[2 * i] = den;
      st[2 * i + 1] = delta;
    }
  }
  __syncwarp();

  // pass 2: lane = key
  for (int j0 = 0; j0 < S; j0 += 32) {
    const int j = j0 + lane;
    const bool col = j < S;
    float kh[DH], vr[DH];
    float vj = 0.f;
    if (col) {
      load_row(k + ko + (size_t)j * Dh, Dh, kh);
      load_row(v + ko + (size_t)j * Dh, Dh, vr);
      vj = valp ? valp[j] : 1.f;
    } else {
#pragma unroll
      for (int d = 0; d < DH; ++d) kh[d] = vr[d] = 0.f;
    }
    const float kn = to_unit(kh);
    float dkh[DH], dvr[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) dkh[d] = dvr[d] = 0.f;
    for (int i0 = 0; i0 < L; i0 += 32) {
      const int n = min(32, L - i0);
      if (lane < n) {                    // row i0 + lane: this lane's pass-1 row
        const int i = i0 + lane;
        float r[DH];
        load_row(q + qo + (size_t)i * Dh, Dh, r);
        to_unit(r);
#pragma unroll
        for (int d = 0; d < DH; ++d) ta[lane * DH + d] = r[d];
        load_row(dout + qo + (size_t)i * Dh, Dh, r);
#pragma unroll
        for (int d = 0; d < DH; ++d) tb[lane * DH + d] = r[d];
        tc[lane] = st[2 * i];
        td[lane] = st[2 * i + 1];
      }
      __syncwarp();
      for (int ii = 0; ii < n; ++ii) {
        const float* qr = ta + ii * DH;
        const float* dr = tb + ii * DH;
        float e, gate;
        pair_terms(dot(kh, qr), vj, &e, &gate);
        const float pij = e / tc[ii];
        const float dg = gate * pij * (dot(vr, dr) - td[ii]);
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          dvr[d] = fmaf(pij, dr[d], dvr[d]);
          dkh[d] = fmaf(dg, qr[d], dkh[d]);
        }
      }
      __syncwarp();
    }
    if (col) {
      normalize_vjp(dkh, kh, kn, Dh, dk + ko + (size_t)j * Dh);
#pragma unroll
      for (int d = 0; d < DH; ++d)
        if (d < Dh) dv[ko + (size_t)j * Dh + d] = dvr[d];
    }
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, const float* val,
           const float* dout, float* dq, float* dk, float* dv, float* stats,
           int P, int H, int L, int S, int Dh, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * (2 * 32 * DH + 64);
  if (smem > 48 * 1024) {
    int max_smem = 0;
    cudaError_t err = smem_attr::optin_limit(&max_smem);
    if (err != cudaSuccess) return err;
    if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
    err = smem_attr::allow(packed_bwd_kernel<DH>, smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (P + kWarps - 1) / kWarps;
  packed_bwd_kernel<DH><<<blocks, kWarps * 32, smem, stream>>>(
      q, k, v, val, dout, dq, dk, dv, stats, P, H, L, S, Dh);
  return cudaGetLastError();
}

}  // namespace

// q [B,H,L,Dh], k/v [B,H,S,Dh], val [B,S] or null, dout [B,H,L,Dh]; outputs
// dq [B,H,L,Dh], dk/dv [B,H,S,Dh] and the scratch stats [B,H,L,2] (each
// row's denominator and δ). All fp32, contiguous, on the current device.
// Launches on `stream` and returns cudaGetLastError() (0 on success). A head
// dim outside 1..128 is refused with cudaErrorInvalidValue.
extern "C" int packed_mhgsa_bwd(const float* q, const float* k,
                                const float* v, const float* val,
                                const float* dout, float* dq, float* dk,
                                float* dv, float* stats, int B, int H, int L,
                                int S, int Dh, void* stream) {
  if (B < 0 || H < 0 || L < 0 || S < 0 || Dh < 1 || Dh > 128)
    return cudaErrorInvalidValue;
  const int P = B * H;
  if (P == 0 || (L == 0 && S == 0)) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh <= 8)
    return launch<8>(q, k, v, val, dout, dq, dk, dv, stats, P, H, L, S, Dh, st);
  if (Dh <= 16)
    return launch<16>(q, k, v, val, dout, dq, dk, dv, stats, P, H, L, S, Dh,
                      st);
  if (Dh <= 32)
    return launch<32>(q, k, v, val, dout, dq, dk, dv, stats, P, H, L, S, Dh,
                      st);
  if (Dh <= 64)
    return launch<64>(q, k, v, val, dout, dq, dk, dv, stats, P, H, L, S, Dh,
                      st);
  return launch<128>(q, k, v, val, dout, dq, dk, dv, stats, P, H, L, S, Dh,
                     st);
}
