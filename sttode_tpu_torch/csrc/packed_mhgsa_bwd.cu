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
// (chip_smoke.py, attn_bwd_work); the launch and the serial chain inside a
// problem bound it. The TPU kernel packs heads into lanes and sums dk̂ and
// dv over query rows inside one grid step; on Hopper the packing is dropped
// and each problem runs the body of small_bwd.cuh (kernel C's small-S
// mode), with the key validity in place of the mask, as the packed forward
// (packed_mhgsa_fwd.cu) runs small_fwd.cuh's:
//   - a block per problem (88 blocks at the recipe), which holds every
//     row's den and δ in shared memory between its two passes: no scratch
//     in device memory and no atomics;
//   - pass 1, threads own query rows and the keys are split across warps
//     (32 rows × 8 slices of 4 keys at 32 × 32); one walk over the keys
//     sums den = Σ e, Σ e·dp, A = Σ gate·e·dp·k̂_j and B = Σ gate·e·k̂_j,
//     so δ = Σ e·dp / den and dq̂ = (A − δ·B) / den;
//   - pass 2, threads own keys and the rows are split across warps; each
//     pair replays p = e / den_i for dv and dk̂;
//   - the epilogue is the TPU kernel's own, oblique.cuh's pair_terms: the
//     A&S 4.4.46 acos with √x as x·rsqrt(x), the exp as one ex2, the gate
//     rsqrt(max(1 − gc², 1e-12)) where the unclipped |g| < 1 − 1e-4, each on
//     the SFU; e is then multiplied by the key's validity.
// The body holds four DH-vectors a thread in registers, so it takes head
// dims up to 32 (small_bwd::head_dim) and problems whose rows fit shared
// memory (small_bwd::fits). Beyond either — head dims 33 to 128 (H·Dh ≤
// 128), or a problem like L = 1024, S = 1 at Dh = 32, which no path of the
// model sends (hidden 64 over 8 heads gives Dh = 8) — the kernel of before
// runs (packed_warp_bwd_kernel): one warp owns a problem, lane = query row
// in pass 1 (two walks over the keys, staged 32 at a time: den and δ, then
// dq̂), lane = key in pass 2, den and δ kept in the warp's shared memory,
// acosf, expf and rsqrtf. The clip gate tests the unclipped g, so q = k
// rows get an exactly zero, finite gradient; an all-invalid problem has
// p ≡ 0 and zero gradients. fp32 FMAs throughout, no TF32.

#include <cuda_runtime.h>
#include <math.h>

#include "smem_attr.cuh"
#include "small_bwd.cuh"

namespace {

constexpr int kWarps = 4;              // warps (problems) a warp-kernel block
constexpr float kClip = 0.9999f;       // 1 - 1e-4
constexpr float kNormFloor = 1e-12f;
constexpr float kDenFloor = 1e-30f;

// the small body with the key validity (val null: every key valid)
template <int DH>
__global__ void __launch_bounds__(small_bwd::max_threads<DH>())
packed_small_bwd_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ val,
                        const float* __restrict__ dout,
                        float* __restrict__ dq, float* __restrict__ dk,
                        float* __restrict__ dv, int H, int L, int S, int Dh,
                        small_bwd::Layout y) {
  small_bwd::body<DH, true>(q, k, v, nullptr, val, dout, dq, dk, dv, nullptr,
                            H, L, S, Dh, y);
}

template <int DH>
int launch_small(const float* q, const float* k, const float* v,
                 const float* val, const float* dout, float* dq, float* dk,
                 float* dv, int P, int H, int L, int S, int Dh,
                 cudaStream_t stream) {
  const small_bwd::Layout y = small_bwd::layout<DH, true>(L, S);
  const size_t smem = small_bwd::smem_bytes<DH, true>(L, S, y);
  cudaError_t err = smem_attr::allow(packed_small_bwd_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  packed_small_bwd_kernel<DH><<<P, y.threads, smem, stream>>>(
      q, k, v, val, dout, dq, dk, dv, H, L, S, Dh, y);
  return cudaGetLastError();
}

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

// floats of shared memory a warp of the warp kernel takes: its [32][DH]
// k̂ / q̂ and v / do tiles, [32] validity / den and δ, and [L][2] den and δ
template <int DH>
__host__ __device__ constexpr size_t warp_floats(int L) {
  return 2 * 32 * DH + 64 + 2 * (size_t)L;
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
packed_warp_bwd_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ val,
                       const float* __restrict__ dout,
                       float* __restrict__ dq, float* __restrict__ dk,
                       float* __restrict__ dv, int P, int H, int L, int S,
                       int Dh) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ta = smem + warp * warp_floats<DH>(L);   // [32][DH] k̂ / q̂ rows
  float* tb = ta + 32 * DH;                       // [32][DH] v / do rows
  float* tc = tb + 32 * DH;                       // [32] validity / den
  float* td = tc + 32;                            // [32] δ
  float* st = td + 32;                            // [L][2] den, δ

  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= P) return;                             // whole warp leaves
  const size_t qo = (size_t)p * L * Dh, ko = (size_t)p * S * Dh;
  const float* valp = val ? val + (size_t)(p / H) * S : nullptr;

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
      if (lane < n) {
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

// the warp kernel: kWarps problems a block, or one where that passes the
// shared memory a block may take
template <int DH>
int launch_warp(const float* q, const float* k, const float* v,
                const float* val, const float* dout, float* dq, float* dk,
                float* dv, int P, int H, int L, int S, int Dh,
                cudaStream_t stream) {
  int warps = kWarps;
  size_t smem = sizeof(float) * warps * warp_floats<DH>(L);
  if (smem > small_bwd::kSmemOptin) {
    warps = 1;
    smem = sizeof(float) * warp_floats<DH>(L);
    if (smem > small_bwd::kSmemOptin) return cudaErrorInvalidValue;
  }
  cudaError_t err = smem_attr::allow(packed_warp_bwd_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (P + warps - 1) / warps;
  packed_warp_bwd_kernel<DH><<<blocks, warps * 32, smem, stream>>>(
      q, k, v, val, dout, dq, dk, dv, P, H, L, S, Dh);
  return cudaGetLastError();
}

// the small body where it takes the head dim and the problem fits, else the
// warp kernel
template <int DH>
int launch(const float* q, const float* k, const float* v, const float* val,
           const float* dout, float* dq, float* dk, float* dv, int P, int H,
           int L, int S, int Dh, cudaStream_t stream) {
  if constexpr (DH <= 32) {
    if (small_bwd::fits<DH, true>(L, S))
      return launch_small<DH>(q, k, v, val, dout, dq, dk, dv, P, H, L, S, Dh,
                              stream);
  }
  return launch_warp<DH>(q, k, v, val, dout, dq, dk, dv, P, H, L, S, Dh,
                         stream);
}

}  // namespace

// q [B,H,L,Dh], k/v [B,H,S,Dh], val [B,S] or null, dout [B,H,L,Dh]; outputs
// dq [B,H,L,Dh] and dk/dv [B,H,S,Dh]. All fp32, contiguous, on the current
// device. Launches on `stream` and returns cudaGetLastError() (0 on
// success). A head dim outside 1..128, or a problem whose den and δ pass
// the warp kernel's shared memory (L above ~25,000), is refused with
// cudaErrorInvalidValue.
extern "C" int packed_mhgsa_bwd(const float* q, const float* k,
                                const float* v, const float* val,
                                const float* dout, float* dq, float* dk,
                                float* dv, int B, int H, int L, int S, int Dh,
                                void* stream) {
  if (B < 0 || H < 0 || L < 0 || S < 0 || Dh < 1 || Dh > 128)
    return cudaErrorInvalidValue;
  const int P = B * H;
  if (P == 0 || (L == 0 && S == 0)) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh <= 8)
    return launch<8>(q, k, v, val, dout, dq, dk, dv, P, H, L, S, Dh, st);
  if (Dh <= 16)
    return launch<16>(q, k, v, val, dout, dq, dk, dv, P, H, L, S, Dh, st);
  if (Dh <= 32)
    return launch<32>(q, k, v, val, dout, dq, dk, dv, P, H, L, S, Dh, st);
  if (Dh <= 64)
    return launch<64>(q, k, v, val, dout, dq, dk, dv, P, H, L, S, Dh, st);
  return launch<128>(q, k, v, val, dout, dq, dk, dv, P, H, L, S, Dh, st);
}
