// S-tiled (flash) geodesic attention backward for Hopper (sm_90a), fp32: the
// dq sweep and the dk/dv sweep.
//
// Replace the TPU kernels of sttode_tpu/kernels/mhgsa.py::_flash_bwd, oblique
// metric: the dq sweep (kernel body _make_flash_dq_kernel) and the dk/dv
// sweep (_make_flash_dkv_kernel). Both replay the forward's scores from its
// per-row lse instead of storing the L × S probabilities. With
// x̂ = x / max(‖x‖, 1e-12), g_ij = q̂_i·k̂_j, gc = clip(g, ±(1 − 1e-4)) and
// the cotangent do of out:
//
//   p_ij  = exp(−acos(gc_ij) − lse_i)         (0 where val[b,j] ≤ 0)
//   ds_ij = p_ij (do_i·v_j − δ_i),   δ_i = do_i·out_i (the caller's rowsum)
//   dg_ij = ds_ij / √(1 − gc²) · 1{|g_ij| < 1 − 1e-4}   (the unclipped g)
//   dq̂_i = Σ_j dg_ij k̂_j,   dk̂_j = Σ_i dg_ij q̂_i,   dv_j = Σ_i p_ij do_i
//   dq_i  = (dq̂_i − q̂_i (dq̂_i·q̂_i)) / max(‖q_i‖, 1e-12), dk alike.
//
// What bounds them on the H100: at the NBA recipe at B = 2304 a call is 88
// problems of 2304 × 2304 × 8; each sweep replays the Gram, acos and exp of
// every pair, so together they do 6.3e10 operations on 2.5 MB of inputs
// and outputs (chip_smoke.py, flash_dq_work and flash_dkv_work): bound by
// operations, ~0.9 ms at the fp32 peak. On the TPU each sweep is a grid
// whose innermost axis runs in order and carries the sum in VMEM scratch;
// on Hopper blocks run in parallel, so each sweep gives one thread one
// output row and loops over the other axis inside the block, and nothing
// needs atomics:
//   dq sweep: a block per (problem, 128 query rows), a thread per query row
//     i holding q̂_i, do_i and dq̂_i in registers; the keys are normalized
//     and staged with their values and validity 128 at a time in shared
//     memory and read as broadcasts; the q-side normalize VJP ends the row;
//   dk/dv sweep: a block per (problem, 128 keys), a thread per key j holding
//     k̂_j, v_j, dk̂_j and dv_j in registers; the query rows (q̂, do, lse, δ)
//     are staged 128 at a time; the k-side normalize VJP ends the key.
// fp32 FMAs throughout, no TF32 (acos' amplifies Gram error near ±1). The
// gate takes rsqrtf(max(1 − gc², 1e-12)), so q = k rows (g ≈ 1) get an
// exactly zero, finite gradient; an invalid key has p ≡ 0 and zero dk and
// dv; a row with no valid key gets dq = 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;          // output rows per block
constexpr int kTile = kThreads;        // rows of the other axis per step
constexpr float kClip = 0.9999f;       // 1 - 1e-4
constexpr float kNormFloor = 1e-12f;

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

// (p, dg) of one pair from its Gram entry, the row's lse and δ and the pair's
// do·v: the replayed probability and the clip-gated score cotangent
__device__ __forceinline__ void pair_grad(float g, float lse, float delta,
                                          float dp, float* p, float* dg) {
  const float gc = fminf(fmaxf(g, -kClip), kClip);
  *p = expf(-acosf(gc) - lse);
  const float gate =
      fabsf(g) < kClip ? rsqrtf(fmaxf(1.f - gc * gc, 1e-12f)) : 0.f;
  *dg = *p * (dp - delta) * gate;
}

// (dx̂ − x̂ (dx̂·x̂)) / max(n, floor) written to out[0..Dh)
template <int DH>
__device__ __forceinline__ void normalize_vjp(const float (&dxh)[DH],
                                              const float (&xh)[DH], float n,
                                              int Dh,
                                              float* __restrict__ out) {
  float r = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) r = fmaf(dxh[d], xh[d], r);
  const float f = fmaxf(n, kNormFloor);
#pragma unroll
  for (int d = 0; d < DH; ++d)
    if (d < Dh) out[d] = (dxh[d] - xh[d] * r) / f;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_mhgsa_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ val,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq,
                      int L, int S, int Dh, int row_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                       // [kTile][DH] unit keys
  float* vs = ks + kTile * DH;            // [kTile][DH] values
  float* ok = vs + kTile * DH;            // [kTile] 1 = valid key

  const int t = threadIdx.x;
  const int b = blockIdx.x / row_tiles;
  const int i = (blockIdx.x % row_tiles) * kThreads + t;
  const bool row = i < L;
  const size_t ri = (size_t)b * L + i;
  const float* kb = k + (size_t)b * S * Dh;
  const float* vb = v + (size_t)b * S * Dh;
  const float* valb = val ? val + (size_t)b * S : nullptr;

  float qh[DH], dor[DH];
  float qn = 0.f, li = 0.f, di = 0.f;
  if (row) {
    load_row(q + ri * Dh, Dh, qh);
    load_row(dout + ri * Dh, Dh, dor);
    li = lse[ri];
    di = delta[ri];
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) qh[d] = dor[d] = 0.f;
  }
  qn = to_unit(qh);
  float dqh[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) dqh[d] = 0.f;

  for (int j0 = 0; j0 < S; j0 += kTile) {
    const int n = min(kTile, S - j0);
    __syncthreads();                      // the previous tile is consumed
    if (t < n) {
      const int j = j0 + t;
      float r[DH];
      load_row(kb + (size_t)j * Dh, Dh, r);
      to_unit(r);
#pragma unroll
      for (int d = 0; d < DH; ++d) ks[t * DH + d] = r[d];
      load_row(vb + (size_t)j * Dh, Dh, r);
#pragma unroll
      for (int d = 0; d < DH; ++d) vs[t * DH + d] = r[d];
      ok[t] = (valb == nullptr || valb[j] > 0.f) ? 1.f : 0.f;
    }
    __syncthreads();
    if (row) {
      for (int jj = 0; jj < n; ++jj) {
        if (ok[jj] == 0.f) continue;      // the same key for every thread
        const float* kr = ks + jj * DH;
        float p, dg;
        pair_grad(dot_smem(qh, kr), li, di, dot_smem(dor, vs + jj * DH), &p,
                  &dg);
        axpy_smem(dg, kr, dqh);
      }
    }
  }
  if (row) normalize_vjp(dqh, qh, qn, Dh, dq + ri * Dh);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_mhgsa_dkv_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ val,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int L,
                       int S, int Dh, int col_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [kTile][DH] unit query rows
  float* ds = qs + kTile * DH;            // [kTile][DH] their do rows
  float* ls = ds + kTile * DH;            // [kTile] lse
  float* dl = ls + kTile;                 // [kTile] δ

  const int t = threadIdx.x;
  const int b = blockIdx.x / col_tiles;
  const int j = (blockIdx.x % col_tiles) * kThreads + t;
  const bool col = j < S;
  const size_t rj = (size_t)b * S + j;
  const size_t qo = (size_t)b * L;
  const bool live = col && (val == nullptr || val[rj] > 0.f);

  float kh[DH], vr[DH];
  if (col) {
    load_row(k + rj * Dh, Dh, kh);
    load_row(v + rj * Dh, Dh, vr);
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) kh[d] = vr[d] = 0.f;
  }
  const float kn = to_unit(kh);
  float dkh[DH], dvr[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) dkh[d] = dvr[d] = 0.f;

  for (int i0 = 0; i0 < L; i0 += kTile) {
    const int n = min(kTile, L - i0);
    __syncthreads();                      // the previous tile is consumed
    if (t < n) {
      const size_t ri = qo + i0 + t;
      float r[DH];
      load_row(q + ri * Dh, Dh, r);
      to_unit(r);
#pragma unroll
      for (int d = 0; d < DH; ++d) qs[t * DH + d] = r[d];
      load_row(dout + ri * Dh, Dh, r);
#pragma unroll
      for (int d = 0; d < DH; ++d) ds[t * DH + d] = r[d];
      ls[t] = lse[ri];
      dl[t] = delta[ri];
    }
    __syncthreads();
    if (live) {
      for (int ii = 0; ii < n; ++ii) {
        const float* qr = qs + ii * DH;
        const float* dr = ds + ii * DH;
        float p, dg;
        pair_grad(dot_smem(kh, qr), ls[ii], dl[ii], dot_smem(vr, dr), &p,
                  &dg);
        axpy_smem(p, dr, dvr);
        axpy_smem(dg, qr, dkh);
      }
    }
  }
  if (col) {
    normalize_vjp(dkh, kh, kn, Dh, dk + rj * Dh);
#pragma unroll
    for (int d = 0; d < DH; ++d)
      if (d < Dh) dv[rj * Dh + d] = dvr[d];
  }
}

constexpr size_t kSmem(int dh) {
  return sizeof(float) * (2 * kTile * dh + 2 * kTile);
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DH>
int launch_dq(const float* q, const float* k, const float* v,
              const float* val, const float* dout, const float* lse,
              const float* delta, float* dq, int B, int L, int S, int Dh,
              cudaStream_t stream) {
  int err = allow_smem(flash_mhgsa_dq_kernel<DH>, kSmem(DH));
  if (err != cudaSuccess) return err;
  const int tiles = (L + kThreads - 1) / kThreads;
  const long long blocks = (long long)B * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_mhgsa_dq_kernel<DH><<<(unsigned)blocks, kThreads, kSmem(DH),
                              stream>>>(q, k, v, val, dout, lse, delta, dq, L,
                                        S, Dh, tiles);
  return cudaGetLastError();
}

template <int DH>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* val, const float* dout, const float* lse,
               const float* delta, float* dk, float* dv, int B, int L, int S,
               int Dh, cudaStream_t stream) {
  int err = allow_smem(flash_mhgsa_dkv_kernel<DH>, kSmem(DH));
  if (err != cudaSuccess) return err;
  const int tiles = (S + kThreads - 1) / kThreads;
  const long long blocks = (long long)B * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_mhgsa_dkv_kernel<DH><<<(unsigned)blocks, kThreads, kSmem(DH),
                               stream>>>(q, k, v, val, dout, lse, delta, dk,
                                         dv, L, S, Dh, tiles);
  return cudaGetLastError();
}

}  // namespace

// The dq sweep. q [B,L,Dh], k/v [B,S,Dh], val [B,S] (> 0 marks a real key)
// or null, dout [B,L,Dh], lse and delta [B,L]; output dq [B,L,Dh]. All fp32,
// contiguous, on the current device. Launches on `stream` and returns
// cudaGetLastError() (0 on success). A head dim outside 1..128 is refused
// with cudaErrorInvalidValue.
extern "C" int flash_mhgsa_dq(const float* q, const float* k, const float* v,
                              const float* val, const float* dout,
                              const float* lse, const float* delta, float* dq,
                              int B, int L, int S, int Dh, void* stream) {
  if (B < 0 || L < 0 || S < 0 || Dh < 1 || Dh > 128)
    return cudaErrorInvalidValue;
  if (B == 0 || L == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh <= 8)
    return launch_dq<8>(q, k, v, val, dout, lse, delta, dq, B, L, S, Dh, st);
  if (Dh <= 16)
    return launch_dq<16>(q, k, v, val, dout, lse, delta, dq, B, L, S, Dh, st);
  if (Dh <= 32)
    return launch_dq<32>(q, k, v, val, dout, lse, delta, dq, B, L, S, Dh, st);
  if (Dh <= 64)
    return launch_dq<64>(q, k, v, val, dout, lse, delta, dq, B, L, S, Dh, st);
  return launch_dq<128>(q, k, v, val, dout, lse, delta, dq, B, L, S, Dh, st);
}

// The dk/dv sweep: the same operands; outputs dk and dv [B,S,Dh].
extern "C" int flash_mhgsa_dkv(const float* q, const float* k, const float* v,
                               const float* val, const float* dout,
                               const float* lse, const float* delta,
                               float* dk, float* dv, int B, int L, int S,
                               int Dh, void* stream) {
  if (B < 0 || L < 0 || S < 0 || Dh < 1 || Dh > 128)
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh <= 8)
    return launch_dkv<8>(q, k, v, val, dout, lse, delta, dk, dv, B, L, S, Dh,
                         st);
  if (Dh <= 16)
    return launch_dkv<16>(q, k, v, val, dout, lse, delta, dk, dv, B, L, S, Dh,
                          st);
  if (Dh <= 32)
    return launch_dkv<32>(q, k, v, val, dout, lse, delta, dk, dv, B, L, S, Dh,
                          st);
  if (Dh <= 64)
    return launch_dkv<64>(q, k, v, val, dout, lse, delta, dk, dv, B, L, S, Dh,
                          st);
  return launch_dkv<128>(q, k, v, val, dout, lse, delta, dk, dv, B, L, S, Dh,
                         st);
}
