// Small-shape geodesic attention forward with key validity, Hopper (sm_90a),
// fp32.
//
// Replaces the TPU kernel sttode_tpu/kernels/packed_mhgsa.py::_packed_fwd
// (kernel body _make_packed_fwd_kernel). For each problem p = (b, h) of
// q [B·H, L, Dh], k/v [B·H, S, Dh] and the validity row val[b] [S] (shared by
// the H heads of b, or null for all-valid):
//
//   out[p,i] = Σ_j e_ij v[p,j] / max(Σ_j e_ij, 1e-30),
//   e_ij     = exp(−acos(clip(q̂_i·k̂_j, ±(1 − 1e-4)))) · val[b,j]
//
// with x̂ = x / max(‖x‖, 1e-12). The scores lie in [−π, 0], so the softmax
// needs no max: a masked key multiplies its exp by 0 and an all-invalid
// problem outputs exactly 0.
//
// What bounds it on the H100: the route sends it L·S ≤ 32² problems of
// head dim 8 — at the NBA recipe 88 problems of 32 × 32 × 8, 360 KB in and
// out and 3.4 M operations, a bound of ~0.1 µs (chip_smoke.py,
// attn_fwd_work). Nothing of that fills the card: launch latency and the
// serial chain inside a problem bound it. The TPU kernel packs the H heads
// into the 128 lanes with block-diagonal key matrices so that its MXU sees
// full tiles; on Hopper a warp is the natural unit of a problem this small,
// so the packing is dropped: one warp per (problem, chunk of 32 query rows),
// each lane owning one query row. A lane keeps q̂_i and its output
// accumulator in registers (the head dim rounded up to a compile-time
// 8/16/32/64/128) and walks the keys; keys and values are staged 32 at a
// time into the warp's shared memory (each lane normalizes one key) and read
// back as broadcasts, so no warp reduction and no bank conflict sits in the
// inner loop. Σ_j e_ij v_j and Σ_j e_ij accumulate together (maxless: no
// rescaling) and one division ends the row. The Gram uses fp32 FMAs, no
// TF32: acos' amplifies Gram error near ±1.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr float kClip = 0.9999f;       // 1 - 1e-4
constexpr float kNormFloor = 1e-12f;
constexpr float kDenFloor = 1e-30f;

// r = x[0..Dh) zero-padded to DH, scaled to unit norm (norm floored);
// returns the unfloored norm.
template <int DH>
__device__ __forceinline__ float load_unit(const float* __restrict__ x,
                                           int Dh, float (&r)[DH]) {
  float ss = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    r[d] = d < Dh ? x[d] : 0.f;
    ss = fmaf(r[d], r[d], ss);
  }
  const float n = sqrtf(ss);
  const float f = fmaxf(n, kNormFloor);
#pragma unroll
  for (int d = 0; d < DH; ++d) r[d] = r[d] / f;
  return n;
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
packed_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ val,
                  float* __restrict__ out, int P, int H, int L, int S,
                  int Dh) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ks = smem + warp * (2 * 32 * DH + 32);   // [32][DH] unit keys
  float* vs = ks + 32 * DH;                       // [32][DH] values
  float* vl = vs + 32 * DH;                       // [32] key validity

  const int chunks = (L + 31) / 32;
  const long long item = (long long)blockIdx.x * kWarps + warp;
  if (item >= (long long)P * chunks) return;      // whole warp leaves
  const int p = (int)(item / chunks);
  const int i = (int)(item % chunks) * 32 + lane;
  const bool row = i < L;
  const float* kp = k + (size_t)p * S * Dh;
  const float* vp = v + (size_t)p * S * Dh;
  const float* valp = val ? val + (size_t)(p / H) * S : nullptr;

  float qh[DH];
  if (row) {
    load_unit(q + ((size_t)p * L + i) * Dh, Dh, qh);
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) qh[d] = 0.f;
  }
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float den = 0.f;

  for (int j0 = 0; j0 < S; j0 += 32) {
    const int n = min(32, S - j0);
    if (lane < n) {
      const int j = j0 + lane;
      float kr[DH];
      load_unit(kp + (size_t)j * Dh, Dh, kr);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        ks[lane * DH + d] = kr[d];
        vs[lane * DH + d] = d < Dh ? vp[(size_t)j * Dh + d] : 0.f;
      }
      vl[lane] = valp ? valp[j] : 1.f;
    }
    __syncwarp();
    for (int jj = 0; jj < n; ++jj) {
      const float* kr = ks + jj * DH;
      const float* vr = vs + jj * DH;
      float g = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) g = fmaf(qh[d], kr[d], g);
      const float e = expf(-acosf(fminf(fmaxf(g, -kClip), kClip))) * vl[jj];
      den += e;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(e, vr[d], acc[d]);
    }
    __syncwarp();
  }
  if (row) {
    const float dn = fmaxf(den, kDenFloor);
    float* o = out + ((size_t)p * L + i) * Dh;
#pragma unroll
    for (int d = 0; d < DH; ++d)
      if (d < Dh) o[d] = acc[d] / dn;
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, const float* val,
           float* out, int P, int H, int L, int S, int Dh,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * (2 * 32 * DH + 32);
  if (smem > 48 * 1024) {
    int dev = 0, max_smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(packed_fwd_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long items = (long long)P * ((L + 31) / 32);
  const long long blocks = (items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  packed_fwd_kernel<DH><<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      q, k, v, val, out, P, H, L, S, Dh);
  return cudaGetLastError();
}

}  // namespace

// q [B,H,L,Dh], k/v [B,H,S,Dh], val [B,S] (key validity multiplying each
// exp, shared by the heads) or null, out [B,H,L,Dh]; all fp32, contiguous,
// on the current device. Launches on `stream` and returns
// cudaGetLastError() (0 on success). A head dim outside 1..128 is refused
// with cudaErrorInvalidValue.
extern "C" int packed_mhgsa_fwd(const float* q, const float* k,
                                const float* v, const float* val, float* out,
                                int B, int H, int L, int S, int Dh,
                                void* stream) {
  if (B < 0 || H < 0 || L < 0 || S < 0 || Dh < 1 || Dh > 128)
    return cudaErrorInvalidValue;
  const int P = B * H;
  if (P == 0 || L == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh <= 8) return launch<8>(q, k, v, val, out, P, H, L, S, Dh, st);
  if (Dh <= 16) return launch<16>(q, k, v, val, out, P, H, L, S, Dh, st);
  if (Dh <= 32) return launch<32>(q, k, v, val, out, P, H, L, S, Dh, st);
  if (Dh <= 64) return launch<64>(q, k, v, val, out, P, H, L, S, Dh, st);
  return launch<128>(q, k, v, val, out, P, H, L, S, Dh, st);
}
