// Geodesic attention forward for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel sttode_tpu/kernels/mhgsa.py::_fused_fwd (kernel body
// _make_fwd_kernel), oblique metric. For each problem b and query row i:
//
//   out[b,i] = Σ_j p_ij · v[b,j],   p_ij = e_ij / max(Σ_j e_ij, 1e-30),
//   e_ij     = exp(-acos(clip(q̂_i · k̂_j, ±(1 − 1e-4))) + mask[b,i,j])
//
// with x̂ = x / max(‖x‖, 1e-12). The softmax is maxless, as on the TPU: the
// scores are bounded in [-π, 0] and the caller canonicalizes the mask (row-max
// shift, floor −30, excluded entries = −1e30), so exp cannot overflow and an
// all-excluded row gets denominator 1e-30 and outputs exactly 0.
//
// What bounds it on the H100: on the serving path the problems are tiny
// (L = S ≤ 32, Dh = 8 — one problem per (scene or agent slot) × head), so
// the kernel is bound by latency and launch overhead, not by bytes or FLOPs:
// the whole input is a few hundred KB. The design keeps one problem per block
// with all its keys and values staged once in shared memory (normalized k
// rows padded to an odd stride so the per-lane Gram loop hits no bank
// conflicts), one warp per query row, scores held in a per-warp shared row,
// and the Gram computed with fp32 FMAs: no TF32 and no tensor cores, because
// acos' amplifies Gram error near ±1. acosf is CUDA's (≤ 2 ulp), where the
// TPU needed a polynomial.
//
// The score orientation is always scores[i,j] = -acos(q̂_i·k̂_j); the
// reference-compat transposed square case (quirk Q3) is the caller swapping
// q and k.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr float kClip = 0.9999f;       // 1 - 1e-4
constexpr float kNormFloor = 1e-12f;
constexpr float kDenFloor = 1e-30f;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kWarps * 32)
mhgsa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 float* __restrict__ out, int L, int S, int Dh) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = Dh | 1;                 // odd stride: conflict-free rows
  float* kn = smem;                       // [S][ldk] normalized keys
  float* vs = kn + S * ldk;               // [S][Dh]
  float* qn = vs + S * Dh;                // [kWarps][Dh]
  float* p = qn + kWarps * Dh;            // [kWarps][S]

  const int b = blockIdx.x;
  const float* qb = q + (size_t)b * L * Dh;
  const float* kb = k + (size_t)b * S * Dh;
  const float* vb = v + (size_t)b * S * Dh;

  for (int i = threadIdx.x; i < S * Dh; i += blockDim.x) vs[i] = vb[i];
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const float* kr = kb + (size_t)j * Dh;
    float ss = 0.f;
    for (int d = 0; d < Dh; ++d) ss = fmaf(kr[d], kr[d], ss);
    const float nrm = fmaxf(sqrtf(ss), kNormFloor);
    for (int d = 0; d < Dh; ++d) kn[j * ldk + d] = kr[d] / nrm;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qw = qn + warp * Dh;
  float* pw = p + warp * S;
  for (int i = warp; i < L; i += kWarps) {
    const float* qr = qb + (size_t)i * Dh;
    float ss = 0.f;
    for (int d = lane; d < Dh; d += 32) ss = fmaf(qr[d], qr[d], ss);
    const float nrm = fmaxf(sqrtf(warp_sum(ss)), kNormFloor);
    for (int d = lane; d < Dh; d += 32) qw[d] = qr[d] / nrm;
    __syncwarp();

    const float* mrow = mask ? mask + ((size_t)b * L + i) * S : nullptr;
    float den = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float* kr = kn + j * ldk;
      float g = 0.f;
      for (int d = 0; d < Dh; ++d) g = fmaf(qw[d], kr[d], g);
      float s = -acosf(fminf(fmaxf(g, -kClip), kClip));
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

}  // namespace

// q [B,L,Dh], k/v [B,S,Dh], mask [B,L,S] or null (already canonicalized),
// out [B,L,Dh]; all fp32, contiguous, on the current device. Launches on
// `stream` and returns cudaGetLastError() (0 on success). An S whose keys and
// values do not fit in shared memory is refused with cudaErrorInvalidValue.
extern "C" int mhgsa_fwd(const float* q, const float* k, const float* v,
                         const float* mask, float* out, int B, int L, int S,
                         int Dh, void* stream) {
  if (B <= 0 || L <= 0) return cudaSuccess;
  const size_t smem =
      sizeof(float) * ((size_t)S * (Dh | 1) + (size_t)S * Dh +
                       (size_t)kWarps * Dh + (size_t)kWarps * S);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(mhgsa_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  mhgsa_fwd_kernel<<<B, kWarps * 32, smem, (cudaStream_t)stream>>>(
      q, k, v, mask, out, L, S, Dh);
  return cudaGetLastError();
}
