// Small-shape geodesic attention forward, both metrics: the packed forward
// (packed_mhgsa_fwd.cu, kernel P) and the whole-S forward's small-S mode
// (mhgsa_fwd.cu: kernels A and 1p at S ≤ its crossover) share this body.
//
// For each problem p and query row i:
//
//   e_ij     = w(q_i, k_j) · val[p / H, j] · 2^(mask[p,i,j]·log2 e)
//   out[p,i] = Σ_j e_ij v[p,j] / max(Σ_j e_ij, 1e-30)
//
// with the oblique weight w = exp(−acos(clip(q̂_i·k̂_j, ±(1 − 1e-4)))),
// x̂ = x / max(‖x‖, 1e-12), or the poincaré weight of ball points
// (poincare::fwd_weight); the key validity val (shared by the H heads of a
// problem's batch row) and the additive mask (canonicalized by the caller:
// finite entries in [−30, 0], −1e30 excludes) are each optional. The weights
// are bounded, so the softmax needs no max and no rescaling: one pass sums
// Σ e·v and Σ e, and one division ends the row. An invalid key (val 0) or
// an excluded entry (2^(−1.44e30) = +0) gets weight exactly 0, so a row
// with none left outputs exactly 0.
//
// What bounds it on the H100: at the model's shapes (88 problems of
// 32 × 32 × 8, or 512 of 8 × 8 × 8) the whole input is a few hundred KB
// and a few M operations, a bound of ~0.1 µs; the launch and the serial
// chain of one row's keys bound it instead. So the design shortens the
// chain and fills more SMs:
// - a block per (problem, chunk of `rows` ≤ 32 query rows): at 88 × 32²
//   88 blocks (the one-warp-per-32-rows layout gave 22 blocks of 4 warps);
// - the block's rows × slices threads: thread t owns row t % rows (lane =
//   row) and key slice t / rows, the keys j ≡ slice (mod slices) of each
//   staged tile, so that `slices` partial sums of each row run side by side
//   (about kKeysPerThread keys each: 8 slices of 4 keys at 32², one warp per
//   slice) and are combined once, through shared memory, at the end;
// - keys (unit rows for oblique; raw ball rows and y2 for poincaré), values,
//   the validity and the mask's row segments are staged cooperatively, up to
//   tile_keys<DH>() keys at a time, rows padded to an odd stride so that the
//   slices of one warp hit distinct banks (one warp reads one key as a
//   broadcast when rows = 32);
// - the epilogue is the TPU kernel's own (oblique.cuh's weight): acos from
//   the Abramowitz & Stegun 4.4.46 polynomial
//   (sttode_tpu/kernels/mhgsa.py::_acos, |error| ≤ 2e-8),
//   √(1 − |g|) as x·rsqrt(x) and the exp as one ex2 on the SFU (a negative
//   Gram takes e^(−π)·2^(r·log2 e)); poincaré as poincare::fwd_weight (zc
//   in IEEE fp32, then rcp, and lg2/ex2 only at c ≠ 1); a masked entry
//   multiplies by one more ex2.
// The Gram stays fp32 FMAs: no TF32 and no tensor cores (acos' amplifies
// Gram error near ±1; x2 − 2g + y2 cancels for close points).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "oblique.cuh"
#include "poincare.cuh"
#include "sfu.cuh"
#include "smem_attr.cuh"

// timing variants of the design (see scripts/torch_small_attn_bench.py):
// the IEEE epilogue (acosf, expf, the poincaré score's logf) in place of the
// SFU one, and one key slice (a warp per 32 rows, each lane all the keys)
#ifndef STTODE_SMALL_IEEE_EPILOGUE
#define STTODE_SMALL_IEEE_EPILOGUE 0
#endif
#ifndef STTODE_SMALL_ONE_SLICE
#define STTODE_SMALL_ONE_SLICE 0
#endif

// internal linkage: each including source keeps its own copy
namespace {
namespace small_fwd {

constexpr float kNormFloor = 1e-12f;
constexpr float kDenFloor = 1e-30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kKeysPerThread = 4;

// threads of a block: 256 up to Dh = 32, 128 above (q̂ and the accumulator
// are 2·DH registers a thread)
template <int DH>
__host__ __device__ constexpr int max_threads() {
  return DH <= 32 ? 256 : 128;
}

// keys staged at a time: 128 up to Dh = 16, then 2048 / DH
template <int DH>
__host__ __device__ constexpr int tile_keys() {
  return DH <= 16 ? 128 : 2048 / DH;
}

__host__ __device__ constexpr int ld(int dh) { return dh | 1; }

template <bool POINCARE, bool C1>
__device__ __forceinline__ float weight(float g, float x2, float y2,
                                        const poincare::Curv& k) {
  if (!POINCARE) return oblique::weight<STTODE_SMALL_IEEE_EPILOGUE>(g);
#if STTODE_SMALL_IEEE_EPILOGUE
  return expf(poincare::score(poincare::pair(g, x2, y2, k), k));
#else
  return poincare::fwd_weight<C1>(g, x2, y2, k);
#endif
}

__device__ __forceinline__ float mask_factor(float m) {
#if STTODE_SMALL_IEEE_EPILOGUE
  return expf(m);
#else
  return sfu::ex2_approx(m * kLog2e);
#endif
}

// shared memory of a block: the staged tile (keys, values, the validity or
// y2, the mask's row segments), later reused for the slices' partial sums
template <int DH>
size_t smem_bytes(int rows, int slices, bool masked) {
  constexpr int TK = tile_keys<DH>();
  const size_t tile = (size_t)TK * (2 * ld(DH) + 1) +
                      (masked ? (size_t)rows * (TK + 1) : 0);
  const size_t part = slices > 1 ? (size_t)rows * slices * (DH + 1) : 0;
  return sizeof(float) * (tile > part ? tile : part);
}

// q [P,L,Dh], k/v [P,S,Dh], val [P/H,S] or null, mask [P,L,S] or null,
// out [P,L,Dh]; block (p, row chunk), rows × slices threads
template <int DH, bool POINCARE, bool C1>
__device__ __forceinline__ void body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ val,
    const float* __restrict__ mask, float* __restrict__ out, int H, int L,
    int S, int Dh, int rows, int slices, const poincare::Curv& curv) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TK = tile_keys<DH>();
  constexpr int LD = ld(DH);
  float* ks = smem;                 // [TK][LD] unit (ball) keys
  float* vs = ks + TK * LD;         // [TK][LD] values
  float* kx = vs + TK * LD;         // [TK] validity (oblique) or y2
  float* ms = kx + TK;              // [rows][TK + 1] mask segments

  const int p = blockIdx.x;
  const int t = threadIdx.x, nt = blockDim.x;
  const int r = t % rows, s = t / rows;
  const int i0 = blockIdx.y * rows;
  const int i = i0 + r;
  const bool row = i < L;
  const float* kp = k + (size_t)p * S * Dh;
  const float* vp = v + (size_t)p * S * Dh;
  const float* valp = val ? val + (size_t)(p / H) * S : nullptr;
  const float* mp = mask ? mask + (size_t)p * L * S : nullptr;

  float qh[DH];
  float x2 = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qh[d] = row && d < Dh ? q[((size_t)p * L + i) * Dh + d] : 0.f;
    x2 = fmaf(qh[d], qh[d], x2);
  }
  if (!POINCARE) {
    const float f = fmaxf(sqrtf(x2), kNormFloor);
#pragma unroll
    for (int d = 0; d < DH; ++d) qh[d] = qh[d] / f;
  }
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float den = 0.f;

  for (int j0 = 0; j0 < S; j0 += TK) {
    const int n = min(TK, S - j0);
    for (int jj = t; jj < n; jj += nt) {
      const float* kr = kp + (size_t)(j0 + jj) * Dh;
      float kr_[DH];
      float ss = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        kr_[d] = d < Dh ? kr[d] : 0.f;
        ss = fmaf(kr_[d], kr_[d], ss);
      }
      const float f = POINCARE ? 1.f : fmaxf(sqrtf(ss), kNormFloor);
#pragma unroll
      for (int d = 0; d < DH; ++d)
        ks[jj * LD + d] = POINCARE ? kr_[d] : kr_[d] / f;
      kx[jj] = POINCARE ? ss : (valp ? valp[j0 + jj] : 1.f);
    }
    for (int e = t; e < n * DH; e += nt) {
      const int jj = e / DH, d = e % DH;
      vs[jj * LD + d] = d < Dh ? vp[(size_t)(j0 + jj) * Dh + d] : 0.f;
    }
    if (mp) {
      for (int e = t; e < rows * n; e += nt) {
        const int rr = e / n, jj = e % n;
        ms[rr * (TK + 1) + jj] =
            i0 + rr < L ? mp[(size_t)(i0 + rr) * S + j0 + jj] : 0.f;
      }
    }
    __syncthreads();
    for (int jj = s; jj < n; jj += slices) {
      const float* kr = ks + jj * LD;
      float g = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) g = fmaf(qh[d], kr[d], g);
      float e = weight<POINCARE, C1>(g, x2, kx[jj], curv);
      if (!POINCARE) e *= kx[jj];
      if (mp) e *= mask_factor(ms[r * (TK + 1) + jj]);
      den += e;
      const float* vr = vs + jj * LD;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(e, vr[d], acc[d]);
    }
    __syncthreads();
  }

  if (slices == 1) {
    if (row) {
      const float dn = fmaxf(den, kDenFloor);
      float* o = out + ((size_t)p * L + i) * Dh;
#pragma unroll
      for (int d = 0; d < DH; ++d)
        if (d < Dh) o[d] = acc[d] / dn;
    }
    return;
  }
  // the slices' partial sums, combined in slice order
  float* part = smem;               // [slices][rows][DH + 1]
  float* mine = part + (size_t)t * (DH + 1);
#pragma unroll
  for (int d = 0; d < DH; ++d) mine[d] = acc[d];
  mine[DH] = den;
  __syncthreads();
  for (int e = t; e < rows * Dh; e += nt) {
    const int rr = e / Dh, d = e % Dh;
    if (i0 + rr >= L) continue;
    float a = 0.f, dn = 0.f;
    for (int sl = 0; sl < slices; ++sl) {
      const float* pr = part + (size_t)(sl * rows + rr) * (DH + 1);
      a += pr[d];
      dn += pr[DH];
    }
    out[((size_t)p * L + i0 + rr) * Dh + d] = a / fmaxf(dn, kDenFloor);
  }
}

__host__ __forceinline__ int pow2_ceil(int x) {
  int y = 1;
  while (y < x) y <<= 1;
  return y;
}

// the block's layout (kernels/mhgsa.py::small_fwd_layout is its Python
// form): rows = min(L, 32) rounded up to a power of two, and enough key
// slices for about kKeysPerThread keys a thread, within max_threads<DH>()
// and at most one slice per staged key (so that a tile's keys split evenly)
template <int DH>
void layout(int L, int S, int* rows, int* slices) {
  *rows = pow2_ceil(L < 32 ? L : 32);
  int n = pow2_ceil((S + kKeysPerThread - 1) / kKeysPerThread);
  if (n > max_threads<DH>() / *rows) n = max_threads<DH>() / *rows;
  if (n > tile_keys<DH>()) n = tile_keys<DH>();
  *slices = STTODE_SMALL_ONE_SLICE ? 1 : n;
}

// launch `kernel` (a __global__ wrapper of body<DH, ...>) over P problems
template <int DH, typename Kernel>
int launch(Kernel* kernel, const float* q, const float* k, const float* v,
           const float* val, const float* mask, float* out, int P, int H,
           int L, int S, int Dh, float c, cudaStream_t stream) {
  int rows = 0, slices = 0;
  layout<DH>(L, S, &rows, &slices);
  const size_t smem = smem_bytes<DH>(rows, slices, mask != nullptr);
  const int chunks = (L + rows - 1) / rows;
  if (chunks > 65535) return cudaErrorInvalidValue;
  cudaError_t err = smem_attr::allow(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)P, (unsigned)chunks), rows * slices, smem,
           stream>>>(q, k, v, val, mask, out, H, L, S, Dh, rows, slices,
                     poincare::make_curv(c));
  return cudaGetLastError();
}

}  // namespace small_fwd
}  // namespace
