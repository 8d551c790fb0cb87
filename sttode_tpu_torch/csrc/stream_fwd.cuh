// Key-streaming geodesic attention forward, both metrics, any head dim: the
// whole-S forward's mode beyond shared memory (mhgsa_fwd.cu) and the flash
// forward's mode for head dims above 128 (flash_mhgsa_fwd.cu).
//
// For each problem b and query row i:
//
//   e_ij     = exp(s_ij + mask[b,i,j])      (0 where val[b,j] ≤ 0)
//   l_i      = max(Σ_j e_ij, 1e-30)
//   out[b,i] = Σ_j e_ij v[b,j] / l_i,    lse[b,i] = log(l_i)
//
// with the oblique score s_ij = −acos(clip(q̂_i·k̂_j, ±(1 − 1e-4))) or the
// poincaré score of ball points (poincare.cuh). The mask (already
// canonicalized by the caller), the key validity and the lse are each
// optional. The scores are bounded and the mask is canonicalized, so the
// softmax needs no running max: one pass over the keys accumulates Σ e and
// Σ e·v per row, and one division ends the row.
//
// Design: a block per (problem, tile of `rows` query rows), kWarps warps, a
// warp per query row at a time. The rows' q (unit, or the ball row and its
// x2) and their accumulators live in shared memory, sized by Dh and not by
// S; the keys are normalized (or kept raw with their y2) and staged with
// their values `tile` ≤ 32 at a time, one lane per key: lane j's Gram is a
// dot product over the key's row (an odd stride, so the lanes hit distinct
// banks), its score and mask entry (read straight from device memory, 32
// consecutive floats per warp) give e_j in the warp's row of shared memory,
// and then the lanes split the head dim to add Σ_j e_j v_j to the
// accumulator. `rows` and `tile` are chosen at launch so that the block
// fits shared memory (config); the grid's B × ceil(L / rows)
// blocks fill the SMs where B alone (8 problems) would not.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "poincare.cuh"
#include "smem_attr.cuh"

// internal linkage: each including source keeps its own copy
namespace {
namespace stream_fwd {

constexpr int kWarps = 4;
constexpr float kClip = 0.9999f;       // 1 - 1e-4
constexpr float kNormFloor = 1e-12f;
constexpr float kDenFloor = 1e-30f;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// floats of shared memory for `rows` query rows and key tiles of `tile`
inline size_t smem_floats(int rows, int tile, int Dh) {
  return 2 * (size_t)rows * Dh + 2 * (size_t)rows
         + (size_t)tile * ((Dh | 1) + Dh + 2) + (size_t)kWarps * tile;
}

// The largest (rows, tile) — rows first, from 16 down to kWarps, then tile
// from 32 down to 1 — whose shared memory fits max_smem bytes; false when
// even (kWarps, 1) does not (Dh above ~5,800).
inline bool config(int Dh, int max_smem, int* rows, int* tile) {
  for (int r = 16; r >= kWarps; r /= 2)
    for (int t = 32; t >= 1; t /= 2)
      if (sizeof(float) * smem_floats(r, t, Dh) <= (size_t)max_smem) {
        *rows = r;
        *tile = t;
        return true;
      }
  return false;
}

template <bool POINCARE>
__global__ void __launch_bounds__(kWarps * 32)
stream_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ mask,
                  const float* __restrict__ val, float* __restrict__ out,
                  float* __restrict__ lse, int L, int S, int Dh, int rows,
                  int tile, int row_tiles, poincare::Curv curv) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = Dh | 1;
  float* qs = smem;                       // [rows][Dh] unit (ball) q rows
  float* acc = qs + rows * Dh;            // [rows][Dh] Σ e·v
  float* x2 = acc + rows * Dh;            // [rows] poincaré: ‖q_i‖²
  float* den = x2 + rows;                 // [rows] Σ e
  float* ks = den + rows;                 // [tile][ldk] unit (ball) keys
  float* vs = ks + tile * ldk;            // [tile][Dh] values
  float* y2 = vs + tile * Dh;             // [tile] poincaré: ‖k_j‖²
  float* ok = y2 + tile;                  // [tile] 1 = valid key
  float* pe = ok + tile;                  // [kWarps][tile] e of a row

  const int b = blockIdx.x / row_tiles;
  const int i0 = (blockIdx.x % row_tiles) * rows;
  const int nr = min(rows, L - i0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* kb = k + (size_t)b * S * Dh;
  const float* vb = v + (size_t)b * S * Dh;
  const float* valb = val ? val + (size_t)b * S : nullptr;

  // the block's query rows, normalized (oblique) or raw with x2 (poincaré)
  for (int r = warp; r < nr; r += kWarps) {
    const float* qr = q + ((size_t)b * L + i0 + r) * Dh;
    float ss = 0.f;
    for (int d = lane; d < Dh; d += 32) ss = fmaf(qr[d], qr[d], ss);
    ss = warp_sum(ss);
    const float f = POINCARE ? 1.f : fmaxf(sqrtf(ss), kNormFloor);
    for (int d = lane; d < Dh; d += 32) {
      qs[r * Dh + d] = POINCARE ? qr[d] : qr[d] / f;
      acc[r * Dh + d] = 0.f;
    }
    if (lane == 0) {
      x2[r] = ss;
      den[r] = 0.f;
    }
  }

  float* pw = pe + warp * tile;
  for (int j0 = 0; j0 < S; j0 += tile) {
    const int n = min(tile, S - j0);
    __syncthreads();                      // the previous tile is consumed
    // stage the tile: a warp per key, the lanes over the head dim
    for (int jj = warp; jj < n; jj += kWarps) {
      const float* kr = kb + (size_t)(j0 + jj) * Dh;
      float ss = 0.f;
      for (int d = lane; d < Dh; d += 32) ss = fmaf(kr[d], kr[d], ss);
      ss = warp_sum(ss);
      const float f = POINCARE ? 1.f : fmaxf(sqrtf(ss), kNormFloor);
      for (int d = lane; d < Dh; d += 32) {
        ks[jj * ldk + d] = POINCARE ? kr[d] : kr[d] / f;
        vs[jj * Dh + d] = vb[(size_t)(j0 + jj) * Dh + d];
      }
      if (lane == 0) {
        y2[jj] = ss;
        ok[jj] = (valb == nullptr || valb[j0 + jj] > 0.f) ? 1.f : 0.f;
      }
    }
    __syncthreads();
    for (int r = warp; r < nr; r += kWarps) {
      const float* qr = qs + r * Dh;
      float e = 0.f;
      if (lane < n && ok[lane] != 0.f) {
        const float* kr = ks + lane * ldk;
        float g = 0.f;
        for (int d = 0; d < Dh; ++d) g = fmaf(qr[d], kr[d], g);
        float s = POINCARE
            ? poincare::score(poincare::pair(g, x2[r], y2[lane], curv), curv)
            : -acosf(fminf(fmaxf(g, -kClip), kClip));
        if (mask) s += mask[((size_t)b * L + i0 + r) * S + j0 + lane];
        e = expf(s);
      }
      if (lane < n) pw[lane] = e;
      const float se = warp_sum(e);
      if (lane == 0) den[r] += se;
      __syncwarp();
      float* ar = acc + r * Dh;
      for (int d = lane; d < Dh; d += 32) {
        float a = ar[d];
        for (int jj = 0; jj < n; ++jj) a = fmaf(pw[jj], vs[jj * Dh + d], a);
        ar[d] = a;
      }
      __syncwarp();
    }
  }
  __syncwarp();
  for (int r = warp; r < nr; r += kWarps) {
    const float l = fmaxf(den[r], kDenFloor);
    float* o = out + ((size_t)b * L + i0 + r) * Dh;
    for (int d = lane; d < Dh; d += 32) o[d] = acc[r * Dh + d] / l;
    if (lse && lane == 0) lse[(size_t)b * L + i0 + r] = logf(l);
  }
}

// Launch over B problems on `stream`; cudaErrorInvalidValue when the head
// dim does not fit shared memory even at the smallest tiles.
template <bool POINCARE>
int launch(const float* q, const float* k, const float* v, const float* mask,
           const float* val, float* out, float* lse, int B, int L, int S,
           int Dh, float c, cudaStream_t stream) {
  int max_smem = 0;
  cudaError_t err = smem_attr::optin_limit(&max_smem);
  if (err != cudaSuccess) return err;
  int rows = 0, tile = 0;
  if (!config(Dh, max_smem, &rows, &tile)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(rows, tile, Dh);
  err = smem_attr::allow(stream_fwd_kernel<POINCARE>, smem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (L + rows - 1) / rows;
  const long long blocks = (long long)B * row_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  stream_fwd_kernel<POINCARE><<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      q, k, v, mask, val, out, lse, L, S, Dh, rows, tile, row_tiles,
      poincare::make_curv(c));
  return cudaGetLastError();
}

}  // namespace stream_fwd
}  // namespace
