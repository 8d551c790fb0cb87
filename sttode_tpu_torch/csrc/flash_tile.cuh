// What the flash register kernels share: the forward of both metrics
// (flash_mhgsa_fwd.cu, F and 3p) and the dq and dk/dv sweeps
// (flash_mhgsa_bwd.cu, Fdq, Fdkv and 4p). A block has kThreads threads,
// each owning output rows (the sweeps sweep_rows(DH): two at DH ≤ 16, where
// registers allow; the forward its own choice); the other axis is staged
// raw, sweep_tile(DH) rows at a time, with cp.async into shared memory,
// with no registers or instructions of the threads; what is derived from a
// staged row (its squared norm, or its unit form) is computed from shared
// memory once the tile has landed.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// internal linkage: each including source keeps its own copy
namespace {
namespace flash_tile {

constexpr int kThreads = 128;          // threads (and row slots) per block
constexpr float kNormFloor = 1e-12f;   // x̂ = x / max(‖x‖, kNormFloor)

// output rows per thread: two where registers allow (no spills at DH ≤ 16)
constexpr int sweep_rows(int dh) { return dh <= 16 ? 2 : 1; }

// rows of the other axis per staged tile: 128, fewer above DH = 32, so that
// a tile's two [rows][DH] arrays stay within 32 KB
__host__ __device__ constexpr int sweep_tile(int dh) {
  return dh <= 32 ? kThreads : 4096 / dh;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool full, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(full ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Start copying rows [0, n) of the [*, Dh] array src into the [T][DH] tile
// dst, the columns from Dh up to DH zero-filled: 16 bytes a copy when the
// rows are 16-byte aligned (vec), else 4.
template <int DH>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int n, int Dh, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < n * (DH / 4); e += kThreads) {
      const int r = e / (DH / 4), d = e % (DH / 4) * 4;
      const bool in = d < Dh;
      cp_async(dst + r * DH + d, in ? src + (size_t)r * Dh + d : src, in, 16);
    }
  } else {
    for (int e = threadIdx.x; e < n * DH; e += kThreads) {
      const int r = e / DH, d = e % DH;
      const bool in = d < Dh;
      cp_async(dst + r * DH + d, in ? src + (size_t)r * Dh + d : src, in, 4);
    }
  }
}

// whether rows of width Dh starting at a and b can be copied 16 bytes at a
// time
__device__ __forceinline__ bool vec_rows(const float* a, const float* b,
                                         int Dh) {
  return Dh % 4 == 0 && (reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b)) % 16 == 0;
}

// the squared norm of a 16-byte aligned row of shared memory
template <int DH>
__device__ __forceinline__ float sq_norm_smem(const float* __restrict__ x) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float ss = 0.f;
#pragma unroll
  for (int d = 0; d < DH / 4; ++d) {
    const float4 u = x4[d];
    ss = fmaf(u.x, u.x, ss);
    ss = fmaf(u.y, u.y, ss);
    ss = fmaf(u.z, u.z, ss);
    ss = fmaf(u.w, u.w, ss);
  }
  return ss;
}

// scale a 16-byte aligned row of shared memory to unit norm (floored),
// dividing by max(‖x‖, 1e-12) as the kernels' register rows do
template <int DH>
__device__ __forceinline__ void unit_smem(float* __restrict__ x) {
  const float f = fmaxf(sqrtf(sq_norm_smem<DH>(x)), kNormFloor);
  float4* x4 = reinterpret_cast<float4*>(x);
#pragma unroll
  for (int d = 0; d < DH / 4; ++d) {
    float4 u = x4[d];
    u.x = u.x / f;
    u.y = u.y / f;
    u.z = u.z / f;
    u.w = u.w / f;
    x4[d] = u;
  }
}

}  // namespace flash_tile
}  // namespace
