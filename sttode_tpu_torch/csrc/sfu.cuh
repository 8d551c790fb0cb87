// The SFU's (MUFU) native approximations, as PTX: reciprocal, reciprocal
// square root, log2 and exp2, each one instruction (.approx.ftz: about 2 ulp,
// subnormal inputs and results flushed to zero). The epilogues built on them
// (poincare::sweep_grad and poincare::fwd_weight in poincare.cuh, the small-
// shape forward's oblique weight in small_fwd.cuh) keep every argument a
// normal number. ex2 of a very negative argument (an excluded mask entry's
// −1e30·log2 e) returns +0.

#pragma once

namespace sfu {

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace sfu
