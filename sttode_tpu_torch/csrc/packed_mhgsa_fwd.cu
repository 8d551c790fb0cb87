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
// What bounds it on the H100: the route sends it L·S ≤ 32² problems with
// H·Dh ≤ 128 — at the NBA recipe 88 problems of 32 × 32 × 8, 360 KB in and
// out and 3.4 M operations, a bound of ~0.1 µs (chip_smoke.py,
// attn_fwd_work). Nothing of that fills the card: launch latency and the
// serial chain inside a problem bound it. The TPU kernel packs the H heads
// into the 128 lanes with block-diagonal key matrices so that its MXU sees
// full tiles; on Hopper the packing is dropped and each problem runs the
// small-shape body of small_fwd.cuh (oblique, with the validity): a block
// per (problem, 32 query rows), lane = query row, the keys split across the
// block's warps in slices of about four keys (8 slices at 32 × 32, 32 at
// L = 8, S = 128, one at L = 1024, S = 1), the partial sums combined once
// through shared memory, and the TPU kernel's own acos polynomial on the
// SFU for the epilogue.

#include <cuda_runtime.h>

#include "small_fwd.cuh"

namespace {

template <int DH>
__global__ void __launch_bounds__(small_fwd::max_threads<DH>())
packed_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ val,
                  const float* __restrict__ mask, float* __restrict__ out,
                  int H, int L, int S, int Dh, int rows, int slices,
                  poincare::Curv curv) {
  small_fwd::body<DH, false, false>(q, k, v, val, mask, out, H, L, S, Dh,
                                    rows, slices, curv);
}

template <int DH>
int launch(const float* q, const float* k, const float* v, const float* val,
           float* out, int P, int H, int L, int S, int Dh,
           cudaStream_t stream) {
  return small_fwd::launch<DH>(packed_fwd_kernel<DH>, q, k, v, val, nullptr,
                               out, P, H, L, S, Dh, 1.f, stream);
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
