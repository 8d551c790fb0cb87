// Best-of-K selection decode for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel sttode_tpu/kernels/select_decode.py::select_decode
// (kernel body _select_kernel). For every scene agent m and latent sample k it
// runs the whole two-block decompose decode of the STTODE decoder:
//
//   block 0: a = relu([pf | z | state0] @ W1 + b1) for decoder_y and
//            decoder_x, two more layers each           → y0 [2T_f], x0 [2T_p]
//   block 1: res = x_true − x0; h = relu(conv1d(res), k=3, pad 1, 2→32);
//            state = GRU(32→96) over the T_p steps of h (h0 = 0, gates r,z,n);
//            y1 = decoder_y([pf | z | state])          → y1 [2T_f]
//   pred = y0 + y1;  mode "traj": out[k,m,:] = pred
//                    mode "dist": out[m,k]   = Σ (fut_rel[m] − pred)²
//
// Two ideas carry over from the TPU kernel. The K-fold repeat is never
// materialized: per-agent operands are indexed by m, only z_km [K,M,Z] by
// (k, m). And the first layers are split by rows into pf | z | state blocks,
// so the z-independent partials (pf and state0 rows of both block-0 first
// layers, pf rows of the block-1 first layer) are computed ONCE per agent by
// select_base_kernel and reused by all K samples from an [Mp, 1536] scratch
// that stays in L2. The TPU kernel's band matrices and 128-lane gate padding
// existed only for TPU tiling; here the conv and the GRU gates are computed
// directly.
//
// What bounds it on the H100: ~1.6 MFLOP per (m, k) row, 16.8 GFLOP at
// M = 512, K = 20, against fp32 FMA throughput (no tensor cores: this version
// keeps the plain decode's fp32 numerics); the weights it reads (~3.4 MB
// fp32) do not fit in a block's 227 KB of shared memory, while DRAM traffic
// stays under 10 MB per call. The design streams the weights from L2
// through the read-only path, and gives each block kTM = 16 agent rows of one
// sample so that every weight element read is used for 16 rows, while all
// activations ([16, 512] at the widest) stay in shared memory. Each dense
// layer is a block-wide tile product (block_gemm) whose thread → (row group,
// column) mapping is chosen from the layer's width.

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kTM = 16;          // agent rows per block
constexpr int kThreads = 256;
constexpr int kH1 = 512, kH2 = 256, kGru = 96, kConv = 32;
constexpr int kBaseW = 3 * kH1;  // [y0 | x0 | y1] first-layer partials

struct Weights {
  const float *y0_w1, *y0_b1, *y0_w2, *y0_b2, *y0_w3, *y0_b3;
  const float *x0_w1, *x0_b1, *x0_w2, *x0_b2, *x0_w3, *x0_b3;
  const float *conv_w, *conv_b;
  const float *w_ih, *w_hh, *b_ih, *b_hh;
  const float *y1_w1, *y1_b1, *y1_w2, *y1_b2, *y1_w3, *y1_b3;
};
constexpr int kNumWeights = 24;
static_assert(sizeof(Weights) == kNumWeights * sizeof(void*), "Weights");

struct Dims {
  int M, K, D2, Z, Tp, Tf;
};

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// Y[r][n] = act(bias[n] + base[r][n] + Σ_i X[r][i] · W[i][n]), r < kTM, n < N.
// X is in shared memory with a leading dimension ldx that is a multiple of 4
// and a 16-byte aligned base, so its rows load as float4. W [Kin][N] is read
// from global memory once per block and used for RPT rows per load. base and
// Y may alias (in-place accumulation): each thread reads back only the
// elements it writes.
template <int RPT>
__device__ void gemm_rows(const float* X, int ldx, int Kin,
                          const float* __restrict__ W, int N,
                          const float* __restrict__ bias, const float* base,
                          int ldb, float* Y, int ldy, bool relu) {
  constexpr int kGroups = kTM / RPT;
  const int items = kGroups * N;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int n = it % N;
    const int r0 = (it / N) * RPT;
    float acc[RPT];
    const float b0 = bias ? __ldg(bias + n) : 0.f;
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      acc[r] = base ? b0 + base[(r0 + r) * ldb + n] : b0;
    int i = 0;
    for (; i + 4 <= Kin; i += 4) {
      const float w0 = __ldg(W + (size_t)(i + 0) * N + n);
      const float w1 = __ldg(W + (size_t)(i + 1) * N + n);
      const float w2 = __ldg(W + (size_t)(i + 2) * N + n);
      const float w3 = __ldg(W + (size_t)(i + 3) * N + n);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 x =
            *reinterpret_cast<const float4*>(X + (r0 + r) * ldx + i);
        acc[r] = fmaf(x.x, w0, acc[r]);
        acc[r] = fmaf(x.y, w1, acc[r]);
        acc[r] = fmaf(x.z, w2, acc[r]);
        acc[r] = fmaf(x.w, w3, acc[r]);
      }
    }
    for (; i < Kin; ++i) {
      const float w = __ldg(W + (size_t)i * N + n);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        acc[r] = fmaf(X[(r0 + r) * ldx + i], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      Y[(r0 + r) * ldy + n] = relu ? fmaxf(acc[r], 0.f) : acc[r];
  }
}

// Wide layers give every thread all kTM rows of one column (most reuse of a
// weight load); narrow ones split the rows so more threads have work.
__device__ void block_gemm(const float* X, int ldx, int Kin, const float* W,
                           int N, const float* bias, const float* base,
                           int ldb, float* Y, int ldy, bool relu) {
  if (N >= kThreads)
    gemm_rows<kTM>(X, ldx, Kin, W, N, bias, base, ldb, Y, ldy, relu);
  else if (N * 4 >= kThreads)
    gemm_rows<4>(X, ldx, Kin, W, N, bias, base, ldb, Y, ldy, relu);
  else
    gemm_rows<1>(X, ldx, Kin, W, N, bias, base, ldb, Y, ldy, relu);
}

// Load rows [m0, m0 + kTM) × cols [0, width) of a row-major [M, width] array
// into shared memory with leading dimension ld; rows ≥ M and cols ≥ width
// read as 0.
__device__ void load_tile(const float* __restrict__ src, int M, int width,
                          int m0, float* dst, int ld) {
  for (int i = threadIdx.x; i < kTM * ld; i += blockDim.x) {
    const int r = i / ld, c = i % ld, m = m0 + r;
    dst[i] = (m < M && c < width) ? src[(size_t)m * width + c] : 0.f;
  }
}

// z-independent first-layer partials, once per agent row:
//   base[m, 0:512)     = pf @ y0_w1[pf rows] + state0 @ y0_w1[state rows] + b
//   base[m, 512:1024)  = the same for decoder_x of block 0
//   base[m, 1024:1536) = pf @ y1_w1[pf rows] + b   (block-1 state is per k)
__global__ void __launch_bounds__(kThreads)
select_base_kernel(const float* __restrict__ pf,
                   const float* __restrict__ state0, Weights w, Dims d,
                   float* __restrict__ base) {
  extern __shared__ __align__(16) float sm[];
  const int ldf = round4(d.D2);
  float* P = sm;                 // [kTM][ldf]
  float* S0 = P + kTM * ldf;     // [kTM][kGru]
  const int m0 = blockIdx.x * kTM;
  load_tile(pf, d.M, d.D2, m0, P, ldf);
  load_tile(state0, d.M, kGru, m0, S0, kGru);
  __syncthreads();

  float* out = base + (size_t)m0 * kBaseW;
  const size_t state_row = (size_t)(d.D2 + d.Z) * kH1;
  block_gemm(P, ldf, d.D2, w.y0_w1, kH1, w.y0_b1, nullptr, 0, out, kBaseW,
             false);
  block_gemm(P, ldf, d.D2, w.x0_w1, kH1, w.x0_b1, nullptr, 0, out + kH1,
             kBaseW, false);
  block_gemm(P, ldf, d.D2, w.y1_w1, kH1, w.y1_b1, nullptr, 0, out + 2 * kH1,
             kBaseW, false);
  block_gemm(S0, kGru, kGru, w.y0_w1 + state_row, kH1, nullptr, out, kBaseW,
             out, kBaseW, false);
  block_gemm(S0, kGru, kGru, w.x0_w1 + state_row, kH1, nullptr, out + kH1,
             kBaseW, out + kH1, kBaseW, false);
}

__host__ __device__ size_t main_smem_floats(int Z, int Tp, int Tf) {
  return (size_t)kTM * (round4(Z) + 2 * kH1 + kH2 + 2 * round4(2 * Tf) +
                        round4(2 * Tp) + Tp * kConv + kGru);
}

// One block per (16-row agent tile, sample k).
__global__ void __launch_bounds__(kThreads)
select_main_kernel(const float* __restrict__ z_km,
                   const float* __restrict__ x_true,
                   const float* __restrict__ fut_rel,
                   const float* __restrict__ base, Weights w, Dims d,
                   int mode, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  const int ldz = round4(d.Z);
  const int tp2 = 2 * d.Tp, tf2 = 2 * d.Tf;
  const int ldt = round4(tf2), ldp = round4(tp2), ldh = d.Tp * kConv;
  float* Zs = sm;                  // [kTM][ldz]  z
  float* A = Zs + kTM * ldz;       // [kTM][512]  a_y0, then GRU gi, then a_y1
  float* Bm = A + kTM * kH1;       // [kTM][512]  a_x0, then GRU gh
  float* C = Bm + kTM * kH1;       // [kTM][256]  second-layer activations
  float* Y0 = C + kTM * kH2;       // [kTM][ldt]
  float* Y1 = Y0 + kTM * ldt;      // [kTM][ldt]
  float* R = Y1 + kTM * ldt;       // [kTM][ldp]  x0, then the residual
  float* Hc = R + kTM * ldp;       // [kTM][ldh]  conv output, [t][32] per row
  float* St = Hc + kTM * ldh;      // [kTM][96]   GRU state

  const int m0 = blockIdx.x * kTM;
  const int k = blockIdx.y;
  const float* base_rows = base + (size_t)m0 * kBaseW;
  const size_t z_row = (size_t)d.D2 * kH1;
  const size_t state_row = (size_t)(d.D2 + d.Z) * kH1;

  load_tile(z_km + (size_t)k * d.M * d.Z, d.M, d.Z, m0, Zs, ldz);
  for (int i = threadIdx.x; i < kTM * kGru; i += blockDim.x) St[i] = 0.f;
  __syncthreads();

  // block 0
  block_gemm(Zs, ldz, d.Z, w.y0_w1 + z_row, kH1, nullptr, base_rows, kBaseW,
             A, kH1, true);
  block_gemm(Zs, ldz, d.Z, w.x0_w1 + z_row, kH1, nullptr, base_rows + kH1,
             kBaseW, Bm, kH1, true);
  __syncthreads();
  block_gemm(A, kH1, kH1, w.y0_w2, kH2, w.y0_b2, nullptr, 0, C, kH2, true);
  __syncthreads();
  block_gemm(C, kH2, kH2, w.y0_w3, tf2, w.y0_b3, nullptr, 0, Y0, ldt, false);
  __syncthreads();
  block_gemm(Bm, kH1, kH1, w.x0_w2, kH2, w.x0_b2, nullptr, 0, C, kH2, true);
  __syncthreads();
  block_gemm(C, kH2, kH2, w.x0_w3, tp2, w.x0_b3, nullptr, 0, R, ldp, false);
  __syncthreads();

  // block 1: residual, conv + relu
  for (int i = threadIdx.x; i < kTM * tp2; i += blockDim.x) {
    const int r = i / tp2, c = i % tp2, m = m0 + r;
    const float xt = m < d.M ? x_true[(size_t)m * tp2 + c] : 0.f;
    R[r * ldp + c] = xt - R[r * ldp + c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTM * d.Tp * kConv; i += blockDim.x) {
    const int o = i % kConv, t = (i / kConv) % d.Tp, r = i / (kConv * d.Tp);
    float acc = __ldg(w.conv_b + o);
    for (int kk = 0; kk < 3; ++kk) {
      const int ts = t + kk - 1;
      if (ts < 0 || ts >= d.Tp) continue;
      for (int c = 0; c < 2; ++c)
        acc = fmaf(R[r * ldp + ts * 2 + c],
                   __ldg(w.conv_w + (kk * 2 + c) * kConv + o), acc);
    }
    Hc[r * ldh + t * kConv + o] = fmaxf(acc, 0.f);
  }
  __syncthreads();

  // block 1: GRU over the T_p steps (torch gate convention, h0 = 0)
  float* GI = A;
  float* GH = Bm;
  for (int t = 0; t < d.Tp; ++t) {
    block_gemm(Hc + t * kConv, ldh, kConv, w.w_ih, 3 * kGru, w.b_ih, nullptr,
               0, GI, 3 * kGru, false);
    block_gemm(St, kGru, kGru, w.w_hh, 3 * kGru, w.b_hh, nullptr, 0, GH,
               3 * kGru, false);
    __syncthreads();
    for (int i = threadIdx.x; i < kTM * kGru; i += blockDim.x) {
      const int r = i / kGru, j = i % kGru;
      const float* gi = GI + r * 3 * kGru;
      const float* gh = GH + r * 3 * kGru;
      const float rg = sigmoidf(gi[j] + gh[j]);
      const float zg = sigmoidf(gi[kGru + j] + gh[kGru + j]);
      const float ng = tanhf(gi[2 * kGru + j] + rg * gh[2 * kGru + j]);
      St[i] = (1.f - zg) * ng + zg * St[i];
    }
    __syncthreads();
  }

  // block 1: decoder_y on [pf | z | state]
  block_gemm(Zs, ldz, d.Z, w.y1_w1 + z_row, kH1, nullptr, base_rows + 2 * kH1,
             kBaseW, A, kH1, false);
  __syncthreads();
  block_gemm(St, kGru, kGru, w.y1_w1 + state_row, kH1, nullptr, A, kH1, A,
             kH1, true);
  __syncthreads();
  block_gemm(A, kH1, kH1, w.y1_w2, kH2, w.y1_b2, nullptr, 0, C, kH2, true);
  __syncthreads();
  block_gemm(C, kH2, kH2, w.y1_w3, tf2, w.y1_b3, nullptr, 0, Y1, ldt, false);
  __syncthreads();

  if (mode == 1) {  // traj: out [K, M, 2T_f]
    for (int i = threadIdx.x; i < kTM * tf2; i += blockDim.x) {
      const int r = i / tf2, c = i % tf2, m = m0 + r;
      if (m < d.M)
        out[((size_t)k * d.M + m) * tf2 + c] = Y0[r * ldt + c] + Y1[r * ldt + c];
    }
  } else {          // dist: out [M, K]
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < kTM; r += blockDim.x >> 5) {
      const int m = m0 + r;
      if (m >= d.M) continue;   // warp-uniform
      float s = 0.f;
      for (int c = lane; c < tf2; c += 32) {
        const float e =
            fut_rel[(size_t)m * tf2 + c] - (Y0[r * ldt + c] + Y1[r * ldt + c]);
        s = fmaf(e, e, s);
      }
      s = warp_sum(s);
      if (lane == 0) out[(size_t)m * d.K + k] = s;
    }
  }
}

}  // namespace

// pf [M,D2], z_km [K,M,Z], state0 [M,96], x_true [M,2T_p], fut_rel [M,2T_f]
// (read in mode 0 only; may be null in mode 1), weights = host array of the
// 24 device pointers in the order of struct Weights, base = scratch of
// ceil(M/16)·16 × 1536 floats, out = [M,K] (mode 0, "dist") or [K,M,2T_f]
// (mode 1, "traj"). All fp32, contiguous, on the current device. Launches
// both kernels on `stream`; returns the first CUDA error (0 on success).
extern "C" int select_decode_fwd(const float* pf, const float* z_km,
                                 const float* state0, const float* x_true,
                                 const float* fut_rel,
                                 const void* const* weights, float* base,
                                 float* out, int M, int K, int D2, int Z,
                                 int Tp, int Tf, int mode, void* stream) {
  if (M <= 0 || K <= 0) return cudaSuccess;
  if (mode != 0 && mode != 1) return cudaErrorInvalidValue;
  Weights w;
  memcpy(&w, weights, sizeof(w));
  const Dims d{M, K, D2, Z, Tp, Tf};
  const int mtiles = (M + kTM - 1) / kTM;
  const size_t smem0 = sizeof(float) * kTM * (round4(D2) + kGru);
  const size_t smem1 = sizeof(float) * main_smem_floats(Z, Tp, Tf);
  cudaError_t err = cudaFuncSetAttribute(
      select_base_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem0);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(select_main_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem1);
  if (err != cudaSuccess) return err;
  cudaStream_t s = (cudaStream_t)stream;
  select_base_kernel<<<mtiles, kThreads, smem0, s>>>(pf, state0, w, d, base);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  select_main_kernel<<<dim3(mtiles, K), kThreads, smem1, s>>>(
      z_km, x_true, fut_rel, base, w, d, mode, out);
  return cudaGetLastError();
}

extern "C" const char* sttode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
