// Best-of-K selection decode for Hopper (sm_90a), fp32 or bf16 storage, on
// the tensor cores.
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
// select_base_kernel and reused by all K samples from an [M, 1536] fp32
// scratch that stays in L2 (the TPU kernel's fp32 base0/base1 scratch). The
// TPU kernel's band matrices and 128-lane gate padding existed only for TPU
// tiling; here the conv and the GRU gates are computed directly.
//
// Two storage types, one template. WT = float is the plain fp32 decode. WT =
// __nv_bfloat16 is the TPU kernel's bf16 numerics (select_dtype="bfloat16"):
// weight matrices stored in bf16; pf, z and state0 rounded to bf16 on load;
// the first-layer biases and the GRU biases stay fp32; the tail-layer and
// conv biases arrive already rounded to bf16 values (prep_select_weights);
// every activation that feeds a matrix product is rounded to bf16 (the
// first- and second-layer activations, the residual, the conv output), the
// GRU input projection gi is rounded before its bias is added, and the GRU
// state after every step; x_true, fut_rel, pred and the distance stay fp32.
// Products accumulate in fp32: a bf16×bf16 product is exact in fp32, so a
// bf16 tensor-core MMA computes what fp32 FMAs over bf16 operands compute,
// up to summation order.
//
// What bounds it on the H100: ~1.4 MFLOP of matrix products per (m, k) row,
// 38 GFLOP at the training step's M = 1408, K = 20 (5 past / 10 future
// steps), 690 GFLOP at the B = 2304 scene batch's M = 25,344; DRAM traffic
// stays under 10 MB per call at M = 1408. So it is bound by operations: on
// the tensor cores 0.04 ms at the bf16 peak (989 TFLOP/s) and, for fp32, 0.23
// ms at 3xTF32 (three TF32 products per product at 495 TFLOP/s), where the
// fp32 cores alone (67 TFLOP/s) need 0.59 ms. The design before ran every
// layer as fp32 FMAs over 16-row tiles of one sample, weights re-read from L2
// by every block: 24 % of the fp32-core bound, and its bf16 variant no
// faster. This one:
//   - runs every dense layer on the tensor cores with mma.sync: bf16
//     m16n8k16 (fp32 accumulators) for bf16 storage, and 3xTF32 m16n8k8 for
//     fp32: each operand is split into a TF32 hi part and a TF32 lo part
//     (cvt.rna, as it is loaded into registers, so the weights cross L2 in
//     4 bytes and not as 8 of hi/lo planes) and hi·hi + hi·lo + lo·hi
//     accumulate in fp32, which keeps fp32's accuracy where one
//     TF32 product (3 decimal digits over 512-long sums) would break the
//     1e-4 tolerance; the conv (6 × 32 per step) and the GRU gates stay on
//     the fp32 cores;
//   - tiles the flattened (k, m) rows, BM = 64 (32 where M·K < 16,896, as at
//     the serving shapes M·K = 7,040 and 10,240, so that the 132 SMs fill),
//     so every weight byte a block reads serves 64 (or 32) rows;
//   - streams the weights, in the order of the MMA fragments
//     (pack_select_weights: a lane's fragment is one 8-byte load), through
//     a ring of 18 KB stages in shared memory, each stage one bulk copy
//     (TMA, cp.async.bulk) that one thread issues kStages − 1 stages ahead
//     and an mbarrier counts; a whole MLP (17 runs of k-tiles) and the
//     whole GRU (T_p steps × row groups) are each one stream, so the ring
//     does not drain between layers;
//   - fuses each MLP's first and second layer by 64-column chunks: the
//     first layer's chunk [BM, 64] is the second layer's K-chunk, whose
//     [BM, 256] fp32 accumulators stay in registers, so no [BM, 512]
//     activation exists; the GRU state and the conv output reuse the
//     second layer's output buffer. Shared memory: ~214 KB (fp32, BM 64:
//     one block per SM), ~111 KB (bf16, BM 64: two), ~126 KB and ~102 KB
//     at BM 32.
// What bounds it now (scripts/torch_select_profile.py's cycle stamps): not
// the weight traffic — a block waits for its stages ~1–2 % of its cycles —
// but the issue of the layers themselves with 8 warps per block: for fp32
// the layers' bodies (three MMAs and the operand splits of 3xTF32 per
// product), for bf16 the epilogues (the L2 loads of the first-layer
// partials, the GRU gates, register spills at the 128-register budget of
// two blocks per SM). It runs at 5–12 % of the tensor-core bound; PERF.md
// has the numbers and the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "smem_attr.cuh"

namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kH1 = 512, kH2 = 256, kGru = 96, kConv = 32;
constexpr int kChunk = 64;       // first-layer columns per chunk
constexpr int kChunks = kH1 / kChunk;
constexpr int kBaseW = 3 * kH1;  // [y0 | x0 | y1] first-layer partials
constexpr int kMaxOut = 64;      // 2T_f and 2T_p limit (8 n-tiles)
constexpr int kBigRows = 16896;  // M·K from which BM = 64

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// --------------------------------------------------------------------------
// The MMA of a storage type: its k depth, a lane's B-fragment bytes, the
// activation type in shared memory, A/B fragment loads and the product.

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename WT>
struct Mma;

// fp32 storage: 3xTF32 m16n8k8. A fragment of row-major X (fp32 in shared
// memory): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); a B
// fragment is (w(t, g), w(t+4, g)). Both are split into hi = tf32(x) and
// lo = tf32(x − hi) as they are loaded, so the weights cross L2 as fp32.
template <>
struct Mma<float> {
  using Act = float;
  static constexpr int kK = 8;
  static constexpr int kVB = 8;
  static constexpr int kPad = 4;   // row stride ≡ 4 (mod 8) words
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi0, hi1, lo0, lo1;
  };
  static __device__ __forceinline__ A load_a(const float* X, int ld, int r0,
                                             int k0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const float* p = X + (r0 + g) * ld + k0 + t;
    const float x[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
    A a;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a.hi[i] = tf32_rna(x[i]);
      a.lo[i] = tf32_rna(x[i] - __uint_as_float(a.hi[i]));
    }
    return a;
  }
  static __device__ __forceinline__ B load_b(const char* tile, int lane) {
    const uint2 v = *reinterpret_cast<const uint2*>(tile + lane * kVB);
    const float w0 = __uint_as_float(v.x), w1 = __uint_as_float(v.y);
    B b;
    b.hi0 = tf32_rna(w0);
    b.hi1 = tf32_rna(w1);
    b.lo0 = tf32_rna(w0 - __uint_as_float(b.hi0));
    b.lo1 = tf32_rna(w1 - __uint_as_float(b.hi1));
    return b;
  }
  // the three products of 3xTF32, small ones first; a caller runs pass 0
  // over all its tiles, then pass 1, then pass 2, so that consecutive MMAs
  // feed different accumulators
  static constexpr int kPasses = 3;
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b, int pass) {
    if (pass == 0) mma_tf32(c, a.lo, b.hi0, b.hi1);
    if (pass == 1) mma_tf32(c, a.hi, b.lo0, b.lo1);
    if (pass == 2) mma_tf32(c, a.hi, b.hi0, b.hi1);
  }
  static __device__ __forceinline__ float to_act(float x) { return x; }
  static __device__ __forceinline__ float from_act(float x) { return x; }
};

// bf16 storage: m16n8k16. A registers: (g, 2t..2t+1), (g+8, 2t..), (g,
// 2t+8..), (g+8, 2t+8..); a B fragment is (k 2t, 2t+1, 2t+8, 2t+9; n g).
template <>
struct Mma<__nv_bfloat16> {
  using Act = __nv_bfloat16;
  static constexpr int kK = 16;
  static constexpr int kVB = 8;
  static constexpr int kPad = 8;   // row stride ≡ 4 (mod 8) words
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t b0, b1;
  };
  static __device__ __forceinline__ A load_a(const __nv_bfloat16* X, int ld,
                                             int r0, int k0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const __nv_bfloat16* p = X + (r0 + g) * ld + k0 + 2 * t;
    A a;
    a.r[0] = *reinterpret_cast<const uint32_t*>(p);
    a.r[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
    a.r[2] = *reinterpret_cast<const uint32_t*>(p + 8);
    a.r[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
    return a;
  }
  static __device__ __forceinline__ B load_b(const char* tile, int lane) {
    const uint2 v = *reinterpret_cast<const uint2*>(tile + lane * kVB);
    return B{v.x, v.y};
  }
  static constexpr int kPasses = 1;
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b, int) {
    mma_bf16(c, a.r, b.b0, b.b1);
  }
  static __device__ __forceinline__ __nv_bfloat16 to_act(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float from_act(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

// row stride (elements) of an activation buffer `width` wide
template <typename WT>
__host__ __device__ constexpr int act_ld(int width) {
  return round_up(width, Mma<WT>::kK) + Mma<WT>::kPad;
}

// bytes of one k-tile of a packed matrix with `nt` n-tiles
template <typename WT>
__host__ __device__ constexpr int tile_bytes(int nt) {
  return nt * 32 * Mma<WT>::kVB;
}

// The weight ring of a (storage type, row tile): its depth and its stage
// bytes, at least the widest k-tile (the GRU's 36 n-tiles, 9,216 bytes).
// At M = 1408 (NVIDIA H100, scripts/torch_select_bench.py) 4 × 9,216 →
// 6 × 18,432 took fp32 from 2.54 to 2.25 ms, and bf16, which keeps two
// blocks per SM with 3 × 18,432, from 0.88 to 0.79 ms.
template <typename WT, int BM>
struct Ring {
  static constexpr int kStages = 4, kBytes = 18432;
};
template <>
struct Ring<float, 64> {
  static constexpr int kStages = 6, kBytes = 18432;
};
template <>
struct Ring<__nv_bfloat16, 64> {
  static constexpr int kStages = 3, kBytes = 18432;
};
static_assert(Ring<float, 64>::kBytes >= tile_bytes<float>(3 * kGru / 8),
              "ring stage");

// blocks per SM that the register budget of the main kernel aims at
template <typename WT, int BM>
constexpr int kMinBlocks = (BM == 64 && sizeof(WT) == 4) ? 1 : 2;

// --------------------------------------------------------------------------
// Weights: the packed matrices (pack_select_weights: a k-tile is
// [n-tile][lane][fragment] contiguous, so a chunk of k-tiles is one run of
// bytes; first layers "chunked", [chunk of 64 columns][k-tile][8 n-tiles])
// and the fp32 biases and conv weight.

struct Packed {
  const char* z0y;   // block 0 decoder_y first layer, z rows (chunked)
  const char* z0x;   // block 0 decoder_x first layer, z rows (chunked)
  const char* y0w2; const char* y0w3;
  const char* x0w2; const char* x0w3;
  const char* gru;   // w_ih then w_hh, k-tiles of 288 columns
  const char* b1w1;  // block 1 decoder_y first layer, z | state rows (chunked)
  const char* y1w2; const char* y1w3;
  const char* p0y;   // prologue: decoder_y, pf | state rows (chunked)
  const char* p0x;   // prologue: decoder_x, pf | state rows (chunked)
  const char* p1;    // prologue: block 1 decoder_y, pf rows (chunked)
  const float* conv_w;  // [3][2][32], values of the storage type
  const float* y0_b1; const float* y0_b2; const float* y0_b3;
  const float* x0_b1; const float* x0_b2; const float* x0_b3;
  const float* conv_b; const float* b_ih; const float* b_hh;
  const float* y1_b1; const float* y1_b2; const float* y1_b3;
};
constexpr int kNumWeights = 26;
static_assert(sizeof(Packed) == kNumWeights * sizeof(void*), "Packed");

struct Dims {
  int M, K, D2, Z, Tp, Tf;
};

// --------------------------------------------------------------------------
// The weight ring: one bulk copy (TMA, cp.async.bulk) per stage, issued by
// one thread, its completion counted in bytes by the stage's mbarrier.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

// thread 0: expect `bytes` on `bar` and copy them from global `src` to `dst`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// every thread: wait until phase `parity` of `bar` has completed
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// The ring of a block: kStages stages of kBytes and one mbarrier each;
// `count` is the number of stages consumed so far, kept across streams so
// that each mbarrier's phase parity follows its uses.
struct RingState {
  char* buf;
  unsigned long long* bars;
  int count;
};

// Carve the ring at the start of dynamic shared memory and initialize its
// barriers (thread 0); the caller synchronizes the block before first use.
template <typename WT, int BM>
__device__ RingState ring_init(char* sm) {
  constexpr int n = Ring<WT, BM>::kStages;
  RingState r{sm, reinterpret_cast<unsigned long long*>(
                      sm + n * Ring<WT, BM>::kBytes), 0};
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) bar_init(r.bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return r;
}

// shared-memory bytes of the ring and its barriers
template <typename WT, int BM>
__host__ __device__ constexpr int ring_bytes() {
  return Ring<WT, BM>::kStages * (Ring<WT, BM>::kBytes + 8);
}

// A run of k-tiles of one packed matrix: `ktiles` tiles of `tbytes` bytes
// each, contiguous from `src`.
struct Seg {
  const char* src;
  int ktiles, tbytes;
};

// Streams the segments seg_of(0 .. nseg) through the ring, a stage holding
// as many k-tiles of one segment as fit (stages never straddle segments),
// the copies running kStages − 1 stages ahead across segment boundaries, so
// the ring never drains inside a layer chain. For each k-tile once it has
// landed: body(seg, kt, tile); after a segment's last k-tile: end(seg).
// Every thread of the block takes part. Between two stages the block
// synchronizes, so what end(s) writes is visible to the bodies of later
// segments, a stage's bodies never overlap another stage's, and a stage is
// refilled only after all threads are done with it. Returns with the ring
// idle and the block synchronized.
template <typename WT, int BM, typename SegOf, typename Body, typename End>
__device__ void stream(int nseg, SegOf seg_of, RingState& ring, Body body,
                       End end) {
  constexpr int kStages = Ring<WT, BM>::kStages;
  constexpr int kSB = Ring<WT, BM>::kBytes;
  struct Cursor {
    int seg, st, per, nst;
    Seg s;
  };
  auto open_seg = [&](Cursor& c, int i) {
    c.seg = i;
    c.st = 0;
    if (i < nseg) {
      c.s = seg_of(i);
      c.per = max(1, kSB / c.s.tbytes);
      c.nst = (c.s.ktiles + c.per - 1) / c.per;
    }
  };
  Cursor fill, use;
  open_seg(fill, 0);
  open_seg(use, 0);
  int filled = ring.count, used = ring.count;
  auto issue = [&]() {
    if (fill.seg >= nseg) return;
    if (threadIdx.x == 0) {
      const int k0 = fill.st * fill.per;
      const int bytes = min(fill.per, fill.s.ktiles - k0) * fill.s.tbytes;
      const int slot = filled % kStages;
      bulk_copy(ring.buf + slot * kSB, fill.s.src + (size_t)k0 * fill.s.tbytes,
                bytes, ring.bars + slot);
    }
    ++filled;
    if (++fill.st == fill.nst) open_seg(fill, fill.seg + 1);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue();
  while (use.seg < nseg) {
    const int slot = used % kStages;
    bar_wait(ring.bars + slot, (used / kStages) & 1);
    __syncthreads();   // this stage landed; every thread is done with the last
    issue();
    const char* st = ring.buf + slot * kSB;
    const int k0 = use.st * use.per;
    const int kn = min(use.per, use.s.ktiles - k0);
    for (int i = 0; i < kn; ++i) body(use.seg, k0 + i, st + i * use.s.tbytes);
    ++used;
    if (++use.st == use.nst) {
      end(use.seg);
      open_seg(use, use.seg + 1);
    }
  }
  ring.count = used;
  __syncthreads();
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// --------------------------------------------------------------------------
// One decoder MLP on the block's BM rows (MT = BM / 16 m-tiles), as one
// weight stream of 17 segments: for each chunk c of 64 first-layer columns,
//   L1(c): H = rnd(relu(base[:, c] + [X1 | X2] @ W1[:, c]))
//          (warp w: n-tile w of the chunk, all m-tiles; X1 covers k-tiles
//          [0, kt1), X2 the rest)
//   L2(c): acc2 += H @ W2[c rows]   (warp w: columns [32w, 32w + 32))
// then C = rnd(relu(acc2 + b2)) and L3: out (+)= C @ W3 + b3 (n < nout;
// warp w: the (m-tile, n-tile) pairs w, w + 8, ...).
template <typename WT, int MT>
__device__ void mlp(const typename Mma<WT>::Act* X1, int ld1, int kt1,
                    const typename Mma<WT>::Act* X2, int ld2, int kt2,
                    const char* w1, const float* __restrict__ base, int bcol,
                    const int* rowm, const char* w2,
                    const float* __restrict__ b2, const char* w3,
                    const float* __restrict__ b3, int nout, float* out,
                    int ldo, bool add, typename Mma<WT>::Act* H,
                    typename Mma<WT>::Act* C, RingState& ring) {
  using Q = Mma<WT>;
  using Act = typename Q::Act;
  constexpr int ldh = act_ld<WT>(kChunk), ldc = act_ld<WT>(kH2);
  constexpr int kt_chunk = kChunk / Q::kK;
  constexpr int tb1 = tile_bytes<WT>(kChunk / 8), tb2 = tile_bytes<WT>(kH2 / 8);
  static_assert(MT * (kMaxOut / 8) <= MT * kWarps, "third-layer pairs");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nt3 = (nout + 7) / 8, pairs = MT * nt3;
  const int w1_chunk = (kt1 + kt2) * tb1;
  float acc1[MT][4];       // a first-layer chunk, then the third layer
  float acc2[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc2[mt][j][0] = acc2[mt][j][1] = acc2[mt][j][2] = acc2[mt][j][3] = 0.f;

  // blocks start at different chunks, so that the SMs read different
  // weights from L2 at a time
  const int rot = blockIdx.x % kChunks;
  auto seg_of = [&](int i) -> Seg {
    if (i == 2 * kChunks) return Seg{w3, kH2 / Q::kK, tile_bytes<WT>(nt3)};
    const int c = ((i >> 1) + rot) % kChunks;
    return (i & 1) ? Seg{w2 + (size_t)c * kt_chunk * tb2, kt_chunk, tb2}
                   : Seg{w1 + (size_t)c * w1_chunk, kt1 + kt2, tb1};
  };
  auto body = [&](int i, int kt, const char* tile) {
    if (i == 2 * kChunks) {                  // L3, pairs over the warps
      if (kt == 0) zero(acc1);
      const int np = (pairs - warp + kWarps - 1) / kWarps;
      typename Q::A a[MT];
      typename Q::B b[MT];
#pragma unroll
      for (int p8 = 0; p8 < MT; ++p8) {
        const int p = min(warp + p8 * kWarps, pairs - 1);
        a[p8] = Q::load_a(C, ldc, (p / nt3) * 16, kt * Q::kK, lane);
        b[p8] = Q::load_b(tile + (p % nt3) * 32 * Q::kVB, lane);
      }
#pragma unroll
      for (int ps = 0; ps < Q::kPasses; ++ps)
#pragma unroll
        for (int p8 = 0; p8 < MT; ++p8)
          if (p8 < np) Q::mma(acc1[p8], a[p8], b[p8], ps);
    } else if (i & 1) {                      // L2
      typename Q::B b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = Q::load_b(tile + (warp * 4 + j) * 32 * Q::kVB, lane);
      typename Q::A a[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        a[mt] = Q::load_a(H, ldh, mt * 16, kt * Q::kK, lane);
#pragma unroll
      for (int ps = 0; ps < Q::kPasses; ++ps)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) Q::mma(acc2[mt][j], a[mt], b[j], ps);
    } else {                                 // L1
      if (kt == 0) zero(acc1);
      const typename Q::B b = Q::load_b(tile + warp * 32 * Q::kVB, lane);
      const bool first = kt < kt1;
      const Act* X = first ? X1 : X2;
      const int ld = first ? ld1 : ld2;
      const int k0 = (first ? kt : kt - kt1) * Q::kK;
      typename Q::A a[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) a[mt] = Q::load_a(X, ld, mt * 16, k0, lane);
#pragma unroll
      for (int ps = 0; ps < Q::kPasses; ++ps)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) Q::mma(acc1[mt], a[mt], b, ps);
    }
  };
  auto end = [&](int i) {
    if (i == 2 * kChunks) {                  // L3 epilogue
#pragma unroll
      for (int p8 = 0; p8 < MT; ++p8) {
        const int p = warp + p8 * kWarps;
        if (p >= pairs) continue;
        const int mt = p / nt3, nt = p % nt3;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + g + (e >> 1) * 8;
          const int n = nt * 8 + 2 * t + (e & 1);
          if (n < nout) {
            const float y = acc1[p8][e] + __ldg(b3 + n);
            out[r * ldo + n] = add ? out[r * ldo + n] + y : y;
          }
        }
      }
    } else if (i & 1) {                      // after the last L2: C
      if (i != 2 * kChunks - 1) return;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = mt * 16 + g + (e >> 1) * 8;
            const int n = warp * 32 + j * 8 + 2 * t + (e & 1);
            C[r * ldc + n] =
                Q::to_act(fmaxf(acc2[mt][j][e] + __ldg(b2 + n), 0.f));
          }
    } else {                                 // L1 epilogue: H
      const int c = ((i >> 1) + rot) % kChunks;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + g + (e >> 1) * 8;
          const int n = warp * 8 + 2 * t + (e & 1);
          const int m = rowm[r];
          const float bv =
              m >= 0 ? base[(size_t)m * kBaseW + bcol + c * kChunk + n] : 0.f;
          H[r * ldh + n] = Q::to_act(fmaxf(acc1[mt][e] + bv, 0.f));
        }
    }
  };
  stream<WT, MT * 16>(2 * kChunks + 1, seg_of, ring, body, end);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// Hc = rnd(relu(conv1d(R)[step t])): the block's rows, 32 channels
template <typename WT>
__device__ void conv_step(const float* R, int tp2, int Tp, int t,
                          const float* __restrict__ conv_w,
                          const float* __restrict__ conv_b, int rows,
                          typename Mma<WT>::Act* Hc) {
  using Q = Mma<WT>;
  constexpr int ldx = act_ld<WT>(kConv);
  for (int i = threadIdx.x; i < rows * kConv; i += kThreads) {
    const int r = i / kConv, o = i % kConv;
    float acc = __ldg(conv_b + o);
    for (int kk = 0; kk < 3; ++kk) {
      const int ts = t + kk - 1;
      if (ts < 0 || ts >= Tp) continue;
      for (int c = 0; c < 2; ++c)
        acc = fmaf(R[r * tp2 + ts * 2 + c],
                   __ldg(conv_w + (kk * 2 + c) * kConv + o), acc);
    }
    Hc[r * ldx + o] = Q::to_act(fmaxf(acc, 0.f));
  }
}

// The GRU over the T_p steps (torch gate convention, h0 = St[0] = 0) as one
// weight stream of T_p · MT/2 segments (a step, a group of 32 rows): gi =
// rnd(Hc @ w_ih), gh = St @ w_hh + b_hh, r = σ(gi_r + b_ih_r + gh_r), z
// likewise, n = tanh(gi_n + b_ih_n + r·gh_n), St' = rnd((1 − z)·n + z·St).
// A warp takes 3 of a group's 24 (m-tile, 8-column j-tile) pairs and holds
// their six gate products. Between steps the conv output of the next step
// is made. Returns the index of the final state in St.
template <typename WT, int MT>
__device__ int gru(typename Mma<WT>::Act* Hc, typename Mma<WT>::Act* St0,
                   typename Mma<WT>::Act* St1, const float* R, int Tp,
                   const char* wgru, const float* __restrict__ b_ih,
                   const float* __restrict__ b_hh,
                   const float* __restrict__ conv_w,
                   const float* __restrict__ conv_b, RingState& ring) {
  using Q = Mma<WT>;
  using Act = typename Q::Act;
  constexpr int ldx = act_ld<WT>(kConv), lds = act_ld<WT>(kGru);
  constexpr int kti = kConv / Q::kK, kth = kGru / Q::kK;
  constexpr int jt_n = kGru / 8;            // 12 j-tiles
  constexpr int groups = MT / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  Act* S = St0;            // the state, and where the next one goes
  Act* Sn = St1;
  int cur = 0;
  float gi[3][3][4], gh[3][3][4];   // per pair and gate
  conv_step<WT>(R, 2 * Tp, Tp, 0, conv_w, conv_b, MT * 16, Hc);
  // (the stream synchronizes the block before its first stage's bodies)
  auto seg_of = [&](int) -> Seg {
    return Seg{wgru, kti + kth, tile_bytes<WT>(3 * jt_n)};
  };
  auto body = [&](int i, int kt, const char* tile) {
    const int grp = i % groups;
    if (kt == 0) {
      zero(gi[0]), zero(gi[1]), zero(gi[2]);
      zero(gh[0]), zero(gh[1]), zero(gh[2]);
    }
    const bool input = kt < kti;
    const Act* X = input ? Hc : S;
    const int ld = input ? ldx : lds;
    const int k0 = (input ? kt : kt - kti) * Q::kK;
    typename Q::A a[3];
    typename Q::B b[3][3];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const int pr = warp * 3 + p;
      const int mt = grp * 2 + pr / jt_n, jt = pr % jt_n;
      a[p] = Q::load_a(X, ld, mt * 16, k0, lane);
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
        b[p][gate] = Q::load_b(tile + (gate * jt_n + jt) * 32 * Q::kVB, lane);
    }
    // static accumulator indices in both branches: a runtime index would
    // put the accumulators in local memory
    if (input) {
#pragma unroll
      for (int ps = 0; ps < Q::kPasses; ++ps)
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int gate = 0; gate < 3; ++gate)
            Q::mma(gi[p][gate], a[p], b[p][gate], ps);
    } else {
#pragma unroll
      for (int ps = 0; ps < Q::kPasses; ++ps)
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int gate = 0; gate < 3; ++gate)
            Q::mma(gh[p][gate], a[p], b[p][gate], ps);
    }
  };
  auto end = [&](int i) {
    const int grp = i % groups, step = i / groups;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const int pr = warp * 3 + p;
      const int mt = grp * 2 + pr / jt_n, jt = pr % jt_n;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 16 + g + (e >> 1) * 8;
        const int j = jt * 8 + 2 * t + (e & 1);
        const float gir = Q::from_act(Q::to_act(gi[p][0][e]));
        const float giz = Q::from_act(Q::to_act(gi[p][1][e]));
        const float gin = Q::from_act(Q::to_act(gi[p][2][e]));
        const float ghr = gh[p][0][e] + __ldg(b_hh + j);
        const float ghz = gh[p][1][e] + __ldg(b_hh + kGru + j);
        const float ghn = gh[p][2][e] + __ldg(b_hh + 2 * kGru + j);
        const float rg = sigmoidf(gir + __ldg(b_ih + j) + ghr);
        const float zg = sigmoidf(giz + __ldg(b_ih + kGru + j) + ghz);
        const float ng = tanhf(gin + __ldg(b_ih + 2 * kGru + j) + rg * ghn);
        const float h = Q::from_act(S[r * lds + j]);
        Sn[r * lds + j] = Q::to_act((1.f - zg) * ng + zg * h);
      }
    }
    if (grp == groups - 1) {   // the step is done: next state, next input
      __syncthreads();
      Act* x = S;
      S = Sn;
      Sn = x;
      cur ^= 1;
      if (step + 1 < Tp)
        conv_step<WT>(R, 2 * Tp, Tp, step + 1, conv_w, conv_b, MT * 16, Hc);
    }
  };
  stream<WT, MT * 16>(Tp * groups, seg_of, ring, body, end);
  return cur;
}

// --------------------------------------------------------------------------
// Shared memory of the main kernel, in bytes, carved in this order: ring |
// Zs | H | C (also St[2] and Hc during the GRU) | Y | R | rowm.

__host__ __device__ constexpr int align(int x) { return round_up(x, 16); }

template <typename WT, int BM>
struct Layout {
  using Act = typename Mma<WT>::Act;
  int zs, h, c, st0, st1, hc, y, r, rowm, total;
  __host__ __device__ Layout(const Dims& d) {
    const int ldz = act_ld<WT>(d.Z);
    int off = ring_bytes<WT, BM>();
    zs = off;   off = align(off + BM * ldz * (int)sizeof(Act));
    h = off;    off = align(off + BM * act_ld<WT>(kChunk) * (int)sizeof(Act));
    c = off;
    const int st_bytes = align(BM * act_ld<WT>(kGru) * (int)sizeof(Act));
    st0 = c;
    st1 = c + st_bytes;
    hc = c + 2 * st_bytes;
    const int c_bytes = align(BM * act_ld<WT>(kH2) * (int)sizeof(Act));
    const int gru_bytes =
        2 * st_bytes + align(BM * act_ld<WT>(kConv) * (int)sizeof(Act));
    off += c_bytes > gru_bytes ? c_bytes : gru_bytes;
    y = off;    off = align(off + BM * 2 * d.Tf * 4);
    r = off;    off = align(off + BM * 2 * d.Tp * 4);
    rowm = off; off = align(off + BM * 4);
    total = off;
  }
};

// One block per BM flattened rows gr = k·M + m of the M·K (agent, sample)
// pairs.
template <typename WT, int BM>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<WT, BM>))
select_main_kernel(const float* __restrict__ z_km,
                   const float* __restrict__ x_true,
                   const float* __restrict__ fut_rel,
                   const float* __restrict__ base, Packed w, Dims d, int mode,
                   float* __restrict__ out) {
  using Q = Mma<WT>;
  using Act = typename Q::Act;
  constexpr int MT = BM / 16;
  extern __shared__ __align__(16) char sm[];
  const Layout<WT, BM> lay(d);
  RingState ring = ring_init<WT, BM>(sm);
  Act* Zs = reinterpret_cast<Act*>(sm + lay.zs);
  Act* H = reinterpret_cast<Act*>(sm + lay.h);
  Act* C = reinterpret_cast<Act*>(sm + lay.c);
  Act* St0 = reinterpret_cast<Act*>(sm + lay.st0);
  Act* St1 = reinterpret_cast<Act*>(sm + lay.st1);
  Act* Hc = reinterpret_cast<Act*>(sm + lay.hc);
  float* Y = reinterpret_cast<float*>(sm + lay.y);
  float* R = reinterpret_cast<float*>(sm + lay.r);
  int* rowm = reinterpret_cast<int*>(sm + lay.rowm);

  const long long MK = (long long)d.M * d.K;
  const long long gr0 = (long long)blockIdx.x * BM;
  const int ldz = act_ld<WT>(d.Z), lds = act_ld<WT>(kGru);
  const int kz = round_up(d.Z, Q::kK) / Q::kK;
  const int tf2 = 2 * d.Tf, tp2 = 2 * d.Tp;

  for (int r = threadIdx.x; r < BM; r += kThreads)
    rowm[r] = gr0 + r < MK ? (int)((gr0 + r) % d.M) : -1;
  for (int i = threadIdx.x; i < BM * ldz; i += kThreads) {
    const int r = i / ldz, c = i % ldz;
    const long long gr = gr0 + r;
    Zs[i] = Q::to_act(gr < MK && c < d.Z ? z_km[gr * d.Z + c] : 0.f);
  }
  __syncthreads();

  // block 0: decoder_y → Y, decoder_x → R
  mlp<WT, MT>(Zs, ldz, kz, Zs, ldz, 0, w.z0y, base, 0, rowm, w.y0w2, w.y0_b2,
              w.y0w3, w.y0_b3, tf2, Y, tf2, false, H, C, ring);
  mlp<WT, MT>(Zs, ldz, kz, Zs, ldz, 0, w.z0x, base, kH1, rowm, w.x0w2,
              w.x0_b2, w.x0w3, w.x0_b3, tp2, R, tp2, false, H, C, ring);

  // block 1: residual (rounded), state 0, the GRU on the tensor cores
  for (int i = threadIdx.x; i < BM * tp2; i += kThreads) {
    const int r = i / tp2, c = i % tp2, m = rowm[r];
    const float xt = m >= 0 ? x_true[(size_t)m * tp2 + c] : 0.f;
    R[i] = Q::from_act(Q::to_act(xt - R[i]));
  }
  for (int i = threadIdx.x; i < BM * lds; i += kThreads)
    St0[i] = Q::to_act(0.f);
  __syncthreads();
  const int cur = gru<WT, MT>(Hc, St0, St1, R, d.Tp, w.gru, w.b_ih, w.b_hh,
                              w.conv_w, w.conv_b, ring);

  // block 1: decoder_y on [pf | z | state], added to Y
  mlp<WT, MT>(Zs, ldz, kz, cur ? St1 : St0, lds, kGru / Q::kK, w.b1w1, base,
              2 * kH1, rowm, w.y1w2, w.y1_b2, w.y1w3, w.y1_b3, tf2, Y, tf2,
              true, H, C, ring);

  if (mode == 1) {  // traj: out [K, M, 2T_f], row gr at gr · 2T_f
    for (int i = threadIdx.x; i < BM * tf2; i += kThreads) {
      const int r = i / tf2;
      if (rowm[r] >= 0) out[(gr0 + r) * tf2 + i % tf2] = Y[i];
    }
  } else {          // dist: out [M, K]
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < BM; r += kWarps) {
      const int m = rowm[r];
      if (m < 0) continue;   // warp-uniform
      float s = 0.f;
      for (int c = lane; c < tf2; c += 32) {
        const float e = fut_rel[(size_t)m * tf2 + c] - Y[r * tf2 + c];
        s = fmaf(e, e, s);
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) out[(size_t)m * d.K + (gr0 + r) / d.M] = s;
    }
  }
}

// z-independent first-layer partials, once per agent row (fp32), on the
// tensor cores, one weight stream of the matrix's 8 chunks; blockIdx.y
// picks the matrix:
//   base[m, 0:512)     = pf @ y0_w1[pf rows] + state0 @ y0_w1[state rows] + b
//   base[m, 512:1024)  = the same for decoder_x of block 0
//   base[m, 1024:1536) = pf @ y1_w1[pf rows] + b   (block-1 state is per k)
template <typename WT, int BM>
__global__ void __launch_bounds__(kThreads)
select_base_kernel(const float* __restrict__ pf,
                   const float* __restrict__ state0, Packed w, Dims d,
                   float* __restrict__ base) {
  using Q = Mma<WT>;
  using Act = typename Q::Act;
  constexpr int MT = BM / 16;
  extern __shared__ __align__(16) char sm[];
  const int ldp = act_ld<WT>(d.D2), lds = act_ld<WT>(kGru);
  RingState ring = ring_init<WT, BM>(sm);
  Act* P = reinterpret_cast<Act*>(sm + ring_bytes<WT, BM>());
  Act* S0 = P + BM * ldp;
  const int m0 = blockIdx.x * BM;
  for (int i = threadIdx.x; i < BM * ldp; i += kThreads) {
    const int r = i / ldp, c = i % ldp, m = m0 + r;
    P[i] = Q::to_act(m < d.M && c < d.D2 ? pf[(size_t)m * d.D2 + c] : 0.f);
  }
  for (int i = threadIdx.x; i < BM * lds; i += kThreads) {
    const int r = i / lds, c = i % lds, m = m0 + r;
    S0[i] = Q::to_act(m < d.M && c < kGru ? state0[(size_t)m * kGru + c]
                                          : 0.f);
  }
  __syncthreads();   // the staged rows and the ring's barriers

  const int which = blockIdx.y;
  const char* wm = which == 0 ? w.p0y : which == 1 ? w.p0x : w.p1;
  const float* b1 = which == 0 ? w.y0_b1 : which == 1 ? w.x0_b1 : w.y1_b1;
  const int kp = round_up(d.D2, Q::kK) / Q::kK;
  const int ks = which == 2 ? 0 : kGru / Q::kK;
  const int tb = tile_bytes<WT>(kChunk / 8);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[MT][4];
  const int rot = blockIdx.x % kChunks;
  auto seg_of = [&](int i) -> Seg {
    const int c = (i + rot) % kChunks;
    return Seg{wm + (size_t)c * (kp + ks) * tb, kp + ks, tb};
  };
  auto body = [&](int, int kt, const char* tile) {
    if (kt == 0) zero(acc);
    const typename Q::B b = Q::load_b(tile + warp * 32 * Q::kVB, lane);
    const bool first = kt < kp;
    const Act* X = first ? P : S0;
    const int ld = first ? ldp : lds;
    const int k0 = (first ? kt : kt - kp) * Q::kK;
    typename Q::A a[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) a[mt] = Q::load_a(X, ld, mt * 16, k0, lane);
#pragma unroll
    for (int ps = 0; ps < Q::kPasses; ++ps)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) Q::mma(acc[mt], a[mt], b, ps);
  };
  auto end = [&](int i) {
    const int c = (i + rot) % kChunks;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 16 + g + (e >> 1) * 8;
        const int n = c * kChunk + warp * 8 + 2 * t + (e & 1);
        if (m0 + r < d.M)
          base[(size_t)(m0 + r) * kBaseW + which * kH1 + n] =
              acc[mt][e] + __ldg(b1 + n);
      }
  };
  stream<WT, BM>(kChunks, seg_of, ring, body, end);
}

template <typename WT, int BM>
size_t base_smem(const Dims& d) {
  using Act = typename Mma<WT>::Act;
  return ring_bytes<WT, BM>() +
         (size_t)BM * (act_ld<WT>(d.D2) + act_ld<WT>(kGru)) * sizeof(Act);
}

template <typename WT, int BM>
cudaError_t launch(const float* pf, const float* z_km, const float* state0,
                   const float* x_true, const float* fut_rel, const Packed& w,
                   float* base, float* out, const Dims& d, int mode,
                   cudaStream_t s) {
  int max_smem = 0;
  cudaError_t err = smem_attr::optin_limit(&max_smem);
  if (err != cudaSuccess) return err;
  const size_t smem0 = base_smem<WT, BM>(d);
  const size_t smem1 = (size_t)Layout<WT, BM>(d).total;
  if (smem0 > (size_t)max_smem || smem1 > (size_t)max_smem)
    return cudaErrorInvalidValue;
  err = smem_attr::allow(select_base_kernel<WT, BM>, smem0);
  if (err != cudaSuccess) return err;
  err = smem_attr::allow(select_main_kernel<WT, BM>, smem1);
  if (err != cudaSuccess) return err;
  select_base_kernel<WT, BM><<<dim3((d.M + BM - 1) / BM, 3), kThreads, smem0,
                               s>>>(pf, state0, w, d, base);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long blocks = ((long long)d.M * d.K + BM - 1) / BM;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  select_main_kernel<WT, BM><<<(unsigned)blocks, kThreads, smem1, s>>>(
      z_km, x_true, fut_rel, base, w, d, mode, out);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t dispatch(const float* pf, const float* z_km, const float* state0,
                     const float* x_true, const float* fut_rel,
                     const Packed& w, float* base, float* out, const Dims& d,
                     int mode, cudaStream_t s) {
  if ((long long)d.M * d.K >= kBigRows)
    return launch<WT, 64>(pf, z_km, state0, x_true, fut_rel, w, base, out, d,
                          mode, s);
  return launch<WT, 32>(pf, z_km, state0, x_true, fut_rel, w, base, out, d,
                        mode, s);
}

}  // namespace

// pf [M,D2], z_km [K,M,Z], state0 [M,96], x_true [M,2T_p], fut_rel [M,2T_f]
// (read in mode 0 only; may be null in mode 1), all fp32; weights = host
// array of the 26 device pointers of struct Packed, in its order: the
// matrices packed by pack_select_weights in the storage type (dtype 0:
// fp32, 1: bf16), then the conv weight and the biases
// in fp32; base = fp32 scratch of M × 1536 floats; out = fp32 [M,K] (mode 0,
// "dist") or [K,M,2T_f] (mode 1, "traj"). All contiguous, on the current
// device. 2T_f and 2T_p are at most 64. Launches both kernels on `stream`;
// returns the first CUDA error (0 on success).
extern "C" int select_decode_fwd(const float* pf, const float* z_km,
                                 const float* state0, const float* x_true,
                                 const float* fut_rel,
                                 const void* const* weights, float* base,
                                 float* out, int M, int K, int D2, int Z,
                                 int Tp, int Tf, int mode, int dtype,
                                 void* stream) {
  if (M <= 0 || K <= 0) return cudaSuccess;
  if ((mode != 0 && mode != 1) || 2 * Tf > kMaxOut || 2 * Tp > kMaxOut ||
      Tp < 1 || Tf < 1 || D2 < 1 || Z < 1)
    return cudaErrorInvalidValue;
  const Dims d{M, K, D2, Z, Tp, Tf};
  Packed w;
  memcpy(&w, weights, sizeof(w));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(pf, z_km, state0, x_true, fut_rel, w, base, out, d,
                           mode, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(pf, z_km, state0, x_true, fut_rel, w, base,
                                   out, d, mode, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* sttode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
