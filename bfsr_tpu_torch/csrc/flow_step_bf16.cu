// K5 at passes=1 (BFSR_PRECISION=default): one fused conditional SRFlow
// FlowStep (eval, no log-det), forward and reverse, with bf16-rounded
// operands (round to nearest even) in some of its five products and every
// sum in f32.  NHWC state (B, H, W, C) with C in {12, 24, 48, 96, 192}
// (the 4x model's three flow levels and the 8x model's four), coupling
// hidden width 64, any H and W, any batch: the image is blockIdx.z, the
// state, its records and the output are offset by whole images and the
// weights are shared, so a batch-1 launch is the launch it was before the
// batch.  Two forms, a template flag:
//
// XLA form (PALLAS = false; entries flow_step_bf16_forward / _reverse), the
// form SRFlowLPPredictor serves under default.  It follows the JAX
// predictor, whose FlowStep kernel is off by default
// (bfsr_tpu/pipelines/srflow_eval.py:30-46), so its default runs the XLA
// step: the folds at Precision.HIGHEST (bfsr_tpu/ops/flows.py:144-154), only
// conv1-3 of the coupling tower at DEFAULT (:386-396) and the Conv2dZeros
// gain exp(3 logs) applied after conv3 (flow_conv_zeros, :237-240).  Here:
//   - the folds run f32 FMA on the unrounded state x (forward) and t
//     (reverse) with the unrounded w_fold / w_inv_fold;
//   - rounded: z1 before conv1, the hidden map before conv2 and before
//     conv3 (products 2-4 below);
//   - W3 is rounded unscaled, and o = (conv3(h; W3) + b3) * g in the f32
//     epilogue, g = exp(3 logs) from the buffer.
// Pallas form (PALLAS = true; entries flow_step_bf16_pallas_forward /
// _reverse, step_form="pallas"): the JAX FlowStep kernel at passes == 1
// (bfsr_tpu/ops/pallas/flow_step.py:_fwd_kernel / _rev_kernel, with
// BFSR_SRFLOW_STEP_KERNEL=on), where _dot3 is one dot(bf16(v), bf16(w))
// with f32 accumulation.  The rounded operands, as there:
//   1. the state x before the forward fold (folded actnorm + invconv 1x1);
//   2. z1 (za's first half, zero outside the image) before conv1;
//   3. the hidden map after actnorm1 + ReLU, before the 1x1 conv2;
//   4. the hidden map after actnorm2 + ReLU and the image mask, before conv3;
//   5. t = [x1 | x2] / scale_ft - shift_ft before the reverse fold;
// and the gain folded into W3 and b3 before W3 is rounded
// (flow_step.py:31, 112): round(W3 g) where the XLA step has round(W3) g.
// The weights were rounded once at freeze() (flow_step.py:pack_step_bf16).
// Everything else is f32 in both: the records, b_fold, an_bias, the
// actnorm vectors, b3, the gain, the sigmoid and the coupling.  A product
// of two bf16 values is exact in f32, so the folds of the Pallas form run
// as f32 FMA on rounded values, the same function.
// Not carried over from the TPU kernel: the 128-lane pads, the 8-column
// halos, the level-1 space-to-depth phases, the hi/lo split, the VMEM tile
// budget.
//
// What bounds it on this card: bytes.  Per pixel a step moves (C + (2C +
// 64) + C) * 4 bytes and does 2*C*C + 2*9*cn*64 + 2*64*64 + 2*9*64*C flops
// (29 K at C = 12 to 193 K at C = 96): 65-232 flop/B, under the 295 flop/B
// where the H100's bf16 rate and its memory rate balance.  Once the three
// tower convs run on the tensor cores, what is left is the kernel's
// skeleton: the halo reads of the state and the records, the weight copies
// into shared memory (36 KB a block at C = 12, 213 KB at C = 96), the stage
// barriers and the f32 folds (SIMT, C x C per pixel, the forward one on
// the 2-pixel halo).  At C = 192 the fold (147 KB f32) does not fit beside
// W1 (9 x 96 rows, 124 KB), W2 and the W3 ring: both folds are then read
// from global memory (FS = 0; every block reads the same rows, which stay
// in L2) and the state from global memory too (XS = 0).
//
// Design.  A block of 256 threads (8 warps) owns a TY x TX tile of output
// pixels.  At its start it copies the step's weights into shared memory
// with 16-byte cp.async, in three groups: the fold this direction needs
// (f32, C x C), the f32 vectors and (XS levels) the state on the window;
// W2 and W1 (bf16, rows padded to 72 values so that ldmatrix reads them
// without bank conflicts); W3 (bf16, 9 taps x 64 x N3 columns), whole or,
// at C = 96, its first S3 taps, the rest streamed one tap a slot through
// an S3-slot ring during conv3.
//   A. z1 on the (TY+4) x (TX+4) window (2-pixel halo: two stacked 3x3
//      convs), rounded to bf16 once, zero outside the image.  Forward: the
//      fold, f32 FMA from shared memory, in items of PX pixels x QA
//      outputs (a float4 of the state feeds 4 QA FMAs, a float4 of the
//      fold 4 PX); z1 written to the output (f32), za's second half kept
//      for the tile.  Reverse: x's first half.
//   B. conv1 and conv2 on the tensor cores (mma.sync.m16n8k16, bf16 in,
//      f32 accumulate), one warp per 16-pixel M fragment of the flat
//      (TY+2) x (TX+2) hidden region, all 64 hidden channels (8 n8 tiles:
//      each A fragment feeds 8 MMAs).  conv1's K is the taps' channels
//      concatenated (9 cn, zero rows in W1 to the next 16), its A fragment
//      gathered from the window by 32-bit loads (cn is even, so a pair of
//      k never straddles a tap), its B by ldmatrix.trans.  Its epilogue
//      (+ aff1_ft, actnorm1, ReLU) runs on the accumulators, whose layout
//      is that of conv2's A fragments: the rounded hidden map goes from
//      registers straight into conv2.  conv2's epilogue (actnorm2, ReLU,
//      ZEROED OUTSIDE THE IMAGE: conv3 pads its input with zeros, and the
//      hidden map there carries the actnorm biases) stores bf16 pairs to
//      the shared hidden map.
//   C. conv3 on the tensor cores: warps split into M groups (16 output
//      pixels, A by ldmatrix from the hidden map at the tap's offset) x N
//      groups (NTW n8 tiles of W3, B by ldmatrix.trans), K = 9 taps x 64
//      in a fixed order.  W3's columns are interleaved (scale j, shift j),
//      so each lane holds both halves of its channels: the epilogue (b3,
//      the XLA form's gain, the sigmoid, the coupling) runs on the
//      accumulators and writes the coupled half (reverse: x2' to shared
//      memory).
//   D. (reverse only) the ft affine, then the folded inverse 1x1 as f32
//      FMA from shared memory in items of PXD pixels x QD outputs.
// Every sum runs in a fixed order with no atomics: two launches on the
// same inputs give the same bits.
//
// Tiles, each level's best of three candidates timed side by side with
// bfsr_tpu_torch/profiling/k5_times.py (NVIDIA H100 80GB HBM3, 700.00 W):
// 16 x 16 at C = 12 (256 blocks at 256^2, two a SM; 8 x 16 and 8 x 32
// slower), 16 x 8 at C = 24 (128 blocks at 128^2; 8 x 8 slower, 8 x 16
// level), 4 x 8 at C = 96 (128 blocks at 64^2; a W3 ring of 2, 4 or 6
// slots level).  On that card: 0.029 / 0.015 / 0.021 ms forward and 0.030
// / 0.016 / 0.019 ms reverse at 256^2 x 12 / 128^2 x 24 / 64^2 x 96, 30 /
// 20 / 11% of the bf16 byte bound; the f32 kernel takes 0.082 / 0.037 /
// 0.057.  What holds it there: at C = 12 the MMAs (~2,500 a block with
// the halo and the pads, ~11 us of the 29 at the rate mma.sync reaches
// here) and the weight copies (~4 us); at C = 96 the halo recompute of
// the forward fold and the weight copies (~210 KB a block).  The 8x
// model's levels (k5_times.py --levels x8): 8 x 8 at C = 48 (64 blocks at
// 64^2; 16 x 8 slower, 4 x 16 level; 4 x 8 would split its 6 n8 tiles of
// W3 over 4 warps), 0.016 ms each way, 8% of the bound; 4 x 4 at C = 192
// (64 blocks at 32^2; 4 x 8 and 8 x 4 slower), 0.055 / 0.033 ms forward /
// reverse, 2 / 4%: latency, the folds read through L2 and, at 16 tile
// pixels, W1 and the W3 ring copied into every block (~185 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHid = 64;
constexpr int kLD = kHid + 8;  // W1, W2 and hidden-map row stride, bf16
constexpr float kAffineEps = 1e-4f;

// Per level: output tile TY x TX (TY * TX a multiple of 16); S3 slots of
// one W3 tap (9: whole); items of the forward fold PX pixels x QA outputs,
// of the inverse fold PXD pixels x QD outputs; XS: the forward fold reads
// the state from a copy of the window in shared memory (else from global
// memory); MINB blocks per SM; FS: the fold of the direction in shared
// memory (else read from global memory).
template <int C> struct Tile;
template <> struct Tile<12> {
  static constexpr int TY = 16, TX = 16, S3 = 9, PX = 1, QA = 6, PXD = 1,
                       QD = 6, XS = 0, MINB = 2, FS = 1;
};
template <> struct Tile<24> {
  static constexpr int TY = 16, TX = 8, S3 = 9, PX = 1, QA = 12, PXD = 1,
                       QD = 6, XS = 1, MINB = 1, FS = 1;
};
template <> struct Tile<48> {
  static constexpr int TY = 8, TX = 8, S3 = 9, PX = 2, QA = 6, PXD = 2,
                       QD = 6, XS = 1, MINB = 1, FS = 1;
};
template <> struct Tile<96> {
  static constexpr int TY = 4, TX = 8, S3 = 2, PX = 4, QA = 6, PXD = 2,
                       QD = 6, XS = 1, MINB = 1, FS = 1;
};
template <> struct Tile<192> {
  static constexpr int TY = 4, TX = 4, S3 = 2, PX = 2, QA = 12, PXD = 1,
                       QD = 12, XS = 0, MINB = 1, FS = 0;
};

constexpr int rup128(int n) { return (n + 127) / 128 * 128; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int C, bool PALLAS>
struct Geo {
  using T = Tile<C>;
  static constexpr int CN = C / 2, CO = C - C / 2, R = 2 * C + kHid;
  // W3's columns in the buffer, and conv3's n8 tiles (past 2co: zeros)
  static constexpr int N3 = (2 * CO + 15) / 16 * 16, NT3 = (2 * CO + 7) / 8;
  static constexpr int TY = T::TY, TX = T::TX;
  static constexpr int HY = TY + 2, HX = TX + 2, NH = HY * HX;
  static constexpr int MH = (NH + 15) / 16;  // conv1 / conv2 M fragments
  static constexpr int WY = TY + 4, WX = TX + 4, NW = WY * WX;
  static constexpr int NO = TY * TX, MO = NO / 16;  // conv3 M fragments
  static constexpr int K1 = 9 * CN, K1P = (K1 + 15) / 16 * 16;
  // conv3: warp = mg * NG3 + ng, NG3 N groups of NTW n8 tiles, MG3 M
  // groups of MFW fragments
  static constexpr int NG3 = MO >= kWarps ? 1 : kWarps / MO;
  static constexpr int NTW = NT3 / NG3, MG3 = kWarps / NG3;
  static constexpr int MFW = (MO + MG3 - 1) / MG3;
  static constexpr int S3 = T::S3, NG3C = S3 == 9 ? 1 : S3;  // W3 groups
  static constexpr int QA = T::QA, GA = CN / QA, QD = T::QD, GD = C / QD;
  static constexpr int PX = T::PX, PXD = T::PXD;
  static constexpr bool XS = T::XS, FS = T::FS;
  static constexpr int SX = C + 4;  // the state's window copy, f32
  // z1 pixel stride (bf16): even, an odd number of 32-bit words
  static constexpr int SZ = (CN / 2) % 2 ? CN : CN + 2;
  static constexpr int S2 = CO | 1, ST = C + 1;  // za2 / x2', t (f32)
  static constexpr int LD3 = N3 + 8;             // W3 row stride, bf16
  // the buffer (bfsr_tpu_torch/ops/cuda/flow_step.py:_layout_bf16): f32
  // words first, offsets in floats; the XLA form's gain G3 after b3
  static constexpr int BF = 0, AB = BF + C, AN1B = AB + C;
  static constexpr int AN1E = AN1B + kHid, AN2B = AN1E + kHid;
  static constexpr int AN2E = AN2B + kHid, B3 = AN2E + kHid, G3 = B3 + N3;
  static constexpr int NVEC = PALLAS ? G3 : G3 + N3;  // the vectors
  static constexpr int WF = NVEC, WI = WF + C * C;
  static constexpr int NWORDS = (WI + C * C + 7) / 8 * 8;
  // then bf16 values, offsets in bf16 from the buffer's start
  static constexpr int W1 = 2 * NWORDS, W2 = W1 + K1P * kHid;
  static constexpr int W3 = W2 + kHid * kHid;
  // shared memory, in bytes: vectors | W2 | hidden map | za2 / x2' | W3
  // slots | fold | z1 window | W1 | (XS) the state on the window; reverse:
  // t over the z1 window and W1
  static constexpr int B_W2 = rup128(NVEC * 4);
  static constexpr int B_H = B_W2 + rup128(kHid * kLD * 2);
  static constexpr int B_2 = B_H + rup128(MH * 16 * kLD * 2);
  static constexpr int B_W3 = B_2 + rup128(NO * S2 * 4);
  static constexpr int B_F = B_W3 + rup128(S3 * kHid * LD3 * 2);
  static constexpr int B_Z = B_F + (FS ? rup128(C * C * 4) : 0);
  static constexpr int B_W1 = B_Z + rup128(NW * SZ * 2);
  static constexpr int B_X = B_W1 + rup128(K1P * kLD * 2);
  static constexpr int SMEM = cmax(B_X + (XS ? rup128(NW * SX * 4) : 0),
                                   B_Z + rup128(NO * ST * 4));
  static_assert(C % 4 == 0 && CN == CO && CN % 2 == 0, "C");
  static_assert(NO % 16 == 0 && (MO >= kWarps ? MO % kWarps == 0
                                              : kWarps % MO == 0), "tile");
  static_assert(NT3 % NG3 == 0, "conv3 N groups");
  static_assert(CN % QA == 0 && QA % 2 == 0 && C % QD == 0 && QD % 2 == 0 &&
                NO % PX == 0 && NO % PXD == 0, "fold items");
  static_assert(S3 == 9 || (S3 >= 2 && S3 <= 8), "W3 slots");
  static_assert(NVEC % 4 == 0 && (C * C) % 4 == 0, "16-byte copies");
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
// 16 bytes, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// wait until at most n (0 <= n <= 7) groups are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// n floats (n % 4 == 0, both ends 16-byte aligned), copied by the block
__device__ __forceinline__ void copy_f32(float* dst,
                                         const float* __restrict__ src,
                                         int n) {
  for (int e = threadIdx.x; e < n / 4; e += kThreads) {
    cp_async16(dst + 4 * e, src + 4 * e);
  }
}

// rows x n bf16 (n % 8 == 0) from a packed matrix to rows of stride ld
template <int ROWS, int N>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* __restrict__ src) {
  constexpr int V = N / 8;
  for (int e = threadIdx.x; e < ROWS * V; e += kThreads) {
    const int r = e / V, v = e % V;
    cp_async16(dst + r * ld + 8 * v, src + r * N + 8 * v);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// a float4 of a fold: from shared memory (FS) or, read-only, from global
template <bool FS>
__device__ __forceinline__ float4 ldf4(const float* p) {
  if constexpr (FS) {
    return ld4(p);
  } else {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
}

// v[i] = p[i], i < N, in float4 loads (N % 4 == 0, p 16-byte aligned) or
// float2 loads (N even, p 8-byte aligned)
template <int N>
__device__ __forceinline__ void ldg_vec(float (&v)[N],
                                        const float* __restrict__ p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else {
    static_assert(N % 2 == 0, "float2 loads");
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p) + i);
      v[2 * i] = q.x;
      v[2 * i + 1] = q.y;
    }
  }
}

// p[i] = v[i], i < N, the same way
template <int N>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  } else {
    static_assert(N % 2 == 0, "float2 stores");
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      reinterpret_cast<float2*>(p)[i] = make_float2(v[2 * i], v[2 * i + 1]);
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  // not volatile: a register-only op, which the compiler may schedule
  // after the (volatile) loads of the next k step
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(p)));
}

// acc[j] += A (16 x 16) * B (16 rows of b from column 8 j, j < 8): the
// 64 hidden channels of one k step; b points at this lane's ldmatrix row
__device__ __forceinline__ void mma_k16_n64(float (&acc)[8][4],
                                            const uint32_t (&a)[4],
                                            const __nv_bfloat16* b) {
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4_trans(b0, b1, b2, b3, b + 8 * j);
    mma_bf16(acc[j], a, b0, b1);
    mma_bf16(acc[j + 1], a, b2, b3);
  }
}

template <int C, bool REV, bool PALLAS>
__global__ void __launch_bounds__(kThreads, Tile<C>::MINB)
flow_step_bf16_kernel(const float* __restrict__ x,
                      const float* __restrict__ cond,
                      const __nv_bfloat16* __restrict__ wb,
                      float* __restrict__ out, int H, int W) {
  using G = Geo<C, PALLAS>;
  constexpr int CN = G::CN, CO = G::CO, R = G::R, N3 = G::N3;
  constexpr int TX = G::TX, TY = G::TY, HX = G::HX, WX = G::WX, SZ = G::SZ;
  constexpr int NH = G::NH, NO = G::NO, S2 = G::S2, LD3 = G::LD3;
  constexpr int S3 = G::S3, NG3C = G::NG3C;
  const float* __restrict__ wf = reinterpret_cast<const float*>(wb);
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_vec = reinterpret_cast<float*>(smem);
  __nv_bfloat16* s_w2 = reinterpret_cast<__nv_bfloat16*>(smem + G::B_W2);
  __nv_bfloat16* s_h = reinterpret_cast<__nv_bfloat16*>(smem + G::B_H);
  float* s_2 = reinterpret_cast<float*>(smem + G::B_2);  // za2 / x2'
  __nv_bfloat16* s_w3 = reinterpret_cast<__nv_bfloat16*>(smem + G::B_W3);
  // the fold of this direction: in shared memory (FS) or global memory
  const float* s_f = G::FS ? reinterpret_cast<const float*>(smem + G::B_F)
                           : wf + (REV ? G::WI : G::WF);
  __nv_bfloat16* s_z = reinterpret_cast<__nv_bfloat16*>(smem + G::B_Z);
  __nv_bfloat16* s_w1 = reinterpret_cast<__nv_bfloat16*>(smem + G::B_W1);
  float* s_x = reinterpret_cast<float*>(smem + G::B_X);  // XS: the window

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  // pixels before this block's image, in the state, records and output
  const size_t img_px = static_cast<size_t>(blockIdx.z) * H * W;
  x += img_px * C;
  cond += img_px * R;
  out += img_px * C;

  // ---- the weights, in flight while stage A runs ----
  if constexpr (G::FS) {
    copy_f32(reinterpret_cast<float*>(smem + G::B_F),
             wf + (REV ? G::WI : G::WF), C * C);
  }
  copy_f32(s_vec, wf, G::NVEC);
  if constexpr (G::XS) {  // the state on the window, zero outside
    for (int e = tid; e < G::NW * (C / 4); e += kThreads) {
      const int p = e / (C / 4), v = e % (C / 4);
      const int gy = y0 - 2 + p / WX, gx = x0 - 2 + p % WX;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16_zfill(
          s_x + p * G::SX + 4 * v,
          ok ? x + (static_cast<size_t>(gy) * W + gx) * C + 4 * v : x,
          ok ? 16 : 0);
    }
  }
  cp_async_commit();
  copy_rows<kHid, kHid>(s_w2, kLD, wb + G::W2);
  copy_rows<G::K1P, kHid>(s_w1, kLD, wb + G::W1);
  cp_async_commit();
  if constexpr (S3 == 9) {
    copy_rows<9 * kHid, N3>(s_w3, LD3, wb + G::W3);
    cp_async_commit();
  } else {
#pragma unroll
    for (int t = 0; t < S3; ++t) {
      copy_rows<kHid, N3>(s_w3 + t * kHid * LD3, LD3,
                          wb + G::W3 + t * kHid * N3);
      cp_async_commit();
    }
  }

  // ---- A: z1 on the window, bf16 (zero outside the image) ----
  if constexpr (!REV) {
    constexpr int QA = G::QA, PX = G::PX;
    constexpr int NQZ = (G::NW + PX - 1) / PX, NQ = NQZ + NO / PX;
    cp_async_wait<NG3C + 1>();
    __syncthreads();  // the fold, the vectors (and the window) landed
    // items: (PX window pixels, z1 group) then (PX tile pixels, za2
    // group); item qd's pixels are qd + k NQZ (+ k NO / PX on the tile), so
    // that the lanes of a warp read neighbouring pixels
    constexpr int NQ2 = NO / PX;
    for (int i = tid; i < NQ * G::GA; i += kThreads) {
      const int qd = i % NQ, g = i / NQ;
      const bool z = qd < NQZ;
      const int o0 = (z ? 0 : CN) + g * QA;
      int wp[PX], tp[PX];
      bool ok[PX], in[PX];
      size_t pix[PX];
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        int wy, wx;
        if (z) {
          ok[k] = qd + k * NQZ < G::NW;
          const int p = min(qd + k * NQZ, G::NW - 1);
          wy = p / WX;
          wx = p % WX;
        } else {
          ok[k] = true;
          tp[k] = qd - NQZ + k * NQ2;
          wy = tp[k] / TX + 2;
          wx = tp[k] % TX + 2;
        }
        wp[k] = wy * WX + wx;
        const int gy = y0 - 2 + wy, gx = x0 - 2 + wx;
        in[k] = ok[k] && gy >= 0 && gy < H && gx >= 0 && gx < W;
        pix[k] = in[k] ? static_cast<size_t>(gy) * W + gx : 0;
      }
      const float* wr = s_f + o0 * C;
      float acc[PX][QA];
#pragma unroll
      for (int k = 0; k < PX; ++k) {
#pragma unroll
        for (int q = 0; q < QA; ++q) acc[k][q] = 0.f;
      }
#pragma unroll 2
      for (int c4 = 0; c4 < C / 4; ++c4) {
        float4 v[PX];
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          if constexpr (G::XS) {
            v[k] = ld4(s_x + wp[k] * G::SX + 4 * c4);
          } else {
            v[k] = in[k] ? __ldg(reinterpret_cast<const float4*>(
                               x + pix[k] * C) + c4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          if constexpr (PALLAS) {  // product 1
            v[k].x = round_bf16(v[k].x);
            v[k].y = round_bf16(v[k].y);
            v[k].z = round_bf16(v[k].z);
            v[k].w = round_bf16(v[k].w);
          }
        }
#pragma unroll
        for (int q = 0; q < QA; ++q) {
          const float4 w = ldf4<G::FS>(wr + q * C + 4 * c4);
#pragma unroll
          for (int k = 0; k < PX; ++k) {
            acc[k][q] += v[k].x * w.x;
            acc[k][q] += v[k].y * w.y;
            acc[k][q] += v[k].z * w.z;
            acc[k][q] += v[k].w * w.w;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        uint32_t* zr = reinterpret_cast<uint32_t*>(s_z + wp[k] * SZ + g * QA);
        if (!in[k]) {
          if (z && ok[k]) {
#pragma unroll
            for (int q = 0; q < QA / 2; ++q) zr[q] = 0u;
          }
          continue;
        }
        const float* rec = cond + pix[k] * R + o0;
        float sc[QA], sh[QA], za[QA];
        ldg_vec(sc, rec);
        ldg_vec(sh, rec + C);
#pragma unroll
        for (int q = 0; q < QA; ++q) {
          za[q] = (acc[k][q] + s_vec[G::BF + o0 + q] + sh[q]) * sc[q];
        }
        if (z) {
#pragma unroll
          for (int q = 0; q < QA / 2; ++q) {
            zr[q] = pack_bf16(za[2 * q], za[2 * q + 1]);  // product 2
          }
          const int wy = wp[k] / WX, wx = wp[k] % WX;
          if (wy >= 2 && wy < TY + 2 && wx >= 2 && wx < TX + 2) {
            st_vec(out + pix[k] * C + o0, za);
          }
        } else {
          float* zr2 = s_2 + tp[k] * S2 + g * QA;
#pragma unroll
          for (int q = 0; q < QA; ++q) zr2[q] = za[q];
        }
      }
    }
  } else if constexpr (G::XS) {
    cp_async_wait<NG3C + 1>();
    __syncthreads();  // the window landed
    for (int i = tid; i < G::NW * (CN / 2); i += kThreads) {
      const int p = i / (CN / 2), q = i % (CN / 2);
      const float2 v = *reinterpret_cast<const float2*>(s_x + p * G::SX + 2 * q);
      reinterpret_cast<uint32_t*>(s_z + p * SZ)[q] =
          pack_bf16(v.x, v.y);  // product 2
    }
  } else {
    for (int p = tid; p < G::NW; p += kThreads) {
      const int gy = y0 - 2 + p / WX, gx = x0 - 2 + p % WX;
      float z1[CN];
#pragma unroll
      for (int q = 0; q < CN; ++q) z1[q] = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        ldg_vec(z1, x + (static_cast<size_t>(gy) * W + gx) * C);
      }
      uint32_t* zr = reinterpret_cast<uint32_t*>(s_z + p * SZ);
#pragma unroll
      for (int q = 0; q < CN / 2; ++q) {
        zr[q] = pack_bf16(z1[2 * q], z1[2 * q + 1]);  // product 2
      }
    }
  }
  cp_async_wait<NG3C>();
  __syncthreads();  // the window, W2 and W1 in place

  // ---- B: conv1 -> actnorm1 + ReLU -> conv2 -> actnorm2 + ReLU + mask ----
  // lane: rows g8 and g8 + 8 of a fragment, columns q2, q2 + 1 of each n8
  // tile; b_row / b_nt: its row of the ldmatrix.trans tiles
  const int g8 = lane >> 2, q2 = (lane & 3) * 2;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_nt = lane >> 4;
  for (int mf = warp; mf < G::MH; mf += kWarps) {
    int pr[2];
    bool in[2];
    const uint32_t* zb[2];
    float2 af[2][8];  // aff1_ft of the two rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pr[h] = mf * 16 + g8 + 8 * h;
      const int p = min(pr[h], NH - 1);
      const int hy = p / HX, hx = p % HX;
      zb[h] = reinterpret_cast<const uint32_t*>(s_z + (hy * WX + hx) * SZ);
      const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
      in[h] = pr[h] < NH && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* ar = cond + (in[h] ? (static_cast<size_t>(gy) * W + gx) * R
                                      : 0) + 2 * C + q2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        af[h][j] = in[h] ? __ldg(reinterpret_cast<const float2*>(ar + 8 * j))
                         : make_float2(0.f, 0.f);
      }
    }
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    // conv1: k = tap * cn + channel; pairs (k, k + 1) lie in one tap
#pragma unroll
    for (int ks = 0; ks < G::K1P / 16; ++ks) {
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 16 * ks + 8 * h + q2;
        if (k < G::K1) {
          const int tap = k / CN, c = k - tap * CN;
          const int off = ((tap / 3) * WX + tap % 3) * (SZ / 2) + c / 2;
          a[2 * h] = zb[0][off];
          a[2 * h + 1] = zb[1][off];
        } else {
          a[2 * h] = 0u;
          a[2 * h + 1] = 0u;
        }
      }
      mma_k16_n64(acc, a, s_w1 + (16 * ks + b_row) * kLD + 8 * b_nt);
    }
    // actnorm1 + ReLU, rounded: tiles 2kk, 2kk + 1 are conv2's k step kk
    uint32_t ha[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(s_vec + G::AN1B +
                                                        8 * j + q2);
      const float2 e = *reinterpret_cast<const float2*>(s_vec + G::AN1E +
                                                        8 * j + q2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = fmaxf((acc[j][2 * h] + af[h][j].x + b.x) * e.x, 0.f);
        const float v1 =
            fmaxf((acc[j][2 * h + 1] + af[h][j].y + b.y) * e.y, 0.f);
        ha[j / 2][2 * (j % 2) + h] = pack_bf16(v0, v1);  // product 3
      }
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) acc[j][e2] = 0.f;
    }
    // conv2 (1x1, K = 64)
#pragma unroll
    for (int kk = 0; kk < kHid / 16; ++kk) {
      mma_k16_n64(acc, ha[kk], s_w2 + (16 * kk + b_row) * kLD + 8 * b_nt);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(s_vec + G::AN2B +
                                                        8 * j + q2);
      const float2 e = *reinterpret_cast<const float2*>(s_vec + G::AN2E +
                                                        8 * j + q2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (pr[h] >= NH) continue;
        const float v0 =
            in[h] ? fmaxf((acc[j][2 * h] + b.x) * e.x, 0.f) : 0.f;
        const float v1 =
            in[h] ? fmaxf((acc[j][2 * h + 1] + b.y) * e.y, 0.f) : 0.f;
        *reinterpret_cast<uint32_t*>(s_h + pr[h] * kLD + 8 * j + q2) =
            pack_bf16(v0, v1);  // product 4
      }
    }
  }
  if constexpr (S3 == 9) cp_async_wait<0>();
  __syncthreads();  // the hidden map (and a whole W3) in place

  // ---- C: conv3 -> (scale, shift) -> the coupled half ----
  constexpr int NTW = G::NTW, MFW = G::MFW, MG3 = G::MG3;
  const int ng = warp % G::NG3, mg = warp / G::NG3;
  const int n0 = ng * NTW;  // this warp's first n8 tile
  int abase[MFW];
#pragma unroll
  for (int i = 0; i < MFW; ++i) {
    const int o = (mg + i * MG3) * 16 + (lane & 15);
    abase[i] = ((o / TX) * HX + o % TX) * kLD + (lane >> 4) * 8;
  }
  float acc3[MFW][NTW][4];
#pragma unroll
  for (int i = 0; i < MFW; ++i) {
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc3[i][j][e] = 0.f;
    }
  }
#pragma unroll(S3 == 9 ? 3 : 1)
  for (int tap = 0; tap < 9; ++tap) {
    if constexpr (S3 < 9) {
      cp_async_wait_upto(min(S3 - 1, 8 - tap));
      __syncthreads();  // tap's slot landed
    }
    const __nv_bfloat16* w3 = s_w3 + (tap % S3) * kHid * LD3;
    const int toff = ((tap / 3) * HX + tap % 3) * kLD;
#pragma unroll
    for (int kk = 0; kk < kHid / 16; ++kk) {
      uint32_t b[NTW][2];
#pragma unroll
      for (int j = 0; j + 1 < NTW; j += 2) {
        ldsm_x4_trans(b[j][0], b[j][1], b[j + 1][0], b[j + 1][1],
                      w3 + (16 * kk + b_row) * LD3 + (n0 + j + b_nt) * 8);
      }
      if constexpr (NTW % 2) {
        ldsm_x2_trans(b[NTW - 1][0], b[NTW - 1][1],
                      w3 + (16 * kk + (lane & 15)) * LD3 +
                          (n0 + NTW - 1) * 8);
      }
#pragma unroll
      for (int i = 0; i < MFW; ++i) {
        if (mg + i * MG3 >= G::MO) continue;
        uint32_t a[4];
        ldsm_x4(a, s_h + abase[i] + toff + 16 * kk);
#pragma unroll
        for (int j = 0; j < NTW; ++j) mma_bf16(acc3[i][j], a, b[j][0], b[j][1]);
      }
    }
    if constexpr (S3 < 9) {
      if (tap + S3 < 9) {
        __syncthreads();  // every warp is done with the slot
        copy_rows<kHid, N3>(s_w3 + (tap % S3) * kHid * LD3, LD3,
                            wb + G::W3 + (tap + S3) * kHid * N3);
        cp_async_commit();
      }
    }
  }
  // the epilogue on the accumulators: columns (q2, q2 + 1) of tile j are
  // (scale, shift) of channel (8 (n0 + j) + q2) / 2
#pragma unroll
  for (int i = 0; i < MFW; ++i) {
    const int mf = mg + i * MG3;
    if (mf >= G::MO) continue;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int col = 8 * (n0 + j) + q2, ch = col / 2;
      if (ch >= CO) continue;
      const float2 b3 = *reinterpret_cast<const float2*>(s_vec + G::B3 + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = mf * 16 + g8 + 8 * h;
        const int gy = y0 + o / TX, gx = x0 + o % TX;
        if (gy >= H || gx >= W) continue;
        float as = acc3[i][j][2 * h] + b3.x;
        float at = acc3[i][j][2 * h + 1] + b3.y;
        if constexpr (!PALLAS) {  // the gain after conv3, as the XLA step
          const float2 g3 =
              *reinterpret_cast<const float2*>(s_vec + G::G3 + col);
          as *= g3.x;
          at *= g3.y;
        }
        const float scale = 1.f / (1.f + expf(-(as + 2.f))) + kAffineEps;
        const size_t pix = static_cast<size_t>(gy) * W + gx;
        if constexpr (!REV) {
          out[pix * C + CN + ch] = (s_2[o * S2 + ch] + at) * scale;
        } else {
          const float x2 =
              G::XS ? s_x[((o / TX + 2) * WX + o % TX + 2) * G::SX + CN + ch]
                    : __ldg(x + pix * C + CN + ch);
          s_2[o * S2 + ch] = x2 / scale - at;
        }
      }
    }
  }

  // ---- D (reverse): ft affine, then the folded inverse 1x1 ----
  if constexpr (REV) {
    constexpr int ST = G::ST, QD = G::QD;
    float* s_t = reinterpret_cast<float*>(smem + G::B_Z);  // (NO, ST)
    __syncthreads();  // x2' written; the window and W1 are free
    for (int i = tid; i < NO * (C / 4); i += kThreads) {
      const int p = i % NO, c0 = (i / NO) * 4;
      const int gy = y0 + p / TX, gx = x0 + p % TX;
      if (gy >= H || gx >= W) continue;
      const size_t pix = static_cast<size_t>(gy) * W + gx;
      const float* rec = cond + pix * R;
      float xv[4], sc[4], sh[4];
      if constexpr (G::XS) {
        const float4 v =
            ld4(s_x + ((p / TX + 2) * WX + p % TX + 2) * G::SX + c0);
        xv[0] = v.x;
        xv[1] = v.y;
        xv[2] = v.z;
        xv[3] = v.w;
      } else {
        ldg_vec(xv, x + pix * C + c0);
      }
      ldg_vec(sc, rec + c0);
      ldg_vec(sh, rec + C + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + e;
        const float v = c < CN ? xv[e] : s_2[p * S2 + c - CN];
        float t = v / sc[e] - sh[e];
        if constexpr (PALLAS) t = round_bf16(t);  // product 5
        s_t[p * ST + c] = t;
      }
    }
    __syncthreads();  // t in place
    // item qd: pixels qd + k NQD, k < PXD
    constexpr int PXD = G::PXD, NQD = NO / PXD;
    for (int i = tid; i < NQD * G::GD; i += kThreads) {
      const int qd = i % NQD, g = i / NQD;
      const float* wr = s_f + g * QD * C;
      float acc[PXD][QD];
#pragma unroll
      for (int k = 0; k < PXD; ++k) {
#pragma unroll
        for (int q = 0; q < QD; ++q) acc[k][q] = 0.f;
      }
#pragma unroll 2
      for (int c4 = 0; c4 < C / 4; ++c4) {
        float t[PXD][4];
#pragma unroll
        for (int k = 0; k < PXD; ++k) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            t[k][e] = s_t[(qd + k * NQD) * ST + 4 * c4 + e];
          }
        }
#pragma unroll
        for (int q = 0; q < QD; ++q) {
          const float4 w = ldf4<G::FS>(wr + q * C + 4 * c4);
#pragma unroll
          for (int k = 0; k < PXD; ++k) {
            acc[k][q] += t[k][0] * w.x;
            acc[k][q] += t[k][1] * w.y;
            acc[k][q] += t[k][2] * w.z;
            acc[k][q] += t[k][3] * w.w;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < PXD; ++k) {
        const int p = qd + k * NQD;
        const int gy = y0 + p / TX, gx = x0 + p % TX;
        if (gy >= H || gx >= W) continue;
#pragma unroll
        for (int q = 0; q < QD; ++q) acc[k][q] -= s_vec[G::AB + g * QD + q];
        st_vec(out + (static_cast<size_t>(gy) * W + gx) * C + g * QD, acc[k]);
      }
    }
  }
}

template <int C, bool REV, bool PALLAS>
int launch(const float* x, const float* cond, const __nv_bfloat16* wb,
           float* out, int B, int H, int W, cudaStream_t stream) {
  using G = Geo<C, PALLAS>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flow_step_bf16_kernel<C, REV, PALLAS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((W + G::TX - 1) / G::TX, (H + G::TY - 1) / G::TY, B);
  flow_step_bf16_kernel<C, REV, PALLAS><<<grid, kThreads, G::SMEM, stream>>>(
      x, cond, wb, out, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <bool REV, bool PALLAS>
int dispatch(const void* x, const void* cond, const void* packed, void* out,
             int B, int H, int W, int C, int hid, void* stream) {
  if (hid != kHid || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(cond);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(packed);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 12: return launch<12, REV, PALLAS>(xp, cp, wp, op, B, H, W, st);
    case 24: return launch<24, REV, PALLAS>(xp, cp, wp, op, B, H, W, st);
    case 48: return launch<48, REV, PALLAS>(xp, cp, wp, op, B, H, W, st);
    case 96: return launch<96, REV, PALLAS>(xp, cp, wp, op, B, H, W, st);
    case 192: return launch<192, REV, PALLAS>(xp, cp, wp, op, B, H, W, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, out: (B, H, W, C) NHWC f32; cond: (B, H, W, 2C + hid) records
// [scale_ft | shift_ft | aff1_ft]; packed: the step's one-pass buffer in the
// entry's form (flow_step.py:pack_step_bf16), shared by the batch, 32-byte
// aligned.  C must be 12, 24, 48, 96 or 192, hid 64 and B <= 65535; x and
// cond 16-byte aligned.
extern "C" int flow_step_bf16_forward(const void* x, const void* cond,
                                      const void* packed, void* out, int B,
                                      int H, int W, int C, int hid,
                                      void* stream) {
  return dispatch<false, false>(x, cond, packed, out, B, H, W, C, hid,
                                stream);
}

extern "C" int flow_step_bf16_reverse(const void* x, const void* cond,
                                      const void* packed, void* out, int B,
                                      int H, int W, int C, int hid,
                                      void* stream) {
  return dispatch<true, false>(x, cond, packed, out, B, H, W, C, hid,
                               stream);
}

extern "C" int flow_step_bf16_pallas_forward(const void* x, const void* cond,
                                             const void* packed, void* out,
                                             int B, int H, int W, int C,
                                             int hid, void* stream) {
  return dispatch<false, true>(x, cond, packed, out, B, H, W, C, hid,
                               stream);
}

extern "C" int flow_step_bf16_pallas_reverse(const void* x, const void* cond,
                                             const void* packed, void* out,
                                             int B, int H, int W, int C,
                                             int hid, void* stream) {
  return dispatch<true, true>(x, cond, packed, out, B, H, W, C, hid,
                              stream);
}
