// K5 at passes=1 (BFSR_PRECISION=default): one fused conditional SRFlow
// FlowStep (eval, no log-det), forward and reverse, with bf16-rounded
// operands (round to nearest even) in some of its five products and every
// sum in f32.  NHWC state (B, H, W, C) with C in {12, 24, 48, 96, 192}
// (the 4x model's three flow levels and the 8x model's four), coupling
// hidden width 64, any H and W, any batch: the state, its records and the
// output are offset by whole images and the weights are shared, so an
// image of a batch gets the bits of its batch-1 launch.  Two kernels: C =
// 12, 24 and 96 run flow_step_bf16_kernel (Tile<C>, the image blockIdx.z);
// C = 48 and 192, the 8x model's wide levels, flow_step_bf16_wide_kernel
// (BWide<C>, thread-block clusters).  Two forms, a template flag:
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
// (29 K at C = 12 to 414 K at C = 192): 65-124 flop/B; the tower on the
// bf16 tensor cores and the folds at the rate of what runs them (f32 SIMT
// at C = 12, 24, 96; TF32 at C = 48, 192) take less time than the bytes
// (profiling/k5_times.py:k5_cost).  Once the three tower convs run on the
// tensor cores, what is left is the kernel's skeleton: the halo reads of
// the state and the records, the weight copies into shared memory (36 KB
// a block at C = 12, 213 KB at C = 96), the stage barriers and the folds.
//
// Design (C = 12, 24, 96).  A block of 256 threads (8 warps) owns a TY x
// TX tile of output pixels.  At its start it copies the step's weights into
// shared memory with 16-byte cp.async, in three groups: the fold this
// direction needs (f32, C x C), the f32 vectors and (XS levels) the state
// on the window; W2 and W1 (bf16, rows padded to 72 values so that
// ldmatrix reads them without bank conflicts); W3 (bf16, 9 taps x 64 x N3
// columns), whole or, at C = 96, its first S3 taps, the rest streamed one
// tap a slot through an S3-slot ring during conv3.
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
// model's levels 3 and 4 ran this kernel until the wide kernel below took
// them: 8 x 8 at C = 48, 0.016 ms each way, and 4 x 4 at C = 192, 0.055 /
// 0.033 ms forward / reverse (2 / 4% of the bound).
//
// Design (C = 48, 192).  The wide levels' images are small (4,096 and
// 1,024 pixels at B 1): a block of the kernel above got a tiny tile, copied
// the step's weights for it and ran both folds as SIMT f32, from global
// memory at C = 192, most of its time (stage clocks of that kernel on
// the earlier tree).  Here a thread-block cluster of NC CTAs (8 at C =
// 192, 2 at C = 48; 256 threads, one CTA a SM) owns a TY x TX output tile
// (11 x 7, 8 x 8: 15 and 64 tiles at B 1) and its CTAs split the channels
// as csrc/flow_step.cu's wide kernel does.  As many clusters run as the
// card holds at once, each taking every ncl-th tile of the batch (at B 1
// one tile each).  CTA r holds in shared memory 1/NC of the step's weights
// (65 / 52 KB), copied for its first tile and kept for the others: its HC
// = 64 / NC hidden channels of W1 and W2, the interleaved (scale, shift)
// columns of W3 of its JC coupled channels, its rows of the fold of the
// direction (JC z1 and JC za2 rows forward, DR = C / NC inverse-fold
// rows), copied by 16-byte cp.async: what the first stage needs first, W3
// (reverse: and the fold rows) under conv1's MMAs (LATE3: at C = 192, and
// forward at C = 48) or with the first copies (reverse at C = 48).  Per
// tile:
//   A. forward: the state on the window (every CTA), the fold: the CTA's
//      z1 rows on the window, its za2 rows on the tile; reverse: the
//      CTA's 1/NC of the window's pixels of z1 (= x1), and t's first half,
//      x1 / scale_ft - shift_ft, of its channels;
//   B. conv1 (K = 9 cn in chunks of 8 channels, each within a tap: A by
//      ldmatrix from the bf16 window) and conv2, the CTA's HC channels of
//      the hidden region, a warp an m-fragment;
//   C. conv3, the CTA's columns on the tile, a warp an m-fragment (the
//      other warps fetch the coupling's inputs and, reverse, send t's
//      first half), then the coupling by all threads;
//   D. reverse: the inverse fold, the CTA's DR rows.
// What crosses distributed shared memory: forward z1 on the window, h1
// and h2 (bf16); reverse the z1 window, h1, h2 (bf16) and t (f32).  Each
// CTA stores its share into the others with st.async, each store
// completing its bytes on an mbarrier of the receiving CTA, which waits
// for the bytes it expects: no cluster barrier between the stages (one,
// forward at C = 192, before z1 lands over the state window), one between
// a cluster's tiles (no CTA stores the next tile's maps into another
// before that one is done with the last's), each barrier's phase a tile.
// The folds run on TF32 mma.sync, fragments by ldmatrix: xla 3xTF32 on the
// unrounded state and t (f32 grade: each K step's three products summed
// from zero on the tensor cores, which truncate, that sum added in f32),
// pallas one pass on its bf16 values (exact in TF32).
//
// Candidates (k5_times.py --levels x8, B 1, xla fwd / rev ms at 64^2 x 48
// and at 32^2 x 192; NVIDIA H100 80GB HBM3, 700.00 W; the tile kernel
// timed beside each: 0.0151-0.0154 / 0.0156-0.0159 and 0.0544-0.0553 /
// 0.0331-0.0339):
// persistent clusters, cluster barriers between the stages: 0.0168 /
// 0.0153, 0.0263 / 0.0237; a cluster a tile, the coupling by all threads:
// 0.0156 / 0.0143, 0.0272 / 0.0227 (4 CTAs of 4 x 8 at C = 192: 0.0361 /
// 0.0329, not all 32 clusters resident; 1 CTA at C = 48: 0.0182 / 0.0170);
// the windows by TMA multicast: 0.0161 / 0.0155, 0.0245 / 0.0238; W1-3 by
// tensor-map TMA boxes too: 0.0164 / 0.0159, 0.0244 / 0.0238 (rows of 16
// to 48 bytes: the copy engine slower than cp.async); back to cp.async,
// the barriers replaced by st.async on mbarriers: 0.0132 / 0.0127, 0.0254
// / 0.0215; the z1 window 1/NC a CTA, t's first half early: 0.0133 /
// 0.0123, 0.0255 / 0.0204; W3 under conv1 at C = 192, t's first half sent
// by conv3's idle warps, the folds' fragments by ldmatrix: 0.0133 /
// 0.0121, 0.0243 / 0.0189; W3 under conv1 in the forward at C = 48 too:
// 0.0130 / 0.0122-0.0123, 0.0243-0.0244 / 0.0189 (pallas 0.0126 /
// 0.0121-0.0122, 0.0225-0.0227 / 0.0176-0.0177); the clusters persistent
// (this kernel; the first tile's code compile-time, a runtime flag cost
// B 1 up to 5%): B 1 the same, 0.0131 / 0.0124, 0.0242 / 0.0191, and
// where tiles outnumber clusters 3-10% faster than a cluster a tile: B 12
// of 20^2 x 48 0.0230-0.0231 / 0.0209 (0.0236-0.0237 / 0.0216-0.0217), a
// 2048^2 sample's 256^2 x 48 0.1615-0.1616 / 0.1400-0.1402 (0.1778-0.1792
// / 0.1544-0.1545) and 128^2 x 192 0.3388-0.3411 / 0.2510-0.2543
// (0.3583-0.3610 / 0.2708-0.2734).  There at C = 48 the tile kernel was
// faster, 0.1210-0.1216 / 0.1265-0.1270: two CTAs and their exchanges
// for an 8 x 8 tile move fewer pixels an SM than its one block.
// Rejected: conv3's K, or its n-tiles, over twice the warps at C = 48
// (forward 0.0135, 0.0133-0.0134), the forward's state window by TMA
// multicast (C = 48 0.0138, C = 192 0.0229).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster.cuh"
#include "tf32.cuh"

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
template <> struct Tile<96> {
  static constexpr int TY = 4, TX = 8, S3 = 2, PX = 4, QA = 6, PXD = 2,
                       QD = 6, XS = 1, MINB = 1, FS = 1;
};

constexpr int rup128(int n) { return (n + 127) / 128 * 128; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// the one-pass buffer (bfsr_tpu_torch/ops/cuda/flow_step.py:_layout_bf16):
// f32 words first, offsets in floats, the XLA form's gain G3 after b3; then
// bf16 values, offsets in bf16 from the buffer's start
template <int C, bool PALLAS>
struct Buf {
  static constexpr int CN = C / 2, CO = C - C / 2, R = 2 * C + kHid;
  static constexpr int N3 = (2 * CO + 15) / 16 * 16;
  static constexpr int K1 = 9 * CN, K1P = (K1 + 15) / 16 * 16;
  static constexpr int BF = 0, AB = BF + C, AN1B = AB + C;
  static constexpr int AN1E = AN1B + kHid, AN2B = AN1E + kHid;
  static constexpr int AN2E = AN2B + kHid, B3 = AN2E + kHid, G3 = B3 + N3;
  static constexpr int NVEC = PALLAS ? G3 : G3 + N3;
  static constexpr int WF = NVEC, WI = WF + C * C;
  static constexpr int NWORDS = (WI + C * C + 7) / 8 * 8;
  static constexpr int W1 = 2 * NWORDS, W2 = W1 + K1P * kHid;
  static constexpr int W3 = W2 + kHid * kHid;
};

template <int C, bool PALLAS>
struct Geo : Buf<C, PALLAS> {
  using T = Tile<C>;
  using P = Buf<C, PALLAS>;
  static constexpr int CN = P::CN, CO = P::CO, R = P::R, N3 = P::N3;
  static constexpr int K1 = P::K1, K1P = P::K1P, NVEC = P::NVEC;
  // conv3's n8 tiles (past 2co: zeros)
  static constexpr int NT3 = (2 * CO + 7) / 8;
  static constexpr int TY = T::TY, TX = T::TX;
  static constexpr int HY = TY + 2, HX = TX + 2, NH = HY * HX;
  static constexpr int MH = (NH + 15) / 16;  // conv1 / conv2 M fragments
  static constexpr int WY = TY + 4, WX = TX + 4, NW = WY * WX;
  static constexpr int NO = TY * TX, MO = NO / 16;  // conv3 M fragments
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

// ---- the wide levels, C = 48 and 192: one tile a thread-block cluster ----
//
// BWide<C>: the cluster's NC CTAs and its TY x TX output tile;
// LATE3[reverse]: W3 (reverse: and the fold rows) copied under conv1's
// MMAs, else with the first copies.  A pixel's sums, and so its bits, do
// not depend on the tile's place or the batch.
template <int C> struct BWide;
template <> struct BWide<48> {
  static constexpr int NC = 2, TY = 8, TX = 8;
  static constexpr bool LATE3[2] = {true, false};
};
template <> struct BWide<192> {
  static constexpr int NC = 8, TY = 11, TX = 7;
  static constexpr bool LATE3[2] = {true, true};
};

// a compile-time flag passed by value
template <bool V>
struct Flag {
  static constexpr bool value = V;
};

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
// a bf16 row stride at or above n (n % 8 == 0) of an odd number of 16-byte
// units: the 8 rows of an ldmatrix tile meet no bank conflict
constexpr int odd8(int n) { return (n / 8) % 2 ? n : n + 8; }
// an f32 row stride at or above n of an odd number of float4s: a TF32
// fragment's 8 rows x 4 columns meet no bank conflict
constexpr int odd4(int n) {
  return ((n + 3) / 4) % 2 ? (n + 3) / 4 * 4 : (n + 3) / 4 * 4 + 4;
}

template <int C, bool PALLAS>
struct WGeo {
  using T = BWide<C>;
  using P = Buf<C, PALLAS>;
  static constexpr int NC = T::NC, CN = C / 2, CO = C - C / 2;
  static constexpr int TY = T::TY, TX = T::TX, NO = TY * TX;
  static constexpr int HY = TY + 2, HX = TX + 2, NH = HY * HX;
  static constexpr int WY = TY + 4, WX = TX + 4, NW = WY * WX;
  // a CTA's share: HC hidden channels (conv1's and conv2's columns), JC
  // coupled channels (JC z1 and JC za2 rows of the fold; conv3's
  // interleaved (scale, shift) columns of those channels, N3L of them), DR
  // rows of the inverse fold
  static constexpr int HC = kHid / NC, JC = CO / NC, DR = C / NC;
  static constexpr int N3L = 2 * JC;
  // m16 fragments over the hidden region, the tile and the window; n8
  // tiles of conv1 / conv2, conv3, the fold (JC rows) and the inverse fold
  static constexpr int MH = cdiv(NH, 16), MO = cdiv(NO, 16);
  static constexpr int MZ = cdiv(NW, 16);
  static constexpr int NT1 = HC / 8, NT3 = N3L / 8, NTF = cdiv(JC, 8);
  static constexpr int NTD = DR / 8;
  // conv1's k16 steps (K = 9 cn, in 8-channel chunks, each within a tap),
  // and its accumulator sets (k steps dealt round robin: chains in flight)
  static constexpr int K1 = 9 * CN, K1S = cdiv(K1, 16);
  static constexpr int NA1 = NT1 >= 4 ? 1 : 4 / NT1;
  // row strides: bf16 (W1 / W2, W3, the z1 window, the hidden maps) and
  // f32 (the state window, the fold rows, t, za2, conv3's output)
  static constexpr int L1 = odd8(HC), L3 = odd8(N3L), SZ = odd8(CN);
  static constexpr int SH = odd8(kHid);
  static constexpr int SX = odd4(C), SF = odd4(C), ST = odd4(CN);
  static constexpr int SA = odd4(JC), SO = odd4(N3L);
  // the fold rows: forward JC z1 rows then JC za2 rows (and the za2
  // n-tiles' spare rows), reverse DR inverse-fold rows
  static constexpr int FR = cmax(DR, JC + 8 * NTF);
  // shared memory, bytes: the exchanges' mbarriers | vectors | W1 | W2 |
  // W3 | fold rows; the maps: the z1 window (reverse: t's second half over
  // it) | t's first half (reverse) | h1 | h2 | za2 (forward) | conv3's
  // (scale, shift) | the coupling's inputs (reverse: x2, scale_ft and
  // shift_ft of the second half, the CTA's channels); the forward's state
  // window after them (ZX) or, where that does not fit, over them
  static constexpr int O_V = 128, O_W1 = O_V + rup128(P::NVEC * 4);
  static constexpr int O_W2 = O_W1 + rup128(P::K1P * L1 * 2);
  static constexpr int O_W3 = O_W2 + rup128(kHid * L1 * 2);
  static constexpr int O_F = O_W3 + rup128(9 * kHid * L3 * 2);
  static constexpr int O_M = O_F + rup128(FR * SF * 4);
  static constexpr int O_T1 = O_M + rup128(cmax(NW * SZ * 2, NO * ST * 4));
  static constexpr int O_H1 = O_T1 + rup128(NO * ST * 4);
  static constexpr int O_H2 = O_H1 + rup128(NH * SH * 2);
  static constexpr int O_A2 = O_H2 + rup128(NH * SH * 2);
  static constexpr int O_O = O_A2 + rup128(NO * SA * 4);
  static constexpr int O_C = O_O + rup128(NO * SO * 4);
  static constexpr int O_END = O_C + rup128(NO * 3 * JC * 4);
  static constexpr int NX = NW * SX * 4;  // the state window's bytes
  static constexpr bool ZX = O_END + NX <= 227 * 1024;
  static constexpr int O_X = ZX ? O_END : O_M;
  static constexpr int SMEM_F = cmax(O_X + NX, O_END);
  static constexpr int SMEM_R = O_END;
  static constexpr int smem(bool rev) { return rev ? SMEM_R : SMEM_F; }
  static_assert(C % 16 == 0 && CO % NC == 0 && kHid % (8 * NC) == 0 &&
                JC % 4 == 0 && N3L % 8 == 0 && DR % 8 == 0 && CN % 8 == 0,
                "channel split");
  static_assert(MH <= kWarps && MO < kWarps, "a warp an m-fragment");
  static_assert(16 * K1S == P::K1P && N3L * NC == P::N3, "buffer rows");
  static_assert(SMEM_F <= 227 * 1024 && SMEM_R <= 227 * 1024,
                "shared memory");
};

// f32 tiles by ldmatrix, in the layout of TF32 mma.sync fragments: a row
// of 4 floats is a row of 8 bf16, so a lane gets (row g, column t)
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(p)));
}
// this lane's ldmatrix row of a fold's A (row lane & 15 at ar, K along
// the row: ar points at the row) and of its B (n-tiles of 8 rows, bn
// floats apart, K along the row)
__device__ __forceinline__ int fold_a_col(int lane) { return 4 * (lane >> 4); }
__device__ __forceinline__ int fold_b_off(int lane, int bn) {
  return ((lane & 7) + 8 * (lane >> 4)) * bn + 4 * ((lane >> 3) & 1);
}

// acc[j] += one K step of 8 of A (16 rows, this lane's ldmatrix row at ar)
// times n-tile j of B (this lane's ldmatrix row at br, n-tiles 8 rows of
// bn floats apart), on TF32 mma.sync.  PASSES 3 splits both operands,
// 3xTF32 (small * big, big * small, big * big, as csrc/flow_step.cu's wide
// kernel, small rounded to TF32); PASSES 1 takes them as they are, for
// bf16 values, exact in TF32.  RND rounds A to bf16 first.  The tensor
// cores sum a step's products from zero, and acc adds that sum in f32:
// their sums, which truncate, never carry the K steps'.
template <int NT, int PASSES, bool RND>
__device__ __forceinline__ void fold_k8(float (&acc)[NT][4], const float* ar,
                                        const float* br, int bn) {
  uint32_t ab[4], as[4], bb[NT][2], bs[NT][2];
  ldsm_x4(ab, ar);
  if constexpr (NT == 1) {
    ldsm_x2(bb[0][0], bb[0][1], br);
  } else {
    static_assert(NT % 2 == 0, "n-tiles in pairs");
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t q[4];
      ldsm_x4(q, br + 8 * j * bn);
      bb[j][0] = q[0];
      bb[j][1] = q[1];
      bb[j + 1][0] = q[2];
      bb[j + 1][1] = q[3];
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v = __uint_as_float(ab[e]);
    if constexpr (RND) v = round_bf16(v);
    if constexpr (PASSES == 3) {
      split_tf32_rn(v, ab[e], as[e]);
    } else {
      ab[e] = __float_as_uint(v);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (PASSES == 3) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        split_tf32_rn(__uint_as_float(bb[j][e]), bb[j][e], bs[j][e]);
      }
      mma_tf32(d, as, bb[j]);
      mma_tf32(d, ab, bs[j]);
    }
    mma_tf32(d, ab, bb[j]);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += d[e];
  }
}

// rows x N bf16 (N % 8 == 0) from src (row stride sld) to dst (row stride
// ld), 16-byte cp.async by nt threads, this one the t-th
template <int N>
__device__ __forceinline__ void copy_cols(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* __restrict__ src,
                                          int sld, int rows,
                                          int t = threadIdx.x,
                                          int nt = kThreads) {
  constexpr int V = N / 8;
  for (int e = t; e < rows * V; e += nt) {
    const int r = e / V, v = e % V;
    cp_async16(dst + r * ld + 8 * v, src + r * sld + 8 * v);
  }
}

// rows x C floats (rows C apart in src, ld in dst), 16-byte cp.async by nt
// threads, this one the t-th
template <int C>
__device__ __forceinline__ void copy_f32_rows(float* dst, int ld,
                                              const float* __restrict__ src,
                                              int rows, int t = threadIdx.x,
                                              int nt = kThreads) {
  for (int e = t; e < rows * (C / 4); e += nt) {
    const int r = e / (C / 4), v = e % (C / 4);
    cp_async16(dst + r * ld + 4 * v, src + r * C + 4 * v);
  }
}

template <int NA, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NA][NT][4]) {
#pragma unroll
  for (int s = 0; s < NA; ++s) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;
    }
  }
}

// acc[0] += acc[1] + ... + acc[NA - 1], in that order
template <int NA, int NT>
__device__ __forceinline__ void sum_sets(float (&acc)[NA][NT][4]) {
#pragma unroll
  for (int s = 1; s < NA; ++s) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][j][e] += acc[s][j][e];
    }
  }
}

// acc[j] += A (16 x 16, bf16) * B (16 rows of n-tile j < NT: rows ld
// apart from w + j ts, w at the k step's first row), B by ldmatrix.trans
template <int NT>
__device__ __forceinline__ void mma_k16(float (&acc)[NT][4],
                                        const uint32_t (&a)[4],
                                        const __nv_bfloat16* w, int ld,
                                        int ts, int lane) {
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_nt = lane >> 4;
#pragma unroll
  for (int j = 0; j + 1 < NT; j += 2) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4_trans(b0, b1, b2, b3, w + b_row * ld + (j + b_nt) * ts);
    mma_bf16(acc[j], a, b0, b1);
    mma_bf16(acc[j + 1], a, b2, b3);
  }
  if constexpr (NT % 2) {
    uint32_t b0, b1;
    ldsm_x2_trans(b0, b1, w + (lane & 15) * ld + (NT - 1) * ts);
    mma_bf16(acc[NT - 1], a, b0, b1);
  }
}

template <int C, bool REV, bool PALLAS>
__global__ void __launch_bounds__(kThreads, 1)
flow_step_bf16_wide_kernel(const float* __restrict__ x_batch,
                           const float* __restrict__ cond_batch,
                           const __nv_bfloat16* __restrict__ wb,
                           float* __restrict__ out_batch, int B, int H,
                           int W) {
  using G = WGeo<C, PALLAS>;
  using P = Buf<C, PALLAS>;
  constexpr int NC = G::NC, CN = G::CN, R = P::R;
  constexpr int TY = G::TY, TX = G::TX, HX = G::HX, WX = G::WX;
  constexpr int NH = G::NH, NW = G::NW, NO = G::NO;
  constexpr int HC = G::HC, JC = G::JC, DR = G::DR, N3L = G::N3L;
  constexpr int L1 = G::L1, L3 = G::L3, SZ = G::SZ, SH = G::SH;
  constexpr int SX = G::SX, SF = G::SF, ST = G::ST, SA = G::SA, SO = G::SO;
  constexpr int NT1 = G::NT1, NT3 = G::NT3, NA1 = G::NA1;
  constexpr int PASSES = PALLAS ? 1 : 3;  // the folds: bf16 values or f32
  constexpr bool LATE3 = BWide<C>::LATE3[REV];
  const float* __restrict__ wf = reinterpret_cast<const float*>(wb);
  extern __shared__ __align__(128) unsigned char smem[];
  // the exchanges' mbarriers, each completed by the bytes the other CTAs
  // store into this one: z1 (forward), h1, h2, t and the z1 window
  // (reverse)
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* s_vec = reinterpret_cast<float*>(smem + G::O_V);
  __nv_bfloat16* s_w1 = reinterpret_cast<__nv_bfloat16*>(smem + G::O_W1);
  __nv_bfloat16* s_w2 = reinterpret_cast<__nv_bfloat16*>(smem + G::O_W2);
  __nv_bfloat16* s_w3 = reinterpret_cast<__nv_bfloat16*>(smem + G::O_W3);
  float* s_f = reinterpret_cast<float*>(smem + G::O_F);
  __nv_bfloat16* s_z = reinterpret_cast<__nv_bfloat16*>(smem + G::O_M);
  float* s_t2 = reinterpret_cast<float*>(smem + G::O_M);  // reverse: t
  float* s_t1 = reinterpret_cast<float*>(smem + G::O_T1);
  __nv_bfloat16* s_h1 = reinterpret_cast<__nv_bfloat16*>(smem + G::O_H1);
  __nv_bfloat16* s_h2 = reinterpret_cast<__nv_bfloat16*>(smem + G::O_H2);
  float* s_a2 = reinterpret_cast<float*>(smem + G::O_A2);  // forward: za2
  float* s_o = reinterpret_cast<float*>(smem + G::O_O);    // conv3's
  float* s_c = reinterpret_cast<float*>(smem + G::O_C);    // coupling's
  float* s_x = reinterpret_cast<float*>(smem + G::O_X);  // the state window

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = cluster_rank();
  // reverse: the window's pixels r, r + NC, ... are this CTA's to load
  const int own = cdiv(NW - r, NC);
  // a tile's phase of each barrier the direction uses (forward 0-2,
  // reverse 1-4): the arrival, with the bytes the other CTAs store
  auto arm = [&] {
    if (tid < 5 && (REV ? tid > 0 : tid < 3)) {
      const int xb[5] = {(NC - 1) * NW * JC * 2, (NC - 1) * NH * HC * 2,
                         (NC - 1) * NH * HC * 2, (NC - 1) * NO * JC * 8,
                         (NW - own) * CN * 2};
      mbar_expect_tx(bar + tid, xb[tid]);
    }
  };
  if (tid < 5) mbar_init(bar + tid);
  arm();
  // this CTA runs and its barriers are set: waited for before any store
  // into another CTA
  cluster_arrive();
  const int g = lane >> 2, t4 = lane & 3;  // a fragment's row and column
  const int hi = lane >> 4;                // ldmatrix: this lane's k chunk
  // the cluster's tiles: image, then rows of tiles, then tiles, every
  // ncl-th from the cluster's index
  const int ntx = cdiv(W, TX), nty = cdiv(H, TY);
  const int ntiles = B * nty * ntx, ncl = gridDim.x / NC;
  // one tile, ph its barriers' phase parity; the first (Flag<true>) copies
  // the weights, which stay for the others
  auto run_tile = [&](auto first_tile, int tile, uint32_t ph) {
    constexpr bool first = decltype(first_tile)::value;
    const int img = tile / (nty * ntx), t2 = tile % (nty * ntx);
    const int y0 = (t2 / ntx) * TY, x0 = (t2 % ntx) * TX;
    const size_t img_px = static_cast<size_t>(img) * H * W;
    const float* __restrict__ x = x_batch + img_px * C;
    const float* __restrict__ cond = cond_batch + img_px * R;
    float* __restrict__ out = out_batch + img_px * C;
    auto inside = [&](int gy, int gx) {
      return gy >= 0 && gy < H && gx >= 0 && gx < W;
    };

    // the CTA's columns of W1, W2 and W3 and its rows of the fold of the
    // direction, in cp.async groups in the order of use: what the first
    // stage needs here (the vectors and, forward, the fold rows and the
    // state window; reverse, W1 and W2); forward, W1 and W2 by the warps
    // with a fold fragment fewer; W3 (reverse: and the fold rows) under
    // conv1's MMAs in NPART parts (LATE3), or right after W1 and W2
    auto copy_w12 = [&](int t, int nt) {
      copy_cols<HC>(s_w1, L1, wb + P::W1 + r * HC, kHid, P::K1P, t, nt);
      copy_cols<HC>(s_w2, L1, wb + P::W2 + r * HC, kHid, kHid, t, nt);
    };
    constexpr int NPART = 6;
    static_assert((9 * kHid) % NPART == 0 && DR % NPART == 0, "parts");
    auto copy_late = [&](int part, int nparts, int t, int nt) {
      const int r3 = 9 * kHid / nparts, rf = DR / nparts;
      copy_cols<N3L>(s_w3 + part * r3 * L3, L3,
                     wb + P::W3 + part * r3 * P::N3 + r * N3L, P::N3, r3, t,
                     nt);
      if constexpr (REV) {
        copy_f32_rows<C>(s_f + part * rf * SF, SF,
                         wf + P::WI + (r * DR + part * rf) * C, rf, t, nt);
      }
    };
    for (int e = tid; first && e < P::NVEC / 4; e += kThreads) {
      cp_async16(s_vec + 4 * e, wf + 4 * e);
    }
    if constexpr (REV) {
      // z1 on the window, rounded (product 2): x's first half, zeros outside
      // the image, this CTA's pixels, stored here and in every CTA; and t's
      // first half, x1 / scale_ft - shift_ft, of the CTA's channels (pallas:
      // rounded, product 5), to every CTA; the loads in flight while the
      // weights' copies issue
      constexpr int CH = CN / 8;  // 16-byte pieces of a pixel's bf16 z1
      constexpr int PZ = cdiv(cdiv(NW, NC) * CH, kThreads);
      constexpr int PT = cdiv(NO * (JC / 4), kThreads);
      float4 v[PZ][2], w[PT][3];
  #pragma unroll
      for (int u = 0; u < PZ; ++u) {
        const int i = tid + u * kThreads, p = r + NC * (i / CH);
        const int gy = y0 - 2 + p / WX, gx = x0 - 2 + p % WX;
        v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < own * CH && inside(gy, gx)) {
          const float4* src = reinterpret_cast<const float4*>(
              x + (static_cast<size_t>(gy) * W + gx) * C + 8 * (i % CH));
          v[u][0] = __ldg(src);
          v[u][1] = __ldg(src + 1);
        }
      }
  #pragma unroll
      for (int u = 0; u < PT; ++u) {
        const int i = tid + u * kThreads, q = i / (JC / 4);
        const int c = r * JC + 4 * (i % (JC / 4));
        const int gy = y0 + q / TX, gx = x0 + q % TX;
        w[u][0] = w[u][2] = make_float4(0.f, 0.f, 0.f, 0.f);
        w[u][1] = make_float4(1.f, 1.f, 1.f, 1.f);
        if (i < NO * (JC / 4) && gy < H && gx < W) {
          const size_t pix = static_cast<size_t>(gy) * W + gx;
          w[u][0] = __ldg(reinterpret_cast<const float4*>(x + pix * C + c));
          w[u][1] = __ldg(reinterpret_cast<const float4*>(cond + pix * R + c));
          w[u][2] =
              __ldg(reinterpret_cast<const float4*>(cond + pix * R + C + c));
        }
      }
      if (first) copy_w12(tid, kThreads);
      cp_async_commit();
      if constexpr (!LATE3) {
        if (first) copy_late(0, 1, tid, kThreads);
        cp_async_commit();
      }
      cluster_wait();
      const uint32_t bz =
          static_cast<uint32_t>(__cvta_generic_to_shared(bar + 4));
  #pragma unroll
      for (int u = 0; u < PZ; ++u) {
        const int i = tid + u * kThreads, p = r + NC * (i / CH);
        if (i < own * CH) {
          const uint4 z = make_uint4(
              pack_bf16(v[u][0].x, v[u][0].y), pack_bf16(v[u][0].z, v[u][0].w),
              pack_bf16(v[u][1].x, v[u][1].y), pack_bf16(v[u][1].z, v[u][1].w));
          __nv_bfloat16* dst = s_z + p * SZ + 8 * (i % CH);
          *reinterpret_cast<uint4*>(dst) = z;
          const uint32_t a =
              static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  #pragma unroll
          for (int k = 1; k < NC; ++k) st_async(a, z, bz, (r + k) % NC);
        }
      }
  #pragma unroll
      for (int u = 0; u < PT; ++u) {
        const int i = tid + u * kThreads, q = i / (JC / 4);
        if (i < NO * (JC / 4)) {
          float t1[4] = {w[u][0].x / w[u][1].x - w[u][2].x,
                         w[u][0].y / w[u][1].y - w[u][2].y,
                         w[u][0].z / w[u][1].z - w[u][2].z,
                         w[u][0].w / w[u][1].w - w[u][2].w};
          if constexpr (PALLAS) {  // product 5
  #pragma unroll
            for (int e = 0; e < 4; ++e) t1[e] = round_bf16(t1[e]);
          }
          st_vec(s_t1 + q * ST + r * JC + 4 * (i % (JC / 4)), t1);
        }
      }
    } else {
      // the state on the window, zeros outside
      for (int i = tid; i < NW * (C / 4); i += kThreads) {
        const int p = i / (C / 4), c4 = i % (C / 4);
        const int gy = y0 - 2 + p / WX, gx = x0 - 2 + p % WX;
        const bool in = inside(gy, gx);
        cp_async16_zfill(
            s_x + p * SX + 4 * c4,
            in ? x + (static_cast<size_t>(gy) * W + gx) * C + 4 * c4 : x,
            in ? 16 : 0);
      }
      if (first) {
        copy_f32_rows<C>(s_f, SF, wf + P::WF + r * JC * C, JC);
        copy_f32_rows<C>(s_f + JC * SF, SF, wf + P::WF + (CN + r * JC) * C,
                         JC);
      }
      cp_async_commit();
      cluster_wait();
    }
    cp_async_wait<REV && !LATE3 ? 1 : 0>();
    __syncthreads();  // the window and the first group
    if constexpr (REV) mbar_wait(bar + 4, ph);  // the z1 window, whole

    // ---- A (forward): the fold, f32 grade (xla: 3xTF32 on the state;
    // pallas: the state rounded, product 1), the CTA's JC z1 rows on the
    // window and its JC za2 rows on the tile ----
    if constexpr (!REV) {
      constexpr int MZ = G::MZ, MF = G::MZ + G::MO, MFW = cdiv(MF, kWarps);
      constexpr int NTF = G::NTF;
      float acc[MFW][NTF][4];
      int wrow[MFW][2];  // window pixels of the fragment's rows g, g + 8
      // the epilogue's scale_ft and shift_ft (zero outside the image), early
      float2 esc[MFW][2][NTF], esh[MFW][2][NTF];
  #pragma unroll
      for (int u = 0; u < MFW; ++u) {
        const int f = warp + kWarps * u;
        const int ch0 = (f < MZ ? 0 : CN) + r * JC;
  #pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * (f < MZ ? f : f - MZ) + g + 8 * h;
          const int q = min(row, NO - 1);
          wrow[u][h] = f < MZ ? min(row, NW - 1)
                              : (q / TX + 2) * WX + q % TX + 2;
          const int gy = y0 - 2 + wrow[u][h] / WX;
          const int gx = x0 - 2 + wrow[u][h] % WX;
          const bool in = f < MF && inside(gy, gx);
          const float* rec =
              cond + (in ? static_cast<size_t>(gy) * W + gx : 0) * R + ch0;
  #pragma unroll
          for (int j = 0; j < NTF; ++j) {
            const int n = 8 * j + 2 * t4;
            const bool ok = in && n < JC;
            esc[u][h][j] = ok ? __ldg(reinterpret_cast<const float2*>(rec + n))
                              : make_float2(0.f, 0.f);
            esh[u][h][j] =
                ok ? __ldg(reinterpret_cast<const float2*>(rec + C + n))
                   : make_float2(0.f, 0.f);
          }
        }
  #pragma unroll
        for (int j = 0; j < NTF; ++j) {
  #pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;
        }
        if (f >= MF) continue;
        // this lane's ldmatrix rows: window pixel of fragment row lane & 15
        const int lr = 16 * (f < MZ ? f : f - MZ) + (lane & 15);
        const int lq = min(lr, NO - 1);
        const int ap =
            f < MZ ? min(lr, NW - 1) : (lq / TX + 2) * WX + lq % TX + 2;
        const float* ar = s_x + ap * SX + fold_a_col(lane);
        const float* br = s_f + (f < MZ ? 0 : JC * SF) + fold_b_off(lane, SF);
  #pragma unroll 4
        for (int k = 0; k < C; k += 8) {
          fold_k8<NTF, PASSES, PALLAS>(acc[u], ar + k, br + k, SF);
        }
      }
      // za = (fold + b_fold + shift_ft) * scale_ft, zero outside the image
  #pragma unroll
      for (int u = 0; u < MFW; ++u) {
        const int f = warp + kWarps * u;
        if (f >= MF) continue;
        const int ch0 = (f < MZ ? 0 : CN) + r * JC;
  #pragma unroll
        for (int h = 0; h < 2; ++h) {
  #pragma unroll
          for (int j = 0; j < NTF; ++j) {
            const int n = 8 * j + 2 * t4;
            if (n >= JC) continue;
            const float2 bf =
                *reinterpret_cast<const float2*>(s_vec + P::BF + ch0 + n);
            acc[u][j][2 * h] =
                (acc[u][j][2 * h] + bf.x + esh[u][h][j].x) * esc[u][h][j].x;
            acc[u][j][2 * h + 1] =
                (acc[u][j][2 * h + 1] + bf.y + esh[u][h][j].y) * esc[u][h][j].y;
          }
        }
      }
      {
        // the warps with a fragment fewer (all, if none has)
        constexpr int FEW = MF % kWarps ? MF % kWarps : 0;
        if (first && warp >= FEW) {
          copy_w12(tid - 32 * FEW, kThreads - 32 * FEW);
        }
        cp_async_commit();
        if constexpr (!LATE3) {
          if (first && warp >= FEW) {
            copy_late(0, 1, tid - 32 * FEW, kThreads - 32 * FEW);
          }
          cp_async_commit();
        }
      }
      if constexpr (!G::ZX) {
        // every CTA is done with its state window, under the maps
        cluster_sync();
      }
  #pragma unroll
      for (int u = 0; u < MFW; ++u) {
        const int f = warp + kWarps * u;
        if (f >= MF) continue;
        const bool z = f < MZ;
  #pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * (z ? f : f - MZ) + g + 8 * h;
          if (row >= (z ? NW : NO)) continue;
          const int wy = wrow[u][h] / WX, wx = wrow[u][h] % WX;
          const int gy = y0 - 2 + wy, gx = x0 - 2 + wx;
          const bool out_px = z && wy >= 2 && wy < TY + 2 && wx >= 2 &&
                              wx < TX + 2 && inside(gy, gx);
  #pragma unroll
          for (int j = 0; j < NTF; ++j) {
            const int n = 8 * j + 2 * t4;
            if (n >= JC) continue;
            const float v[2] = {acc[u][j][2 * h], acc[u][j][2 * h + 1]};
            if (z) {
              *reinterpret_cast<uint32_t*>(s_z + row * SZ + r * JC + n) =
                  pack_bf16(v[0], v[1]);  // product 2
              if (out_px) {
                st_vec(out + (static_cast<size_t>(gy) * W + gx) * C + r * JC +
                           n,
                       v);
              }
            } else {
              *reinterpret_cast<float2*>(s_a2 + row * SA + n) =
                  make_float2(v[0], v[1]);
            }
          }
        }
      }
      __syncthreads();  // the CTA's z1 channels on the window
      share_rows<NC, 2 * JC>(s_z, 2 * SZ, 2 * r * JC, NW, r, bar, tid,
                             kThreads);
      mbar_wait(bar, ph);  // z1 on the window, whole
      cp_async_wait<LATE3 ? 0 : 1>();
      __syncthreads();  // W1 and W2
    }

    // ---- B: conv1 -> actnorm1 + ReLU -> conv2 -> actnorm2 + ReLU + mask,
    // the CTA's HC hidden channels, a warp an m-fragment of the hidden
    // region; each map to every CTA ----
    const int mf1 = warp;
    int prow[2];
    bool pin[2];
  #pragma unroll
    for (int h = 0; h < 2; ++h) {
      prow[h] = 16 * mf1 + g + 8 * h;
      pin[h] = prow[h] < NH &&
               inside(y0 - 1 + prow[h] / HX, x0 - 1 + prow[h] % HX);
    }
    if (mf1 < G::MH) {
      float2 af[2][NT1];  // aff1_ft of the two rows
  #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gy = y0 - 1 + prow[h] / HX, gx = x0 - 1 + prow[h] % HX;
        const float* ar =
            cond + (pin[h] ? (static_cast<size_t>(gy) * W + gx) * R : 0) +
            2 * C + r * HC + 2 * t4;
  #pragma unroll
        for (int j = 0; j < NT1; ++j) {
          af[h][j] = pin[h] ? __ldg(reinterpret_cast<const float2*>(ar + 8 * j))
                            : make_float2(0.f, 0.f);
        }
      }
      // A rows: hidden pixels, at the window pixel of tap (0, 0)
      const int p = min(16 * mf1 + (lane & 15), NH - 1);
      const __nv_bfloat16* zrow = s_z + ((p / HX) * WX + p % HX) * SZ;
      float acc[NA1][NT1][4];
      zero_acc(acc);
  #pragma unroll
      for (int ks = 0; ks < G::K1S; ++ks) {
        // this lane's chunk of 8 channels, k = tap * cn + channel; past K1
        // (W1's zero rows) any chunk in the window
        int k8 = 16 * ks + 8 * hi;
        if (k8 >= G::K1) k8 = 0;
        const int tap = k8 / CN, c = k8 - tap * CN;
        uint32_t a[4];
        ldsm_x4(a, zrow + ((tap / 3) * WX + tap % 3) * SZ + c);
        mma_k16<NT1>(acc[ks % NA1], a, s_w1 + 16 * ks * L1, L1, 8, lane);
        if (LATE3 && first && ks % (G::K1S / NPART) == 0 &&
            ks / (G::K1S / NPART) < NPART) {
          copy_late(ks / (G::K1S / NPART), NPART, tid, 32 * G::MH);
        }
      }
      sum_sets(acc);
  #pragma unroll
      for (int j = 0; j < NT1; ++j) {
        const int hc = r * HC + 8 * j + 2 * t4;
        const float2 b = *reinterpret_cast<const float2*>(s_vec + P::AN1B + hc);
        const float2 e = *reinterpret_cast<const float2*>(s_vec + P::AN1E + hc);
  #pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (prow[h] >= NH) continue;
          const float v0 =
              fmaxf((acc[0][j][2 * h] + af[h][j].x + b.x) * e.x, 0.f);
          const float v1 =
              fmaxf((acc[0][j][2 * h + 1] + af[h][j].y + b.y) * e.y, 0.f);
          *reinterpret_cast<uint32_t*>(s_h1 + prow[h] * SH + hc) =
              pack_bf16(v0, v1);  // product 3
        }
      }
    }
    if constexpr (LATE3) cp_async_commit();  // W3 (and the fold rows)
    __syncthreads();  // the CTA's h1 channels
    share_rows<NC, 2 * HC>(s_h1, 2 * SH, 2 * r * HC, NH, r,
                                     bar + 1, tid, kThreads);
    mbar_wait(bar + 1, ph);  // the map after conv1, whole
    if (mf1 < G::MH) {
      const int p = min(16 * mf1 + (lane & 15), NH - 1);
      float acc[1][NT1][4];
      zero_acc(acc);
  #pragma unroll
      for (int kk = 0; kk < kHid / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, s_h1 + p * SH + 16 * kk + 8 * hi);
        mma_k16<NT1>(acc[0], a, s_w2 + 16 * kk * L1, L1, 8, lane);
      }
  #pragma unroll
      for (int j = 0; j < NT1; ++j) {
        const int hc = r * HC + 8 * j + 2 * t4;
        const float2 b = *reinterpret_cast<const float2*>(s_vec + P::AN2B + hc);
        const float2 e = *reinterpret_cast<const float2*>(s_vec + P::AN2E + hc);
  #pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (prow[h] >= NH) continue;
          // ZEROED OUTSIDE THE IMAGE: conv3 pads its input with zeros
          const float v0 =
              pin[h] ? fmaxf((acc[0][j][2 * h] + b.x) * e.x, 0.f) : 0.f;
          const float v1 =
              pin[h] ? fmaxf((acc[0][j][2 * h + 1] + b.y) * e.y, 0.f) : 0.f;
          *reinterpret_cast<uint32_t*>(s_h2 + prow[h] * SH + hc) =
              pack_bf16(v0, v1);  // product 4
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the CTA's h2 channels (and W3, the fold rows)
    share_rows<NC, 2 * HC>(s_h2, 2 * SH, 2 * r * HC, NH, r,
                                     bar + 2, tid, kThreads);
    mbar_wait(bar + 2, ph);  // the map after conv2, whole

    // ---- C: conv3 (the CTA's N3L columns: JC channels' (scale, shift)), a
    // warp an m-fragment of the tile; reverse: the other warps fetch the
    // coupling's inputs meanwhile ----
    if (warp < G::MO) {
      const int o = min(16 * warp + (lane & 15), NO - 1);
      const __nv_bfloat16* hrow = s_h2 + ((o / TX) * HX + o % TX) * SH + 8 * hi;
      float acc[2][NT3][4];
      zero_acc(acc);
  #pragma unroll 3
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = ((tap / 3) * HX + tap % 3) * SH;
  #pragma unroll
        for (int kk = 0; kk < kHid / 16; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, hrow + toff + 16 * kk);
          mma_k16<NT3>(acc[kk % 2], a, s_w3 + (tap * kHid + 16 * kk) * L3, L3,
                       8, lane);
        }
      }
      sum_sets(acc);
      // columns (2 t4, 2 t4 + 1) of n-tile j: (scale, shift) of the CTA's
      // channel 4 j + t4
  #pragma unroll
      for (int j = 0; j < NT3; ++j) {
        const int col = r * N3L + 8 * j + 2 * t4;
        const float2 b3 = *reinterpret_cast<const float2*>(s_vec + P::B3 + col);
        float2 g3 = make_float2(1.f, 1.f);
        if constexpr (!PALLAS) {  // the gain after conv3, as the XLA step
          g3 = *reinterpret_cast<const float2*>(s_vec + P::G3 + col);
        }
  #pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 16 * warp + g + 8 * h;
          if (q >= NO) continue;
          float as = acc[0][j][2 * h] + b3.x;
          float at = acc[0][j][2 * h + 1] + b3.y;
          if constexpr (!PALLAS) {
            as *= g3.x;
            at *= g3.y;
          }
          const float scale = 1.f / (1.f + expf(-(as + 2.f))) + kAffineEps;
          *reinterpret_cast<float2*>(s_o + q * SO + 8 * j + 2 * t4) =
              make_float2(scale, at);
        }
      }
    } else if constexpr (REV) {
      // x2, scale_ft and shift_ft of the second half, the CTA's channels
      for (int i = tid - 32 * G::MO; i < NO * (JC / 4);
           i += kThreads - 32 * G::MO) {
        const int q = i / (JC / 4), c = CN + r * JC + 4 * (i % (JC / 4));
        const int gy = y0 + q / TX, gx = x0 + q % TX;
        if (gy >= H || gx >= W) continue;
        const size_t pix = static_cast<size_t>(gy) * W + gx;
        const float* src[3] = {x + pix * C + c, cond + pix * R + c,
                               cond + pix * R + C + c};
  #pragma unroll
        for (int k = 0; k < 3; ++k) {
          *reinterpret_cast<float4*>(s_c + (q * 3 + k) * JC + c - CN - r * JC) =
              __ldg(reinterpret_cast<const float4*>(src[k]));
        }
      }
      // and t's first half to every CTA
      share_rows<NC, 4 * JC>(s_t1, 4 * ST, 4 * r * JC, NO, r, bar + 3,
                             tid - 32 * G::MO, kThreads - 32 * G::MO);
    }
    __syncthreads();  // conv3's (scale, shift) (and the coupling's inputs)
    // the coupling, 4 of the CTA's channels an item: forward the coupled
    // half out; reverse t's second half, (x2 / scale - shift) / scale_ft -
    // shift_ft
    for (int i = tid; i < NO * (JC / 4); i += kThreads) {
      const int q = i / (JC / 4), l = 4 * (i % (JC / 4)), c = r * JC + l;
      const int gy = y0 + q / TX, gx = x0 + q % TX;
      if (gy >= H || gx >= W) continue;
      const float4 o0 = ld4(s_o + q * SO + 2 * l);  // (scale, shift) x 2
      const float4 o1 = ld4(s_o + q * SO + 2 * l + 4);
      const float sc[4] = {o0.x, o0.z, o1.x, o1.z};
      const float sf[4] = {o0.y, o0.w, o1.y, o1.w};
      float y[4];
      if constexpr (!REV) {
        const float4 a = ld4(s_a2 + q * SA + l);
        const float za[4] = {a.x, a.y, a.z, a.w};
  #pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = (za[e] + sf[e]) * sc[e];
        st_vec(out + (static_cast<size_t>(gy) * W + gx) * C + CN + c, y);
      } else {
        float in[3][4];
  #pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float4 v = ld4(s_c + (q * 3 + k) * JC + l);
          in[k][0] = v.x;
          in[k][1] = v.y;
          in[k][2] = v.z;
          in[k][3] = v.w;
        }
  #pragma unroll
        for (int e = 0; e < 4; ++e) {
          y[e] = (in[0][e] / sc[e] - sf[e]) / in[1][e] - in[2][e];
          if constexpr (PALLAS) y[e] = round_bf16(y[e]);  // product 5
        }
        st_vec(s_t2 + q * ST + c, y);
      }
    }

    // ---- D (reverse): t to every CTA, then the folded inverse 1x1, the
    // CTA's DR rows (xla: 3xTF32 on t; pallas: t rounded, one pass) ----
    if constexpr (REV) {
      __syncthreads();  // the CTA's t channels
      share_rows<NC, 4 * JC>(s_t2, 4 * ST, 4 * r * JC, NO, r,
                                       bar + 3, tid, kThreads);
      mbar_wait(bar + 3, ph);  // t, whole
      constexpr int NTD = G::NTD, KS = C / 8;
      for (int u = warp; u < G::MO * NTD; u += kWarps) {
        const int mf = u / NTD, j = u % NTD;
        const int ar =
            min(16 * mf + (lane & 15), NO - 1) * ST + fold_a_col(lane);
        const float* br = s_f + 8 * j * SF + fold_b_off(lane, SF);
        // four sums, K steps dealt round robin, added in order at the end;
        // K: t's first half, then its second
        float acc[4][1][4];
        zero_acc(acc);
  #pragma unroll
        for (int k = 0; k < KS; ++k) {
          const float* a = k < KS / 2 ? s_t1 + ar + 8 * k
                                      : s_t2 + ar + 8 * (k - KS / 2);
          fold_k8<1, PASSES, false>(acc[k % 4], a, br + 8 * k, SF);
        }
        sum_sets(acc);
  #pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 16 * mf + g + 8 * h;
          const int gy = y0 + q / TX, gx = x0 + q % TX;
          if (q >= NO || gy >= H || gx >= W) continue;
          const int col = r * DR + 8 * j + 2 * t4;
          const float v[2] = {acc[0][0][2 * h] - s_vec[P::AB + col],
                              acc[0][0][2 * h + 1] - s_vec[P::AB + col + 1]};
          st_vec(out + (static_cast<size_t>(gy) * W + gx) * C + col, v);
        }
      }
    }
  };
  const int tile0 = blockIdx.x / NC;
  run_tile(Flag<true>(), tile0, 0);
  for (int tile = tile0 + ncl, it = 1; tile < ntiles; tile += ncl, ++it) {
    // the CTA is done with the last tile's maps; this tile's barriers set
    __syncthreads();
    arm();
    cluster_arrive();
    run_tile(Flag<false>(), tile, it & 1);
  }
}

// the clusters of the width resident at once (found once)
template <int C, bool REV, bool PALLAS>
int wide_clusters(cudaLaunchConfig_t cfg, int* n) {
  using G = WGeo<C, PALLAS>;
  static int max_clusters = 0;
  if (max_clusters == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        flow_step_bf16_wide_kernel<C, REV, PALLAS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::smem(REV));
    if (err != cudaSuccess) return static_cast<int>(err);
    cfg.gridDim = dim3(G::NC, 1, 1);
    int m = 0;
    const cudaError_t e2 = cudaOccupancyMaxActiveClusters(
        &m,
        reinterpret_cast<const void*>(
            flow_step_bf16_wide_kernel<C, REV, PALLAS>),
        &cfg);
    if (e2 != cudaSuccess) return static_cast<int>(e2);
    if (m < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    max_clusters = m;
  }
  *n = max_clusters;
  return 0;
}

// a cluster a tile of the batch, at most as many clusters as are resident
// at once (each takes the tiles its index strides over)
template <int C, bool REV, bool PALLAS>
int launch_wide(const float* x, const float* cond, const __nv_bfloat16* wb,
                float* out, int B, int H, int W, cudaStream_t stream) {
  using G = WGeo<C, PALLAS>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G::NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = G::smem(REV);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const int err = wide_clusters<C, REV, PALLAS>(cfg, &clusters);
  if (err != 0) return err;
  const long long tiles = static_cast<long long>(B) *
                          ((H + G::TY - 1) / G::TY) *
                          ((W + G::TX - 1) / G::TX);
  if (tiles > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int ncl = static_cast<int>(tiles < clusters ? tiles : clusters);
  cfg.gridDim = dim3(G::NC * ncl, 1, 1);
  const cudaError_t e2 = cudaLaunchKernelEx(
      &cfg, flow_step_bf16_wide_kernel<C, REV, PALLAS>, x, cond, wb, out, B,
      H, W);
  if (e2 != cudaSuccess) return static_cast<int>(e2);
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
    case 48: return launch_wide<48, REV, PALLAS>(xp, cp, wp, op, B, H, W, st);
    case 96: return launch<96, REV, PALLAS>(xp, cp, wp, op, B, H, W, st);
    case 192:
      return launch_wide<192, REV, PALLAS>(xp, cp, wp, op, B, H, W, st);
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
