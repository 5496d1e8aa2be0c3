// K5: one fused conditional SRFlow FlowStep (eval, no log-det), forward and
// reverse, float32.  NHWC state (B, H, W, C) with C in {12, 24, 48, 96,
// 192} (the three flow levels of the 4x model, and levels 3 and 4 of the
// 8x model's L = 4 flow: 12, 24, 48, 192) and coupling hidden width 64,
// any batch: the image is
// blockIdx.z, the state, its records and the output are offset by whole
// images and the packed weights are shared, so a batch-1 launch is the
// launch it was before the batch.
//
// Replaces bfsr_tpu/ops/pallas/flow_step.py:_fwd_kernel / _rev_kernel
// (step_apply).  What it computes is kept: the folded actnorm+invconv 1x1,
// the feature-conditional affine (scale_ft, shift_ft) and the fAffine
// coupling tower (conv3x3 -> actnorm/relu -> conv1x1 -> actnorm/relu ->
// conv3x3 with exp(3 logs) folded in -> sigmoid coupling), one launch per
// step per direction, with za, the hidden map and the tower output never
// leaving the block.  The TPU workarounds are not: no 128-lane channel
// pads, no 8-column halos, no level-1 space-to-depth phase packing, no bf16
// hi/lo 3-pass products, no VMEM tile budget.  The kernel takes any H, W.
//
// What bounds it on this card: f32 FMA throughput.  Per pixel a step does
// 2*C*C (the 1x1) + 2*9*cn*64 (conv1) + 2*64*64 (conv2) + 2*9*64*C (conv3)
// flops, 29 K at C=12 up to 413 K at C=192, against (C + (2C+64) + C) * 4
// bytes of state and conditioning moved: 260-830 flop/B, far above the
// card's 20 flop/B (67 TFLOP/s f32 over 3.35 TB/s).  At LR 128^2 the
// least time per launch is 28.6 / 12.4 / 11.8 us at levels 1 / 2 / 3.
// Two launches on the same inputs give the same bits, and an image of a
// batch the bits of its batch-1 launch: every sum runs in a fixed order,
// with no atomics, whatever the tile.
//
// Two kernels.  C = 12, 24 and 96 run flow_step_kernel (Tile<C>, f32 FMA);
// C = 48 and 192, the 8x model's wide levels, run flow_step_wide_kernel
// (Wide<C>, thread-block clusters, 3xTF32 tensor-core products).
//
// Design (C = 12, 24, 96).  A block of 256 threads owns a TY x TX tile of
// output pixels.  Every product is an implicit GEMM on register tiles fed
// from shared memory, where the step's weights are copied once per block
// with 16-byte cp.async (the packed layout puts every block of it on a
// 16-byte boundary):
//   A. the z1 half of the state on the (TY+4) x (TX+4) window (2-pixel
//      halo: two stacked 3x3 convs), zero outside the image; forward: the
//      fold, in shared memory, on the window (items of one pixel x QA
//      outputs, a float4 of the state feeding 4 QA FMAs), z1 written to
//      the output and za's second half kept for the tile;
//   B. conv1 (M = the (TY+2) x (TX+2) hidden region, N = 64, K = 9 cn),
//      then the 1x1 conv2 (K = 64) in place: warp w owns hidden channels
//      8w..8w+7 and lane l the pixels l + 32 i, i < PMH, so each step of K
//      is PMH loads of the activation (odd pixel strides) and two broadcast
//      float4 of the weight for 8 PMH FMAs.  After conv2 the map is ZEROED
//      OUTSIDE THE IMAGE: the reference pads conv3's input with zeros,
//      while the hidden map there carries the actnorm biases, so a kernel
//      without this mask is wrong on a 1-pixel frame;
//   C. conv3 (M = the tile, N = 2 co, K = 576): PM3 pixels x PN3 channels
//      a thread, lanes split LG3 ways over channel groups; KS3 slices of the
//      warps split K (the hidden channels) and their partial sums meet in
//      shared memory, added in slice order after b3; then (scale, shift)
//      -> the coupled half (reverse: x2' to shared memory);
//   D. (reverse only) the ft affine and the folded inverse 1x1, after the
//      tower, as the reverse order requires, its weight in shared memory.
// W2 stays whole in shared memory.  W1 and W3 come whole at C = 12 and 24
// and a tap at a time at C = 96 through a two-slot cp.async ring, so chunk
// t+1's copy overlaps chunk t's FMAs; the folds (C x C) sit in shared
// memory.  W3's first chunk is copied during conv2 into the space the
// window, the fold and W1 leave.  Global reads and writes of the state and
// records are float2 / float4 vectors.
//
// Tiles (set by timing candidates side by side with
// bfsr_tpu_torch/profiling/k5_times.py, NVIDIA H100 80GB HBM3, 700.00 W):
// 8 x 16 at C=12 (2 blocks per SM; 512 blocks at 256^2 fill 264 slots in
// 1.94 waves), 16 x 8 at C=24 and 4 x 8 at C=96 (one block per SM, 128
// blocks at 128^2 and 64^2).  On that card: 0.083 / 0.037 / 0.057 ms
// forward and 0.083 / 0.038 / 0.047 ms reverse at 256^2 x 12 / 128^2 x 24 /
// 64^2 x 96, 35 / 34 / 21-25% of the bound above.
// What holds it there: besides the halo recompute (the hidden region is
// 1.4x / 1.4x / 1.9x the tile), the global reads of the records' halo, the
// weight copies (57 KB a block at C=12) and the stage barriers take about
// a third of the time at C=12 and up to half at C=96, where one block per
// SM has 8 warps to hide them; conv2 runs near the FMA peak, conv1 and
// conv3 near 60% of it.
//
// Design (C = 48, 192).  The wide levels' images are small (1,024-4,096
// pixels at B 1), so a block of the kernel above got a tiny tile, copied
// the whole step's weights (827 KB at C = 192) for it and recomputed a
// wide halo.  Here a thread-block cluster of NC CTAs (8 at C = 192, 2 at C
// = 48; one CTA of 256 threads per SM) owns a tile of TY x TX output
// pixels, and its CTAs split the channels, not the pixels: CTA r holds
// hidden channels [r HC, (r+1) HC), coupled channels [r JC, (r+1) JC) (its
// JC z1 and JC za2 rows of the fold, its JC scale and JC shift columns of
// conv3, so the coupling stays in the CTA) and rows [r DR, (r+1) DR) of
// the inverse fold.  Its share of the weights (1/NC of them) lives in
// shared memory: W2, W1 and the fold rows kept for every tile the
// cluster takes (a persistent loop over the tiles of the batch, as many
// clusters as the card holds at once: 15 of 8 CTAs, 66 of 2), W3 a tap at
// a time through a three-slot cp.async ring.  Per tile:
//   A. forward: the state on the window, copied to shared memory (zeros
//      outside the image); the fold, the CTA's z1 rows on the window and
//      its za2 rows on the tile; reverse: the window's z1 half;
//   B. conv1 on the hidden region (K split over KS1 slices, chunks of 8
//      channels within every tap), its partials added in slice order, the
//      actnorm and relu; conv2 likewise, the map zeroed outside the image;
//   C. conv3 on the tile (KS3 slices), the coupling; reverse, t = [x1 |
//      x2'] / scale_ft - shift_ft for the CTA's channels;
//   D. reverse: the inverse fold, the CTA's DR rows.
// What crosses distributed shared memory (st.shared::cluster to every
// CTA, cluster barriers between the stages): z1 on the window (forward),
// the hidden map after conv1 and after conv2, and t (reverse).  Every
// product is 3xTF32 mma.sync.m16n8k8, as K2 (csrc/linf_info.cu): each f32
// operand split into a TF32 big part and the rest, small * big, big *
// small, then big * big, f32 accumulate; fragments read from shared rows
// whose strides keep them free of bank conflicts.  Tiles: 11 x 7 at C =
// 192 (15 tiles at 32^2, one round of the 15 clusters), 8 x 8 at C = 48
// (64 tiles at 64^2 for 66 clusters).
//
// Candidates (k5_times.py --levels x8, NVIDIA H100 80GB HBM3, 700.00 W,
// the parent's 0.091 / 0.057 ms at 32^2 x 192, 0.029 / 0.027 at 64^2 x
// 48): f32 FMA clusters, 8 x 8 tiles of 8 CTAs and 8 x 16 of 4, weights
// kept: 0.068 / 0.065 and 0.058 / 0.057 (16 and 32 tiles for 15 and 30
// resident clusters: two rounds); the same with W1 / W3 streamed and a
// second tile a width chosen at launch: 0.047 / 0.047 and 0.033 / 0.034
// (load-store bound, and the cluster stores a row apart); 3xTF32,
// coalesced cluster stores, the fold on the tensor cores: 0.042 / 0.037
// and 0.027 / 0.026 once each warp's K slice was cut within every tap;
// 11 x 7 tiles, float4 coupling, two accumulator sets: 0.040 / 0.035;
// W1 kept, 4 x 2 warp groups at C = 48: 0.0385 / 0.0342 and 0.0244 /
// 0.0235; 8 K slices of conv3 at C = 192 (this kernel): 0.0378 / 0.0330
// and 0.0244 / 0.0236; a validate batch's B 2 of 10^2 x 192 0.0350 /
// 0.0309, of 20^2 x 48 0.0236 / 0.0223 (parent 0.091 / 0.056, 0.028 /
// 0.027).  At the 3xTF32 rate (495 / 3 TFLOP/s) that is 6.8 / 7.8% of the
// bound at 32^2 x 192 and 9.7 / 10.1% at 64^2 x 48 (17 / 19% and 24 / 25%
// at the f32 SIMT rate).  The trainer's B 12 (no path launches K5 there)
// takes two rounds: 0.069 / 0.058 at 10^2 x 192 and 0.045 / 0.042 at
// 20^2 x 48 (parent 0.169 / 0.109, 0.054 / 0.051); a second, 10 x 10
// tile chosen at launch ran them in one round (0.042 / 0.039, 0.031 /
// 0.030) and nothing else faster, and was dropped.  Rejected: W3 kept
// whole at 11 x 7 (conv3 faster, its 55 KB copy slowed conv1: 0.037 /
// 0.033) and the inverse fold over all eight warps (0.038 / 0.035,
// spills).  Where the reverse's time goes at 32^2 x 192
// (profiling/k5_stages.py, the first CTA's stage clocks): the products
// about half (conv3 with W3's ring 22%, conv1 17%, the inverse fold 9%,
// conv2 1%); the hidden maps' and t's distributed-shared-memory stores
// (about 120 KB a CTA, to seven other CTAs) and the cluster barriers
// about 40% (t's stores and barrier alone about 16%); the state window's
// copy through L2 with, on the first tile, the kept weights' copy 11%.

#include <cuda_runtime.h>

#include <cstdint>

#include "cluster.cuh"
#include "tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHid = 64;
constexpr float kAffineEps = 1e-4f;
constexpr int kPN3 = 12;  // conv3's output channels a thread (3 float4)

// Per level: output tile TY x TX; PMH hidden pixels a lane in conv1/conv2;
// conv3's PM3 pixels x kPN3 channels a thread, its lanes LG3 channel groups
// x 32 / LG3 pixels (one broadcast activation load feeds LG3 lanes); WT taps
// per chunk of W1 and W3 (9: whole); QA / QD outputs per item of the
// forward fold and the inverse fold; MINB blocks per SM.
template <int C> struct Tile;
template <> struct Tile<12> {
  static constexpr int TY = 8, TX = 16, PMH = 6, PM3 = 2, LG3 = 1;
  static constexpr int WT = 9, QA = 6, QD = 12, MINB = 2;
};
template <> struct Tile<24> {
  static constexpr int TY = 16, TX = 8, PMH = 6, PM3 = 4, LG3 = 2;
  static constexpr int WT = 9, QA = 12, QD = 12, MINB = 1;
};
template <> struct Tile<96> {
  static constexpr int TY = 4, TX = 8, PMH = 2, PM3 = 4, LG3 = 4;
  static constexpr int WT = 1, QA = 16, QD = 16, MINB = 1;
};

constexpr int up4(int n) { return (n + 3) / 4 * 4; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int C>
struct Geo {
  using T = Tile<C>;
  static constexpr int CN = C / 2, CO = C - C / 2, N3 = 2 * CO;
  static constexpr int R = 2 * C + kHid;
  static constexpr int TY = T::TY, TX = T::TX;
  static constexpr int HY = TY + 2, HX = TX + 2, NH = HY * HX;
  static constexpr int WY = TY + 4, WX = TX + 4, NW = WY * WX;
  static constexpr int NO = TY * TX;
  static constexpr int PMH = T::PMH, PM3 = T::PM3, PN3 = kPN3;
  // conv3: lane = (lc, lp), LG3 channel groups x LP3 pixels; warp w =
  // (ks * NG3 + ng) * NP3 + ps
  static constexpr int LG3 = T::LG3, LP3 = 32 / LG3;
  static constexpr int NG3 = N3 / (PN3 * LG3);
  static constexpr int NP3 = (NO + LP3 * PM3 - 1) / (LP3 * PM3);
  static constexpr int KS3 = kWarps / (NG3 * NP3), KC3 = kHid / KS3;
  static constexpr int NOP = NP3 * LP3 * PM3;
  static constexpr int WT = T::WT, NCH = 9 / WT;  // W1 / W3 chunks
  static constexpr int CH1 = WT * CN * kHid, CH3 = WT * kHid * N3;
  static constexpr int QA = T::QA, GA = CN / QA, QD = T::QD, GD = C / QD;
  // odd shared-memory strides: window, hidden, partials, x2' / za2, t
  static constexpr int SZ = CN | 1, SH = kHid + 1, SP = N3 + 1;
  static constexpr int S2 = CO | 1, ST = C + 1;
  // packed weights (bfsr_tpu_torch/ops/cuda/flow_step.py:_layout)
  static constexpr int WF = 0, BF = C * C, WI = BF + C, AB = WI + C * C;
  static constexpr int W1 = AB + C, AN1B = W1 + 9 * CN * kHid;
  static constexpr int AN1E = AN1B + kHid, W2 = AN1E + kHid;
  static constexpr int AN2B = W2 + kHid * kHid, AN2E = AN2B + kHid;
  static constexpr int W3 = AN2E + kHid, B3 = W3 + 9 * kHid * N3;
  // shared memory, floats: s_w2 | s_h | s_x | s_za2
  //   s_h: the hidden map; then conv3's partials [KS3][NOP][SP], x2'
  //        (reverse, [NO][S2] at H_X2) and t ([NO][ST], over the partials)
  //   s_x: the window, the fold and the W1 slots; then the
  //        W3 slots; then (reverse) the inverse fold
  static constexpr int FF = C * C;  // fold floats in s_x
  static constexpr int H_X2 = up4(cmax(KS3 * NOP * SP, NO * ST));
  static constexpr int H = up4(cmax(NH * SH, H_X2 + NO * S2));
  static constexpr int X_FOLD = up4(NW * SZ), X_W1 = X_FOLD + FF;
  static constexpr int SLOTS = NCH > 1 ? 2 : 1;
  static constexpr int X = up4(cmax(cmax(X_W1 + SLOTS * CH1, SLOTS * CH3),
                                    FF));
  static constexpr int SMEM_FLOATS = kHid * kHid + H + X + NO * S2;
  static_assert(C % 4 == 0 && CN == CO, "C must be a multiple of 4");
  static_assert(NH <= 32 * PMH, "one pass over the hidden region");
  static_assert(kWarps * 8 == kHid, "a warp per 8 hidden channels");
  static_assert(kWarps % (NG3 * NP3) == 0 && kHid % KS3 == 0 &&
                N3 == NG3 * LG3 * PN3 && 32 % LG3 == 0, "conv3");
  static_assert(CN % QA == 0 && C % QD == 0 && PN3 % 4 == 0, "groups");
  static_assert(9 % WT == 0, "chunks");
  static_assert(SMEM_FLOATS * 4 <= 227 * 1024, "shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// n floats (n % 4 == 0, both ends 16-byte aligned), copied by the block
__device__ __forceinline__ void copy_async(float* dst,
                                           const float* __restrict__ src,
                                           int n) {
  for (int e = threadIdx.x; e < n / 4; e += kThreads) {
    cp_async16(dst + 4 * e, src + 4 * e);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// v[i] = p[i], i < N, in float4 loads (N % 4 == 0, p 16-byte aligned) or
// float2 loads (N even, p 8-byte aligned): one scattered load a vector
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

template <int C, bool REV>
__global__ void __launch_bounds__(kThreads, Tile<C>::MINB)
flow_step_kernel(const float* __restrict__ x, const float* __restrict__ cond,
                 const float* __restrict__ wp, float* __restrict__ out,
                 int H, int W) {
  using G = Geo<C>;
  constexpr int CN = G::CN, CO = G::CO, N3 = G::N3, R = G::R;
  constexpr int TX = G::TX, TY = G::TY, HX = G::HX, WX = G::WX;
  constexpr int NH = G::NH, NO = G::NO;
  constexpr int SZ = G::SZ, SH = G::SH, SP = G::SP, S2 = G::S2;
  constexpr int PMH = G::PMH, PM3 = G::PM3, PN3 = G::PN3;
  extern __shared__ __align__(16) float smem[];
  float* s_w2 = smem;               // (64, 64): W2
  float* s_h = s_w2 + kHid * kHid;  // (NH, SH): the hidden map
  float* s_x = s_h + G::H;          // window, fold, W1 | W3 | inverse fold
  float* s_z1 = s_x;                // (NW, SZ): z1 on the window
  float* s_za2 = s_x + G::X;        // (NO, S2): forward za[cn:]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  // pixels before this block's image, in the state, records and output
  const size_t img_px = static_cast<size_t>(blockIdx.z) * H * W;
  x += img_px * C;
  cond += img_px * R;
  out += img_px * C;

  // the weights of stages A and B, in flight while stage A starts
  if constexpr (!REV) {
    copy_async(s_x + G::X_FOLD, wp + G::WF, C * C);
    cp_async_commit();
  }
  copy_async(s_w2, wp + G::W2, kHid * kHid);
  copy_async(s_x + G::X_W1, wp + G::W1, G::CH1);
  cp_async_commit();

  // ---- A: z1 on the window (zero outside the image) ----
  if constexpr (!REV) {
    constexpr int QA = G::QA, GA = G::GA;
    cp_async_wait<1>();
    __syncthreads();  // the fold's rows landed
    for (int i = tid; i < 2 * GA * G::NW; i += kThreads) {
      const int p = i % G::NW, g = i / G::NW;
      const int wy = p / WX, wx = p % WX;
      const int gy = y0 - 2 + wy, gx = x0 - 2 + wx;
      const bool interior = wy >= 2 && wy < TY + 2 && wx >= 2 && wx < TX + 2;
      if (g >= GA && !interior) continue;
      if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
        if (g < GA) {
#pragma unroll
          for (int q = 0; q < QA; ++q) s_z1[p * SZ + g * QA + q] = 0.f;
        }
        continue;
      }
      const size_t pix = static_cast<size_t>(gy) * W + gx;
      const float4* xr = reinterpret_cast<const float4*>(x + pix * C);
      const float* wr = s_x + G::X_FOLD + g * QA * C;
      float acc[QA];
#pragma unroll
      for (int q = 0; q < QA; ++q) acc[q] = 0.f;
#pragma unroll 2
      for (int c4 = 0; c4 < C / 4; ++c4) {
        const float4 v = __ldg(xr + c4);
#pragma unroll
        for (int q = 0; q < QA; ++q) {
          const float4 w = ld4(wr + q * C + 4 * c4);
          acc[q] += v.x * w.x;
          acc[q] += v.y * w.y;
          acc[q] += v.z * w.z;
          acc[q] += v.w * w.w;
        }
      }
      const float* rec = cond + pix * R + g * QA;
      float sc[QA], sh[QA], bf[QA], za[QA];
      ldg_vec(sc, rec);
      ldg_vec(sh, rec + C);
      ldg_vec(bf, wp + G::BF + g * QA);
#pragma unroll
      for (int q = 0; q < QA; ++q) za[q] = (acc[q] + bf[q] + sh[q]) * sc[q];
      if (g < GA) {
#pragma unroll
        for (int q = 0; q < QA; ++q) s_z1[p * SZ + g * QA + q] = za[q];
        if (interior) st_vec(out + pix * C + g * QA, za);
      } else {
#pragma unroll
        for (int q = 0; q < QA; ++q) {
          s_za2[((wy - 2) * TX + wx - 2) * S2 + (g - GA) * QA + q] = za[q];
        }
      }
    }
  } else {
    for (int p = tid; p < G::NW; p += kThreads) {
      const int wy = p / WX, wx = p % WX;
      const int gy = y0 - 2 + wy, gx = x0 - 2 + wx;
      float z1[CN] = {};
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        ldg_vec(z1, x + (static_cast<size_t>(gy) * W + gx) * C);
      }
#pragma unroll
      for (int q = 0; q < CN; ++q) s_z1[p * SZ + q] = z1[q];
    }
  }

  // ---- B: conv1 on the hidden region, then conv2 in place ----
  // warp w: hidden channels 8w..8w+7; lane l: pixels l + 32 i (slots past
  // NH read the last pixel and write nothing)
  int hoff[PMH], zoff[PMH];
  float acc[PMH][8];
#pragma unroll
  for (int i = 0; i < PMH; ++i) {
    const int p = min(lane + 32 * i, NH - 1);
    const int hy = p / HX, hx = p % HX;
    hoff[i] = p * SH;
    zoff[i] = (hy * WX + hx) * SZ;
    const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float4* a = reinterpret_cast<const float4*>(
          cond + (static_cast<size_t>(gy) * W + gx) * R + 2 * C + warp * 8);
      const float4 u = __ldg(a), v = __ldg(a + 1);
      acc[i][0] = u.x; acc[i][1] = u.y; acc[i][2] = u.z; acc[i][3] = u.w;
      acc[i][4] = v.x; acc[i][5] = v.y; acc[i][6] = v.z; acc[i][7] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
  }
#pragma unroll 1
  for (int ch = 0; ch < G::NCH; ++ch) {
    if (ch + 1 < G::NCH) {
      copy_async(s_x + G::X_W1 + ((ch + 1) & 1) * G::CH1,
                 wp + G::W1 + (ch + 1) * G::CH1, G::CH1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk ch, W2 and the window are in place
    const float* wc = s_x + G::X_W1 + (ch & 1) * G::CH1 + warp * 8;
#pragma unroll 1
    for (int tt = 0; tt < G::WT; ++tt) {
      const int tap = ch * G::WT + tt;
      const float* zt = s_z1 + ((tap / 3) * WX + tap % 3) * SZ;
      const float* wt = wc + tt * CN * kHid;
#pragma unroll 2
      for (int c = 0; c < CN; ++c) {
        const float4 b0 = ld4(wt + c * kHid), b1 = ld4(wt + c * kHid + 4);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < PMH; ++i) {
          const float a = zt[zoff[i] + c];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += a * b[j];
        }
      }
    }
    __syncthreads();  // the slot is free
  }
  {
    const float4* pb = reinterpret_cast<const float4*>(wp + G::AN1B + warp * 8);
    const float4* pe = reinterpret_cast<const float4*>(wp + G::AN1E + warp * 8);
    const float4 b0 = __ldg(pb), b1 = __ldg(pb + 1);
    const float4 e0 = __ldg(pe), e1 = __ldg(pe + 1);
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const float e[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
    for (int i = 0; i < PMH; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (lane + 32 * i < NH) {
          s_h[hoff[i] + warp * 8 + j] = fmaxf((acc[i][j] + b[j]) * e[j], 0.f);
        }
        acc[i][j] = 0.f;
      }
    }
  }
  // W3's first chunk in flight during conv2, where the window, the fold
  // and W1 were
  copy_async(s_x, wp + G::W3, G::CH3);
  cp_async_commit();
  __syncthreads();  // the map after conv1
#pragma unroll 4
  for (int k = 0; k < kHid; ++k) {
    const float4 b0 = ld4(s_w2 + k * kHid + warp * 8);
    const float4 b1 = ld4(s_w2 + k * kHid + warp * 8 + 4);
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < PMH; ++i) {
      const float a = s_h[hoff[i] + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += a * b[j];
    }
  }
  __syncthreads();  // every read of the map is done
  {
    const float4* pb = reinterpret_cast<const float4*>(wp + G::AN2B + warp * 8);
    const float4* pe = reinterpret_cast<const float4*>(wp + G::AN2E + warp * 8);
    const float4 b0 = __ldg(pb), b1 = __ldg(pb + 1);
    const float4 e0 = __ldg(pe), e1 = __ldg(pe + 1);
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const float e[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
    for (int i = 0; i < PMH; ++i) {
      const int p = lane + 32 * i;
      if (p >= NH) continue;
      const int gy = y0 - 1 + p / HX, gx = x0 - 1 + p % HX;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s_h[hoff[i] + warp * 8 + j] =
            in ? fmaxf((acc[i][j] + b[j]) * e[j], 0.f) : 0.f;
      }
    }
  }

  // ---- C: conv3 -> (scale, shift) -> the coupled half ----
  constexpr int NP3 = G::NP3, NG3 = G::NG3, KC3 = G::KC3, LP3 = G::LP3;
  const int ps = warp % NP3, ng = (warp / NP3) % NG3, ks = warp / (NP3 * NG3);
  const int lp = lane % LP3, n0 = (ng * G::LG3 + lane / LP3) * PN3;
  int ooff[PM3];
#pragma unroll
  for (int i = 0; i < PM3; ++i) {
    const int p = min(ps * LP3 * PM3 + LP3 * i + lp, NO - 1);
    ooff[i] = ((p / TX) * HX + p % TX) * SH + ks * KC3;
  }
  float a3[PM3][PN3];
#pragma unroll
  for (int i = 0; i < PM3; ++i) {
#pragma unroll
    for (int j = 0; j < PN3; ++j) a3[i][j] = 0.f;
  }
#pragma unroll 1
  for (int ch = 0; ch < G::NCH; ++ch) {
    if (ch + 1 < G::NCH) {
      copy_async(s_x + ((ch + 1) & 1) * G::CH3,
                 wp + G::W3 + (ch + 1) * G::CH3, G::CH3);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk ch in place (and, the first time, the map)
    const float* wc = s_x + (ch & 1) * G::CH3 + ks * KC3 * N3 + n0;
#pragma unroll 1
    for (int tt = 0; tt < G::WT; ++tt) {
      const int tap = ch * G::WT + tt;
      const float* ht = s_h + ((tap / 3) * HX + tap % 3) * SH;
      const float* wt = wc + tt * kHid * N3;
#pragma unroll 4
      for (int k = 0; k < KC3; ++k) {
        float b[PN3];
#pragma unroll
        for (int q = 0; q < PN3 / 4; ++q) {
          const float4 v = ld4(wt + k * N3 + 4 * q);
          b[4 * q] = v.x;
          b[4 * q + 1] = v.y;
          b[4 * q + 2] = v.z;
          b[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < PM3; ++i) {
          const float a = ht[ooff[i] + k];
#pragma unroll
          for (int j = 0; j < PN3; ++j) a3[i][j] += a * b[j];
        }
      }
    }
    __syncthreads();  // the slot is free; the last time, the map too
  }
  if constexpr (REV) {  // the inverse fold, in flight now
    copy_async(s_x, wp + G::WI, C * C);
    cp_async_commit();
  }
  // the slices' partial sums [ks][pixel][N3], over the map
  float* s_p = s_h;
#pragma unroll
  for (int i = 0; i < PM3; ++i) {
    const int p = ps * LP3 * PM3 + LP3 * i + lp;
    if (p >= NO) continue;
#pragma unroll
    for (int j = 0; j < PN3; ++j) {
      s_p[(ks * G::NOP + p) * SP + n0 + j] = a3[i][j];
    }
  }
  __syncthreads();
  float* s_x2 = s_h + G::H_X2;  // (NO, S2): reverse x2'
  constexpr int JQ = 2;  // coupled channels an item (one float2 access)
  for (int i = tid; i < NO * (CO / JQ); i += kThreads) {
    const int p = i % NO, j0 = (i / NO) * JQ;
    const int gy = y0 + p / TX, gx = x0 + p % TX;
    if (gy >= H || gx >= W) continue;
    float as[JQ], at[JQ], y[JQ];
    ldg_vec(as, wp + G::B3 + j0);
    ldg_vec(at, wp + G::B3 + CO + j0);
#pragma unroll
    for (int s = 0; s < G::KS3; ++s) {  // slice order: fixed sums
#pragma unroll
      for (int q = 0; q < JQ; ++q) {
        as[q] += s_p[(s * G::NOP + p) * SP + j0 + q];
        at[q] += s_p[(s * G::NOP + p) * SP + CO + j0 + q];
      }
    }
    const size_t pix = static_cast<size_t>(gy) * W + gx;
    if constexpr (!REV) {
#pragma unroll
      for (int q = 0; q < JQ; ++q) {
        const float scale = 1.f / (1.f + expf(-(as[q] + 2.f))) + kAffineEps;
        y[q] = (s_za2[p * S2 + j0 + q] + at[q]) * scale;
      }
      st_vec(out + pix * C + CN + j0, y);
    } else {
      ldg_vec(y, x + pix * C + CN + j0);
#pragma unroll
      for (int q = 0; q < JQ; ++q) {
        const float scale = 1.f / (1.f + expf(-(as[q] + 2.f))) + kAffineEps;
        s_x2[p * S2 + j0 + q] = y[q] / scale - at[q];
      }
    }
  }

  // ---- D (reverse): ft affine, then the folded inverse 1x1 ----
  if constexpr (REV) {
    constexpr int ST = G::ST, QD = G::QD;
    __syncthreads();  // x2' written, the partials read
    float* s_t = s_h;  // (NO, ST): t = [x1 | x2'] / scale_ft - shift_ft
    for (int i = tid; i < NO * (C / 4); i += kThreads) {
      const int p = i % NO, c0 = (i / NO) * 4;
      const int gy = y0 + p / TX, gx = x0 + p % TX;
      if (gy >= H || gx >= W) continue;
      const size_t pix = static_cast<size_t>(gy) * W + gx;
      const float* rec = cond + pix * R;
      float xv[4], sc[4], sh[4];
      ldg_vec(xv, x + pix * C + c0);
      ldg_vec(sc, rec + c0);
      ldg_vec(sh, rec + C + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + e;
        const float v = c < CN ? xv[e] : s_x2[p * S2 + c - CN];
        s_t[p * ST + c] = v / sc[e] - sh[e];
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // t and the inverse fold in place
    for (int i = tid; i < NO * G::GD; i += kThreads) {
      const int p = i % NO, g = i / NO;
      const int gy = y0 + p / TX, gx = x0 + p % TX;
      if (gy >= H || gx >= W) continue;
      const float* wr = s_x + g * QD * C;
      const float* tr = s_t + p * ST;
      float acc[QD], ab[QD];
#pragma unroll
      for (int q = 0; q < QD; ++q) acc[q] = 0.f;
#pragma unroll 2
      for (int c4 = 0; c4 < C / 4; ++c4) {
        const float t0 = tr[4 * c4], t1 = tr[4 * c4 + 1];
        const float t2 = tr[4 * c4 + 2], t3 = tr[4 * c4 + 3];
#pragma unroll
        for (int q = 0; q < QD; ++q) {
          const float4 w = ld4(wr + q * C + 4 * c4);
          acc[q] += t0 * w.x;
          acc[q] += t1 * w.y;
          acc[q] += t2 * w.z;
          acc[q] += t3 * w.w;
        }
      }
      ldg_vec(ab, wp + G::AB + g * QD);
#pragma unroll
      for (int q = 0; q < QD; ++q) acc[q] -= ab[q];
      st_vec(out + (static_cast<size_t>(gy) * W + gx) * C + g * QD, acc);
    }
  }
}

template <int C, bool REV>
int launch(const float* x, const float* cond, const float* wp, float* out,
           int B, int H, int W, cudaStream_t stream) {
  using G = Geo<C>;
  constexpr int smem = G::SMEM_FLOATS * static_cast<int>(sizeof(float));
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flow_step_kernel<C, REV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((W + G::TX - 1) / G::TX, (H + G::TY - 1) / G::TY, B);
  flow_step_kernel<C, REV><<<grid, kThreads, smem, stream>>>(x, cond, wp, out,
                                                             H, W);
  return static_cast<int>(cudaGetLastError());
}

// ---- the wide levels, C = 48 and 192: one tile a thread-block cluster ----
//
// Wide<C>: the tile of width C: the cluster's NC CTAs, its TY x TX output
// tile and its warps' split of conv1 / conv2 (KS1 K slices x MG1 row
// groups x NG1 column groups) and of conv3.  A pixel's sums, and so its
// bits, do not depend on the tile's place or the batch.
template <int C> struct Wide;
template <> struct Wide<192> {
  static constexpr int NC = 8, TY = 11, TX = 7;
  static constexpr int KS1 = 4, MG1 = 2, NG1 = 1, KS3 = 8, MG3 = 1, NG3 = 1;
};
template <> struct Wide<48> {
  static constexpr int NC = 2, TY = 8, TX = 8;
  static constexpr int KS1 = 1, MG1 = 4, NG1 = 2, KS3 = 4, MG3 = 2, NG3 = 1;
};

// the least multiple of 4 at or above n whose float4 count is odd: an A
// fragment's 8 rows x 4 columns at that row stride, and neighbouring
// lanes' float4s, meet no bank conflict
constexpr int odd4(int n) { return (up4(n) / 4) % 2 ? up4(n) : up4(n) + 4; }
// a row stride at or above n that is 8 or 24 mod 32: a B fragment's 4 rows
// x 8 columns meet no bank conflict
constexpr int bstride(int n) {
  return n % 32 == 8 || n % 32 == 24 ? n : n + 8;
}
__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

template <int C>
struct WGeo {
  using T = Wide<C>;
  static constexpr int NC = T::NC, CN = C / 2, CO = C - C / 2;
  static constexpr int R = 2 * C + kHid;
  static constexpr int TY = T::TY, TX = T::TX, NO = TY * TX;
  static constexpr int HY = TY + 2, HX = TX + 2, NH = HY * HX;
  static constexpr int WY = TY + 4, WX = TX + 4, NW = WY * WX;
  // a CTA's share: HC hidden channels, JC coupled channels (JC z1 and JC
  // za2 rows of the fold, their scale and shift columns of conv3), DR rows
  // of the inverse fold
  static constexpr int HC = kHid / NC, JC = CO / NC, N3L = 2 * JC;
  static constexpr int DR = C / NC;
  // conv1 / conv2 (M = NH hidden pixels, N = HC) and conv3 (M = NO, N =
  // N3L): m16 x n8 tiles a warp; K in chunks of 8 channels, K slice ks the
  // chunks [ks KW, (ks + 1) KW) of every tap (conv1: KW1 of CN / 8, conv2:
  // KW2 of 64 / 8, conv3: KW3 of 64 / 8)
  static constexpr int KS1 = T::KS1, MG1 = T::MG1, NG1 = T::NG1;
  static constexpr int MT1 = cdiv(cdiv(NH, 16), MG1), NT1 = HC / 8 / NG1;
  static constexpr int KW1 = CN / 8 / KS1, KW2 = kHid / 8 / KS1;
  static constexpr int KS3 = T::KS3, MG3 = T::MG3, NG3 = T::NG3;
  static constexpr int MT3 = cdiv(cdiv(NO, 16), MG3), NT3 = N3L / 8 / NG3;
  static constexpr int KW3 = kHid / 8 / KS3;
  // the folds: forward, the z1 rows' m-tiles over the window and the za2
  // rows' over the tile, two n-tiles (JC = 12 rows); reverse, the tile's
  // m-tiles x DR / 8 n-tiles
  static constexpr int MZ = cdiv(NW, 16), MA = cdiv(NO, 16);
  static constexpr int NTF = cdiv(JC, 8);
  static constexpr int MD = cdiv(NO, 16), MDW = cdiv(MD, kWarps);
  static constexpr int NTD = DR / 8;
  // items a thread of the hidden maps' epilogues and of the coupling (4
  // coupled channels an item)
  static constexpr int I1 = cdiv(NH * (HC / 4), kThreads);
  static constexpr int IC = cdiv(NO * (JC / 4), kThreads);
  // row strides (floats): window, hidden map, t, the state on the window
  // and the fold rows (A fragments); W1 / W2 and W3 rows (B fragments)
  static constexpr int SZ = odd4(CN), SH = odd4(kHid), ST = odd4(C);
  static constexpr int SX = odd4(C), SF = odd4(C);
  static constexpr int B1 = bstride(HC), B3 = bstride(N3L);
  static constexpr int S2A = odd4(JC);  // za2
  // packed weights (bfsr_tpu_torch/ops/cuda/flow_step.py:_layout)
  static constexpr int WF = 0, BF = C * C, WI = BF + C, AB = WI + C * C;
  static constexpr int W1 = AB + C, AN1B = W1 + 9 * CN * kHid;
  static constexpr int AN1E = AN1B + kHid, W2 = AN1E + kHid;
  static constexpr int AN2B = W2 + kHid * kHid, AN2E = AN2B + kHid;
  static constexpr int W3 = AN2E + kHid, B3W = W3 + 9 * kHid * 2 * CO;
  // shared memory (floats): W2, the fold rows (4 spare rows for the
  // forward fold's last n-tile) and W1, kept; W3 a tap a slot of a
  // three-slot ring; then the maps.  The forward fold's state window sits
  // over the maps and za2 from O_Z (SMEM covers it), which the fold's
  // stores reach only after a cluster barrier
  static constexpr int LW2 = kHid * B1, LF = (2 * JC + 4) * SF;
  static constexpr int LW1 = 9 * CN * B1, LR3 = kHid * B3;
  static constexpr int ZN = NW * SZ, HN = NH * SH, TN = NO * ST;
  // h2 over the window where it fits (the window is dead after conv1)
  static constexpr bool H2Z = HN <= ZN;
  // the K slices' partial sums: conv1's / conv2's in the partials region,
  // conv3's there or (P3H) over h1 and it (h1 is dead after conv2)
  static constexpr int P1N = KS1 * NH * HC, P3N = KS3 * NO * N3L;
  static constexpr bool P3H = H2Z && P3N > cmax(P1N, HN);
  static constexpr int PN = up4(cmax(P1N, P3H ? P3N - HN : P3N));
  static constexpr int O_W2 = 0, O_F = O_W2 + LW2, O_W1 = O_F + LF;
  static constexpr int O_R3 = O_W1 + LW1, O_Z = O_R3 + 3 * LR3;
  static constexpr int O_H1 = O_Z + up4(cmax(cmax(ZN, TN), H2Z ? HN : 0));
  static constexpr int O_H2 = H2Z ? O_Z : O_H1 + HN;
  static constexpr int O_P = (H2Z ? O_H1 : O_H2) + HN;
  static constexpr int O_P3 = P3H ? O_H1 : O_P, O_A2 = O_P + PN;
  static constexpr int SMEM = cmax(O_A2 + up4(NO * S2A), O_Z + NW * SX);
  static_assert(C % 8 == 0 && CN == CO && CO % NC == 0 && kHid % NC == 0,
                "channel split");
  static_assert(KS1 * MG1 * NG1 == kWarps && KS3 * MG3 * NG3 == kWarps &&
                HC % (8 * NG1) == 0 && N3L % (8 * NG3) == 0 &&
                CN % (8 * KS1) == 0 && kHid % (8 * KS3) == 0, "warp roles");
  static_assert(JC % 4 == 0 && JC <= 16 && DR % 8 == 0, "folds");
  static_assert(SMEM * 4 <= 227 * 1024, "shared memory");
};

// one K step of 8 as 3xTF32 products on MT x NT tiles: every fragment
// loaded and split first, then small * big, big * small and big * big over
// all tiles, so the tensor cores see MT NT independent products at a time
// (each accumulator adds its three in that order, as K2's).  A_i's rows g
// and g + 8 start at a + r0[i] and a + r1[i] (K along the row); B's element
// (k, n) of n-tile j is b[k * bk + (8 j + n) * bn].
template <int MT, int NT>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4],
                                         const float* a, const int (&r0)[MT],
                                         const int (&r1)[MT], const float* b,
                                         int bk, int bn, int g, int t) {
  uint32_t bb[NT][2], bs[NT][2], ab[MT][4], as[MT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float* q = b + (8 * j + g) * bn;
    split_tf32(q[t * bk], bb[j][0], bs[j][0]);
    split_tf32(q[(t + 4) * bk], bb[j][1], bs[j][1]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    split_tf32(a[r0[i] + t], ab[i][0], as[i][0]);
    split_tf32(a[r1[i] + t], ab[i][1], as[i][1]);
    split_tf32(a[r0[i] + t + 4], ab[i][2], as[i][2]);
    split_tf32(a[r1[i] + t + 4], ab[i][3], as[i][3]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], as[i], bb[j]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ab[i], bs[j]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ab[i], bb[j]);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
}

// a warp's m-tiles' partial sums to s_p: rows (16 (m0 + i) + g, + 8) below
// rows (a warp's padded tiles lie past them), columns 8 (n0 + j) + 2 t,
// rows n floats apart
template <int MT, int NT>
__device__ __forceinline__ void store_tiles(float* s_p,
                                            const float (&acc)[MT][NT][4],
                                            int m0, int n0, int rows, int n,
                                            int g, int t) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * (m0 + i) + g + 8 * h;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        *reinterpret_cast<float2*>(s_p + row * n + 8 * (n0 + j) + 2 * t) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

// a float4 of the hidden map's K-slice partials at (pixel p, channel j),
// added in slice order
template <int KS, int NH, int HC>
__device__ __forceinline__ float4 sum_slices(const float* s_p, int p, int j) {
  float4 s = ld4(s_p + p * HC + j);
#pragma unroll
  for (int k = 1; k < KS; ++k) {
    const float4 u = ld4(s_p + (k * NH + p) * HC + j);
    s.x += u.x;
    s.y += u.y;
    s.z += u.z;
    s.w += u.w;
  }
  return s;
}

// the 9 taps of a weight streamed through a three-slot ring: tap t in slot
// t % 3, copied two taps ahead (copy(t) issues and commits one group; the
// caller has issued taps 0 and 1, the latest groups); body(t) per tap
template <class Copy, class Body>
__device__ __forceinline__ void tap_ring(Copy copy, Body body) {
#pragma unroll 1
  for (int t = 0; t < 9; ++t) {
    if (t < 8) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tap t landed; every warp is done with tap t - 1
    if (t + 2 < 9) copy(t + 2);
    body(t);
  }
}

// cp.async of 8 bytes (both ends 8-byte aligned)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// cp.async of 16 bytes, or 16 zero bytes where !valid (src is then not read
// but must still be a global address)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// rows x N floats from src (row stride ss) to dst (row stride ds), copied
// by the block in 16-byte (N % 4 == 0) or 8-byte pieces
template <int N>
__device__ __forceinline__ void copy_rows(float* dst, int ds,
                                          const float* __restrict__ src,
                                          int ss, int rows) {
  constexpr int V = N % 4 == 0 ? 4 : 2, PER = N / V;
  static_assert(N % 2 == 0, "rows of whole float2s");
  for (int e = threadIdx.x; e < rows * PER; e += kThreads) {
    const int r = e / PER, v = V * (e % PER);
    if constexpr (V == 4) {
      cp_async16(dst + r * ds + v, src + r * ss + v);
    } else {
      cp_async8(dst + r * ds + v, src + r * ss + v);
    }
  }
}

template <int C, bool REV>
__global__ void __launch_bounds__(kThreads, 1)
flow_step_wide_kernel(const float* __restrict__ x,
                      const float* __restrict__ cond,
                      const float* __restrict__ wp, float* __restrict__ out,
                      int B, int H, int W) {
  using G = WGeo<C>;
  constexpr int NC = G::NC, CN = G::CN, CO = G::CO, R = G::R;
  constexpr int TY = G::TY, TX = G::TX, HX = G::HX, WX = G::WX;
  constexpr int NH = G::NH, NW = G::NW, NO = G::NO;
  constexpr int HC = G::HC, JC = G::JC, DR = G::DR;
  constexpr int SZ = G::SZ, SH = G::SH, ST = G::ST, SX = G::SX, SF = G::SF;
  constexpr int B1 = G::B1, B3 = G::B3, S2A = G::S2A;
  constexpr int MT1 = G::MT1, NT1 = G::NT1, MT3 = G::MT3, NT3 = G::NT3;
  extern __shared__ __align__(16) float smem[];
  float* s_w2 = smem + G::O_W2;  // [64][B1]: W2, the CTA's HC columns
  float* s_f = smem + G::O_F;    // [2 JC][SF] z1 | za2 rows; [DR][SF] inverse
  float* s_w1 = smem + G::O_W1;  // [9 CN][B1]: W1, the CTA's HC columns
  float* s_r3 = smem + G::O_R3;  // 3 x [64][B3]: W3, JC scales | JC shifts
  float* s_x = smem + G::O_Z;    // [NW][SX]: forward, the state on the window
  float* s_z = smem + G::O_Z;    // [NW][SZ]: z1 on the window
  float* s_t = s_z;              // [NO][ST]: reverse, t after conv3
  float* s_h1 = smem + G::O_H1;  // [NH][SH]: the hidden map after conv1
  float* s_h2 = smem + G::O_H2;  // [NH][SH]: after conv2
  float* s_p = smem + G::O_P;    // conv1's / conv2's K slices' partials
  float* s_p3 = smem + G::O_P3;  // conv3's
  float* s_a2 = smem + G::O_A2;  // [NO][S2A]: forward, the CTA's za2

  const int r = cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // a fragment's row and column
  const int ng1 = warp % G::NG1, mg1 = (warp / G::NG1) % G::MG1;
  const int ks1 = warp / (G::NG1 * G::MG1);
  const int ng3 = warp % G::NG3, mg3 = (warp / G::NG3) % G::MG3;
  const int ks3 = warp / (G::NG3 * G::MG3);
  const int m01 = mg1 * MT1, m03 = mg3 * MT3;
  // A fragment rows: conv1 on the window, conv2 on the hidden map, conv3
  // on the hidden map, at tap (0, 0)
  int a1w[2][MT1], a1h[2][MT1], a3h[2][MT3];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < MT1; ++i) {
      const int p = min(16 * (m01 + i) + g + 8 * h, NH - 1);
      a1w[h][i] = ((p / HX) * WX + p % HX) * SZ;
      a1h[h][i] = p * SH;
    }
#pragma unroll
    for (int i = 0; i < MT3; ++i) {
      const int q = min(16 * (m03 + i) + g + 8 * h, NO - 1);
      a3h[h][i] = ((q / TX) * HX + q % TX) * SH;
    }
  }

  // kept for every tile: W2, W1 and the CTA's fold (or inverse fold) rows
  copy_rows<HC>(s_w2, B1, wp + G::W2 + r * HC, kHid, kHid);
  copy_rows<HC>(s_w1, B1, wp + G::W1 + r * HC, kHid, 9 * CN);
  if constexpr (!REV) {
    copy_rows<C>(s_f, SF, wp + G::WF + r * JC * C, C, JC);
    copy_rows<C>(s_f + JC * SF, SF, wp + G::WF + (CN + r * JC) * C, C, JC);
  } else {
    copy_rows<C>(s_f, SF, wp + G::WI + r * DR * C, C, DR);
  }
  cp_async_commit();
  // W3's tap t, the CTA's columns, into ring slot t % 3
  auto copy_w3 = [&](int t) {
    float* d = s_r3 + (t % 3) * G::LR3;
    const float* s = wp + G::W3 + t * kHid * 2 * CO + r * JC;
    copy_rows<JC>(d, B3, s, 2 * CO, kHid);
    copy_rows<JC>(d + JC, B3, s + CO, 2 * CO, kHid);
    cp_async_commit();
  };

  const int ntx = (W + TX - 1) / TX, nty = (H + TY - 1) / TY;
  const int ntiles = B * nty * ntx;
  const int ncl = gridDim.x / NC;
  bool first = true;
  for (int tile = blockIdx.x / NC; tile < ntiles; tile += ncl) {
    const int img = tile / (nty * ntx), t2 = tile % (nty * ntx);
    const int y0 = (t2 / ntx) * TY, x0 = (t2 % ntx) * TX;
    const size_t img_px = static_cast<size_t>(img) * H * W;
    const float* xi = x + img_px * C;
    const float* ci = cond + img_px * R;
    float* oi = out + img_px * C;
    auto inside = [&](int gy, int gx) {
      return gy >= 0 && gy < H && gx >= 0 && gx < W;
    };

    // the window, zeros outside the image: forward the state, reverse its
    // z1 half (every CTA copies it whole)
    if (!first) __syncthreads();  // the last tile's maps are read
    {
      constexpr int NV = (REV ? CN : C) / 4, S = REV ? SZ : SX;
      for (int i = tid; i < NW * NV; i += kThreads) {
        const int pi = i / NV, c4 = i % NV;
        const int gy = y0 - 2 + pi / WX, gx = x0 - 2 + pi % WX;
        const bool in = inside(gy, gx);
        cp_async16_zfill(
            s_x + pi * S + 4 * c4,
            in ? xi + (static_cast<size_t>(gy) * W + gx) * C + 4 * c4 : xi,
            in);
      }
      cp_async_commit();
    }
    // the epilogue of conv1 reads aff1_ft: this thread's items, early
    float4 aff[G::I1];
#pragma unroll
    for (int u = 0; u < G::I1; ++u) {
      const int i = tid + u * kThreads;
      const int j = 4 * (i % (HC / 4)), p = i / (HC / 4);
      const int gy = y0 - 1 + p / HX, gx = x0 - 1 + p % HX;
      aff[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p < NH && inside(gy, gx)) {
        aff[u] = __ldg(reinterpret_cast<const float4*>(
            ci + (static_cast<size_t>(gy) * W + gx) * R + 2 * C + r * HC +
            j));
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the window (and, the first tile, the kept weights)

    // ---- A (forward): the fold, the CTA's JC z1 rows on the window (to
    // every CTA) and its JC za2 rows on the tile (kept) ----
    if constexpr (!REV) {
      constexpr int MZ = G::MZ, MA = G::MA, NTF = G::NTF;
      constexpr int MZW = cdiv(MZ, kWarps), MAW = cdiv(MA, kWarps);
      // z1 m-tiles warp + 8 u; za2 m-tiles a0 + 8 u, dealt on after them
      const int a0 = (warp - MZ % kWarps + kWarps) % kWarps;
      int zr[2][MZW], ar[2][MAW];  // window pixels of the rows
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int u = 0; u < MZW; ++u) {
          zr[h][u] = min(16 * (warp + kWarps * u) + g + 8 * h, NW - 1);
        }
#pragma unroll
        for (int u = 0; u < MAW; ++u) {
          const int q = min(16 * (a0 + kWarps * u) + g + 8 * h, NO - 1);
          ar[h][u] = (q / TX + 2) * WX + q % TX + 2;
        }
      }
      float az[MZW][NTF][4], aa[MAW][NTF][4];
      zero(az);
      zero(aa);
      {
        int z0[MZW], z1[MZW], q0[MAW], q1[MAW];
#pragma unroll
        for (int u = 0; u < MZW; ++u) {
          z0[u] = zr[0][u] * SX;
          z1[u] = zr[1][u] * SX;
        }
#pragma unroll
        for (int u = 0; u < MAW; ++u) {
          q0[u] = ar[0][u] * SX;
          q1[u] = ar[1][u] * SX;
        }
#pragma unroll 4
        for (int k = 0; k < C; k += 8) {
          mma_step<MZW, NTF>(az, s_x + k, z0, z1, s_f + k, 1, SF, g, t4);
          mma_step<MAW, NTF>(aa, s_x + k, q0, q1, s_f + JC * SF + k, 1, SF,
                             g, t4);
        }
      }
      // za = (fold + b_fold + shift_ft) * scale_ft, zero outside the image
      auto finish = [&](float (&acc)[NTF][4], const int (&wpix)[2],
                        int ch0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gy = y0 - 2 + wpix[h] / WX, gx = x0 - 2 + wpix[h] % WX;
          const bool in = inside(gy, gx);
          const size_t pix = in ? static_cast<size_t>(gy) * W + gx : 0;
#pragma unroll
          for (int j = 0; j < NTF; ++j) {
            const int n = 8 * j + 2 * t4;
            if (n >= JC) continue;
            float bf[2], sc[2] = {0.f, 0.f}, sh[2] = {0.f, 0.f};
            ldg_vec(bf, wp + G::BF + ch0 + n);
            if (in) {
              ldg_vec(sc, ci + pix * R + ch0 + n);
              ldg_vec(sh, ci + pix * R + C + ch0 + n);
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              acc[j][2 * h + e] = (acc[j][2 * h + e] + bf[e] + sh[e]) * sc[e];
            }
          }
        }
      };
#pragma unroll
      for (int u = 0; u < MZW; ++u) {
        finish(az[u], {zr[0][u], zr[1][u]}, r * JC);
      }
#pragma unroll
      for (int u = 0; u < MAW; ++u) {
        finish(aa[u], {ar[0][u], ar[1][u]}, CN + r * JC);
      }
      // every CTA runs and is done with the last tile's maps, and this
      // CTA's threads with the state window under s_z
      cluster_sync();
#pragma unroll
      for (int u = 0; u < MZW; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * (warp + kWarps * u) + g + 8 * h;
          if (row >= NW) continue;
          const int wy = row / WX, wx = row % WX;
          const bool tile_px = wy >= 2 && wy < TY + 2 && wx >= 2 &&
                               wx < TX + 2 && inside(y0 - 2 + wy, x0 - 2 + wx);
#pragma unroll
          for (int j = 0; j < NTF; ++j) {
            const int n = 8 * j + 2 * t4;
            if (n >= JC) continue;
            const float v[2] = {az[u][j][2 * h], az[u][j][2 * h + 1]};
            st_cluster<NC>(s_z + row * SZ + r * JC + n, v);
            if (tile_px) {
              st_vec(oi + (static_cast<size_t>(y0 - 2 + wy) * W + x0 - 2 +
                           wx) * C + r * JC + n,
                     v);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < MAW; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 16 * (a0 + kWarps * u) + g + 8 * h;
          if (q >= NO) continue;
#pragma unroll
          for (int j = 0; j < NTF; ++j) {
            const int n = 8 * j + 2 * t4;
            if (n >= JC) continue;
            *reinterpret_cast<float2*>(s_a2 + q * S2A + n) =
                make_float2(aa[u][j][2 * h], aa[u][j][2 * h + 1]);
          }
        }
      }
      cluster_sync();  // z1 on the window in every CTA
    }

    // ---- B: conv1, then conv2, the CTA's HC hidden channels ----
    {
      // two sums, a tap's even and odd chunks, added at the end
      float acc[MT1][NT1][4], acc2[MT1][NT1][4];
      zero(acc);
      zero(acc2);
      const int k0 = 8 * G::KW1 * ks1;
#pragma unroll 1
      for (int tp = 0; tp < 9; ++tp) {
        const float* a = s_z + ((tp / 3) * WX + tp % 3) * SZ + k0;
        const float* b = s_w1 + (tp * CN + k0) * B1 + 8 * NT1 * ng1;
#pragma unroll
        for (int c = 0; c < G::KW1; ++c) {
          mma_step<MT1, NT1>(c % 2 ? acc2 : acc, a + 8 * c, a1w[0], a1w[1],
                             b + 8 * c * B1, B1, 1, g, t4);
        }
      }
#pragma unroll
      for (int i = 0; i < MT1; ++i) {
#pragma unroll
        for (int j = 0; j < NT1; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += acc2[i][j][e];
        }
      }
      store_tiles(s_p + ks1 * NH * HC, acc, m01, NT1 * ng1, NH, HC, g, t4);
    }
    copy_w3(0);  // W3's first taps, in flight during conv2
    copy_w3(1);
    if (REV && first) {
      cluster_sync();  // every CTA runs before any remote store
    } else {
      __syncthreads();  // the partials
    }
#pragma unroll
    for (int u = 0; u < G::I1; ++u) {
      const int i = tid + u * kThreads;
      const int j = 4 * (i % (HC / 4)), p = i / (HC / 4);
      if (p >= NH) continue;
      const float4 s = sum_slices<G::KS1, NH, HC>(s_p, p, j);
      const float4 b = __ldg(reinterpret_cast<const float4*>(
          wp + G::AN1B + r * HC + j));
      const float4 e = __ldg(reinterpret_cast<const float4*>(
          wp + G::AN1E + r * HC + j));
      const float4 a = aff[u];
      const float h[4] = {fmaxf((s.x + a.x + b.x) * e.x, 0.f),
                          fmaxf((s.y + a.y + b.y) * e.y, 0.f),
                          fmaxf((s.z + a.z + b.z) * e.z, 0.f),
                          fmaxf((s.w + a.w + b.w) * e.w, 0.f)};
      st_cluster<NC>(s_h1 + p * SH + r * HC + j, h);
    }
    cluster_sync();  // the map after conv1, whole in every CTA
    {
      float acc[MT1][NT1][4];
      zero(acc);
      const int k0 = 8 * G::KW2 * ks1;
#pragma unroll
      for (int c = 0; c < G::KW2; ++c) {
        mma_step<MT1, NT1>(acc, s_h1 + k0 + 8 * c, a1h[0], a1h[1],
                           s_w2 + (k0 + 8 * c) * B1 + 8 * NT1 * ng1, B1, 1, g,
                           t4);
      }
      store_tiles(s_p + ks1 * NH * HC, acc, m01, NT1 * ng1, NH, HC, g, t4);
    }
    // the coupling reads the state and the records: this thread's items,
    // early (reverse)
    float cy[G::IC][4], cx1[G::IC][4], csc1[G::IC][4], csh1[G::IC][4];
    float csc2[G::IC][4], csh2[G::IC][4];
    if constexpr (REV) {
#pragma unroll
      for (int u = 0; u < G::IC; ++u) {
        const int i = tid + u * kThreads;
        const int j0 = 4 * (i % (JC / 4)), q = i / (JC / 4);
        const int gy = y0 + q / TX, gx = x0 + q % TX;
        if (q >= NO || gy >= H || gx >= W) continue;
        const size_t pix = static_cast<size_t>(gy) * W + gx;
        const int c1 = r * JC + j0, c2 = CN + c1;
        ldg_vec(cy[u], xi + pix * C + c2);
        ldg_vec(cx1[u], xi + pix * C + c1);
        ldg_vec(csc1[u], ci + pix * R + c1);
        ldg_vec(csh1[u], ci + pix * R + C + c1);
        ldg_vec(csc2[u], ci + pix * R + c2);
        ldg_vec(csh2[u], ci + pix * R + C + c2);
      }
    }
    __syncthreads();
    // after conv2 the map is ZEROED OUTSIDE THE IMAGE: conv3 pads its
    // input with zeros, where the map would carry the actnorm biases
    for (int i = tid; i < NH * (HC / 4); i += kThreads) {
      const int j = 4 * (i % (HC / 4)), p = i / (HC / 4);
      const float4 s = sum_slices<G::KS1, NH, HC>(s_p, p, j);
      const bool in = inside(y0 - 1 + p / HX, x0 - 1 + p % HX);
      const float4 b = __ldg(reinterpret_cast<const float4*>(
          wp + G::AN2B + r * HC + j));
      const float4 e = __ldg(reinterpret_cast<const float4*>(
          wp + G::AN2E + r * HC + j));
      const float h[4] = {in ? fmaxf((s.x + b.x) * e.x, 0.f) : 0.f,
                          in ? fmaxf((s.y + b.y) * e.y, 0.f) : 0.f,
                          in ? fmaxf((s.z + b.z) * e.z, 0.f) : 0.f,
                          in ? fmaxf((s.w + b.w) * e.w, 0.f) : 0.f};
      st_cluster<NC>(s_h2 + p * SH + r * HC + j, h);
    }
    cluster_sync();  // the map after conv2 in every CTA

    // ---- C: conv3 (the CTA's JC scale and JC shift columns) ----
    {
      float acc[MT3][NT3][4];
      zero(acc);
      tap_ring(copy_w3, [&](int tp) {
        const int k0 = 8 * G::KW3 * ks3;
        const float* a = s_h2 + ((tp / 3) * HX + tp % 3) * SH + k0;
        const float* b = s_r3 + (tp % 3) * G::LR3 + k0 * B3 + 8 * NT3 * ng3;
#pragma unroll
        for (int c = 0; c < G::KW3; ++c) {
          mma_step<MT3, NT3>(acc, a + 8 * c, a3h[0], a3h[1], b + 8 * c * B3,
                             B3, 1, g, t4);
        }
      });
      store_tiles(s_p3 + ks3 * NO * G::N3L, acc, m03, NT3 * ng3, NO, G::N3L,
                  g, t4);
    }
    if constexpr (REV) {
      cluster_sync();  // every CTA is done with h2, where t lands
    } else {
      __syncthreads();
    }
    // (scale, shift) -> forward: the coupled half; reverse: t of the CTA's
    // JC x1 and JC x2' channels, to every CTA; 4 channels an item
#pragma unroll
    for (int u = 0; u < G::IC; ++u) {
      const int i = tid + u * kThreads;
      const int j0 = 4 * (i % (JC / 4)), q = i / (JC / 4);
      const int gy = y0 + q / TX, gx = x0 + q % TX;
      if (q >= NO || gy >= H || gx >= W) continue;
      float as[4], at[4];
      ldg_vec(as, wp + G::B3W + r * JC + j0);
      ldg_vec(at, wp + G::B3W + CO + r * JC + j0);
#pragma unroll
      for (int k = 0; k < G::KS3; ++k) {  // slice order: fixed sums
        const float* pk = s_p3 + (k * NO + q) * G::N3L + j0;
        const float4 ps = ld4(pk), pt = ld4(pk + JC);
        as[0] += ps.x; as[1] += ps.y; as[2] += ps.z; as[3] += ps.w;
        at[0] += pt.x; at[1] += pt.y; at[2] += pt.z; at[3] += pt.w;
      }
      const int c1 = r * JC + j0;
      float y[4], t1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float scale = 1.f / (1.f + expf(-(as[e] + 2.f))) + kAffineEps;
        if constexpr (!REV) {
          y[e] = (s_a2[q * S2A + j0 + e] + at[e]) * scale;
        } else {
          t1[e] = cx1[u][e] / csc1[u][e] - csh1[u][e];
          y[e] = (cy[u][e] / scale - at[e]) / csc2[u][e] - csh2[u][e];
        }
      }
      if constexpr (!REV) {
        st_vec(oi + (static_cast<size_t>(gy) * W + gx) * C + CN + c1, y);
      } else {
        st_cluster<NC>(s_t + q * ST + c1, t1);
        st_cluster<NC>(s_t + q * ST + CN + c1, y);
      }
    }

    // ---- D (reverse): the folded inverse 1x1, the CTA's DR rows ----
    if constexpr (REV) {
      constexpr int MD = G::MD, MDW = G::MDW, NTD = G::NTD;
      cluster_sync();  // t whole in every CTA
      int d0[MDW], d1[MDW];
#pragma unroll
      for (int u = 0; u < MDW; ++u) {
        d0[u] = min(16 * (warp + kWarps * u) + g, NO - 1) * ST;
        d1[u] = min(16 * (warp + kWarps * u) + g + 8, NO - 1) * ST;
      }
      // two sums, the even and the odd K steps, added at the end: twice
      // the independent products in flight
      float acc[MDW][NTD][4], acc2[MDW][NTD][4];
      zero(acc);
      zero(acc2);
#pragma unroll 2
      for (int k = 0; k < C; k += 16) {
        mma_step<MDW, NTD>(acc, s_t + k, d0, d1, s_f + k, 1, SF, g, t4);
        mma_step<MDW, NTD>(acc2, s_t + k + 8, d0, d1, s_f + k + 8, 1, SF, g,
                           t4);
      }
#pragma unroll
      for (int u = 0; u < MDW; ++u) {
#pragma unroll
        for (int j = 0; j < NTD; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][j][e] += acc2[u][j][e];
        }
      }
#pragma unroll
      for (int u = 0; u < MDW; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 16 * (warp + kWarps * u) + g + 8 * h;
          const int gy = y0 + q / TX, gx = x0 + q % TX;
          if (q >= NO || gy >= H || gx >= W) continue;
          float* o = oi + (static_cast<size_t>(gy) * W + gx) * C + r * DR;
#pragma unroll
          for (int j = 0; j < NTD; ++j) {
            const int n = 8 * j + 2 * t4;
            float ab[2];
            ldg_vec(ab, wp + G::AB + r * DR + n);
            const float v[2] = {acc[u][j][2 * h] - ab[0],
                                acc[u][j][2 * h + 1] - ab[1]};
            st_vec(o + n, v);
          }
        }
      }
    }
    first = false;
  }
}

// the clusters of the width resident at once (found once)
template <int C, bool REV>
int wide_clusters(cudaLaunchConfig_t cfg, int* n) {
  using G = WGeo<C>;
  static int max_clusters = 0;
  if (max_clusters == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        flow_step_wide_kernel<C, REV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM * 4);
    if (err != cudaSuccess) return static_cast<int>(err);
    cfg.gridDim = dim3(G::NC, 1, 1);
    int m = 0;
    const cudaError_t e2 = cudaOccupancyMaxActiveClusters(
        &m, reinterpret_cast<const void*>(flow_step_wide_kernel<C, REV>),
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
template <int C, bool REV>
int launch_wide(const float* x, const float* cond, const float* wp,
                float* out, int B, int H, int W, cudaStream_t stream) {
  using G = WGeo<C>;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G::NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = G::SMEM * 4;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const int err = wide_clusters<C, REV>(cfg, &clusters);
  if (err != 0) return err;
  const long long tiles = static_cast<long long>(B) *
                          ((H + G::TY - 1) / G::TY) *
                          ((W + G::TX - 1) / G::TX);
  if (tiles > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int ncl = static_cast<int>(tiles < clusters ? tiles : clusters);
  cfg.gridDim = dim3(G::NC * ncl, 1, 1);
  const cudaError_t e2 = cudaLaunchKernelEx(
      &cfg, flow_step_wide_kernel<C, REV>, x, cond, wp, out, B, H, W);
  if (e2 != cudaSuccess) return static_cast<int>(e2);
  return static_cast<int>(cudaGetLastError());
}

template <bool REV>
int dispatch(const void* x, const void* cond, const void* packed, void* out,
             int B, int H, int W, int C, int hid, void* stream) {
  if (hid != kHid || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(cond);
  const float* wp = static_cast<const float*>(packed);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 12: return launch<12, REV>(xp, cp, wp, op, B, H, W, st);
    case 24: return launch<24, REV>(xp, cp, wp, op, B, H, W, st);
    case 48: return launch_wide<48, REV>(xp, cp, wp, op, B, H, W, st);
    case 96: return launch<96, REV>(xp, cp, wp, op, B, H, W, st);
    case 192: return launch_wide<192, REV>(xp, cp, wp, op, B, H, W, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, out: (B, H, W, C) NHWC; cond: (B, H, W, 2C + hid) records [scale_ft |
// shift_ft | aff1_ft]; packed: the step's weights (flow_step.py:pack_step),
// shared by the batch.  C must be 12, 24, 48, 96 or 192, hid 64 and B <=
// 65535;
// every pointer 16-byte aligned.
extern "C" int flow_step_forward(const void* x, const void* cond,
                                 const void* packed, void* out, int B, int H,
                                 int W, int C, int hid, void* stream) {
  return dispatch<false>(x, cond, packed, out, B, H, W, C, hid, stream);
}

extern "C" int flow_step_reverse(const void* x, const void* cond,
                                 const void* packed, void* out, int B, int H,
                                 int W, int C, int hid, void* stream) {
  return dispatch<true>(x, cond, packed, out, B, H, W, C, hid, stream);
}
