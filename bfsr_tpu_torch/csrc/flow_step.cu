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
// flops, 29 K at C=12 up to 193 K at C=96, against (C + (2C+64) + C) * 4
// bytes of state and conditioning moved: 260-830 flop/B, far above the
// card's 20 flop/B (67 TFLOP/s f32 over 3.35 TB/s).  At LR 128^2 the
// least time per launch is 28.6 / 12.4 / 11.8 us at levels 1 / 2 / 3.
// The sums are f32 FMA (no TF32), in a fixed order: two launches on the
// same inputs give the same bits.
//
// Design.  A block of 256 threads owns a TY x TX tile of output pixels.
// Every product is an implicit GEMM on register tiles fed from shared
// memory, where the step's weights are copied once per block with 16-byte
// cp.async (the packed layout puts every block of it on a 16-byte
// boundary):
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
// W2 stays whole in shared memory.  W1 and W3 come in chunks of WT taps:
// whole at C = 12 and 24; three taps at a time at C = 48; one tap at a
// time at C = 96 and 192 (whole they would not fit), through a two-slot
// cp.async ring, so chunk t+1's copy overlaps chunk t's FMAs.  The folds
// (C x C) sit in shared memory up to C = 96; at C = 192 (144 KB) they do
// not fit beside the rest, and stages A and D read them from global
// memory (L2: every block reads the same 147 KB; the lanes of a warp read
// one address at a time, a broadcast).  W3's first chunk is copied during
// conv2 into the space the window, the fold and W1 leave.  Global reads
// and writes of the state and records are float2 / float4 vectors.
//
// Tiles (set by timing candidates side by side with
// bfsr_tpu_torch/profiling/k5_times.py, NVIDIA H100 80GB HBM3, 700.00 W):
// 8 x 16 at C=12 (2 blocks per SM; 512 blocks at 256^2 fill 264 slots in
// 1.94 waves), 16 x 8 at C=24 and 4 x 8 at C=96 (one block per SM, 128
// blocks at 128^2 and 64^2).  On that card: 0.083 / 0.037 / 0.057 ms
// forward and 0.083 / 0.038 / 0.047 ms reverse at 256^2 x 12 / 128^2 x 24 /
// 64^2 x 96, 35 / 34 / 21-25% of the bound above.  The 8x model's levels
// (k5_times.py --levels x8, same card): 4 x 8 at C = 48 (128 blocks at
// 64^2; 8 x 8 slower, 8 x 4 level), 0.029 / 0.027 ms forward / reverse,
// 20-22% of the bound; 2 x 4 at C = 192 (128 blocks at 32^2, 180 at the
// trainer's 12 x 10^2; 4 x 4, 4 x 8, 4 x 2 and 2 x 2 slower), 0.091 /
// 0.057 ms, 7 / 11%: that level is bound by latency, not arithmetic, and
// its forward by the fold read through L2 on the window (6 x 8 pixels for
// a 2 x 4 tile).
// What holds it there: besides the halo recompute (the hidden region is
// 1.4x / 1.4x / 1.9x the tile), the global reads of the records' halo, the
// weight copies (57 KB a block at C=12) and the stage barriers take about
// a third of the time at C=12 and up to half at C=96, where one block per
// SM has 8 warps to hide them; conv2 runs near the FMA peak, conv1 and
// conv3 near 60% of it.

#include <cuda_runtime.h>

#include <cstdint>

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
// forward fold and the inverse fold; MINB blocks per SM; FS: the folds in
// shared memory (else read from global memory).
template <int C> struct Tile;
template <> struct Tile<12> {
  static constexpr int TY = 8, TX = 16, PMH = 6, PM3 = 2, LG3 = 1;
  static constexpr int WT = 9, QA = 6, QD = 12, MINB = 2, FS = 1;
};
template <> struct Tile<24> {
  static constexpr int TY = 16, TX = 8, PMH = 6, PM3 = 4, LG3 = 2;
  static constexpr int WT = 9, QA = 12, QD = 12, MINB = 1, FS = 1;
};
template <> struct Tile<48> {
  static constexpr int TY = 4, TX = 8, PMH = 2, PM3 = 2, LG3 = 2;
  static constexpr int WT = 3, QA = 12, QD = 12, MINB = 1, FS = 1;
};
template <> struct Tile<96> {
  static constexpr int TY = 4, TX = 8, PMH = 2, PM3 = 4, LG3 = 4;
  static constexpr int WT = 1, QA = 16, QD = 16, MINB = 1, FS = 1;
};
template <> struct Tile<192> {
  static constexpr int TY = 2, TX = 4, PMH = 1, PM3 = 1, LG3 = 4;
  static constexpr int WT = 1, QA = 16, QD = 16, MINB = 1, FS = 0;
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
  static constexpr bool FS = T::FS;
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
  //   s_x: the window, the fold (FS) and the W1 slots; then the
  //        W3 slots; then (reverse, FS) the inverse fold
  static constexpr int FF = FS ? C * C : 0;  // fold floats in s_x
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
  if constexpr (!REV && G::FS) {
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
      const float* wr = (G::FS ? s_x + G::X_FOLD : wp + G::WF) + g * QA * C;
      float acc[QA];
#pragma unroll
      for (int q = 0; q < QA; ++q) acc[q] = 0.f;
#pragma unroll 2
      for (int c4 = 0; c4 < C / 4; ++c4) {
        const float4 v = __ldg(xr + c4);
#pragma unroll
        for (int q = 0; q < QA; ++q) {
          const float4 w = ldf4<G::FS>(wr + q * C + 4 * c4);
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
  if constexpr (REV && G::FS) {  // the inverse fold, in flight now
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
      const float* wr = (G::FS ? s_x : wp + G::WI) + g * QD * C;
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
          const float4 w = ldf4<G::FS>(wr + q * C + 4 * c4);
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
    case 48: return launch<48, REV>(xp, cp, wp, op, B, H, W, st);
    case 96: return launch<96, REV>(xp, cp, wp, op, B, H, W, st);
    case 192: return launch<192, REV>(xp, cp, wp, op, B, H, W, st);
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
