// K5: one fused conditional SRFlow FlowStep (eval, no log-det), forward and
// reverse, float32.  Batch 1, NHWC state (H, W, C) with C in {12, 24, 96}
// (the three flow levels) and coupling hidden width 64.
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
//
// Design.  A block of 256 threads owns a TY x TX tile of output pixels and
// keeps everything the step needs for it in shared memory:
//   A. the z1 half of the state on the (TY+4) x (TX+4) window (2-pixel
//      halo: two stacked 3x3 convs), zero outside the image; forward also
//      keeps za's second half for the tile and writes z1 to the output;
//   B. the hidden map on (TY+2) x (TX+2) x 64: conv1 over z1 plus the
//      precomputed aff1_ft, actnorm + ReLU, then the 1x1 conv2 in place
//      (each pixel's 64 channels are read, synced, then overwritten),
//      actnorm + ReLU, and ZEROED OUTSIDE THE IMAGE: the reference pads
//      conv3's input with zeros, while the hidden map there carries the
//      actnorm biases, so a kernel without this mask is wrong on a
//      1-pixel frame;
//   C. conv3 on the tile -> (scale, shift) -> the coupled half;
//   D. (reverse only) the ft affine and the folded inverse 1x1, after the
//      tower, as the reverse order requires.
// Every stage is a loop of (pixel, channel group) items with its
// accumulators in registers; the weights (one packed buffer per step, laid
// out at freeze()) are read with warp-uniform __ldg float4 loads, served
// from L1/L2.  Tiles: 14x14 at C=12 and 14x6 at C=24 (hidden region 256 /
// 128 pixels), 6x6 at C=96 (64 pixels, 121 blocks at 64^2), so each level
// fills the card.  Odd shared-memory row strides keep the pixel-parallel
// reads free of bank conflicts.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHid = 64;
constexpr float kAffineEps = 1e-4f;

// per-level tiling: output tile TY x TX; GC / GD channel groups of stages
// C and D (their items are pixel x group)
template <int C> struct Tile;
template <> struct Tile<12> { static constexpr int TY = 14, TX = 14, GC = 1, GD = 1; };
template <> struct Tile<24> { static constexpr int TY = 14, TX = 6, GC = 3, GD = 3; };
template <> struct Tile<96> { static constexpr int TY = 6, TX = 6, GC = 6, GD = 6; };

// acc[i] += a * w[i], i < N; w 16-byte aligned when N % 4 == 0
template <int N>
__device__ __forceinline__ void fma_run(float (&acc)[N], float a,
                                        const float* __restrict__ w) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(w) + i);
      acc[4 * i] += a * v.x;
      acc[4 * i + 1] += a * v.y;
      acc[4 * i + 2] += a * v.z;
      acc[4 * i + 3] += a * v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += a * __ldg(w + i);
  }
}

template <int N>
__device__ __forceinline__ void load_run(float (&v)[N],
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
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __ldg(p + i);
  }
}

// sum_c v[c] * w[c], w a 16-byte aligned row of N (N % 4 == 0) floats
template <int N>
__device__ __forceinline__ float dot_row(const float (&v)[N],
                                         const float* __restrict__ w) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(w) + i);
    acc += v[4 * i] * q.x;
    acc += v[4 * i + 1] * q.y;
    acc += v[4 * i + 2] * q.z;
    acc += v[4 * i + 3] * q.w;
  }
  return acc;
}

template <int C>
struct Geo {
  static constexpr int CN = C / 2, CO = C - C / 2, R = 2 * C + kHid;
  static constexpr int TY = Tile<C>::TY, TX = Tile<C>::TX;
  static constexpr int HY = TY + 2, HX = TX + 2, NH = HY * HX;
  static constexpr int WY = TY + 4, WX = TX + 4, NW = WY * WX;
  static constexpr int NO = TY * TX;
  static constexpr int GB = kThreads / NH, QB = kHid / GB;
  static constexpr int GC = Tile<C>::GC, QJ = CO / GC;
  static constexpr int GD = Tile<C>::GD, QD = C / GD;
  static constexpr int SZ = CN | 1, SH = kHid + 1;  // odd smem strides
  // packed weights (bfsr_tpu_torch/ops/cuda/flow_step.py:_layout)
  static constexpr int WF = 0, BF = C * C, WI = BF + C, AB = WI + C * C;
  static constexpr int W1 = AB + C, AN1B = W1 + 9 * CN * kHid;
  static constexpr int AN1E = AN1B + kHid, W2 = AN1E + kHid;
  static constexpr int AN2B = W2 + kHid * kHid, AN2E = AN2B + kHid;
  static constexpr int W3 = AN2E + kHid, B3 = W3 + 9 * kHid * 2 * CO;
  static constexpr int SMEM_FLOATS = NW * SZ + NH * SH + NO * CO;
  static_assert(C % 4 == 0 && CN == CO, "C must be a multiple of 4");
  static_assert(NH * GB == kThreads && QB % 4 == 0, "hidden tiling");
  static_assert(CO % GC == 0 && C % GD == 0, "channel groups");
};

template <int C, bool REV>
__global__ void __launch_bounds__(kThreads, C == 96 ? 1 : 2)
flow_step_kernel(const float* __restrict__ x, const float* __restrict__ cond,
                 const float* __restrict__ wp, float* __restrict__ out,
                 int H, int W) {
  using G = Geo<C>;
  constexpr int CN = G::CN, CO = G::CO, R = G::R;
  constexpr int TX = G::TX, TY = G::TY, HX = G::HX, WX = G::WX;
  constexpr int SZ = G::SZ, SH = G::SH;
  extern __shared__ float smem[];
  float* s_z1 = smem;                  // (WY * WX, SZ): z1 on the window
  float* s_h = s_z1 + G::NW * SZ;      // (HY * HX, SH): hidden map
  float* s_2 = s_h + G::NH * SH;       // (NO, CO): fwd za[cn:], rev x2'

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;

  // ---- A: z1 on the window (zero outside the image) ----
  if constexpr (!REV) {
    for (int i = tid; i < 2 * G::NW; i += kThreads) {
      const int p = i % G::NW, g = i / G::NW;  // g 0: z1, g 1: za[cn:]
      const int wy = p / WX, wx = p % WX;
      const int gy = y0 - 2 + wy, gx = x0 - 2 + wx;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const bool interior = wy >= 2 && wy < TY + 2 && wx >= 2 && wx < TX + 2;
      if (!in) {
        if (g == 0) {
          for (int q = 0; q < CN; ++q) s_z1[p * SZ + q] = 0.f;
        }
        continue;
      }
      if (g == 1 && !interior) continue;
      const size_t pix = static_cast<size_t>(gy) * W + gx;
      float xv[C];
      load_run<C>(xv, x + pix * C);
      const float* rec = cond + pix * R;
      const int o0 = g * CN;
#pragma unroll 1
      for (int q = 0; q < CN; ++q) {
        const int o = o0 + q;
        const float zf = dot_row<C>(xv, wp + G::WF + o * C) + __ldg(wp + G::BF + o);
        const float za = (zf + __ldg(rec + C + o)) * __ldg(rec + o);
        if (g == 0) {
          s_z1[p * SZ + q] = za;
          if (interior) out[pix * C + q] = za;
        } else {
          s_2[((wy - 2) * TX + (wx - 2)) * CO + q] = za;
        }
      }
    }
  } else {
    for (int p = tid; p < G::NW; p += kThreads) {
      const int wy = p / WX, wx = p % WX;
      const int gy = y0 - 2 + wy, gx = x0 - 2 + wx;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const float* xp = x + (static_cast<size_t>(gy) * W + gx) * C;
        for (int q = 0; q < CN; ++q) s_z1[p * SZ + q] = __ldg(xp + q);
      } else {
        for (int q = 0; q < CN; ++q) s_z1[p * SZ + q] = 0.f;
      }
    }
  }
  __syncthreads();

  // ---- B: hidden map on the (TY+2) x (TX+2) region ----
  {
    constexpr int QB = G::QB;
    const int p = tid % G::NH, g = tid / G::NH;
    const int hy = p / HX, hx = p % HX;
    const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float acc[QB];
    if (in) {
      load_run<QB>(acc, cond + (static_cast<size_t>(gy) * W + gx) * R + 2 * C +
                            g * QB);
    } else {
#pragma unroll
      for (int q = 0; q < QB; ++q) acc[q] = 0.f;
    }
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const float* zrow = s_z1 + ((hy + tap / 3) * WX + hx + tap % 3) * SZ;
      const float* wrow = wp + G::W1 + tap * CN * kHid + g * QB;
#pragma unroll 2
      for (int c = 0; c < CN; ++c) fma_run<QB>(acc, zrow[c], wrow + c * kHid);
    }
    float b[QB], e[QB];
    load_run<QB>(b, wp + G::AN1B + g * QB);
    load_run<QB>(e, wp + G::AN1E + g * QB);
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      s_h[p * SH + g * QB + q] = fmaxf((acc[q] + b[q]) * e[q], 0.f);
      acc[q] = 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kHid; ++k) {
      fma_run<QB>(acc, s_h[p * SH + k], wp + G::W2 + k * kHid + g * QB);
    }
    __syncthreads();  // every read of this pixel's row is done
    load_run<QB>(b, wp + G::AN2B + g * QB);
    load_run<QB>(e, wp + G::AN2E + g * QB);
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      s_h[p * SH + g * QB + q] = in ? fmaxf((acc[q] + b[q]) * e[q], 0.f) : 0.f;
    }
  }
  __syncthreads();

  // ---- C: conv3 -> (scale, shift) -> the coupled half ----
  constexpr int QJ = G::QJ;
  for (int i = tid; i < G::NO * G::GC; i += kThreads) {
    const int p = i % G::NO, g = i / G::NO;
    const int oy = p / TX, ox = p % TX;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy >= H || gx >= W) continue;
    float as[QJ], at[QJ];
    load_run<QJ>(as, wp + G::B3 + g * QJ);
    load_run<QJ>(at, wp + G::B3 + CO + g * QJ);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const float* hrow = s_h + ((oy + tap / 3) * HX + ox + tap % 3) * SH;
      const float* wrow = wp + G::W3 + tap * kHid * 2 * CO + g * QJ;
#pragma unroll 2
      for (int k = 0; k < kHid; ++k) {
        const float a = hrow[k];
        fma_run<QJ>(as, a, wrow + k * 2 * CO);
        fma_run<QJ>(at, a, wrow + k * 2 * CO + CO);
      }
    }
    const size_t pix = static_cast<size_t>(gy) * W + gx;
#pragma unroll
    for (int q = 0; q < QJ; ++q) {
      const int j = g * QJ + q;
      const float scale = 1.f / (1.f + expf(-(as[q] + 2.f))) + kAffineEps;
      if constexpr (!REV) {
        out[pix * C + CN + j] = (s_2[p * CO + j] + at[q]) * scale;
      } else {
        s_2[p * CO + j] = __ldg(x + pix * C + CN + j) / scale - at[q];
      }
    }
  }

  // ---- D (reverse): ft affine, then the folded inverse 1x1 ----
  if constexpr (REV) {
    __syncthreads();
    constexpr int QD = G::QD;
    for (int i = tid; i < G::NO * G::GD; i += kThreads) {
      const int p = i % G::NO, g = i / G::NO;
      const int oy = p / TX, ox = p % TX;
      const int gy = y0 + oy, gx = x0 + ox;
      if (gy >= H || gx >= W) continue;
      const size_t pix = static_cast<size_t>(gy) * W + gx;
      const float* rec = cond + pix * R;
      float t[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float v = c < CN ? __ldg(x + pix * C + c) : s_2[p * CO + c - CN];
        t[c] = v / __ldg(rec + c) - __ldg(rec + C + c);
      }
#pragma unroll 1
      for (int q = 0; q < QD; ++q) {
        const int o = g * QD + q;
        out[pix * C + o] = dot_row<C>(t, wp + G::WI + o * C) - __ldg(wp + G::AB + o);
      }
    }
  }
}

template <int C, bool REV>
int launch(const float* x, const float* cond, const float* wp, float* out,
           int H, int W, cudaStream_t stream) {
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
  const dim3 grid((W + G::TX - 1) / G::TX, (H + G::TY - 1) / G::TY);
  flow_step_kernel<C, REV><<<grid, kThreads, smem, stream>>>(x, cond, wp, out,
                                                             H, W);
  return static_cast<int>(cudaGetLastError());
}

template <bool REV>
int dispatch(const void* x, const void* cond, const void* packed, void* out,
             int H, int W, int C, int hid, void* stream) {
  if (hid != kHid) return static_cast<int>(cudaErrorInvalidValue);
  if (H <= 0 || W <= 0) return 0;
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(cond);
  const float* wp = static_cast<const float*>(packed);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 12: return launch<12, REV>(xp, cp, wp, op, H, W, st);
    case 24: return launch<24, REV>(xp, cp, wp, op, H, W, st);
    case 96: return launch<96, REV>(xp, cp, wp, op, H, W, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, out: (H, W, C) NHWC; cond: (H, W, 2C + hid) records [scale_ft |
// shift_ft | aff1_ft]; packed: the step's weights (flow_step.py:pack_step).
// C must be 12, 24 or 96 and hid 64; every pointer 16-byte aligned.
extern "C" int flow_step_forward(const void* x, const void* cond,
                                 const void* packed, void* out, int H, int W,
                                 int C, int hid, void* stream) {
  return dispatch<false>(x, cond, packed, out, H, W, C, hid, stream);
}

extern "C" int flow_step_reverse(const void* x, const void* cond,
                                 const void* packed, void* out, int H, int W,
                                 int C, int hid, void* stream) {
  return dispatch<true>(x, cond, packed, out, H, W, C, hid, stream);
}
