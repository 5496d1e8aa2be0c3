// K5 at passes=1 (BFSR_PRECISION=default): one fused conditional SRFlow
// FlowStep (eval, no log-det), forward and reverse, with bf16-rounded
// operands (round to nearest even) in some of its five products and every
// sum in f32.  Batch 1, NHWC state (H, W, C) with C in {12, 24, 96},
// coupling hidden width 64, any H and W.  Two forms, a template flag:
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
// actnorm vectors, b3, the gain, the sigmoid and the coupling.
//
// Where each product runs:
//   - conv2 (64 -> 64, per hidden pixel) and conv3 (9 taps x 64 -> 2co) on
//     the tensor cores: nvcuda::wmma m16n16k16 bf16 fragments, f32
//     accumulators; conv3's 2co = 12 / 24 is padded to 16 / 32 columns with
//     zero weights (in the buffer);
//   - the C x C folds and conv1 (9 taps x cn, cn = 6 / 12 / 48) as f32 FMA:
//     conv1 (and the Pallas form's folds) on rounded values, where a product
//     of two bf16 values is exact in f32, so this is the same function.  The
//     buffer keeps these weights in f32 words (bf16 values where rounded),
//     read as the f32 kernel reads its own.
// Not carried over from the TPU kernel: the 128-lane pads, the 8-column
// halos, the level-1 space-to-depth phases, the hi/lo split, the VMEM tile
// budget.
//
// What bounds it on this card: at the bf16 rate, bytes.  Per pixel a step
// moves (C + (2C + 64) + C) * 4 bytes and does 2*C*C + 2*9*cn*64 + 2*64*64
// + 2*9*64*C flops (29 K at C = 12 to 193 K at C = 96): 65-232 flop/B,
// under the 295 flop/B where the H100's bf16 rate and its memory rate
// balance.  For this first form, the SIMT products (conv1 and the folds, on
// a halo that grows with small tiles) are the larger cost.
//
// Design: the f32 kernel's (csrc/flow_step.cu), with a tile whose rows are
// one tensor-core M fragment.  A block of 256 threads owns a TY x 16 tile of
// output pixels:
//   A. z1 on the (TY+4) x 20 window (2-pixel halo: two stacked 3x3 convs),
//      rounded to bf16 once here and zero outside the image; forward also
//      keeps za's second half (f32) for the tile and writes z1 (f32, not
//      rounded) to the output;
//   B. conv1 + aff1_ft, actnorm1 + ReLU on the (TY+2) x 18 hidden region,
//      stored as bf16 with a pixel stride of 80 (160 bytes: every pixel
//      starts a 32-byte aligned fragment row, rows spread over the banks);
//      then conv2 on the tensor cores, one warp per 16-pixel fragment of
//      the flat hidden region: it loads the fragment's 64 channels, then
//      writes actnorm2 + ReLU back over them in place (no other warp reads
//      those pixels), ZEROED OUTSIDE THE IMAGE: conv3 pads its input with
//      zeros, and the hidden map there carries the actnorm biases;
//   C. conv3 on the tensor cores: one warp per (output row, 16 columns of
//      2co): 9 taps x 4 k-steps, A from the hidden map at the tap's offset,
//      B from the buffer (L1/L2); the sums go to shared memory, then
//      (scale, shift) -> the coupled half;
//   D. (reverse only) the ft affine and the folded inverse 1x1.
// Tiles: 8 x 16 at C = 12 (512 blocks at 256^2), 4 x 16 at C = 24 (256 at
// 128^2), 2 x 16 at C = 96 (128 at 64^2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHid = 64;
constexpr int kTX = 16;          // output columns: one M fragment per row
constexpr int kSH = kHid + 16;   // hidden-map pixel stride, bf16 (160 B)
constexpr float kAffineEps = 1e-4f;

// per level: output rows TY; conv1 channel groups GB; stage D groups GD
template <int C> struct Tile;
template <> struct Tile<12> { static constexpr int TY = 8, GB = 4, GD = 1; };
template <> struct Tile<24> { static constexpr int TY = 4, GB = 4, GD = 3; };
template <> struct Tile<96> { static constexpr int TY = 2, GB = 8, GD = 6; };

constexpr int rup128(int n) { return (n + 127) / 128 * 128; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int C, bool PALLAS>
struct Geo {
  static constexpr int CN = C / 2, CO = C - C / 2, R = 2 * C + kHid;
  static constexpr int N3 = (2 * CO + 15) / 16 * 16;  // conv3 columns
  static constexpr int TY = Tile<C>::TY, TX = kTX;
  static constexpr int HY = TY + 2, HX = TX + 2, NH = HY * HX;
  static constexpr int NHP = (NH + 15) / 16 * 16;     // conv2 M, padded
  static constexpr int WY = TY + 4, WX = TX + 4, NW = WY * WX;
  static constexpr int NO = TY * TX;
  static constexpr int GB = Tile<C>::GB, QB = kHid / GB;
  static constexpr int GD = Tile<C>::GD, QD = C / GD;
  // z1 pixel stride (bf16): even, with an odd number of 32-bit words, so
  // the pixel-parallel reads of conv1 are free of bank conflicts
  static constexpr int SZ = (CN / 2) % 2 ? CN : CN + 2;
  // the buffer (bfsr_tpu_torch/ops/cuda/flow_step.py:_layout_bf16): f32
  // words first, offsets in floats; the XLA form's gain G3 after b3
  static constexpr int BF = 0, AB = BF + C, AN1B = AB + C;
  static constexpr int AN1E = AN1B + kHid, AN2B = AN1E + kHid;
  static constexpr int AN2E = AN2B + kHid, B3 = AN2E + kHid, G3 = B3 + N3;
  static constexpr int WF = PALLAS ? G3 : G3 + N3, WI = WF + C * C;
  static constexpr int W1 = WI + C * C;
  static constexpr int NWORDS = (W1 + 9 * CN * kHid + 7) / 8 * 8;
  // then bf16 values, offsets in bf16 from the buffer's start
  static constexpr int W2 = 2 * NWORDS, W3 = W2 + kHid * kHid;
  // shared memory, in bytes
  static constexpr int S_H = 0;                                  // (NHP, kSH) bf16
  static constexpr int S_O = S_H + rup128(NHP * kSH * 2);        // (NO, N3) f32
  static constexpr int S_2 = S_O + rup128(cmax(NO * N3, kWarps * 256) * 4);
  static constexpr int S_Z = S_2 + rup128(NO * CO * 4);          // (NW, SZ) bf16
  static constexpr int SMEM = S_Z + rup128(NW * SZ * 2);
  static_assert(C % 4 == 0 && CN == CO && CN % 2 == 0, "C");
  static_assert(QB % 8 == 0 && C % GD == 0, "channel groups");
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

// 8 floats -> 8 bf16 at a 16-byte aligned shared address
__device__ __forceinline__ void store8_bf16(__nv_bfloat16* dst,
                                            const float* v) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// acc[i] += a * w[i], i < N, w a 16-byte aligned row (N % 4 == 0)
template <int N>
__device__ __forceinline__ void fma_run(float (&acc)[N], float a,
                                        const float* __restrict__ w) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(w) + i);
    acc[4 * i] += a * v.x;
    acc[4 * i + 1] += a * v.y;
    acc[4 * i + 2] += a * v.z;
    acc[4 * i + 3] += a * v.w;
  }
}

template <int N>
__device__ __forceinline__ void load_run(float (&v)[N],
                                         const float* __restrict__ p) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
    v[4 * i] = q.x;
    v[4 * i + 1] = q.y;
    v[4 * i + 2] = q.z;
    v[4 * i + 3] = q.w;
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

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int C, bool REV, bool PALLAS>
__global__ void __launch_bounds__(kThreads, C == 96 ? 1 : 2)
flow_step_bf16_kernel(const float* __restrict__ x,
                      const float* __restrict__ cond,
                      const __nv_bfloat16* __restrict__ wb,
                      float* __restrict__ out, int H, int W) {
  using G = Geo<C, PALLAS>;
  constexpr int CN = G::CN, CO = G::CO, R = G::R, N3 = G::N3;
  constexpr int TX = G::TX, TY = G::TY, HX = G::HX, WX = G::WX, SZ = G::SZ;
  const float* __restrict__ wf = reinterpret_cast<const float*>(wb);
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_h = reinterpret_cast<__nv_bfloat16*>(smem + G::S_H);
  float* s_o = reinterpret_cast<float*>(smem + G::S_O);
  float* s_2 = reinterpret_cast<float*>(smem + G::S_2);
  __nv_bfloat16* s_z = reinterpret_cast<__nv_bfloat16*>(smem + G::S_Z);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;

  // ---- A: z1 on the window, bf16 (zero outside the image) ----
  if constexpr (!REV) {
    for (int i = tid; i < 2 * G::NW; i += kThreads) {
      const int p = i % G::NW, g = i / G::NW;  // g 0: z1, g 1: za[cn:]
      const int wy = p / WX, wx = p % WX;
      const int gy = y0 - 2 + wy, gx = x0 - 2 + wx;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const bool interior = wy >= 2 && wy < TY + 2 && wx >= 2 && wx < TX + 2;
      if (!in) {
        if (g == 0) {
          for (int q = 0; q < CN; ++q) s_z[p * SZ + q] = __float2bfloat16_rn(0.f);
        }
        continue;
      }
      if (g == 1 && !interior) continue;
      const size_t pix = static_cast<size_t>(gy) * W + gx;
      float xv[C];
      load_run<C>(xv, x + pix * C);
      if constexpr (PALLAS) {
#pragma unroll
        for (int c = 0; c < C; ++c) xv[c] = round_bf16(xv[c]);  // product 1
      }
      const float* rec = cond + pix * R;
      const int o0 = g * CN;
#pragma unroll 1
      for (int q = 0; q < CN; ++q) {
        const int o = o0 + q;
        const float zf = dot_row<C>(xv, wf + G::WF + o * C) + __ldg(wf + G::BF + o);
        const float za = (zf + __ldg(rec + C + o)) * __ldg(rec + o);
        if (g == 0) {
          s_z[p * SZ + q] = __float2bfloat16_rn(za);  // product 2
          if (interior) out[pix * C + q] = za;
        } else {
          s_2[((wy - 2) * TX + (wx - 2)) * CO + q] = za;
        }
      }
    }
  } else {
    for (int i = tid; i < G::NW * CN; i += kThreads) {
      const int p = i / CN, q = i % CN;
      const int wy = p / WX, wx = p % WX;
      const int gy = y0 - 2 + wy, gx = x0 - 2 + wx;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = __ldg(x + (static_cast<size_t>(gy) * W + gx) * C + q);
      }
      s_z[p * SZ + q] = __float2bfloat16_rn(v);  // product 2
    }
  }
  __syncthreads();

  // ---- B1: conv1 + aff1_ft, actnorm1 + ReLU -> bf16 hidden map ----
  {
    constexpr int QB = G::QB;
    for (int i = tid; i < G::NHP * G::GB; i += kThreads) {
      const int p = i % G::NHP, g = i / G::NHP;
      __nv_bfloat16* hrow = s_h + p * kSH + g * QB;
      float acc[QB];
#pragma unroll
      for (int q = 0; q < QB; ++q) acc[q] = 0.f;
      if (p >= G::NH) {  // conv2's padding rows
#pragma unroll
        for (int q = 0; q < QB; q += 8) store8_bf16(hrow + q, acc + q);
        continue;
      }
      const int hy = p / HX, hx = p % HX;
      const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        load_run<QB>(acc, cond + (static_cast<size_t>(gy) * W + gx) * R +
                              2 * C + g * QB);
      }
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const __nv_bfloat16* zrow =
            s_z + ((hy + tap / 3) * WX + hx + tap % 3) * SZ;
        const float* wrow = wf + G::W1 + tap * CN * kHid + g * QB;
#pragma unroll 2
        for (int c = 0; c < CN; c += 2) {
          const float2 z2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(zrow + c));
          fma_run<QB>(acc, z2.x, wrow + c * kHid);
          fma_run<QB>(acc, z2.y, wrow + (c + 1) * kHid);
        }
      }
      float b[QB], e[QB];
      load_run<QB>(b, wf + G::AN1B + g * QB);
      load_run<QB>(e, wf + G::AN1E + g * QB);
#pragma unroll
      for (int q = 0; q < QB; ++q) acc[q] = fmaxf((acc[q] + b[q]) * e[q], 0.f);
#pragma unroll
      for (int q = 0; q < QB; q += 8) store8_bf16(hrow + q, acc + q);  // product 3
    }
  }
  __syncthreads();

  // ---- B2: conv2 on the tensor cores, actnorm2 + ReLU + mask in place ----
  {
    float* stage = s_o + warp * 256;  // this warp's 16 x 16 f32 tile
    const int r = lane >> 1, half = lane & 1;
    for (int mf = warp; mf < G::NHP / 16; mf += kWarps) {
      __nv_bfloat16* arow = s_h + mf * 16 * kSH;
      FragA a[kHid / 16];
#pragma unroll
      for (int k = 0; k < kHid / 16; ++k) {
        wmma::load_matrix_sync(a[k], arow + 16 * k, kSH);
      }
      __syncwarp();  // every lane holds its A values before any write-back
      const int p = mf * 16 + r;
      const int hy = p / HX, hx = p % HX;
      const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
      const bool keep = p < G::NH && gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int j = 0; j < kHid / 16; ++j) {
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int k = 0; k < kHid / 16; ++k) {
          FragB b;
          wmma::load_matrix_sync(b, wb + G::W2 + 16 * k * kHid + 16 * j, kHid);
          wmma::mma_sync(acc, a[k], b, acc);
        }
        wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
        __syncwarp();
        const int c0 = 16 * j + 8 * half;
        float v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float h = (stage[r * 16 + 8 * half + t] +
                           __ldg(wf + G::AN2B + c0 + t)) *
                          __ldg(wf + G::AN2E + c0 + t);
          v[t] = keep ? fmaxf(h, 0.f) : 0.f;
        }
        store8_bf16(arow + r * kSH + c0, v);  // product 4
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // ---- C: conv3 on the tensor cores -> (scale, shift) -> coupled half ----
  {
    constexpr int NJ = N3 / 16;
    for (int it = warp; it < TY * NJ; it += kWarps) {
      const int oy = it / NJ, j = it % NJ;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const __nv_bfloat16* arow = s_h + ((oy + tap / 3) * HX + tap % 3) * kSH;
        const __nv_bfloat16* brow = wb + G::W3 + tap * kHid * N3 + 16 * j;
#pragma unroll
        for (int k = 0; k < kHid / 16; ++k) {
          FragA a;
          FragB b;
          wmma::load_matrix_sync(a, arow + 16 * k, kSH);
          wmma::load_matrix_sync(b, brow + 16 * k * N3, N3);
          wmma::mma_sync(acc, a, b, acc);
        }
      }
      wmma::store_matrix_sync(s_o + oy * TX * N3 + 16 * j, acc, N3,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = tid; i < G::NO * CO; i += kThreads) {
    const int p = i / CO, j = i % CO;
    const int gy = y0 + p / TX, gx = x0 + p % TX;
    if (gy >= H || gx >= W) continue;
    const size_t pix = static_cast<size_t>(gy) * W + gx;
    float as = s_o[p * N3 + j] + __ldg(wf + G::B3 + j);
    float at = s_o[p * N3 + CO + j] + __ldg(wf + G::B3 + CO + j);
    if constexpr (!PALLAS) {  // the gain after conv3, as the XLA step
      as *= __ldg(wf + G::G3 + j);
      at *= __ldg(wf + G::G3 + CO + j);
    }
    const float scale = 1.f / (1.f + expf(-(as + 2.f))) + kAffineEps;
    if constexpr (!REV) {
      out[pix * C + CN + j] = (s_2[p * CO + j] + at) * scale;
    } else {
      s_2[p * CO + j] = __ldg(x + pix * C + CN + j) / scale - at;
    }
  }

  // ---- D (reverse): ft affine, then the folded inverse 1x1 ----
  if constexpr (REV) {
    __syncthreads();
    constexpr int QD = G::QD;
    for (int i = tid; i < G::NO * G::GD; i += kThreads) {
      const int p = i % G::NO, g = i / G::NO;
      const int gy = y0 + p / TX, gx = x0 + p % TX;
      if (gy >= H || gx >= W) continue;  // never divides off the image
      const size_t pix = static_cast<size_t>(gy) * W + gx;
      const float* rec = cond + pix * R;
      float t[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float v = c < CN ? __ldg(x + pix * C + c) : s_2[p * CO + c - CN];
        t[c] = v / __ldg(rec + c) - __ldg(rec + C + c);
        if constexpr (PALLAS) t[c] = round_bf16(t[c]);  // product 5
      }
#pragma unroll 1
      for (int q = 0; q < QD; ++q) {
        const int o = g * QD + q;
        out[pix * C + o] = dot_row<C>(t, wf + G::WI + o * C) - __ldg(wf + G::AB + o);
      }
    }
  }
}

template <int C, bool REV, bool PALLAS>
int launch(const float* x, const float* cond, const __nv_bfloat16* wb,
           float* out, int H, int W, cudaStream_t stream) {
  using G = Geo<C, PALLAS>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flow_step_bf16_kernel<C, REV, PALLAS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((W + G::TX - 1) / G::TX, (H + G::TY - 1) / G::TY);
  flow_step_bf16_kernel<C, REV, PALLAS><<<grid, kThreads, G::SMEM, stream>>>(
      x, cond, wb, out, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <bool REV, bool PALLAS>
int dispatch(const void* x, const void* cond, const void* packed, void* out,
             int H, int W, int C, int hid, void* stream) {
  if (hid != kHid) return static_cast<int>(cudaErrorInvalidValue);
  if (H <= 0 || W <= 0) return 0;
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(cond);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(packed);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 12: return launch<12, REV, PALLAS>(xp, cp, wp, op, H, W, st);
    case 24: return launch<24, REV, PALLAS>(xp, cp, wp, op, H, W, st);
    case 96: return launch<96, REV, PALLAS>(xp, cp, wp, op, H, W, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, out: (H, W, C) NHWC f32; cond: (H, W, 2C + hid) records [scale_ft |
// shift_ft | aff1_ft]; packed: the step's one-pass buffer in the entry's
// form (flow_step.py:pack_step_bf16), 32-byte aligned.  C must be 12, 24 or
// 96 and hid 64; x and cond 16-byte aligned.
extern "C" int flow_step_bf16_forward(const void* x, const void* cond,
                                      const void* packed, void* out, int H,
                                      int W, int C, int hid, void* stream) {
  return dispatch<false, false>(x, cond, packed, out, H, W, C, hid, stream);
}

extern "C" int flow_step_bf16_reverse(const void* x, const void* cond,
                                      const void* packed, void* out, int H,
                                      int W, int C, int hid, void* stream) {
  return dispatch<true, false>(x, cond, packed, out, H, W, C, hid, stream);
}

extern "C" int flow_step_bf16_pallas_forward(const void* x, const void* cond,
                                             const void* packed, void* out,
                                             int H, int W, int C, int hid,
                                             void* stream) {
  return dispatch<false, true>(x, cond, packed, out, H, W, C, hid, stream);
}

extern "C" int flow_step_bf16_pallas_reverse(const void* x, const void* cond,
                                             const void* packed, void* out,
                                             int H, int W, int C, int hid,
                                             void* stream) {
  return dispatch<true, true>(x, cond, packed, out, H, W, C, hid, stream);
}
