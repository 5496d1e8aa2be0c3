// K3: 3x3 stride-1 SAME convolution over an implicit channel concat of 1-5
// NHWC inputs, with a per-channel scale/bias epilogue (folded BatchNorm +
// conv bias) and an optional ReLU / LeakyReLU.  Float32, any batch: the
// image is blockIdx.z, and every input and the output are offset by whole
// images, so a batch-1 launch is the launch it was before the batch.
//
// Replaces bfsr_tpu/ops/pallas/s2d_conv.py:_kernel (the space-to-depth
// Pallas conv the encoder and the UNet's full-resolution stages run on).
// What it computes is kept; the TPU workarounds are not: no space-to-depth
// phase packing, no 3-pass bf16 split (this kernel accumulates in f32 FMA),
// no 8/128 alignment pads and no even-H/W restriction.
//
// What bounds it on this card: f32 FMA throughput.  At Cout 32-64 and
// Cin 3-192 the conv does 2*9*Cin*Cout flops per pixel against
// ~4*(Cin + Cout) bytes, i.e. 30-130 flop/B: compute-bound for an f32 SIMT
// kernel.  At the RRDB's 128^2 convs (16,384 pixels) the work is also too
// small to fill 132 SMs with one block per 256 output pixels.
//
// Design: an implicit GEMM, M = a tile of output pixels, N = Cout, K = 9 *
// Cin.  Each thread keeps 8 pixels (consecutive in x) x 8 output channels
// in registers, 64 accumulators.  For each input channel and tap row it
// reads a row of 10 halo values (two float4 and a float2) once and reuses
// it for the 3 horizontal taps, with 8 weights (two float4) per tap: 192
// FMAs per 9 shared loads.  A block of 256 threads owns TH x 32 pixels and
// all Cout channels; where TH x 32 x Cout is less than 256 x 64, KS slices
// of its threads split each stage's channels among them (a split of K
// inside the block) and add their partial sums in a fixed order at the end
// through shared memory: deterministic, with no second pass and no atomics.
// Input channels stream through shared memory KC at a time in a
// double-buffered cp.async ring: a (TH+2) x 34 halo tile of the current
// input, channel-major with 36-float rows (4-byte copies, zero-filled
// outside the image and past the input's channels), and the 9 x KC x Cout
// weight slab (16-byte copies), so stage t+1's copies overlap stage t's
// FMAs.  Tiles per launch: TH = 8 where that still gives every SM 4
// blocks (the UNet's 512^2 convs), else TH = 2 at Cout 32 and 64 (256
// blocks at 128^2; KS = 8 and 4), 4 at Cout 16.  Every input has its own
// pointer and weight block: the concat is never built.  The weight is
// (Cin, 3, 3, Cout) over the concatenated channels, so each input's block is
// a contiguous slice of one tensor that the caller lays out once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxInputs = 5;
constexpr int kTileW = 32;  // output columns per block
constexpr int kPxT = 8;     // output pixels per thread (consecutive in x)
constexpr int kCoT = 8;     // output channels per thread
constexpr int kHCP = 36;    // halo row stride, floats (34 used)

struct ConvInputs {
  const float* x[kMaxInputs];  // (B, H, W, cin[i]) NHWC
  const float* w[kMaxInputs];  // (cin[i], 3, 3, Cout)
  int cin[kMaxInputs];
  int n_in;
};

template <int COUT, int TH_>
struct Cfg {
  static constexpr int TH = TH_, NCOG = COUT / kCoT;
  static constexpr int PXG = TH * (kTileW / kPxT);  // 8-pixel groups
  static constexpr int SLICE = PXG * NCOG;           // threads per slice
  static constexpr int KS = kThreads / SLICE;        // K slices
  static constexpr int KC = KS == 1 ? 8 : 16;        // channels per stage
  static constexpr int CPS = KC / KS;                // per slice per stage
  static constexpr int HR = TH + 2;
  static constexpr int SA = KC * HR * kHCP;          // halo floats
  static constexpr int SB = 9 * KC * COUT;           // slab floats
  static constexpr int STAGE = SA + SB;
  static constexpr int RED = KS > 1 ? KS * TH * kTileW * COUT : 0;
  static constexpr int FLOATS = 2 * STAGE > RED ? 2 * STAGE : RED;
  static_assert(kThreads % SLICE == 0 && KC % KS == 0, "slices");
};

// in.x[i] etc. with a run-time i, read from the kernel's parameters by an
// unrolled select (an indexed read would copy them to local memory)
template <class V>
__device__ __forceinline__ V pick(const V (&a)[kMaxInputs], int i) {
  V v = a[0];
#pragma unroll
  for (int k = 1; k < kMaxInputs; ++k) {
    if (k == i) v = a[k];
  }
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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

__device__ __forceinline__ float act_fn(float v, int act, float slope) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return v >= 0.f ? v : v * slope;
  return v;
}

template <int COUT, int TH>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_cat_kernel(ConvInputs in, const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int H, int W, int act, float slope) {
  using G = Cfg<COUT, TH>;
  constexpr int KC = G::KC, HR = G::HR;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int slice = tid / G::SLICE, t2 = tid % G::SLICE;
  const int cog = t2 % G::NCOG, pg = t2 / G::NCOG;
  const int prow = pg / (kTileW / kPxT);
  const int pcol = (pg % (kTileW / kPxT)) * kPxT;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * TH;
  // pixels before this block's image, in every input and the output
  const size_t img_px = static_cast<size_t>(blockIdx.z) * H * W;
  out += img_px * COUT;

  int n_stages = 0;
#pragma unroll
  for (int i = 0; i < kMaxInputs; ++i) {
    if (i < in.n_in) n_stages += (in.cin[i] + KC - 1) / KC;
  }

  int li = 0, lc = 0;  // input and first channel of the next stage to load
  auto load_stage = [&](int slot) {
    float* s_a = smem + slot * G::STAGE;
    float* s_b = s_a + G::SA;
    const int ci = pick(in.cin, li);
    const float* x = pick(in.x, li) + img_px * ci;
    const float* w = pick(in.w, li);
    // halo [c][r][col]: channel fastest in the global read
    for (int e = tid; e < KC * HR * (kTileW + 2); e += kThreads) {
      const int c = e % KC, rest = e / KC;
      const int col = rest % (kTileW + 2), r = rest / (kTileW + 2);
      const int gy = y0 + r - 1, gx = x0 + col - 1, ch = lc + c;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ch < ci;
      const float* src =
          ok ? x + (static_cast<size_t>(gy) * W + gx) * ci + ch : x;
      cp_async4(s_a + (c * HR + r) * kHCP + col, src, ok ? 4 : 0);
    }
    // weight slab [tap][c][COUT]
    for (int e = tid; e < 9 * KC * (COUT / 4); e += kThreads) {
      const int q = e % (COUT / 4), row = e / (COUT / 4);
      const int tap = row / KC, c = row % KC, ch = lc + c;
      const bool ok = ch < ci;
      const float* src =
          ok ? w + (static_cast<size_t>(ch) * 9 + tap) * COUT + 4 * q : w;
      cp_async16(s_b + row * COUT + 4 * q, src, ok ? 16 : 0);
    }
    lc += KC;
    if (lc >= ci) {
      ++li;
      lc = 0;
    }
  };

  float acc[kPxT][kCoT];
#pragma unroll
  for (int p = 0; p < kPxT; ++p)
#pragma unroll
    for (int j = 0; j < kCoT; ++j) acc[p][j] = 0.f;

  load_stage(0);
  cp_async_commit();
  for (int t = 0; t < n_stages; ++t) {
    if (t + 1 < n_stages) load_stage((t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage t landed
    const float* s_a = smem + (t & 1) * G::STAGE;
    const float* s_b = s_a + G::SA;
#pragma unroll 2
    for (int cc = 0; cc < G::CPS; ++cc) {
      const int c = slice * G::CPS + cc;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* row = s_a + (c * HR + prow + dy) * kHCP + pcol;
        const float4 r0 = *reinterpret_cast<const float4*>(row);
        const float4 r1 = *reinterpret_cast<const float4*>(row + 4);
        const float2 r2 = *reinterpret_cast<const float2*>(row + 8);
        const float xv[kPxT + 2] = {r0.x, r0.y, r0.z, r0.w, r1.x,
                                    r1.y, r1.z, r1.w, r2.x, r2.y};
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wr = s_b + ((dy * 3 + dx) * KC + c) * COUT + cog * kCoT;
          const float4 w0 = *reinterpret_cast<const float4*>(wr);
          const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
          const float wv[kCoT] = {w0.x, w0.y, w0.z, w0.w,
                                  w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int p = 0; p < kPxT; ++p) {
            const float a = xv[p + dx];
#pragma unroll
            for (int j = 0; j < kCoT; ++j) acc[p][j] += a * wv[j];
          }
        }
      }
    }
    __syncthreads();  // slot t & 1 is free for stage t + 2
  }
  cp_async_wait<0>();

  if constexpr (G::KS == 1) {
    const int gy = y0 + prow;
    if (gy >= H) return;
    const int co = cog * kCoT;
    float sc[kCoT], bi[kCoT];
#pragma unroll
    for (int j = 0; j < kCoT; ++j) {
      sc[j] = scale ? __ldg(scale + co + j) : 1.f;
      bi[j] = bias ? __ldg(bias + co + j) : 0.f;
    }
#pragma unroll
    for (int p = 0; p < kPxT; ++p) {
      const int gx = x0 + pcol + p;
      if (gx >= W) break;
      float v[kCoT];
#pragma unroll
      for (int j = 0; j < kCoT; ++j) {
        v[j] = act_fn(acc[p][j] * sc[j] + bi[j], act, slope);
      }
      float4* dst = reinterpret_cast<float4*>(
          out + (static_cast<size_t>(gy) * W + gx) * COUT + co);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  } else {
    // the slices' partial sums [slice][pixel][COUT], added in slice order
    constexpr int NPX = TH * kTileW;
    float* red = smem;
#pragma unroll
    for (int p = 0; p < kPxT; ++p) {
      float4* dst = reinterpret_cast<float4*>(
          red + (slice * NPX + prow * kTileW + pcol + p) * COUT + cog * kCoT);
      dst[0] = make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
      dst[1] = make_float4(acc[p][4], acc[p][5], acc[p][6], acc[p][7]);
    }
    __syncthreads();
    for (int e = tid; e < NPX * (COUT / 4); e += kThreads) {
      const int px = e / (COUT / 4), co = (e % (COUT / 4)) * 4;
      const int gy = y0 + px / kTileW, gx = x0 + px % kTileW;
      if (gy >= H || gx >= W) continue;
      float4 s = *reinterpret_cast<const float4*>(red + px * COUT + co);
#pragma unroll
      for (int k = 1; k < G::KS; ++k) {
        const float4 v =
            *reinterpret_cast<const float4*>(red + (k * NPX + px) * COUT + co);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = act_fn(v[j] * (scale ? __ldg(scale + co + j) : 1.f) +
                          (bias ? __ldg(bias + co + j) : 0.f),
                      act, slope);
      }
      *reinterpret_cast<float4*>(out + (static_cast<size_t>(gy) * W + gx) *
                                           COUT + co) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <int COUT, int TH>
int launch_tile(const ConvInputs& in, const float* scale, const float* bias,
                float* out, int B, int H, int W, int act, float slope,
                cudaStream_t stream) {
  constexpr int bytes = Cfg<COUT, TH>::FLOATS * 4;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_cat_kernel<COUT, TH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + TH - 1) / TH, B);
  conv3x3_cat_kernel<COUT, TH><<<grid, kThreads, bytes, stream>>>(
      in, scale, bias, out, H, W, act, slope);
  return static_cast<int>(cudaGetLastError());
}

// TH = 8 where it still gives every SM 4 blocks over the batch, else the
// small tile
template <int COUT, int TH_SMALL>
int launch(const ConvInputs& in, const float* scale, const float* bias,
           float* out, int B, int H, int W, int act, float slope,
           cudaStream_t stream) {
  const long big = static_cast<long>((W + kTileW - 1) / kTileW) *
                   ((H + 7) / 8) * B;
  if (big >= 4L * num_sms()) {
    return launch_tile<COUT, 8>(in, scale, bias, out, B, H, W, act, slope,
                                stream);
  }
  return launch_tile<COUT, TH_SMALL>(in, scale, bias, out, B, H, W, act,
                                     slope, stream);
}

}  // namespace

// xs[i]: (B, H, W, cins[i]) NHWC; ws[i]: (cins[i], 3, 3, cout), 16-byte
// aligned; scale, bias: (cout,), or null for 1 / 0; out: (B, H, W, cout).
// act: 0 none, 1 relu, 2 leaky relu.  cout must be 8, 16, 32 or 64;
// 1 <= n_in <= 5; B <= 65535.
extern "C" int conv3x3_cat(int n_in, const void* const* xs,
                           const void* const* ws, const int* cins,
                           const void* scale, const void* bias, void* out,
                           int B, int H, int W, int cout, int act,
                           float slope, void* stream) {
  if (n_in < 1 || n_in > kMaxInputs || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  ConvInputs in{};
  in.n_in = n_in;
  for (int i = 0; i < n_in; ++i) {
    in.x[i] = static_cast<const float*>(xs[i]);
    in.w[i] = static_cast<const float*>(ws[i]);
    in.cin[i] = cins[i];
    if (cins[i] <= 0 || (reinterpret_cast<uintptr_t>(ws[i]) & 15) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 8: return launch<8, 8>(in, s, b, o, B, H, W, act, slope, st);
    case 16: return launch<16, 4>(in, s, b, o, B, H, W, act, slope, st);
    case 32: return launch<32, 2>(in, s, b, o, B, H, W, act, slope, st);
    case 64: return launch<64, 2>(in, s, b, o, B, H, W, act, slope, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
