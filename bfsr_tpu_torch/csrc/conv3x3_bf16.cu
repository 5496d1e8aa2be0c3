// K3 at passes=1 (the bf16 serving modes): 3x3 stride-1 SAME convolution
// over an implicit channel concat of 1-5 NHWC float32 inputs, operands
// rounded to bf16 (round to nearest even), products accumulated in f32 on
// the tensor cores, then a per-channel f32 scale/bias epilogue (folded
// BatchNorm + conv bias) and an optional ReLU / LeakyReLU.  Batch 1; any H
// and W; Cout 8, 16, 32, 64 or a multiple of 64.
//
// Replaces bfsr_tpu/ops/pallas/s2d_conv.py:_kernel at passes=1, and is the
// conv that profiling/mosaic_probe.py (kern_a/b/c) lays out three ways in
// space-to-depth.  Not carried over: the s2d phase packing, the hi/lo
// split and the 8/128 alignment pads.
//
// What bounds it on this card: bf16 tensor-core throughput at the UNet's
// 512^2 convs (2*9*Cin*Cout flop per pixel against ~4*(Cin + Cout) bytes:
// 70-300 flop/B, near the 295 flop/B where the H100's bf16 rate and its
// memory rate balance); for a first kernel, its shared-memory traffic.
// Design: an implicit GEMM.  M is the output pixels: a block of 4 warps
// owns a 4-row x 32-column tile, each warp one row of it, as two 16-pixel
// M fragments.  N is Cout, in blocks of up to 64 (a grid dimension above
// 64).  K is 9 taps x the input channels, staged 16 channels of one input
// at a time: the (4+2) x (32+2) halo tile goes to shared memory rounded to
// bf16 (the one rounding of the activations) with each pixel's 16 channels
// contiguous, so the A fragment of tap (dy, dx) is a row-major view of it
// with ldm = 16 at a 32-byte aligned pixel; the 9 taps' 16 x NB weight
// slab (already bf16, laid out at freeze()) is copied beside it with rows
// padded to NB + 8 so the B fragment loads do not conflict on banks.
// Channels past an input's count (Cin 3, 6, the dense blocks' odd blocks)
// stage as zeros.  nvcuda::wmma 16x16x16 bf16 fragments with f32
// accumulators; each warp holds 2 x NB/16 accumulators for the whole K
// loop, then writes them through a per-warp 16x16 f32 staging tile with
// the epilogue applied, masked at the ragged edges.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kWarps = 4;             // output rows per block, one per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxInputs = 5;
constexpr int kK = 16;                // input channels per stage (MMA depth)
constexpr int kMF = 2;                // 16-pixel M fragments per warp
constexpr int kTileW = 16 * kMF;      // output columns per block
constexpr int kHR = kWarps + 2;       // halo rows
constexpr int kHC = kTileW + 2;       // halo columns
constexpr int kMaxNB = 64;            // output channels per block

struct ConvInputs {
  const float* x[kMaxInputs];           // (H, W, cin[i]) NHWC, f32
  const __nv_bfloat16* w[kMaxInputs];   // (cin[i], 3, 3, cout_p), bf16
  int cin[kMaxInputs];
  int n_in;
};

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

template <int NF>  // 16-wide N fragments per block: NB = 16 * NF
__global__ void __launch_bounds__(kThreads)
conv3x3_bf16_kernel(ConvInputs in, const float* __restrict__ scale,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int H, int W, int cout, int cout_p, int act,
                    float slope) {
  constexpr int NB = 16 * NF;
  constexpr int LDW = NB + 8;  // padded weight row (elements)
  __shared__ __align__(128) __nv_bfloat16 s_in[kHR * kHC * kK];
  __shared__ __align__(128) __nv_bfloat16 s_w[9 * kK * LDW];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kWarps;
  const int n0 = blockIdx.z * NB;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMF][NF];
#pragma unroll
  for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[mf][j], 0.f);

  for (int ii = 0; ii < in.n_in; ++ii) {
    const float* __restrict__ x = in.x[ii];
    const __nv_bfloat16* __restrict__ w = in.w[ii];
    const int ci = in.cin[ii];
    const bool vec = ci % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    for (int c0 = 0; c0 < ci; c0 += kK) {
      __syncthreads();  // the previous stage's fragments are loaded
      // halo tile, 4 channels per item, rounded to bf16 once, here
      for (int e = tid; e < kHR * kHC * 4; e += kThreads) {
        const int g = e & 3, p = e >> 2;
        const int r = p / kHC, col = p - r * kHC;
        const int gy = y0 + r - 1, gx = x0 + col - 1, ch = c0 + 4 * g;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && ch < ci) {
          const float* src = x + (static_cast<size_t>(gy) * W + gx) * ci + ch;
          if (vec) {
            v = *reinterpret_cast<const float4*>(src);
          } else {
            v.x = src[0];
            if (ch + 1 < ci) v.y = src[1];
            if (ch + 2 < ci) v.z = src[2];
            if (ch + 3 < ci) v.w = src[3];
          }
        }
        *reinterpret_cast<uint2*>(s_in + p * kK + 4 * g) =
            make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      }
      // weight slab: row (tap, k) holds NB output channels from n0
      for (int e = tid; e < 9 * kK * (NB / 8); e += kThreads) {
        const int v8 = e % (NB / 8);
        const int row = e / (NB / 8);
        const int tap = row / kK, k = row % kK;
        const int ch = c0 + k;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (ch < ci) {
          val = *reinterpret_cast<const uint4*>(
              w + (static_cast<size_t>(ch) * 9 + tap) * cout_p + n0 + 8 * v8);
        }
        *reinterpret_cast<uint4*>(s_w + row * LDW + 8 * v8) = val;
      }
      __syncthreads();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b[NF];
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          wmma::load_matrix_sync(b[j], s_w + tap * kK * LDW + 16 * j, LDW);
        }
#pragma unroll
        for (int mf = 0; mf < kMF; ++mf) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a;
          wmma::load_matrix_sync(
              a, s_in + ((warp + dy) * kHC + mf * 16 + dx) * kK, kK);
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            wmma::mma_sync(acc[mf][j], a, b[j], acc[mf][j]);
          }
        }
      }
    }
  }

  __syncthreads();  // s_in is free: each warp stages its tiles there
  float* stage = reinterpret_cast<float*>(s_in) + warp * 256;
  const int gy = y0 + warp;
  const int m = lane >> 1, half = lane & 1;
#pragma unroll
  for (int mf = 0; mf < kMF; ++mf) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(stage, acc[mf][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gx = x0 + mf * 16 + m;
      const int co = n0 + 16 * j + 8 * half;
      if (gy < H && gx < W && co < cout) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float t = stage[m * 16 + 8 * half + e];
          t = t * (scale ? scale[co + e] : 1.f) + (bias ? bias[co + e] : 0.f);
          if (act == 1) t = fmaxf(t, 0.f);
          else if (act == 2) t = t >= 0.f ? t : t * slope;
          v[e] = t;
        }
        float4* dst = reinterpret_cast<float4*>(
            out + (static_cast<size_t>(gy) * W + gx) * cout + co);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
      __syncwarp();
    }
  }
}

template <int NF>
void launch(const ConvInputs& in, const float* scale, const float* bias,
            float* out, int H, int W, int cout, int cout_p, int act,
            float slope, cudaStream_t stream) {
  dim3 grid((W + kTileW - 1) / kTileW, (H + kWarps - 1) / kWarps,
            cout_p / (16 * NF));
  conv3x3_bf16_kernel<NF><<<grid, kThreads, 0, stream>>>(
      in, scale, bias, out, H, W, cout, cout_p, act, slope);
}

}  // namespace

// xs[i]: (H, W, cins[i]) NHWC f32; ws[i]: (cins[i], 3, 3, cout_p) bf16 with
// cout_p = cout rounded up to 16 (zero columns past cout); scale, bias:
// (cout,) f32, or null for 1 / 0; out: (H, W, cout) f32.  act: 0 none,
// 1 relu, 2 leaky relu.  cout must be a multiple of 8 with cout_p 16, 32,
// 64 or a multiple of 64; 1 <= n_in <= 5.
extern "C" int conv3x3_cat_bf16(int n_in, const void* const* xs,
                                const void* const* ws, const int* cins,
                                const void* scale, const void* bias,
                                void* out, int H, int W, int cout, int act,
                                float slope, void* stream) {
  const int cout_p = (cout + 15) / 16 * 16;
  if (n_in < 1 || n_in > kMaxInputs || cout <= 0 || cout % 8 != 0 ||
      (cout_p > kMaxNB && cout_p % kMaxNB != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (H <= 0 || W <= 0) return 0;
  ConvInputs in{};
  in.n_in = n_in;
  for (int i = 0; i < n_in; ++i) {
    in.x[i] = static_cast<const float*>(xs[i]);
    in.w[i] = static_cast<const __nv_bfloat16*>(ws[i]);
    in.cin[i] = cins[i];
  }
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cout_p >= kMaxNB ? kMaxNB : cout_p) {
    case 16: launch<1>(in, s, b, o, H, W, cout, cout_p, act, slope, st); break;
    case 32: launch<2>(in, s, b, o, H, W, cout, cout_p, act, slope, st); break;
    case 64: launch<4>(in, s, b, o, H, W, cout, cout_p, act, slope, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
