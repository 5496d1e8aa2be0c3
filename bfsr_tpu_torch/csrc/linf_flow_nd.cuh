// K4: the LINF pointwise flow at general d (the patch model, d = 3 ps^2),
// forward (z only) and inverse.
//
// Replaces bfsr_tpu/ops/pallas/linf_flow.py:_forward_kernel_nd and
// :_inverse_kernel_nd (the generic-d channel-major Pallas kernels).
//
// Per query, forward: for each of L layers z <- W_i z + b_i, then
// z <- z * (sigmoid(s_i + 2) + 1e-4) + t_i with s_i the info rows
// 2di..2di+d-1 and t_i the next d rows; a final z <- W_L z + b_L.
// Inverse: x <- W^-1_L (z - b_L), then for i = L-1..0:
// x <- (x - t_i) / scale_i and x <- W^-1_i (x - b_i), with the W^-1 cached
// in float64 at load and a divide, as the Pallas kernel does.
//
// What bounds it on this card: bytes.  Per query it reads 2dL info floats
// and d inputs and writes d (2,376 B at d = 27, L = 10) for ~2 d^2 (L+1)
// flops (~16 kflop), about 7 flop/B, under the H100's ~20 flop/B balance
// point.  The TPU forms are gone: no (32, N) / (544, N) row pads, no
// (d, tile) MXU blocks.  Design: one thread per query with the d-vector
// in registers (d a template parameter: 12, 27, 48, fully unrolled); the
// layers' weights and biases pass through shared memory one layer at a
// time, double-buffered (the next layer's load is issued into registers
// before this layer's products and stored after them, so any L fits), and
// are read as warp-wide broadcast float4s from rows padded to a multiple
// of 4; the info is read channel-major (2dL, N), as K2 writes it, so a
// warp's load of one info row is one contiguous line; z is (N, d)
// row-major, the layout of the prior's NHWC latent.  The sigmoid is expf,
// as in K1.  Each direction's C entry is its own source
// (linf_flow_nd_forward.cu, linf_flow_nd_inverse.cu), so the two unrolled
// template sets compile in parallel.

#pragma once

#include <cuda_runtime.h>

namespace bfsr_k4 {

constexpr float kAffineEps = 1e-4f;
constexpr int kThreads = 64;  // few queries per block: spread over the SMs

__device__ __forceinline__ float affine_scale(float s) {
  return 1.f / (1.f + expf(-(s + 2.f))) + kAffineEps;
}

template <int D>
struct Layout {
  static constexpr int kDP = (D + 3) / 4 * 4;        // padded row stride
  static constexpr int kStage = D * kDP + kDP;       // W rows, then b
  static constexpr int kElems = D * D + D;           // what one layer holds
  static constexpr int kPer = (kElems + kThreads - 1) / kThreads;
};

// This thread's share of one layer's W (d x d) and b (d), from global.
template <int D>
__device__ __forceinline__ void fetch_layer(float (&r)[Layout<D>::kPer],
                                            const float* __restrict__ w,
                                            const float* __restrict__ b,
                                            int layer) {
#pragma unroll
  for (int k = 0; k < Layout<D>::kPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    float v = 0.f;
    if (e < D * D) {
      v = w[static_cast<size_t>(layer) * D * D + e];
    } else if (e < Layout<D>::kElems) {
      v = b[static_cast<size_t>(layer) * D + e - D * D];
    }
    r[k] = v;
  }
}

template <int D>
__device__ __forceinline__ void store_layer(const float (&r)[Layout<D>::kPer],
                                            float* __restrict__ s) {
  constexpr int DP = Layout<D>::kDP;
#pragma unroll
  for (int k = 0; k < Layout<D>::kPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (e < D * D) {
      s[(e / D) * DP + e % D] = r[k];
    } else if (e < Layout<D>::kElems) {
      s[D * DP + e - D * D] = r[k];
    }
  }
}

// out[r] = sum_c W[r][c] v[c] over the padded rows of a staged layer.
template <int D>
__device__ __forceinline__ void matvec(const float* __restrict__ sw,
                                       const float (&v)[D], float (&out)[D]) {
  constexpr int DP = Layout<D>::kDP;
#pragma unroll
  for (int r = 0; r < D; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < DP; c4 += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(sw + r * DP + c4);
      acc += wv.x * v[c4];
      if (c4 + 1 < D) acc += wv.y * v[c4 + 1];
      if (c4 + 2 < D) acc += wv.z * v[c4 + 2];
      if (c4 + 3 < D) acc += wv.w * v[c4 + 3];
    }
    out[r] = acc;
  }
}

template <int D, bool kInverse>
__global__ void __launch_bounds__(kThreads)
flow_nd_kernel(const float* __restrict__ w, const float* __restrict__ b,
               const float* __restrict__ x, const float* __restrict__ info,
               float* __restrict__ out, int n, int n_layers) {
  constexpr int DP = Layout<D>::kDP;
  constexpr int ST = Layout<D>::kStage;
  __shared__ __align__(16) float smem[2 * ST];
  // the row pads stay zero: store_layer never writes them
  for (int i = threadIdx.x; i < 2 * ST; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = q < n;
  const size_t stride = static_cast<size_t>(n);
  float v[D], t[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    v[c] = valid ? x[static_cast<size_t>(q) * D + c] : 0.f;
  }

  // stage s runs layer s (forward) or layer L - s (inverse)
  float pre[Layout<D>::kPer];
  fetch_layer<D>(pre, w, b, kInverse ? n_layers : 0);
  store_layer<D>(pre, smem);
  __syncthreads();
  for (int s = 0; s <= n_layers; ++s) {
    const int layer = kInverse ? n_layers - s : s;
    const float* sw = smem + (s & 1) * ST;
    const float* sb = sw + D * DP;
    if (s < n_layers) fetch_layer<D>(pre, w, b, kInverse ? layer - 1 : layer + 1);
    if (!kInverse) {
      matvec<D>(sw, v, t);
      if (layer < n_layers) {
        const float* row = info + static_cast<size_t>(2 * D * layer) * stride + q;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const float sc = valid ? row[c * stride] : 0.f;
          const float sh = valid ? row[(D + c) * stride] : 0.f;
          v[c] = (t[c] + sb[c]) * affine_scale(sc) + sh;
        }
      } else {
#pragma unroll
        for (int c = 0; c < D; ++c) v[c] = t[c] + sb[c];
      }
    } else {
      if (layer < n_layers) {
        const float* row = info + static_cast<size_t>(2 * D * layer) * stride + q;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const float sc = valid ? row[c * stride] : 0.f;
          const float sh = valid ? row[(D + c) * stride] : 0.f;
          v[c] = (v[c] - sh) / affine_scale(sc);
        }
      }
#pragma unroll
      for (int c = 0; c < D; ++c) t[c] = v[c] - sb[c];
      matvec<D>(sw, t, v);
    }
    if (s < n_layers) {
      // the other buffer was last read in stage s - 1, before its barrier
      store_layer<D>(pre, smem + ((s + 1) & 1) * ST);
      __syncthreads();
    }
  }
  if (valid) {
#pragma unroll
    for (int c = 0; c < D; ++c) out[static_cast<size_t>(q) * D + c] = v[c];
  }
}

template <bool kInverse>
int launch(const void* w, const void* b, const void* x, const void* info,
           void* out, int n, int n_layers, int d, void* stream) {
  if (n_layers < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BFSR_ARGS                                                           \
  static_cast<const float*>(w), static_cast<const float*>(b),              \
      static_cast<const float*>(x), static_cast<const float*>(info),       \
      static_cast<float*>(out), n, n_layers
  switch (d) {
    case 12: flow_nd_kernel<12, kInverse><<<blocks, kThreads, 0, st>>>(BFSR_ARGS); break;
    case 27: flow_nd_kernel<27, kInverse><<<blocks, kThreads, 0, st>>>(BFSR_ARGS); break;
    case 48: flow_nd_kernel<48, kInverse><<<blocks, kThreads, 0, st>>>(BFSR_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BFSR_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bfsr_k4
