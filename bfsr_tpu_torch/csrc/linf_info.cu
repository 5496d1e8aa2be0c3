// K2: LINF per-query affine info on a regular HR query grid, fully fused.
//
// Replaces bfsr_tpu/ops/pallas/linf_info.py:_kernel.  For each HR query
// (row y, col x) of an H x W grid over an h x w LR feature map:
//   * the 4 nearest LR corners under half-cell diagonal shifts, found by
//     separable index math with round-half-even (rintf), in the corner
//     order mm, mp, pm, pp (y-shift outer, x-shift inner);
//   * the relative offsets (coord - corner center) * (h, w);
//   * the diagonal-swapped area weights a_{3-k} / sum(a), a = |ry rx| + 1e-9;
//   * the Fourier basis [cos | sin](pi (freq[:C/2] ry + freq[C/2:] rx +
//     phase)), by sincospif;
//   * per corner, (weight * coef) * basis times that corner's C-row block
//     of W1, summed over the corners; ReLU hidden layers; the last linear.
// It writes only the info, channel-major (out_dim, H*W); the 4C features
// never leave the block.  The TPU workarounds are gone: no one-hot column
// select matmuls (the corner columns are gathered directly), no polynomial
// sincos, no 64-row / 128-col pads, no VMEM window estimator.
//
// What bounds it on this card: f32 FMA throughput.  The MLP does
// 2 (4C*C + n_hidden*C*C + C*out) flops per query (0.82 MFLOP at the
// flagship C = 256) against ~2 KB of L2-resident gathers, so it is compute
// bound; without tensor cores (TF32 would break the f32 parity this port
// holds) the ceiling is the SIMT f32 rate.  Design: a block of 256 threads
// owns 64 consecutive queries.  The feature tile of one corner is built in
// shared memory K-major ([C][64 + 4]), so the GEMM reads a thread's 8 query
// rows as two broadcast float4s; W streams through shared memory in
// 32-row chunks; each thread accumulates 8 queries x 8 output channels in
// registers.  Each layer's activations go back to the same shared tile, so
// the hidden layers and the last linear run in the same block.  The last
// linear runs in passes of 128 columns over the final hidden tile (one
// for the pixel model's 60 rows, five for the d = 27 patch model's 540);
// each pass is staged in the W region with the query index swizzled, so
// that neither its stores nor its row-wise copy out conflict in shared
// memory, and the hidden tile stays intact for the next pass.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kM = 64;        // queries per block
constexpr int kMP = kM + 4;   // padded K-major row stride of the tile
constexpr int kKC = 32;       // W rows per shared-memory stage

struct AxisHit {
  int idx;
  float rel;
};

// Nearest LR index along one axis after a shift, and the query's offset to
// that pixel's center in LR pixel units.  _rn intrinsics keep nvcc from
// contracting into FMAs: the rounding must match the f32 reference, since
// queries sit at grid centers where the eps shift alone breaks ties.
__device__ __forceinline__ AxisHit axis_hit(float coord, float shift, int n) {
  float s = __fadd_rn(__fadd_rn(coord, shift), 1e-6f);
  s = fminf(fmaxf(s, -0.999999f), 0.999999f);
  const float fn = static_cast<float>(n);
  const float u = __fdiv_rn(__fsub_rn(__fmul_rn(__fadd_rn(s, 1.f), fn), 1.f),
                            2.f);
  int i = static_cast<int>(rintf(u));
  i = min(max(i, 0), n - 1);
  const float q = __fadd_rn(
      -1.f, __fdiv_rn(__fadd_rn(__fmul_rn(2.f, static_cast<float>(i)), 1.f),
                      fn));
  return {i, __fmul_rn(__fsub_rn(coord, q), fn)};
}

// acc[i][nb*4 + j] += sum_k xs[k][ty*8 + i] * wg[k][nb*128 + tx*4 + j]
// over k < K; wg is (K, ldw) row-major in global memory, columns past
// ncols read as zero.  Ends with a barrier, so xs may be rewritten after.
template <int NB>
__device__ __forceinline__ void gemm_tile(float (&acc)[8][NB * 4],
                                          const float* __restrict__ xs,
                                          const float* __restrict__ wg,
                                          int K, int ldw, int ncols,
                                          float* __restrict__ ws) {
  constexpr int NCOL = NB * 128;
  const int tid = threadIdx.x;
  const int ty = tid / 32, tx = tid % 32;
  const bool vec = (ldw % 4) == 0;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    for (int e = tid; e < kKC * NCOL / 4; e += kThreads) {
      const int kk = e / (NCOL / 4);
      const int c4 = (e % (NCOL / 4)) * 4;
      const int k = k0 + kk;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < K) {
        const float* src = wg + static_cast<size_t>(k) * ldw + c4;
        if (vec && c4 + 4 <= ncols) {
          v = *reinterpret_cast<const float4*>(src);
        } else {
          if (c4 < ncols) v.x = src[0];
          if (c4 + 1 < ncols) v.y = src[1];
          if (c4 + 2 < ncols) v.z = src[2];
          if (c4 + 3 < ncols) v.w = src[3];
        }
      }
      *reinterpret_cast<float4*>(ws + kk * NCOL + c4) = v;
    }
    __syncthreads();
    const int kmax = min(kKC, K - k0);
#pragma unroll 4
    for (int kk = 0; kk < kmax; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(
          xs + (k0 + kk) * kMP + ty * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(
          xs + (k0 + kk) * kMP + ty * 8 + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float4 b = *reinterpret_cast<const float4*>(
            ws + kk * NCOL + nb * 128 + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][nb * 4 + 0] += a[i] * b.x;
          acc[i][nb * 4 + 1] += a[i] * b.y;
          acc[i][nb * 4 + 2] += a[i] * b.z;
          acc[i][nb * 4 + 3] += a[i] * b.w;
        }
      }
    }
    __syncthreads();
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[8][NB * 4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NB * 4; ++j) acc[i][j] = 0.f;
}

// xs[col][row] = relu(acc + bias[col]) over all NB * 128 columns; then a
// barrier.
template <int NB>
__device__ __forceinline__ void store_tile(const float (&acc)[8][NB * 4],
                                           const float* __restrict__ bias,
                                           float* __restrict__ xs) {
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = nb * 128 + tx * 4 + j;
      const float bv = bias[col];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        xs[col * kMP + ty * 8 + i] = fmaxf(acc[i][nb * 4 + j] + bv, 0.f);
      }
    }
  __syncthreads();
}

// ws[col][m ^ (col / 4 % 32)] = acc + bias[col] for col < ncols: one
// pass's (128, kM) output tile, with the query index swizzled by the
// writing thread's column group; then a barrier.
__device__ __forceinline__ void stage_pass(const float (&acc)[8][4],
                                           const float* __restrict__ bias,
                                           int ncols, float* __restrict__ ws) {
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = tx * 4 + j;
    if (col < ncols) {
      const float bv = bias[col];
#pragma unroll
      for (int i = 0; i < 8; ++i) ws[col * kM + ((ty * 8 + i) ^ tx)] = acc[i][j] + bv;
    }
  }
  __syncthreads();
}

// floats of the W staging region: a kKC-row W chunk, or one wide pass
template <int C>
constexpr int kWsFloats = kKC * C > 128 * kM ? kKC * C : 128 * kM;

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
linf_info_kernel(const float* __restrict__ coef, const float* __restrict__ freq,
                 const float* __restrict__ coord_y,
                 const float* __restrict__ coord_x,
                 const float* __restrict__ phase,
                 const float* __restrict__ mlp, float* __restrict__ out,
                 int h, int w, int H, int W, int n_hidden, int out_dim,
                 float shift_y, float shift_x) {
  constexpr int NB = C / 128;
  constexpr int HALF = C / 2;
  // the packed MLP: every offset is a multiple of 4 floats (C % 4 == 0),
  // so the float4 weight loads stay aligned
  const float* w1 = mlp;
  const float* b1 = w1 + 4 * C * C;
  const float* wh = b1 + C;  // hidden layer l: W at wh + l (C*C + C), b after
  const float* w4 = wh + static_cast<size_t>(n_hidden) * (C * C + C);
  const float* b4 = w4 + C * out_dim;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [C][kMP]
  float* ws = xs + C * kMP;                  // [kKC][C], or one output pass
  int* s_pix = reinterpret_cast<int*>(ws + kWsFloats<C>);  // [4][kM]
  float* s_ry = reinterpret_cast<float*>(s_pix + 4 * kM);
  float* s_rx = s_ry + 4 * kM;
  float* s_wt = s_rx + 4 * kM;

  const int tid = threadIdx.x;
  const int n = H * W;
  const int q0 = blockIdx.x * kM;

  if (tid < kM) {
    const int q = q0 + tid;
    const bool valid = q < n;
    const int qq = valid ? q : 0;
    const float cy = coord_y[qq / W], cx = coord_x[qq % W];
    const AxisHit ym = axis_hit(cy, -shift_y, h), yp = axis_hit(cy, shift_y, h);
    const AxisHit xm = axis_hit(cx, -shift_x, w), xp = axis_hit(cx, shift_x, w);
    const AxisHit ys[4] = {ym, ym, yp, yp};
    const AxisHit xs4[4] = {xm, xp, xm, xp};
    float area[4];
    for (int k = 0; k < 4; ++k) {
      area[k] = __fadd_rn(fabsf(__fmul_rn(ys[k].rel, xs4[k].rel)), 1e-9f);
    }
    const float tot = __fadd_rn(__fadd_rn(__fadd_rn(area[0], area[1]), area[2]),
                                area[3]);
    for (int k = 0; k < 4; ++k) {
      s_pix[k * kM + tid] = (ys[k].idx * w + xs4[k].idx) * C;
      s_ry[k * kM + tid] = ys[k].rel;
      s_rx[k * kM + tid] = xs4[k].rel;
      s_wt[k * kM + tid] = valid ? __fdiv_rn(area[3 - k], tot) : 0.f;
    }
  }
  __syncthreads();

  float acc[8][NB * 4];
  zero<NB>(acc);

  // layer 1: sum over corners of features_k @ W1[kC:(k+1)C]
  const int j = tid % HALF;
  const float ph = phase[j];
  for (int k = 0; k < 4; ++k) {
    for (int m = tid / HALF; m < kM; m += kThreads / HALF) {
      const int pix = s_pix[k * kM + m];
      const float ry = s_ry[k * kM + m], rx = s_rx[k * kM + m];
      const float wt = s_wt[k * kM + m];
      const float f = __fadd_rn(
          __fadd_rn(__fmul_rn(freq[pix + j], ry), __fmul_rn(freq[pix + HALF + j], rx)),
          ph);
      float sn, cs;
      sincospif(f, &sn, &cs);
      xs[j * kMP + m] = __fmul_rn(__fmul_rn(wt, coef[pix + j]), cs);
      xs[(HALF + j) * kMP + m] = __fmul_rn(__fmul_rn(wt, coef[pix + HALF + j]), sn);
    }
    __syncthreads();
    gemm_tile<NB>(acc, xs, w1 + static_cast<size_t>(k) * C * C, C, C, C, ws);
  }
  store_tile<NB>(acc, b1, xs);

  for (int l = 0; l < n_hidden; ++l) {
    const float* wl = wh + static_cast<size_t>(l) * (C * C + C);
    zero<NB>(acc);
    gemm_tile<NB>(acc, xs, wl, C, C, C, ws);
    store_tile<NB>(acc, wl + C * C, xs);
  }

  // the last linear in 128-col passes over the hidden tile (one pass for
  // the pixel model's 60 rows, five for the patch model's 540), each
  // staged in ws
  for (int c0 = 0; c0 < out_dim; c0 += 128) {
    const int ncols = min(128, out_dim - c0);
    float acc1[8][4];
    zero<1>(acc1);
    gemm_tile<1>(acc1, xs, w4 + c0, C, out_dim, ncols, ws);
    stage_pass(acc1, b4 + c0, ncols, ws);
    for (int e = tid; e < ncols * kM; e += kThreads) {
      const int o = e / kM, m = e % kM;
      if (q0 + m < n) {
        out[static_cast<size_t>(c0 + o) * n + q0 + m] =
            ws[o * kM + (m ^ ((o / 4) % 32))];
      }
    }
    __syncthreads();  // the next pass's W chunks overwrite ws
  }
}

template <int C>
int launch(const float* coef, const float* freq, const float* coord_y,
           const float* coord_x, const float* phase, const float* mlp,
           float* out, int h, int w, int H, int W, int n_hidden, int out_dim,
           float shift_y, float shift_x, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(C) * kMP + kWsFloats<C> + 16 * kM)
                      * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      linf_info_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = H * W;
  const int blocks = (n + kM - 1) / kM;
  linf_info_kernel<C><<<blocks, kThreads, smem, stream>>>(
      coef, freq, coord_y, coord_x, phase, mlp, out, h, w, H, W, n_hidden,
      out_dim, shift_y, shift_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coef, freq: (h, w, C) NHWC; coord_y: (H,), coord_x: (W,) grid-center
// coords; phase: (C/2,); mlp: one f32 buffer holding, in order, W1 (4C, C),
// b1 (C,), then per hidden layer W (C, C) and b (C,), then W (C, out_dim)
// and b (out_dim,), each W (in, out) row-major; out: (out_dim, H*W).
// shift_y = 1/h, shift_x = 1/w as f32.  C must be 128 or 256 and
// 0 < out_dim <= 1024.
extern "C" int linf_info(const void* coef, const void* freq,
                         const void* coord_y, const void* coord_x,
                         const void* phase, const void* mlp, void* out, int h,
                         int w, int H, int W, int C, int n_hidden, int out_dim,
                         float shift_y, float shift_x, void* stream) {
  if (out_dim > 1024 || out_dim <= 0 || n_hidden < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (H <= 0 || W <= 0) return 0;
#define BFSR_ARGS                                                           \
  static_cast<const float*>(coef), static_cast<const float*>(freq),          \
      static_cast<const float*>(coord_y), static_cast<const float*>(coord_x), \
      static_cast<const float*>(phase), static_cast<const float*>(mlp),      \
      static_cast<float*>(out), h, w, H, W, n_hidden, out_dim, shift_y,      \
      shift_x, static_cast<cudaStream_t>(stream)
  switch (C) {
    case 128: return launch<128>(BFSR_ARGS);
    case 256: return launch<256>(BFSR_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BFSR_ARGS
}
