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
// in float64 at load and a true divide, as the Pallas kernel does.
//
// What bounds it on this card: bytes, then shared-memory reads.  Per
// query it reads 2dL info floats and d inputs and writes d (2,376 B at
// d = 27, L = 10) for ~2 d^2 (L+1) flops (~16 kflop), about 7 flop/B,
// under the H100's ~20 flop/B balance point of SIMT f32.  The products
// stay SIMT f32 FMA (one TF32 pass would break the f32 tolerances; the
// flops are ~8 us a launch at the f32 peak), fed from shared memory: a
// shared load gives each lane at most one float a wavefront, one
// wavefront a clock an SM, so a thread owning R rows x QT queries pays
// (R + QT) / (R QT) wavefronts a warp FMA, against four FMAs a clock.
// Fewer, larger tiles read less; more threads hide more latency.
//
// Thread split.  A block owns Q consecutive queries and keeps their state
// channel-major in shared memory, z[c][q] (row stride Q + 4, two buffers,
// one barrier a layer).  Each layer is a (d x d) x (d x Q) product split
// over the block: thread (g, l) of G row groups owns rows g R..g R + R - 1
// (R = d / G) for queries l QT..l QT + QT - 1, in registers.  A warp's
// lanes run over consecutive queries of one row group, so a W value is a
// broadcast and a z row one contiguous read.  Before the product each
// thread loads its rows' scales and shifts and takes their sigmoids,
// which depend on the info alone and overlap the FMAs; after it, the
// coupling runs on its own rows and writes the next z buffer.  Two tiles
// a d (TileFor): the wide one (QT = 2: at d = 27, 9 x 2 a thread, 192
// threads a block of 128 queries), and the narrow one, with more threads
// a query, for grids of fewer wide blocks than the card has SMs (d = 27:
// 3 x 2, 576 threads), such as the patch wrapper's 135 x 114 grid.
//
// The info ring.  The info and the weights stream through a ring of S
// slots in shared memory, filled by cp.async S - 1 stages ahead of the
// math: slot s holds stage s's matrix (transposed by 4-B copies,
// [c][G][R padded to 4], so a thread's rows at one c are float4s), the
// bias and the 2d x Q info tile its epilogue reads (forward: layer s;
// inverse: W^-1 of layer L - s with the bias and info of layer L - s - 1).
// So a block reads each layer's W and b once, as it reads its info once,
// the ring's size does not grow with L (d = 48: 94 KB a block, two
// blocks an SM, at any L), and one path serves any depth.
//
// Unaligned rows.  The info is channel-major (2dL, N), as K2 writes it: a
// slot's row is Q contiguous floats, but the row stride is N floats, 16-B
// aligned only when N % 4 == 0 (not at the 135 x 114 grid's 15,390).  So
// the launch picks per call: 16-B cp.async chunks when N % 4 == 0 and the
// info pointer is 16-B aligned, else one 4-B cp.async a float; both
// zero-fill past N and put the same bytes in shared memory.  x and out
// are (N, d) row-major, the layout of the prior's NHWC latent: a block's
// slice is one contiguous run, read and written coalesced at any
// alignment and transposed through the z buffers.
//
// The sigmoid is expf, as in K1, with a reciprocal to 2 ulp (a
// correctly rounded one cost 6-8 us a launch); the inverse keeps a true
// divide by the scale.  No atomics and one fixed order of sums: launches
// are bitwise repeatable.  Each direction's C entry is its own source
// (linf_flow_nd_forward.cu, linf_flow_nd_inverse.cu), so the two unrolled
// template sets compile in parallel.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace bfsr_k4 {

constexpr float kAffineEps = 1e-4f;

// sigmoid(s + 2) + eps: expf, as in K1, and the reciprocal to 2 ulp
// (__fdividef: 0 past 2^126, where the sigmoid is under f32's reach)
__device__ __forceinline__ float affine_scale(float s) {
  return __fdividef(1.f, 1.f + expf(-(s + 2.f))) + kAffineEps;
}

// Per d, two tiles of G row groups, Q queries a block, QT queries a
// thread and S ring slots: the wide one, and the narrow one (more threads
// a query) for grids of fewer wide blocks than the card has SMs.
template <int G_, int Q_, int QT_, int S_>
struct Tile {
  static constexpr int G = G_, Q = Q_, QT = QT_, S = S_;
};
template <int D, bool kNarrow>
struct TileFor;
template <> struct TileFor<12, false> : Tile<3, 128, 2, 2> {};
template <> struct TileFor<12, true> : Tile<3, 128, 1, 2> {};
template <> struct TileFor<27, false> : Tile<3, 128, 2, 2> {};
template <> struct TileFor<27, true> : Tile<9, 128, 2, 2> {};
template <> struct TileFor<48, false> : Tile<4, 64, 2, 2> {};
template <> struct TileFor<48, true> : Tile<4, 64, 1, 2> {};

template <int D, bool kNarrow>
struct Cfg {
  using T = TileFor<D, kNarrow>;
  static constexpr int G = T::G, Q = T::Q, QT = T::QT, S = T::S;
  static constexpr int R = D / G;                   // rows a thread
  static constexpr int RP = (R + 3) / 4 * 4;        // padded to float4s
  static constexpr int DP = (D + 3) / 4 * 4;        // bias slot
  static constexpr int LANES = Q / QT;              // threads a row group
  static constexpr int THREADS = G * LANES;
  static constexpr int QZ = Q + 4;                  // z row stride
  static constexpr int W_FLOATS = D * G * RP;
  static constexpr int SLOT = W_FLOATS + DP + 2 * D * Q;
  static constexpr int Z_FLOATS = 2 * D * QZ;
  static constexpr int SMEM_BYTES = (Z_FLOATS + S * SLOT) * 4;
  static_assert(D % G == 0 && Q % QT == 0 && Q % 4 == 0, "tile");
  static_assert(QT == 1 || QT == 2 || QT % 4 == 0, "QT");
  static_assert(S >= 2, "ring");
};

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

// N consecutive floats of shared memory: float4s, then a float2 and a
// float for the rest (p 16-B aligned, or N < 4 and p aligned to N floats).
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  constexpr int N4 = N / 4 * 4;
#pragma unroll
  for (int i = 0; i < N4; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
  }
  if constexpr (N - N4 >= 2) {
    const float2 t = *reinterpret_cast<const float2*>(p + N4);
    v[N4] = t.x; v[N4 + 1] = t.y;
  }
  if constexpr ((N - N4) % 2 == 1) v[N - 1] = p[N - 1];
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
  static_assert(N == 1 || N == 2 || N % 4 == 0, "store_vec");
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// Issue stage s's copies into one ring slot (the caller commits them).
template <int D, bool kNarrow, bool kInverse>
__device__ __forceinline__ void issue_stage(
    float* slot, const float* __restrict__ w, const float* __restrict__ b,
    const float* __restrict__ info, int s, int n_layers, int q0, int n,
    bool vec) {
  using C = Cfg<D, kNarrow>;
  const int lw = kInverse ? n_layers - s : s;      // the matrix's layer
  const int le = kInverse ? n_layers - s - 1 : s;  // the epilogue's layer
  const float* wl = w + static_cast<size_t>(lw) * D * D;
  for (int e = threadIdx.x; e < D * D; e += C::THREADS) {
    const int r = e / D, c = e - r * D;
    cp_async4(slot + (c * C::G + r / C::R) * C::RP + r % C::R, wl + e, 4);
  }
  if (le < 0) return;
  for (int e = threadIdx.x; e < D; e += C::THREADS) {
    cp_async4(slot + C::W_FLOATS + e, b + static_cast<size_t>(le) * D + e, 4);
  }
  if (le >= n_layers) return;
  float* si = slot + C::W_FLOATS + C::DP;
  const size_t stride = static_cast<size_t>(n);
  const float* rows = info + static_cast<size_t>(2 * D) * le * stride + q0;
  if (vec) {
    constexpr int CH = C::Q / 4;
    for (int e = threadIdx.x; e < 2 * D * CH; e += C::THREADS) {
      const int row = e / CH, k = e - row * CH;
      const int left = n - q0 - 4 * k;
      const int bytes = left >= 4 ? 16 : (left > 0 ? 4 * left : 0);
      cp_async16(si + row * C::Q + 4 * k,
                 rows + row * stride + (bytes ? 4 * k : 0), bytes);
    }
  } else {
    for (int e = threadIdx.x; e < 2 * D * C::Q; e += C::THREADS) {
      const int row = e / C::Q, q = e - row * C::Q;
      const bool ok = q0 + q < n;
      cp_async4(si + row * C::Q + q, rows + row * stride + (ok ? q : 0),
                ok ? 4 : 0);
    }
  }
}

template <int D, bool kNarrow, bool kInverse>
__global__ void __launch_bounds__(Cfg<D, kNarrow>::THREADS)
flow_nd_kernel(const float* __restrict__ w, const float* __restrict__ b,
               const float* __restrict__ x, const float* __restrict__ info,
               float* __restrict__ out, int n, int n_layers, bool vec) {
  using C = Cfg<D, kNarrow>;
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;
  float* ring = smem + C::Z_FLOATS;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * C::Q;
  const int nq = min(C::Q, n - q0);

  // stage t into slot t % S; every thread commits one group a stage
  auto issue = [&](int t) {
    if (t <= n_layers) {
      issue_stage<D, kNarrow, kInverse>(ring + (t % C::S) * C::SLOT, w, b,
                                        info, t, n_layers, q0, n, vec);
    }
    cp_async_commit();
  };
  for (int t = 0; t < C::S - 1; ++t) issue(t);
  // the block's x (or z - b_L) into z buffer 0, channel-major.  The
  // queries past N start at 1, not 0: with zero biases (the reference
  // init) a 0 would reach the inverse's divide as 0 / scale, whose slow
  // path held the last block ~25 us
  const float* xb = x + static_cast<size_t>(q0) * D;
  const float* bl = b + static_cast<size_t>(n_layers) * D;
  for (int e = tid; e < C::Q * D; e += C::THREADS) {
    const int q = e / D, c = e - q * D;
    float v = e < nq * D ? xb[e] : 1.f;
    if (kInverse) v -= bl[c];
    zs[c * C::QZ + q] = v;
  }

  const int g = tid / C::LANES;
  const int qi = (tid - g * C::LANES) * C::QT;
  for (int s = 0; s <= n_layers; ++s) {
    // stage s has landed for every thread; the slot issued next was last
    // read in stage s - 1, and z buffer s & 1 is whole
    cp_async_wait<C::S - 2>();
    __syncthreads();
    issue(s + C::S - 1);

    const float* slot = ring + (s % C::S) * C::SLOT;
    const float* sb = slot + C::W_FLOATS;
    const float* si = sb + C::DP;
    const float* zc = zs + (s & 1) * D * C::QZ;
    float* zn = zs + ((s + 1) & 1) * D * C::QZ;
    const bool couple = s < n_layers;
    // the coupling's scales and shifts first: their sigmoids depend on the
    // info alone and overlap the products
    float scl[C::R][C::QT], sh[C::R][C::QT];
#pragma unroll
    for (int j = 0; j < C::R; ++j) {
      if (couple) {
        const int r = g * C::R + j;
        load_vec<C::QT>(si + r * C::Q + qi, scl[j]);
        load_vec<C::QT>(si + (D + r) * C::Q + qi, sh[j]);
#pragma unroll
        for (int k = 0; k < C::QT; ++k) scl[j][k] = affine_scale(scl[j][k]);
      }
    }
    float acc[C::R][C::QT];
#pragma unroll
    for (int j = 0; j < C::R; ++j) {
#pragma unroll
      for (int k = 0; k < C::QT; ++k) acc[j][k] = 0.f;
    }
    const float* wg = slot + g * C::RP;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float zq[C::QT], wr[C::R];
      load_vec<C::QT>(zc + c * C::QZ + qi, zq);
      load_vec<C::R>(wg + c * C::G * C::RP, wr);
#pragma unroll
      for (int j = 0; j < C::R; ++j) {
#pragma unroll
        for (int k = 0; k < C::QT; ++k) {
          acc[j][k] = fmaf(wr[j], zq[k], acc[j][k]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < C::R; ++j) {
      const int r = g * C::R + j;
      // the inverse's last stage has no bias: it took b_L from z
      const float bb = kInverse && !couple ? 0.f : sb[r];
      float v[C::QT];
#pragma unroll
      for (int k = 0; k < C::QT; ++k) {
        if (!couple) {
          v[k] = acc[j][k] + bb;
        } else if (kInverse) {
          v[k] = (acc[j][k] - sh[j][k]) / scl[j][k] - bb;
        } else {
          v[k] = (acc[j][k] + bb) * scl[j][k] + sh[j][k];
        }
      }
      store_vec<C::QT>(zn + r * C::QZ + qi, v);
    }
  }
  __syncthreads();
  const float* zf = zs + ((n_layers + 1) & 1) * D * C::QZ;
  float* ob = out + static_cast<size_t>(q0) * D;
  for (int e = tid; e < nq * D; e += C::THREADS) {
    const int q = e / D, c = e - q * D;
    ob[e] = zf[c * C::QZ + q];
  }
}

inline int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <int D, bool kNarrow, bool kInverse>
int launch_tile(const float* w, const float* b, const float* x,
                const float* info, float* out, int n, int n_layers,
                cudaStream_t stream) {
  using C = Cfg<D, kNarrow>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flow_nd_kernel<D, kNarrow, kInverse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const bool vec =
      n % 4 == 0 && reinterpret_cast<uintptr_t>(info) % 16 == 0;
  const int blocks = (n + C::Q - 1) / C::Q;
  flow_nd_kernel<D, kNarrow, kInverse>
      <<<blocks, C::THREADS, C::SMEM_BYTES, stream>>>(w, b, x, info, out, n,
                                                      n_layers, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kInverse>
int launch_d(const float* w, const float* b, const float* x,
             const float* info, float* out, int n, int n_layers,
             cudaStream_t stream) {
  constexpr int kWideQ = Cfg<D, false>::Q;
  if ((n + kWideQ - 1) / kWideQ < num_sms()) {
    return launch_tile<D, true, kInverse>(w, b, x, info, out, n, n_layers,
                                          stream);
  }
  return launch_tile<D, false, kInverse>(w, b, x, info, out, n, n_layers,
                                         stream);
}

template <bool kInverse>
int launch(const void* w, const void* b, const void* x, const void* info,
           void* out, int n, int n_layers, int d, void* stream) {
  if (n_layers < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(b);
  const auto* xf = static_cast<const float*>(x);
  const auto* inf = static_cast<const float*>(info);
  auto* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 12:
      return launch_d<12, kInverse>(wf, bf, xf, inf, of, n, n_layers, st);
    case 27:
      return launch_d<27, kInverse>(wf, bf, xf, inf, of, n, n_layers, st);
    case 48:
      return launch_d<48, kInverse>(wf, bf, xf, inf, of, n, n_layers, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace bfsr_k4
