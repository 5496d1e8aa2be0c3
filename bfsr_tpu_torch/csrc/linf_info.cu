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
// It writes only the info, channel-major (out_dim, B*H*W), sample-major
// along the columns; the 4C features never leave the block.  A batch of B
// samples, each with its own maps, grid axes and phase, is blockIdx.y:
// a batch-1 launch is the launch it was before the batch came in.  The TPU workarounds are gone: no one-hot column
// select matmuls (the corner columns are gathered directly), no polynomial
// sincos, no 64-row / 128-col pads, no VMEM window estimator.
//
// What bounds it on this card: the MLP's products.  They are 2 (4C*C +
// n_hidden*C*C + C*out) flops per query (0.82 MFLOP at the flagship C =
// 256) against ~2 KB of L2-resident gathers.  The port holds K2 to f32
// grade, which one TF32 pass would break, so every product runs on the
// tensor cores as 3xTF32: each f32 operand is split where its fragment is
// loaded into big (x rounded to TF32) and small (x - big), and
// mma.sync.m16n8k8 (TF32 in, f32 accumulate) adds small*big, big*small,
// then big*big (the small terms first, as CUTLASS's OpMultiplyAddFastF32
// does; small*small, ~2^-22 relative, is left out).  The least time is
// three TF32 products at the TF32 rate.
//
// Design: a block of Tile::kThreads threads owns Tile::M consecutive
// queries and keeps them in a K-major shared tile [C][M + 8] (the row
// stride is 8 mod 32, so an A fragment's lanes, query g and k t, hit 32
// distinct banks).  Every layer is one gemm() over that tile: each warp
// owns an (MT x 16) x (NT x 8) output tile in registers, and W streams
// from L2 through a cp.async ring of KC-row chunks (rows padded to 8 mod
// 32 floats), the next chunk in flight while this one's MMAs run; the
// first chunks of the next product are issued before the current
// epilogue.  Layer 1 sums four K = C products, one a corner: corner k's
// features are built SIMT, in the f32 order of the reference, into the
// tile's rows as corner k - 1's product frees them, a chunk's rows being
// the cos and sin rows of KC / 2 channels, so the 4C features never leave
// the block and the builds overlap the MMAs.  Bias and ReLU write each
// layer back into the same tile, so the hidden layers and the last linear
// run in the same block.  The last linear runs in passes of 128 columns
// (one for the pixel model's 60 rows, five for the d = 27 patch model's
// 540), skipping the n tiles past out_dim; each pass is staged in the ring
// with a row stride of 4 mod 32, so that neither the fragments' stores nor
// the row-wise copy out conflict in shared memory.  No atomics and one
// fixed order of sums: launches are bitwise repeatable.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32.cuh"

namespace {

// M queries a block on WM x WN warps; W in KC-row chunks through a ring of
// STAGES slots.
template <int C_, int M_, int WM_, int WN_, int KC_, int STAGES_,
          int MIN_BLOCKS_>
struct Tile {
  static constexpr int C = C_, M = M_, WM = WM_, WN = WN_, KC = KC_;
  static constexpr int STAGES = STAGES_, kMinBlocks = MIN_BLOCKS_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int MT = M / (16 * WM);   // m16 tiles a warp
  static constexpr int kMP = M + 8;          // tile row stride, 8 mod 32
  static constexpr int kSP = M + 4;          // staging row stride, 4 mod 32
  static constexpr int kPass = 128;          // last-linear columns a pass
  // floats of one ring stage of an NCOL-column product
  __host__ __device__ static constexpr int stage(int ncol) {
    return KC * (ncol + 8);
  }
  static constexpr int kRing = STAGES * KC * (C + 8) > kPass * kSP
                                   ? STAGES * KC * (C + 8) : kPass * kSP;
  static constexpr size_t kSmemBytes =
      (static_cast<size_t>(C) * kMP + kRing + 16 * M) * sizeof(float);
  static_assert(M % 32 == 0 && kThreads >= M && C % KC == 0 && KC % 16 == 0 &&
                    C / KC >= STAGES - 1 && STAGES >= 2,
                "tile shape");
  static_assert(M % (16 * WM) == 0 && kPass % (8 * WN) == 0, "warp grid");
};

// 128 queries on 8 warps (64 x 64 warp tiles at C = 256), 32-row chunks
// in two slots: one block of ~210 KB a multiprocessor.  It beat 128
// queries on 16 warps (32 x 64, register-bound) and 64 on 4 warps (two
// blocks a multiprocessor, twice the weight reads); PERF.md has the times.
template <int C>
using TileFor = Tile<C, 128, 2, 4, 32, 2, 1>;

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
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

// n tiles of a warp over NCOL columns
template <class T, int NCOL>
constexpr int kNT = NCOL / (8 * T::WN);

// Row kk of chunk c, as a row of the tile and of W: rows c KC + kk, or,
// PAIRED, the chunk's KC / 2 cos rows c KC / 2 + kk and then the matching
// sin rows C / 2 + c KC / 2 + kk - KC / 2, so that a chunk holds every row
// of KC / 2 feature channels.
template <class T, bool PAIRED>
__device__ __forceinline__ int chunk_row(int c, int kk) {
  constexpr int H2 = T::KC / 2;
  if (!PAIRED) return c * T::KC + kk;
  return kk < H2 ? c * H2 + kk : T::C / 2 + c * H2 + kk - H2;
}

// Copies chunk c of W (C, ldw) row-major, columns [0, NCOL), into ring
// slot c % STAGES, rows padded to NCOL + 8; columns >= ncols are
// zero-filled.  Commits one cp.async group.
template <class T, int NCOL, bool PAIRED>
__device__ __forceinline__ void load_chunk(float* ring,
                                           const float* __restrict__ wg,
                                           int c, int ldw, int ncols) {
  float* dst = ring + (c % T::STAGES) * T::stage(NCOL);
  if (ldw % 4 == 0) {   // 16-byte rows (ncols is then a multiple of 4)
    for (int e = threadIdx.x; e < T::KC * NCOL / 4; e += T::kThreads) {
      const int kk = e / (NCOL / 4), col = (e % (NCOL / 4)) * 4;
      const bool ok = col < ncols;
      const int r = chunk_row<T, PAIRED>(c, kk);
      cp_async16(dst + kk * (NCOL + 8) + col,
                 ok ? wg + static_cast<size_t>(r) * ldw + col : wg,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < T::KC * NCOL; e += T::kThreads) {
      const int kk = e / NCOL, col = e % NCOL;
      const bool ok = col < ncols;
      const int r = chunk_row<T, PAIRED>(c, kk);
      cp_async4(dst + kk * (NCOL + 8) + col,
                ok ? wg + static_cast<size_t>(r) * ldw + col : wg,
                ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// Puts chunks 0 .. STAGES - 2 of W in flight, as gemm() expects.
template <class T, int NCOL, bool PAIRED = false>
__device__ __forceinline__ void prime(float* ring,
                                      const float* __restrict__ wg, int ldw,
                                      int ncols) {
#pragma unroll
  for (int c = 0; c < T::STAGES - 1; ++c) {
    load_chunk<T, NCOL, PAIRED>(ring, wg, c, ldw, ncols);
  }
}

struct NoHook {
  __device__ void operator()(int) const {}
};

// acc[i][j] += sum_k xs[k][m] W[k][n] over k < C, for the warp's tiles m =
// m_base + 16 i (+ g, + 8), n = n_base + 8 j (+ 2t, + 1); n tiles at or
// past ncols are skipped.  prime() must have put W's first chunks in
// flight.  Chunk c + STAGES - 1 is copied while chunk c's MMAs run, one
// barrier a chunk.  Each term is summed over all of the warp's tiles
// before the next, so an accumulator's three MMAs are MT x NT apart.
// hook(c - 1) runs once chunk c - 1's rows are free: before chunk c's MMAs
// on warps 4-7, half way through them on warps 0-3 (the other warp of each
// SM sub-partition), so that one warp's hook overlaps the other's MMAs; the
// last chunk's hook runs after the closing barrier.  The next gemm()'s
// first barrier publishes what the hooks wrote.
template <class T, int NCOL, bool PAIRED = false, class Hook = NoHook>
__device__ __forceinline__ void gemm(float (&acc)[T::MT][kNT<T, NCOL>][4],
                                     const float* xs,
                                     const float* __restrict__ wg, int ldw,
                                     int ncols, float* ring,
                                     Hook hook = Hook()) {
  constexpr int NT = kNT<T, NCOL>, NP = NCOL + 8, NCHUNK = T::C / T::KC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m_base = (warp / T::WN) * (16 * T::MT);
  const int n_base = (warp % T::WN) * (8 * NT);
  const bool hook_first = (warp / 4) % 2 == 1;
  for (int c = 0; c < NCHUNK; ++c) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1
    if (c + T::STAGES - 1 < NCHUNK) {
      load_chunk<T, NCOL, PAIRED>(ring, wg, c + T::STAGES - 1, ldw, ncols);
    } else {
      cp_async_commit();
    }
    if (c > 0 && hook_first) hook(c - 1);
    const float* wk = ring + (c % T::STAGES) * T::stage(NCOL) + n_base + g;
#pragma unroll
    for (int kk = 0; kk < T::KC; kk += 8) {
      if (kk == T::KC / 2 && c > 0 && !hook_first) hook(c - 1);
      const float* xk =
          xs + chunk_row<T, PAIRED>(c, kk) * T::kMP + m_base + g;
      uint32_t ab[T::MT][4], as[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        const float* p = xk + t * T::kMP + 16 * i;
        split_tf32(p[0], ab[i][0], as[i][0]);
        split_tf32(p[8], ab[i][1], as[i][1]);
        split_tf32(p[4 * T::kMP], ab[i][2], as[i][2]);
        split_tf32(p[4 * T::kMP + 8], ab[i][3], as[i][3]);
      }
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* q = wk + (kk + t) * NP + 8 * j;
        split_tf32(q[0], bb[j][0], bs[j][0]);
        split_tf32(q[4 * NP], bb[j][1], bs[j][1]);
      }
      // small * big, big * small, then big * big
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (n_base + 8 * j < ncols) {
#pragma unroll
          for (int i = 0; i < T::MT; ++i) mma_tf32(acc[i][j], as[i], bb[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (n_base + 8 * j < ncols) {
#pragma unroll
          for (int i = 0; i < T::MT; ++i) mma_tf32(acc[i][j], ab[i], bs[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (n_base + 8 * j < ncols) {
#pragma unroll
          for (int i = 0; i < T::MT; ++i) mma_tf32(acc[i][j], ab[i], bb[j]);
        }
      }
    }
  }
  __syncthreads();
  hook(NCHUNK - 1);
}

// One corner's features for channels [jb, jb + 4 kU): the cos rows jb ..
// and the sin rows C / 2 + jb .. of the tile.  A warp's lanes run over 8
// queries x 4 channels (the stores hit 32 distinct banks); each thread
// keeps its query and gathers kU channels' inputs before their sincospif.
template <class T, int kU>
__device__ __forceinline__ void build_features(
    float* xs, const float* __restrict__ coef, const float* __restrict__ freq,
    const float* __restrict__ phase, const int* s_pix, const float* s_ry,
    const float* s_rx, const float* s_wt, int jb) {
  constexpr int M = T::M, HALF = T::C / 2;
  const int lane = threadIdx.x % 32;
  for (int mg = threadIdx.x / 32; mg < M / 8; mg += T::kThreads / 32) {
    const int m = 8 * mg + lane % 8;
    const int pix = s_pix[m];
    const float ry = s_ry[m], rx = s_rx[m], wt = s_wt[m];
    const int j0 = jb + lane / 8;
    float fy[kU], fx[kU], ph[kU], cc[kU], cn[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = j0 + 4 * u;
      fy[u] = freq[pix + j];
      fx[u] = freq[pix + HALF + j];
      ph[u] = phase[j];
      cc[u] = coef[pix + j];
      cn[u] = coef[pix + HALF + j];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = j0 + 4 * u;
      const float f = __fadd_rn(
          __fadd_rn(__fmul_rn(fy[u], ry), __fmul_rn(fx[u], rx)), ph[u]);
      float sn, cs;
      sincospif(f, &sn, &cs);
      xs[j * T::kMP + m] = __fmul_rn(__fmul_rn(wt, cc[u]), cs);
      xs[(HALF + j) * T::kMP + m] = __fmul_rn(__fmul_rn(wt, cn[u]), sn);
    }
  }
}

template <class T, int NT>
__device__ __forceinline__ void zero(float (&acc)[T::MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
}

// xs[n][m] = relu(acc + bias[n]) over the warp's C-column tiles; then a
// barrier.
template <class T>
__device__ __forceinline__ void store_tile(
    const float (&acc)[T::MT][kNT<T, T::C>][4], const float* __restrict__ bias,
    float* xs) {
  constexpr int NT = kNT<T, T::C>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = (warp / T::WN) * (16 * T::MT) + lane / 4;
  const int n0 = (warp % T::WN) * (8 * NT) + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + 8 * j;
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
      float* p = xs + n * T::kMP + m0 + 16 * i;
      p[0] = fmaxf(acc[i][j][0] + b0, 0.f);
      p[T::kMP] = fmaxf(acc[i][j][1] + b1, 0.f);
      p[8] = fmaxf(acc[i][j][2] + b0, 0.f);
      p[T::kMP + 8] = fmaxf(acc[i][j][3] + b1, 0.f);
    }
  }
  __syncthreads();
}

// ws[o][m] = acc + bias[o] for o < ncols: one pass's (128, M) output
// tile, rows kSP apart; then a barrier.
template <class T>
__device__ __forceinline__ void stage_pass(
    const float (&acc)[T::MT][kNT<T, T::kPass>][4],
    const float* __restrict__ bias, int ncols, float* ws) {
  constexpr int NT = kNT<T, T::kPass>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = (warp / T::WN) * (16 * T::MT) + lane / 4;
  const int n0 = (warp % T::WN) * (8 * NT) + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = n0 + 8 * j + h;
      if (o < ncols) {
        const float bv = bias[o];
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          ws[o * T::kSP + m0 + 16 * i] = acc[i][j][h] + bv;
          ws[o * T::kSP + m0 + 16 * i + 8] = acc[i][j][2 + h] + bv;
        }
      }
    }
  }
  __syncthreads();
}

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
linf_info_kernel(const float* __restrict__ coef, const float* __restrict__ freq,
                 const float* __restrict__ coord_y,
                 const float* __restrict__ coord_x,
                 const float* __restrict__ phase,
                 const float* __restrict__ mlp, float* __restrict__ out,
                 int B, int h, int w, int H, int W, int n_hidden,
                 int out_dim, float shift_y, float shift_x) {
  constexpr int C = T::C, M = T::M, HALF = C / 2;
  constexpr int NT = kNT<T, C>, NT4 = kNT<T, T::kPass>;
  // the packed MLP: every offset is a multiple of 4 floats (C % 4 == 0),
  // so the 16-byte weight copies stay aligned
  const float* w1 = mlp;
  const float* b1 = w1 + 4 * C * C;
  const float* wh = b1 + C;  // hidden layer l: W at wh + l (C*C + C), b after
  const float* w4 = wh + static_cast<size_t>(n_hidden) * (C * C + C);
  const float* b4 = w4 + C * out_dim;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [C][kMP]
  float* ring = xs + C * T::kMP;             // W chunks, or one output pass
  int* s_pix = reinterpret_cast<int*>(ring + T::kRing);  // [4][M]
  float* s_ry = reinterpret_cast<float*>(s_pix + 4 * M);
  float* s_rx = s_ry + 4 * M;
  float* s_wt = s_rx + 4 * M;

  const int tid = threadIdx.x;
  const int n = H * W;
  const int q0 = blockIdx.x * M;
  // sample b's maps, axes and phase; its queries are columns b n .. of out
  const int b = blockIdx.y;
  coef += static_cast<size_t>(b) * h * w * C;
  freq += static_cast<size_t>(b) * h * w * C;
  coord_y += static_cast<size_t>(b) * H;
  coord_x += static_cast<size_t>(b) * W;
  phase += static_cast<size_t>(b) * HALF;
  const size_t n_all = static_cast<size_t>(B) * n;
  out += static_cast<size_t>(b) * n;

  prime<T, C, true>(ring, w1, C, C);
  if (tid < M) {
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
      s_pix[k * M + tid] = (ys[k].idx * w + xs4[k].idx) * C;
      s_ry[k * M + tid] = ys[k].rel;
      s_rx[k * M + tid] = xs4[k].rel;
      s_wt[k * M + tid] = valid ? __fdiv_rn(area[3 - k], tot) : 0.f;
    }
  }
  __syncthreads();

  float acc[T::MT][NT][4];
  zero<T, NT>(acc);

  // layer 1: sum over corners of features_k @ W1[kC:(k+1)C], in chunks of
  // KC / 2 channels' cos and sin rows; corner k + 1's features are built
  // into each chunk's rows once corner k's MMAs are done with them
  constexpr int kU = T::KC / 8;
  const auto features = [&](int k, int jb) {
    build_features<T, kU>(xs, coef, freq, phase, s_pix + k * M, s_ry + k * M,
                          s_rx + k * M, s_wt + k * M, jb);
  };
  for (int jb = 0; jb < HALF; jb += T::KC / 2) features(0, jb);
  for (int k = 0; k < 4; ++k) {
    const float* w1k = w1 + static_cast<size_t>(k) * C * C;
    if (k > 0) prime<T, C, true>(ring, w1k, C, C);
    gemm<T, C, true>(acc, xs, w1k, C, C, ring, [&](int c) {
      if (k < 3) features(k + 1, c * (T::KC / 2));
    });
  }
  if (n_hidden > 0) {
    prime<T, C>(ring, wh, C, C);
  } else {
    prime<T, T::kPass>(ring, w4, out_dim, min(T::kPass, out_dim));
  }
  store_tile<T>(acc, b1, xs);

  for (int l = 0; l < n_hidden; ++l) {
    const float* wl = wh + static_cast<size_t>(l) * (C * C + C);
    zero<T, NT>(acc);
    gemm<T, C>(acc, xs, wl, C, C, ring);
    if (l + 1 < n_hidden) {
      prime<T, C>(ring, wl + C * C + C, C, C);
    } else {
      prime<T, T::kPass>(ring, w4, out_dim, min(T::kPass, out_dim));
    }
    store_tile<T>(acc, wl + C * C, xs);
  }

  // the last linear in 128-col passes over the hidden tile, each staged in
  // the ring; its first chunk is already in flight
  for (int c0 = 0; c0 < out_dim; c0 += T::kPass) {
    const int ncols = min(T::kPass, out_dim - c0);
    float acc4[T::MT][NT4][4];
    zero<T, NT4>(acc4);
    gemm<T, T::kPass>(acc4, xs, w4 + c0, out_dim, ncols, ring);
    stage_pass<T>(acc4, b4 + c0, ncols, ring);
    for (int e = tid; e < ncols * M; e += T::kThreads) {
      const int o = e / M, m = e % M;
      if (q0 + m < n) {
        out[static_cast<size_t>(c0 + o) * n_all + q0 + m] =
            ring[o * T::kSP + m];
      }
    }
    __syncthreads();  // the next pass's W chunks overwrite the staging
    if (c0 + T::kPass < out_dim) {
      prime<T, T::kPass>(ring, w4 + c0 + T::kPass, out_dim,
                         min(T::kPass, out_dim - c0 - T::kPass));
    }
  }
}

template <int C>
int launch(const float* coef, const float* freq, const float* coord_y,
           const float* coord_x, const float* phase, const float* mlp,
           float* out, int B, int h, int w, int H, int W, int n_hidden,
           int out_dim, float shift_y, float shift_x, cudaStream_t stream) {
  using T = TileFor<C>;
  cudaError_t err = cudaFuncSetAttribute(
      linf_info_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = H * W;
  const dim3 blocks((n + T::M - 1) / T::M, B);
  linf_info_kernel<T><<<blocks, T::kThreads, T::kSmemBytes, stream>>>(
      coef, freq, coord_y, coord_x, phase, mlp, out, B, h, w, H, W, n_hidden,
      out_dim, shift_y, shift_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coef, freq: (B, h, w, C) NHWC; coord_y: (B, H), coord_x: (B, W)
// grid-center coords; phase: (B, C/2); mlp: one f32 buffer holding, in
// order, W1 (4C, C), b1 (C,), then per hidden layer W (C, C) and b (C,),
// then W (C, out_dim) and b (out_dim,), each W (in, out) row-major; out:
// (out_dim, B*H*W), sample b's query (y, x) at column b H W + y W + x.
// shift_y = 1/h, shift_x = 1/w as f32.  C must be 128 or 256,
// 0 < out_dim <= 1024 and B <= 65535.
extern "C" int linf_info(const void* coef, const void* freq,
                         const void* coord_y, const void* coord_x,
                         const void* phase, const void* mlp, void* out, int B,
                         int h, int w, int H, int W, int C, int n_hidden,
                         int out_dim, float shift_y, float shift_x,
                         void* stream) {
  if (out_dim > 1024 || out_dim <= 0 || n_hidden < 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || H <= 0 || W <= 0) return 0;
#define BFSR_ARGS                                                           \
  static_cast<const float*>(coef), static_cast<const float*>(freq),          \
      static_cast<const float*>(coord_y), static_cast<const float*>(coord_x), \
      static_cast<const float*>(phase), static_cast<const float*>(mlp),      \
      static_cast<float*>(out), B, h, w, H, W, n_hidden, out_dim, shift_y,   \
      shift_x, static_cast<cudaStream_t>(stream)
  switch (C) {
    case 128: return launch<128>(BFSR_ARGS);
    case 256: return launch<256>(BFSR_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BFSR_ARGS
}
