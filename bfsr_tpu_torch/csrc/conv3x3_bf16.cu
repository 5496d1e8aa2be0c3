// K3 at passes=1 (the bf16 serving modes): 3x3 stride-1 SAME convolution
// over an implicit channel concat of 1-5 NHWC float32 inputs, operands
// rounded to bf16 (round to nearest even), products accumulated in f32 on
// the tensor cores, then a per-channel f32 scale/bias epilogue (folded
// BatchNorm + conv bias) and an optional ReLU / LeakyReLU.  Any batch; any
// H and W; Cout 8, 16, 32, 64 or a multiple of 64.  blockIdx.z is
// image * (cout_p / NB) + the block's Cout block, and every input and the
// output are offset by whole images, so a batch-1 launch is the launch it
// was before the batch (the trainer's encoder runs it at B = 16).
//
// Replaces bfsr_tpu/ops/pallas/s2d_conv.py:_kernel at passes=1, and is the
// conv that profiling/mosaic_probe.py (kern_a/b/c) lays out three ways in
// space-to-depth.  Not carried over: the s2d phase packing, the hi/lo
// split and the 8/128 alignment pads.
//
// What bounds it on this card: bytes.  2*9*Cin*Cout flop per pixel against
// ~4*(Cin + Cout) bytes of f32 activations is 70-300 flop/B, at or under
// the 295 flop/B where the H100's bf16 tensor rate and its memory rate
// balance; at the RRDB's 128^2 convs (16,384 pixels) a launch is also too
// short to hide its load latency unless many blocks overlap their copies
// with their math.
//
// Design: an implicit GEMM on mma.sync.m16n8k16 (bf16 in, f32 accumulate).
// M is the output pixels, N is Cout in blocks of up to 64 (a grid dimension
// above 64), K is 9 taps x the input channels, 16 channels of one input per
// stage.
//   - A ring of STAGES stages in shared memory, filled with cp.async: the
//     (TH+2) x (TW+2) f32 halo of the stage's 16 channels (16-byte copies,
//     or 4-byte ones where an input's channel count is not a multiple of 4;
//     zero-filled outside the image and past the input's channels) and the
//     9 x 16 x NB bf16 weight slab that freeze() laid out (rows padded to
//     NB + 8, so ldmatrix reads them without bank conflicts; zero-filled
//     past the input's channels).  Stage t+STAGES-1's copies are in flight
//     while stage t's MMAs run.
//   - The f32 -> bf16 rounding happens where the A operand is built: each
//     lane reads its fragment's float2 pairs from the halo and packs them
//     with cvt.rn.bf16x2 (the one rounding of the activations).  The halo
//     keeps each pixel's 16 channels as four 16-byte chunks, the chunk index
//     XOR-swizzled by bit 1 of the pixel index, so a fragment's 8-byte reads
//     are free of bank conflicts.  B comes from the slab with
//     ldmatrix.x4.trans.
//   - Tiles chosen per launch: 8 x 32 pixels on 8 warps (two 16-pixel M
//     fragments each, 3 stages) where that gives at least 4 blocks per SM
//     (the UNet's 512^2 convs: 1024 blocks), else 4 x 16 on 4 warps (one
//     fragment each, 4 stages), which puts 256 blocks on the RRDB's 128^2
//     convs.  Every warp holds all NB output channels, so the halo is read
//     once per 64 output channels.
//   - The epilogue applies scale, bias and the activation in f32 to the
//     accumulators and stores float2s straight from the MMA layout, masked
//     at the ragged edges.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxInputs = 5;
constexpr int kKC = 16;      // input channels per stage (one MMA k-step)
constexpr int kMaxNB = 64;   // output channels per block

struct ConvInputs {
  const float* x[kMaxInputs];           // (B, H, W, cin[i]) NHWC, f32
  const __nv_bfloat16* w[kMaxInputs];   // (cin[i], 3, 3, cout_p), bf16
  int cin[kMaxInputs];
  int n_in;
};

// TH x (16 FX) output pixels on WARPS warps, each owning TH * FX / WARPS
// 16-pixel fragments of one row; STAGES-deep copy ring
template <int TH_, int FX_, int WARPS_, int STAGES_>
struct Tile {
  static constexpr int TH = TH_, FX = FX_, TW = 16 * FX_, WARPS = WARPS_;
  static constexpr int STAGES = STAGES_, THREADS = 32 * WARPS_;
  static constexpr int MF = TH * FX / WARPS;
  static constexpr int HR = TH + 2, HC = TW + 2, NPIX = HR * HC;
  static_assert(MF >= 1 && MF <= FX && TH * FX % WARPS == 0, "tile");
};
using Big = Tile<8, 2, 8, 3>;
using Small = Tile<4, 1, 4, 4>;

template <class T, int NB>
struct Smem {
  static constexpr int LDW = NB + 8;                  // weight row, bf16
  static constexpr int A = T::NPIX * kKC * 4;         // halo bytes
  static constexpr int B = 9 * kKC * LDW * 2;         // slab bytes
  static constexpr int STAGE = (A + B + 127) / 128 * 128;
  static constexpr int BYTES = T::STAGES * STAGE;
  // the copy loops' unroll, as measured (profiling/k3_times.py): rolled on
  // the 8 x 32 tile at NB 32 (dense5c), by 4 there at NB 64 (up), else by
  // 2 (by 4 the 4 x 16 tile at NB 64 spills)
  static constexpr int CU = T::FX == 2 ? (NB == 32 ? 1 : NB == 64 ? 4 : 2) : 2;
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

// 16 (or 4) bytes global -> shared, zero-filled where src_bytes is 0
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

// float offset of channel ch (< 16) of halo pixel p: four 16-byte chunks,
// the chunk index XOR-swizzled by bit 1 of p
__device__ __forceinline__ int halo_off(int p, int ch) {
  return p * kKC + ((((ch >> 2) ^ (p & 2))) << 2) + (ch & 3);
}

// two f32 halo values (channels ch, ch + 1 of pixel p) -> one bf16x2 word,
// the lower channel in the low half (the A fragment's order)
__device__ __forceinline__ uint32_t a_pair(const float* s_a, int p, int ch) {
  const float2 v = *reinterpret_cast<const float2*>(s_a + halo_off(p, ch));
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(p)));
}

template <class T, int NB>
__global__ void __launch_bounds__(T::THREADS)
conv3x3_bf16_kernel(ConvInputs in, const float* __restrict__ scale,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int H, int W, int cout, int cout_p, int act,
                    float slope) {
  using S = Smem<T, NB>;
  constexpr int LDW = S::LDW, NT = NB / 8;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int x0 = blockIdx.x * T::TW, y0 = blockIdx.y * T::TH;
  const int n_blocks = cout_p / NB;
  const int img = blockIdx.z / n_blocks;
  const int n0 = (blockIdx.z - img * n_blocks) * NB;
  const size_t img_px = static_cast<size_t>(img) * H * W;
  out += img_px * cout;

  int n_stages = 0;
#pragma unroll
  for (int i = 0; i < kMaxInputs; ++i) {
    if (i < in.n_in) n_stages += (in.cin[i] + kKC - 1) / kKC;
  }

  // the copies of one stage (input li, channels lc..lc+15) into ring slot
  int li = 0, lc = 0;
  auto load_stage = [&](int slot) {
    float* s_a = reinterpret_cast<float*>(smem + slot * S::STAGE);
    __nv_bfloat16* s_b =
        reinterpret_cast<__nv_bfloat16*>(smem + slot * S::STAGE + S::A);
    const int ci = pick(in.cin, li);
    const float* x = pick(in.x, li) + img_px * ci;
    const __nv_bfloat16* w = pick(in.w, li);
    if (ci % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
#pragma unroll (S::CU)
      for (int e = tid; e < T::NPIX * 4; e += T::THREADS) {
        const int p = e >> 2, g = e & 3;
        const int r = p / T::HC, col = p - r * T::HC;
        const int gy = y0 + r - 1, gx = x0 + col - 1, ch = lc + 4 * g;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ch < ci;
        const float* src =
            ok ? x + (static_cast<size_t>(gy) * W + gx) * ci + ch : x;
        cp_async16(s_a + halo_off(p, 4 * g), src, ok ? 16 : 0);
      }
    } else {
#pragma unroll (S::CU)
      for (int e = tid; e < T::NPIX * kKC; e += T::THREADS) {
        const int p = e >> 4, c = e & 15;
        const int r = p / T::HC, col = p - r * T::HC;
        const int gy = y0 + r - 1, gx = x0 + col - 1, ch = lc + c;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ch < ci;
        const float* src =
            ok ? x + (static_cast<size_t>(gy) * W + gx) * ci + ch : x;
        cp_async4(s_a + halo_off(p, c), src, ok ? 4 : 0);
      }
    }
    // weight slab: row (tap, k) holds NB output channels from n0
#pragma unroll (S::CU)
    for (int e = tid; e < 9 * kKC * (NB / 8); e += T::THREADS) {
      const int v8 = e % (NB / 8), row = e / (NB / 8);
      const int tap = row / kKC, k = row % kKC, ch = lc + k;
      const bool ok = ch < ci;
      const __nv_bfloat16* src =
          ok ? w + (static_cast<size_t>(ch) * 9 + tap) * cout_p + n0 + 8 * v8
             : w;
      cp_async16(s_b + row * LDW + 8 * v8, src, ok ? 16 : 0);
    }
    lc += kKC;
    if (lc >= ci) {
      ++li;
      lc = 0;
    }
  };

  float acc[T::MF][NT][4];
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < n_stages) load_stage(s);
    cp_async_commit();
  }

  // this lane's rows of the ldmatrix tiles (B) and of the fragments (A)
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_nt = lane >> 4;
  const int g = lane >> 2, q2 = (lane & 3) * 2;

  for (int t = 0; t < n_stages; ++t) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // stage t landed; slot (t - 1) % STAGES is free
    if (t + T::STAGES - 1 < n_stages) {
      load_stage((t + T::STAGES - 1) % T::STAGES);
    }
    cp_async_commit();
    const int slot = t % T::STAGES;
    const float* s_a = reinterpret_cast<const float*>(smem + slot * S::STAGE);
    const __nv_bfloat16* s_b = reinterpret_cast<const __nv_bfloat16*>(
        smem + slot * S::STAGE + S::A);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        ldsm_x4_trans(b[j][0], b[j][1], b[j + 1][0], b[j + 1][1],
                      s_b + (tap * kKC + b_row) * LDW + (j + b_nt) * 8);
      }
#pragma unroll
      for (int i = 0; i < T::MF; ++i) {
        const int f = warp * T::MF + i;
        const int p0 =
            (f / T::FX + dy) * T::HC + (f % T::FX) * 16 + dx + g;
        uint32_t a[4];
        a[0] = a_pair(s_a, p0, q2);
        a[1] = a_pair(s_a, p0 + 8, q2);
        a[2] = a_pair(s_a, p0, q2 + 8);
        a[3] = a_pair(s_a, p0 + 8, q2 + 8);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: lane holds pixels g and g + 8 of each fragment, channels
  // 8 j + q2 and + 1 of each 8-wide N tile
#pragma unroll
  for (int i = 0; i < T::MF; ++i) {
    const int f = warp * T::MF + i;
    const int gy = y0 + f / T::FX;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gx = x0 + (f % T::FX) * 16 + g + 8 * h;
      if (gy >= H || gx >= W) continue;
      float* dst = out + (static_cast<size_t>(gy) * W + gx) * cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int co = n0 + 8 * j + q2;
        if (co >= cout) continue;
        float v[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float t = v[e] * (scale ? __ldg(scale + co + e) : 1.f) +
                    (bias ? __ldg(bias + co + e) : 0.f);
          if (act == 1) t = fmaxf(t, 0.f);
          else if (act == 2) t = t >= 0.f ? t : t * slope;
          v[e] = t;
        }
        *reinterpret_cast<float2*>(dst + co) = make_float2(v[0], v[1]);
      }
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

template <class T, int NB>
int launch_tile(const ConvInputs& in, const float* scale, const float* bias,
                float* out, int B, int H, int W, int cout, int cout_p,
                int act, float slope, cudaStream_t stream) {
  using S = Smem<T, NB>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_bf16_kernel<T, NB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((W + T::TW - 1) / T::TW, (H + T::TH - 1) / T::TH,
                  B * (cout_p / NB));
  conv3x3_bf16_kernel<T, NB><<<grid, T::THREADS, S::BYTES, stream>>>(
      in, scale, bias, out, H, W, cout, cout_p, act, slope);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch(const ConvInputs& in, const float* scale, const float* bias,
           float* out, int B, int H, int W, int cout, int cout_p, int act,
           float slope, cudaStream_t stream) {
  // the big tile where it still gives every SM 4 blocks over the batch,
  // else the small one
  const long big_blocks = static_cast<long>((W + Big::TW - 1) / Big::TW) *
                          ((H + Big::TH - 1) / Big::TH) * (cout_p / NB) * B;
  if (big_blocks >= 4L * num_sms()) {
    return launch_tile<Big, NB>(in, scale, bias, out, B, H, W, cout, cout_p,
                                act, slope, stream);
  }
  return launch_tile<Small, NB>(in, scale, bias, out, B, H, W, cout, cout_p,
                                act, slope, stream);
}

}  // namespace

// xs[i]: (B, H, W, cins[i]) NHWC f32; ws[i]: (cins[i], 3, 3, cout_p) bf16
// with cout_p = cout rounded up to 16 (zero columns past cout), 16-byte
// aligned; scale, bias: (cout,) f32, or null for 1 / 0; out: (B, H, W,
// cout) f32.  act: 0 none, 1 relu, 2 leaky relu.  cout must be a multiple
// of 8 with cout_p 16, 32, 64 or a multiple of 64; 1 <= n_in <= 5;
// B * max(1, cout_p / 64) <= 65535 (the grid's z extent).
extern "C" int conv3x3_cat_bf16(int n_in, const void* const* xs,
                                const void* const* ws, const int* cins,
                                const void* scale, const void* bias,
                                void* out, int B, int H, int W, int cout,
                                int act, float slope, void* stream) {
  const int cout_p = (cout + 15) / 16 * 16;
  if (n_in < 1 || n_in > kMaxInputs || cout <= 0 || cout % 8 != 0 ||
      (cout_p > kMaxNB && cout_p % kMaxNB != 0) ||
      static_cast<long>(B) * (cout_p > kMaxNB ? cout_p / kMaxNB : 1) >
          65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  ConvInputs in{};
  in.n_in = n_in;
  for (int i = 0; i < n_in; ++i) {
    in.x[i] = static_cast<const float*>(xs[i]);
    in.w[i] = static_cast<const __nv_bfloat16*>(ws[i]);
    in.cin[i] = cins[i];
    if (cins[i] <= 0 || (reinterpret_cast<uintptr_t>(ws[i]) & 15) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cout_p >= kMaxNB ? kMaxNB : cout_p) {
    case 16:
      return launch<16>(in, s, b, o, B, H, W, cout, cout_p, act, slope, st);
    case 32:
      return launch<32>(in, s, b, o, B, H, W, cout, cout_p, act, slope, st);
    case 64:
      return launch<64>(in, s, b, o, B, H, W, cout, cout_p, act, slope, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
