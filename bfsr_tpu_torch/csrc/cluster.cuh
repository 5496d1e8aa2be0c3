// Thread-block clusters, shared by the wide levels of K5 in both precisions
// (flow_step.cu's flow_step_wide_kernel, flow_step_bf16.cu's
// flow_step_bf16_wide_kernel): a CTA's rank, the cluster barrier, and
// stores into the shared memory of the cluster's other CTAs (distributed
// shared memory), plain or completing on an mbarrier there.
#pragma once

#include <cstdint>

namespace {

// the cluster: this CTA's rank, and a barrier of all its threads whose
// shared-memory stores (remote ones too) the threads after it see
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the barrier's two halves: arrive, then (later) wait for every thread of
// the cluster to have arrived; a thread alternates them
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address in CTA k's shared memory of this CTA's shared address a
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int k) {
  uint32_t ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra) : "r"(a), "r"(k));
  return ra;
}

// v to p in every CTA of the cluster (the same offset in each): float4
// stores (N % 4 == 0, p 16-byte aligned) or float2 stores (p 8-byte
// aligned) into distributed shared memory
template <int NC, int N>
__device__ __forceinline__ void st_cluster(float* p, const float (&v)[N]) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const uint32_t ra = cluster_addr(a, k);
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        asm volatile(
            "st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                ra + 16 * i),
            "f"(v[4 * i]), "f"(v[4 * i + 1]), "f"(v[4 * i + 2]),
            "f"(v[4 * i + 3])
            : "memory");
      }
    } else {
      static_assert(N % 2 == 0, "float2 stores");
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         ra + 8 * i),
                     "f"(v[2 * i]), "f"(v[2 * i + 1])
                     : "memory");
      }
    }
  }
}

// v (16 or 8 bytes) to CTA d of the cluster at this CTA's shared address a,
// completing its bytes on the mbarrier at this CTA's shared address ba there
__device__ __forceinline__ void st_async(uint32_t a, const uint4& v,
                                         uint32_t ba, int d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(cluster_addr(a, d)),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(cluster_addr(ba, d))
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t a, const uint2& v,
                                         uint32_t ba, int d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
      "[%0], {%1, %2}, [%3];\n" ::"r"(cluster_addr(a, d)),
      "r"(v.x), "r"(v.y), "r"(cluster_addr(ba, d))
      : "memory");
}

// this CTA's share of a map in shared memory, stored to the same place in
// the cluster's other NC - 1 CTAs, each store completing bytes on the
// mbarrier at bar's offset there: rows x BYTES bytes from byte off of each
// row (rows ld bytes apart, from base), in 16-byte pieces (BYTES % 16 == 0,
// every piece 16-byte aligned) or 8-byte ones, by nt threads, this one the
// t-th
template <int NC, int BYTES>
__device__ __forceinline__ void share_rows(const void* base, int ld, int off,
                                           int rows, int rank, uint64_t* bar,
                                           int t, int nt) {
  constexpr int V = BYTES % 16 == 0 ? 16 : 8, PER = BYTES / V;
  static_assert(BYTES % 8 == 0, "pieces of 8 or 16 bytes");
  const unsigned char* b = static_cast<const unsigned char*>(base) + off;
  const uint32_t ba = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  for (int e = t; e < rows * PER; e += nt) {
    const unsigned char* p = b + (e / PER) * ld + (e % PER) * V;
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    if constexpr (V == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
#pragma unroll
      for (int k = 1; k < NC; ++k) st_async(a, v, ba, (rank + k) % NC);
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
      for (int k = 1; k < NC; ++k) st_async(a, v, ba, (rank + k) % NC);
    }
  }
}

// an mbarrier in shared memory that remote stores complete: set to one
// arrival (the thread that states the bytes to wait for), the setting made
// visible to the cluster
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], 1;\n"
      "fence.mbarrier_init.release.cluster;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(bar)))
      : "memory");
}
// the arrival, stating the bytes the barrier's phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
      "r"(bytes)
      : "memory");
}
// wait for the barrier's phase of parity ``parity`` to complete; what the
// stores completing it wrote is seen after
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
      "r"(parity)
      : "memory");
}

}  // namespace
