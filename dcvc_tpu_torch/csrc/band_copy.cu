// Band copy probe for Hopper (sm_90a): dynamic-offset row-band staging (K2).
//
// Replaces the Pallas TPU kernel tools/diag_dma.py:make_bench.kernel. For
// each output row r it stages the whole band src[by[r] : by[r] + A] (A x C x
// Wp f32, contiguous in src) in shared memory and writes
// out[r, :] = band[0, 0, :], i.e. src[by[r], 0, :]. Every requested band
// byte is copied: the copy is the work the probe measures.
//
// What bounds it: bytes. Counted once (the src rows the bands touch, by and
// out) they are 68.6 MB at the tool's shape (720 rows of [4, 16, 1408]
// bands), 20.5 us at 3.35 TB/s; the 259.5 MB of requested band bytes
// overlap, so most of them come from L2 and the L2 -> SM rate bounds them.
//
// What the design does about it:
//  * every SM works: the H * n_chunks (row, chunk) stages, row-major, go
//    round-robin over min(stages, SMs) persistent CTAs (CTA b takes b,
//    b + G, b + 2 G, ...), so at any moment the CTAs copy neighbouring
//    bands, which overlap in src and meet in L2; a stage is never split;
//  * a band is cut into n_chunks chunks whose boundaries fall on 128-byte
//    lines (chunk k: q + (k < rem) split units at k q + min(k, rem), the
//    last one `tail` bytes more), each at most what the ring's slot holds;
//  * warp 0 is the producer. On the aligned instance its lane 0 issues each
//    chunk as ONE cp.async.bulk global -> shared that completes on the
//    slot's full barrier (mbarrier.arrive.expect_tx); bytes move without
//    any thread issuing them, and a 4-stage ring keeps up to four chunks
//    (~200 KB at the tool's shape) in flight per SM. Warps 1-7 are
//    consumers: they wait on the full barrier's phase, write the part of
//    band row 0 the chunk holds (16-byte stores where out rows are 16-byte
//    aligned) and arrive on the slot's empty barrier (one arrive per warp),
//    which lets the producer refill the slot. No __syncthreads() after the
//    barriers' init;
//  * bands that are not 16-byte aligned (C * Wp * 4 % 16 != 0, or src
//    misaligned) take the second instance: the producer warp's 32 lanes
//    make 4-byte cp.async copies and each arrives on the full barrier when
//    its copies land (cp.async.mbarrier.arrive.noinc).
// The plan (chunks, ring stages, slot stride, grid) is computed in Python
// (dcvc_tpu_torch/ops/band_copy.py:plan_band_copy), which the CPU tests
// check, and passed in here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kConsumerWarps = kThreads / 32 - 1;
constexpr int kBarrierBytes = 128;  // full[kMaxStages], empty[kMaxStages]
constexpr int kMaxStages = 4;

struct Plan {
  long long row_bytes;  // C * Wp * 4: one src row, the stride of band starts
  long long stages;     // H * n_chunks
  int H, Wp, n_chunks, split, q, rem, tail, nst, slot_bytes, vec_out;
};

// Chunk k of a band: (q + (k < rem)) split units at k q + min(k, rem)
// units, the last chunk `tail` bytes more.
__device__ __forceinline__ long long chunk_offset(const Plan& p, int k) {
  return static_cast<long long>(k * p.q + min(k, p.rem)) * p.split;
}

__device__ __forceinline__ int chunk_bytes(const Plan& p, int k) {
  return (p.q + (k < p.rem)) * p.split + (k == p.n_chunks - 1 ? p.tail : 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of this parity has completed. A phase
// that never completes (a broken plan) traps, a launch failure that the
// next synchronize reports, instead of hanging the card; a real wait lasts
// microseconds, the limit is 2^26 tries.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// One of the barrier's expected arrivals, made when every cp.async this
// thread issued so far has landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

template <bool kBulk>
__global__ void __launch_bounds__(kThreads)
    band_copy_kernel(const char* __restrict__ src, const int* __restrict__ by,
                     float* __restrict__ out, const Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full0 = smem_u32(smem);
  const uint32_t empty0 = full0 + 8 * kMaxStages;
  const uint32_t ring0 = smem_u32(smem + kBarrierBytes);
  // this CTA's stages: b, b + G, b + 2 G, ... (all CTAs move over the
  // bands together, so the bands in flight overlap and hit in L2)
  const long long G = gridDim.x;
  const int n = static_cast<int>((p.stages - blockIdx.x + G - 1) / G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.nst; ++i) {
      mbar_init(full0 + 8 * i, kBulk ? 1 : 32);
      mbar_init(empty0 + 8 * i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only one: the barriers exist before any wait

  if (warp == 0) {
    if (!kBulk || lane == 0) {
      // each stage's band start is read one stage ahead
      long long s = blockIdx.x;
      int b_next = __ldg(by + s / p.n_chunks);
      for (int j = 0; j < n; ++j, s += G) {
        const int b_cur = b_next;
        if (s + G < p.stages) b_next = __ldg(by + (s + G) / p.n_chunks);
        const int slot = j % p.nst;
        if (j >= p.nst) mbar_wait(empty0 + 8 * slot, ((j / p.nst) - 1) & 1);
        const int k = static_cast<int>(s % p.n_chunks);
        const int bytes = chunk_bytes(p, k);
        const char* g =
            src + static_cast<long long>(b_cur) * p.row_bytes + chunk_offset(p, k);
        const uint32_t dst = ring0 + slot * p.slot_bytes;
        const uint32_t full = full0 + 8 * slot;
        if (kBulk) {
          mbar_arrive_expect_tx(full, bytes);
          bulk_copy(dst, g, bytes, full);
        } else {
          for (int i = lane * 4; i < bytes; i += 32 * 4) cp_async4(dst + i, g + i);
          cp_async_arrive(full);
        }
      }
    }
    return;
  }

  const long long row0_bytes = static_cast<long long>(p.Wp) * 4;
  const int t = threadIdx.x - 32, nt = kThreads - 32;
  long long s = blockIdx.x;
  for (int j = 0; j < n; ++j, s += G) {
    const int slot = j % p.nst;
    mbar_wait(full0 + 8 * slot, (j / p.nst) & 1);
    const long long row = s / p.n_chunks;
    const int k = static_cast<int>(s % p.n_chunks);
    const long long c0 = chunk_offset(p, k);
    if (c0 < row0_bytes) {  // this chunk holds part of band[0, 0, :]
      const long long c1 = min(c0 + chunk_bytes(p, k), row0_bytes);
      const float* buf =
          reinterpret_cast<const float*>(smem + kBarrierBytes + slot * p.slot_bytes);
      float* orow = out + row * p.Wp + c0 / 4;
      const int nf = static_cast<int>((c1 - c0) / 4);
      if (p.vec_out) {
        for (int i = t; i < nf / 4; i += nt)
          reinterpret_cast<float4*>(orow)[i] =
              reinterpret_cast<const float4*>(buf)[i];
      } else {
        for (int i = t; i < nf; i += nt) orow[i] = buf[i];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);
  }
}

template <bool kBulk>
int launch(const void* src, const int* by, float* out, const Plan& p,
           int grid, int smem, cudaStream_t stream) {
  static int allowed = 0;  // the largest size set so far, per instance
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        band_copy_kernel<kBulk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // a refused size must not fail the next launch
      return static_cast<int>(err);
    }
    allowed = smem;
  }
  band_copy_kernel<kBulk><<<grid, kThreads, smem, stream>>>(
      static_cast<const char*>(src), by, out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int band_copy_launch(const void* src, const void* by, void* out,
                                int H, int Wp, long long row_bytes,
                                int n_chunks, int split, int q, int rem,
                                int tail, int nst, int slot_bytes,
                                int vec_out, int grid, int smem, int bulk,
                                void* stream) {
  if (nst < 1 || nst > kMaxStages || n_chunks < 1 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{row_bytes, static_cast<long long>(H) * n_chunks, H, Wp,
               n_chunks, split, q, rem, tail, nst, slot_bytes, vec_out};
  const int* b = static_cast<const int*>(by);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bulk) return launch<true>(src, b, o, p, grid, smem, st);
  return launch<false>(src, b, o, p, grid, smem, st);
}
