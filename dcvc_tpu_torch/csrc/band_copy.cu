// Band copy probe for Hopper (sm_90a): dynamic-offset row-band staging.
//
// Replaces the Pallas TPU kernel tools/diag_dma.py:make_bench.kernel. For
// each output row r it stages the whole band src[by[r] : by[r] + A] (A x C x
// Wp f32, contiguous in src) in shared memory and writes
// out[r, :] = band[0, 0, :], i.e. src[by[r], 0, :]. See
// dcvc_tpu_torch/ops/band_copy.py for the contract and the bound.
//
// One CTA per rows_per_step output rows, as the TPU grid. A band (4 x 16 x
// 1408 x 4 B = 352 KiB at the tool's shape) does not fit in the 227 KB a CTA
// may hold, so it streams through two kChunkBytes buffers with cp.async:
// stage s + 1 is in flight while stage s is waited on and its share of band
// row 0 is written out. Stages run over (row, chunk) pairs, so the next
// row's first chunk overlaps the current row's last. The whole band is
// always copied: the copy is the work the probe measures. 16-byte copies
// when every band start is 16-byte aligned, else 4-byte copies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkBytes = 64 * 1024;
constexpr int kChunkFloats = kChunkBytes / 4;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ long long chunk_len(long long band_floats,
                                               long long c0) {
  long long left = band_floats - c0;
  return left < kChunkFloats ? left : kChunkFloats;
}

// Issue the copies of one (row, chunk) stage into buffer (stage & 1) and
// commit them as one cp.async group (an empty group where this thread has
// no copies, so every thread commits the same number of groups).
template <bool kVec16>
__device__ __forceinline__ void issue_stage(
    const float* __restrict__ src, const int* __restrict__ by,
    float* smem, int row0, int stage, int n_chunks, long long row_pitch,
    long long band_floats) {
  const int r = stage / n_chunks;
  const long long c0 = static_cast<long long>(stage % n_chunks) * kChunkFloats;
  const float* band =
      src + static_cast<long long>(by[row0 + r]) * row_pitch + c0;
  float* buf = smem + (stage & 1) * kChunkFloats;
  const int n = static_cast<int>(chunk_len(band_floats, c0));
  if (kVec16) {
    for (int v = threadIdx.x; v < n / 4; v += kThreads)
      cp_async16(buf + 4 * v, band + 4 * v);
  } else {
    for (int v = threadIdx.x; v < n; v += kThreads)
      cp_async4(buf + v, band + v);
  }
  cp_async_commit();
}

template <bool kVec16>
__global__ void __launch_bounds__(kThreads)
    band_copy_kernel(const float* __restrict__ src,
                     const int* __restrict__ by, float* __restrict__ out,
                     int Wp, long long row_pitch, long long band_floats,
                     int n_chunks, int rows_per_step) {
  extern __shared__ __align__(16) float smem[];  // 2 x kChunkFloats
  const int row0 = blockIdx.x * rows_per_step;
  const int n_stages = rows_per_step * n_chunks;

  issue_stage<kVec16>(src, by, smem, row0, 0, n_chunks, row_pitch,
                      band_floats);
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) {
      issue_stage<kVec16>(src, by, smem, row0, s + 1, n_chunks, row_pitch,
                          band_floats);
      cp_async_wait<1>();  // stage s has landed, s + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const long long c0 = static_cast<long long>(s % n_chunks) * kChunkFloats;
    if (c0 < Wp) {  // this chunk holds part of band[0, 0, :]
      const float* buf = smem + (s & 1) * kChunkFloats;
      const long long end_l = c0 + kChunkFloats < Wp ? c0 + kChunkFloats : Wp;
      const int end = static_cast<int>(end_l);
      float* orow = out + static_cast<long long>(row0 + s / n_chunks) * Wp;
      for (int i = static_cast<int>(c0) + threadIdx.x; i < end; i += kThreads)
        orow[i] = buf[i - c0];
    }
    __syncthreads();  // buffer (s & 1) is refilled by stage s + 2
  }
}

template <bool kVec16>
int launch(const float* src, const int* by, float* out, int H, int Wp,
           long long row_pitch, int A, int rows_per_step,
           cudaStream_t stream) {
  const int smem = 2 * kChunkBytes;
  cudaError_t err = cudaFuncSetAttribute(
      band_copy_kernel<kVec16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long band_floats = static_cast<long long>(A) * row_pitch;
  const int n_chunks =
      static_cast<int>((band_floats + kChunkFloats - 1) / kChunkFloats);
  band_copy_kernel<kVec16><<<H / rows_per_step, kThreads, smem, stream>>>(
      src, by, out, Wp, row_pitch, band_floats, n_chunks, rows_per_step);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int band_copy_launch(const void* src, const void* by, void* out,
                                int H, int Wp, long long row_pitch, int A,
                                int rows_per_step, int vec16, void* stream) {
  const float* s = static_cast<const float*>(src);
  const int* b = static_cast<const int*>(by);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec16)
    return launch<true>(s, b, o, H, Wp, row_pitch, A, rows_per_step, st);
  return launch<false>(s, b, o, H, Wp, row_pitch, A, rows_per_step, st);
}
