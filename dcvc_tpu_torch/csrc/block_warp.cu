// Block warp for Hopper (sm_90a): approximate bilinear backward warp.
//
// Replaces the Pallas TPU kernel dcvc_tpu/ops/block_warp.py:_kernel; the
// semantics are its oracle block_warp_ref. See
// dcvc_tpu_torch/ops/block_warp.py for the contract, the bound (bytes) and
// the design; the per-block base and window origin (sy, sx, eff_y, eff_x)
// arrive precomputed from PyTorch.
//
// One CTA per (block column, block row, map x channel group):
//   1. stage the block's window, Cg channels of (BH+2Rv+2) x (BW+2Dh+2)
//      texels, in shared memory as f32. Window texel (r, c) sits at padded
//      coordinate (sy + r, sx + c); the edge-replicate pad makes that
//      im[clamp(sy + r - Py, 0, H-1), clamp(sx + c - Px, 0, W-1)].
//   2. per output pixel: read its flow once, clamp the residual from the
//      block's effective base to [-R, R - 1e-4], split it into the integer
//      tap and the bilinear weight, and resolve the 4 taps from shared
//      memory for each channel.
// The arithmetic uses explicitly rounded ops (no FMA contraction) in the
// plain PyTorch version's order, so both give the same f32 bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  // a * (1 - w) + b * w, each op rounded separately
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, w)), __fmul_rn(b, w));
}

template <typename T>
__global__ void block_warp_kernel(const T* __restrict__ im,
                                  const float* __restrict__ flow,
                                  T* __restrict__ out,
                                  const int* __restrict__ sy_arr,
                                  const int* __restrict__ sx_arr,
                                  const float* __restrict__ ey_arr,
                                  const float* __restrict__ ex_arr,
                                  int C, int H, int W, int nby, int nbx,
                                  int BH, int BW, int Dh, int Rv, int Py,
                                  int Px, float hy, float hx, int Cg) {
  extern __shared__ float win[];
  const int bj = blockIdx.x;
  const int bi = blockIdx.y;
  const int ncg = C / Cg;
  const int m = blockIdx.z / ncg;
  const int c0 = (blockIdx.z % ncg) * Cg;
  const int WH = BH + 2 * Rv + 2;
  const int WW = BW + 2 * Dh + 2;
  const int blk = (m * nby + bi) * nbx + bj;
  const int sy = sy_arr[blk];
  const int sx = sx_arr[blk];
  const float ey = ey_arr[blk];
  const float ex = ex_arr[blk];
  const int64_t HW = static_cast<int64_t>(H) * W;
  const T* im_m = im + (static_cast<int64_t>(m) * C + c0) * HW;

  const int n_win = Cg * WH * WW;
  for (int t = threadIdx.x; t < n_win; t += blockDim.x) {
    const int c = t / (WH * WW);
    const int rem = t - c * (WH * WW);
    const int r = rem / WW;
    const int col = rem - r * WW;
    const int y = min(max(sy + r - Py, 0), H - 1);
    const int x = min(max(sx + col - Px, 0), W - 1);
    win[t] = load_f32(im_m + c * HW + static_cast<int64_t>(y) * W + x);
  }
  __syncthreads();

  const float* fx_m = flow + static_cast<int64_t>(m) * 2 * HW;
  const float* fy_m = fx_m + HW;
  T* out_m = out + (static_cast<int64_t>(m) * C + c0) * HW;
  for (int p = threadIdx.x; p < BH * BW; p += blockDim.x) {
    const int il = p / BW;
    const int jl = p - il * BW;
    const int y = bi * BH + il;
    const int x = bj * BW + jl;
    if (y >= H || x >= W) continue;
    const int64_t o = static_cast<int64_t>(y) * W + x;
    const float ry = fminf(fmaxf(__fsub_rn(__ldg(fy_m + o), ey),
                                 static_cast<float>(-Rv)), hy);
    const float rx = fminf(fmaxf(__fsub_rn(__ldg(fx_m + o), ex),
                                 static_cast<float>(-Dh)), hx);
    const float fy0 = floorf(ry);
    const float fx0 = floorf(rx);
    const float wy = __fsub_rn(ry, fy0);
    const float wx = __fsub_rn(rx, fx0);
    const int a = il + static_cast<int>(fy0) + Rv + 1;   // window row
    const int b = jl + static_cast<int>(fx0) + Dh + 1;   // window col
    for (int c = 0; c < Cg; ++c) {
      const float* w0 = win + (c * WH + a) * WW + b;
      const float top = lerp_rn(w0[0], w0[1], wx);
      const float bot = lerp_rn(w0[WW], w0[WW + 1], wx);
      store(out_m + c * HW + o, lerp_rn(top, bot, wy));
    }
  }
}

template <typename T>
int launch(const void* im, const float* flow, void* out, const int* sy,
           const int* sx, const float* ey, const float* ex, int M, int C,
           int H, int W, int nby, int nbx, int BH, int BW, int Dh, int Rv,
           int Py, int Px, float hy, float hx, int Cg, int smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      block_warp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(nbx, nby, M * (C / Cg));
  block_warp_kernel<T><<<grid, 256, smem, stream>>>(
      static_cast<const T*>(im), flow, static_cast<T*>(out), sy, sx, ey, ex,
      C, H, W, nby, nbx, BH, BW, Dh, Rv, Py, Px, hy, hx, Cg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int block_warp_launch(const void* im, const void* flow, void* out,
                                 const void* sy, const void* sx,
                                 const void* ey, const void* ex, int M, int C,
                                 int H, int W, int nby, int nbx, int BH,
                                 int BW, int Dh, int Rv, int Py, int Px,
                                 float hy, float hx, int Cg, int is_bf16,
                                 int smem, void* stream) {
  const float* fl = static_cast<const float*>(flow);
  const int* sy_i = static_cast<const int*>(sy);
  const int* sx_i = static_cast<const int*>(sx);
  const float* ey_f = static_cast<const float*>(ey);
  const float* ex_f = static_cast<const float*>(ex);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(im, fl, out, sy_i, sx_i, ey_f, ex_f, M, C,
                                 H, W, nby, nbx, BH, BW, Dh, Rv, Py, Px, hy,
                                 hx, Cg, smem, st);
  return launch<float>(im, fl, out, sy_i, sx_i, ey_f, ex_f, M, C, H, W, nby,
                       nbx, BH, BW, Dh, Rv, Py, Px, hy, hx, Cg, smem, st);
}
