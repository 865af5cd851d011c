// Block warp (K1) for Hopper (sm_90a): approximate bilinear backward warp.
//
// Replaces the Pallas TPU kernel dcvc_tpu/ops/block_warp.py:_kernel; the
// semantics are its oracle block_warp_ref, repeated by the plain PyTorch
// version in dcvc_tpu_torch/ops/block_warp.py (which also plans each launch).
//
// What bounds it: bytes. Per output value it does ~13 flops on data it reads
// once (im, flow) and writes once (out).
//
// The prep and the warp are separate kernels.
//
// The prep, for "median" and "median4" (``mean`` stays in PyTorch): the
// block's base is the median of its flow samples (all of them for "median",
// a 4x4-strided subsample for "median4"), as jnp.median takes it: the mean
// of the two middle values of an even count, rounded half to even. The
// samples are bitonic-sorted: up to 512 of them by one warp in registers
// (block_prep_warp_kernel, 16 a lane for median4 at 64 x 128 blocks), more
// by one CTA in shared memory (block_prep_kernel). The middle values do not
// depend on the order, so the base is exact. The window origin is then
// clamped into the edge-padded frame and the clamp folded into the
// effective base: sy / sx (int32) and eff_by / eff_bx (f32), [M, nby, nbx].
//
// block_warp_kernel, one CTA per (block column, block row, map), all
// channels:
//   * the block's output rows go in strips of S rows. Window rows are staged
//     in chunks of S rows through a ring of NST chunks in shared memory
//     (f32 or bf16 as stored). Strip s reads chunks s .. s + D, D =
//     ceil(2 Rv / S); while it resolves, chunk s + D + 1 is in flight
//     (cp.async 16-byte copies, one commit group per chunk), so loading
//     overlaps resolving and each window row is loaded once per channel.
//   * each pixel's flow is read once; its residual, taps and weights are
//     computed once in registers and applied to every channel. Channels
//     that do not fit the ring go in groups, one after another in this CTA.
//   * edge replicate: staged row r is frame row clamp(y0 + r); only the
//     columns the taps can reach inside the frame are staged, and a block
//     whose window leaves the frame sideways clamps each tap's column before
//     reading it. Window texel (r, c) is thus im[clamp(y0 + r), clamp(x0 + c)]
//     with no padded copy of the source.
//   * PX = 4 (rows 16-byte aligned): each thread takes 4 adjacent pixels,
//     reads their flow as float4 and writes 16 (f32) or 8 (bf16) bytes per
//     channel; lanes rotate the order of their 4 pixels by (lane / 8) % 4 so
//     that one shared-memory read of a warp spans all 32 banks. PX = 1
//     (other widths): one pixel per thread, and plain loads stage the ring.
// Occupancy at the 1080p OffsetDiversity shape (64 x 128 blocks, Dh = Rv =
// 4, C = 3): S = 8, D = 1, NST = 3; the ring is 24 rows x 3 channels x 140
// floats = 40,320 B in f32 (20,736 B in bf16); 256 threads at up to 64
// registers (ptxas -v, printed by chip_smoke.py), so 4 CTAs per SM, bound
// by registers. Measured on an H100: pinning 48 registers for a fifth CTA
// spills and is slower; loading the next strip's flow ahead into registers
// and keeping two chunks in flight were both slower too.
//
// The arithmetic uses explicitly rounded ops (no FMA contraction) in the
// plain version's order, so both give the same bits in f32 and bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

// launch geometry, filled on the host from the int array that
// dcvc_tpu_torch/ops/block_warp.py:_geometry builds (same field order)
struct Geo {
  int M, C, H, W, nby, nbx, BH, BW, Dh, Rv, Py, Px;
  int S, D, NST, NS, Cg, span, unit_shift;
  float hy, hx;
};
constexpr int kGeoInts = 19;
static_assert(offsetof(Geo, hy) == kGeoInts * sizeof(int), "Geo layout");

struct PrepGeo {
  int H, W, nby, nbx, BH, BW, step, ny, nx, npow2, pad, ymax, xmax;
};
constexpr int kPrepInts = 13;
static_assert(sizeof(PrepGeo) == kPrepInts * sizeof(int), "PrepGeo layout");

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  // a * (1 - w) + b * w, each op rounded separately
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, w)), __fmul_rn(b, w));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int PX>
__device__ __forceinline__ void load_px(const float* p, float (&v)[PX]) {
  if constexpr (PX == 4) {
    const float4 f = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    v[0] = __ldcs(p);
  }
}

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

template <int PX>
__device__ __forceinline__ void store_px(float* p, const float (&v)[PX]) {
  if constexpr (PX == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else
    __stcs(p, v[0]);
}
template <int PX>
__device__ __forceinline__ void store_px(__nv_bfloat16* p,
                                         const float (&v)[PX]) {
  if constexpr (PX == 4)
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3])));
  else
    *p = __float2bfloat16_rn(v[0]);
}

// a[i] <- a[(i + r) % 4]
template <typename V>
__device__ __forceinline__ void rotate_left(V (&a)[4], int r) {
  if (r & 1) { const V t = a[0]; a[0] = a[1]; a[1] = a[2]; a[2] = a[3]; a[3] = t; }
  if (r & 2) { V t = a[0]; a[0] = a[2]; a[2] = t; t = a[1]; a[1] = a[3]; a[3] = t; }
}
// a[i] <- a[(i - r) % 4]
template <typename V>
__device__ __forceinline__ void rotate_right(V (&a)[4], int r) {
  if (r & 1) { const V t = a[3]; a[3] = a[2]; a[2] = a[1]; a[1] = a[0]; a[0] = t; }
  if (r & 2) { V t = a[0]; a[0] = a[2]; a[2] = t; t = a[1]; a[1] = a[3]; a[3] = t; }
}

template <typename T, int PX>
__global__ void __launch_bounds__(kThreads, 4)
block_warp_kernel(const T* __restrict__ im, const float* __restrict__ flow,
                  T* __restrict__ out, const int* __restrict__ sy_arr,
                  const int* __restrict__ sx_arr,
                  const float* __restrict__ ey_arr,
                  const float* __restrict__ ex_arr, const Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);
  constexpr int A = PX == 4 ? 16 / static_cast<int>(sizeof(T)) : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bj = blockIdx.x, bi = blockIdx.y, m = blockIdx.z;
  const int blk = (m * g.nby + bi) * g.nbx + bj;
  const int y0 = sy_arr[blk] - g.Py;  // frame row of window row 0
  const int x0 = sx_arr[blk] - g.Px;  // frame column of window column 0
  const float ey = ey_arr[blk], ex = ex_arr[blk];
  // taps reach window columns 1 .. BW + 2Dh
  const int lo = x0 + 1, hi = x0 + g.BW + 2 * g.Dh;
  const bool edge = lo < 0 || hi > g.W - 1;
  const int xs = min(max(lo, 0), g.W - 1) / A * A;  // first staged column
  const int nvec = (min(max(hi, 0), g.W - 1) - xs + A) / A;
  const int line = g.Cg * g.span;  // one ring row: every staged channel
  const int ring_rows = g.NST * g.S;
  const int nch = g.NS + g.D;  // chunks per channel group
  const int ncg = (g.C + g.Cg - 1) / g.Cg;
  const int64_t HW = static_cast<int64_t>(g.H) * g.W;
  const T* const im_m = im + static_cast<int64_t>(m) * g.C * HW;
  T* const out_m = out + static_cast<int64_t>(m) * g.C * HW;
  const float* const fx_m = flow + static_cast<int64_t>(m) * 2 * HW;
  const float* const fy_m = fx_m + HW;

  // chunk t: channel group t / nch, window rows 1 + k S .. k S + S
  auto stage = [&](int t) {
    const int grp = t / nch;
    const int k = t - grp * nch;
    const int c0 = grp * g.Cg;
    const int cn = min(g.Cg, g.C - c0);
    T* const slot = ring + (t % g.NST) * g.S * line;
    for (int l = warp; l < g.S * cn; l += kThreads / 32) {
      const int j = l / cn;
      const int c = l - j * cn;
      const int y = min(max(y0 + 1 + k * g.S + j, 0), g.H - 1);
      const T* src = im_m + (c0 + c) * HW + static_cast<int64_t>(y) * g.W + xs;
      T* dst = slot + j * line + c * g.span;
      for (int v = lane; v < nvec; v += 32) {
        if constexpr (PX == 4)
          cp_async16(dst + v * A, src + v * A);
        else
          dst[v] = src[v];
      }
    }
    if constexpr (PX == 4) cp_async_commit();
  };

  const int units = g.S * g.BW / PX;  // work units of one strip
  const int urow = g.BW / PX;         // units per output row
  const int n_chunks = ncg * nch;
  int issued = 0;
  for (int u = 0; u < ncg * g.NS; ++u) {
    const int grp = u / g.NS;
    const int s = u - grp * g.NS;
    const int first = grp * nch + s;  // the strip reads chunks first..first+D
    while (issued < n_chunks && issued < first + g.NST) stage(issued++);
    if constexpr (PX == 4) {  // chunks issued after first + D may pend
      if (issued - 1 > first + g.D) cp_async_wait<1>();
      else cp_async_wait<0>();
    }
    __syncthreads();
    const int c0 = grp * g.Cg;
    const int cn = min(g.Cg, g.C - c0);
    const int rs = (first % g.NST) * g.S;  // ring row of window row s S + 1
    for (int q = tid; q < units; q += kThreads) {
      const int is = g.unit_shift >= 0 ? q >> g.unit_shift : q / urow;
      const int il = s * g.S + is;
      const int jl = (q - is * urow) * PX;
      const int y = bi * g.BH + il;
      const int x = bj * g.BW + jl;
      if (il >= g.BH || y >= g.H || x >= g.W) continue;
      const int64_t o = static_cast<int64_t>(y) * g.W + x;
      float fx[PX], fy[PX];
      load_px<PX>(fx_m + o, fx);
      load_px<PX>(fy_m + o, fy);
      const int rot = PX == 4 ? (jl >> 5) & 3 : 0;
      if constexpr (PX == 4) {
        rotate_left(fx, rot);
        rotate_left(fy, rot);
      }
      int top[PX], bot[PX], dc[PX];
      float wx[PX], wy[PX];
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        const int p = (i + rot) & (PX - 1);  // the pixel fx[i], fy[i] belong to
        const float ry = fminf(fmaxf(__fsub_rn(fy[i], ey),
                                     static_cast<float>(-g.Rv)), g.hy);
        const float rx = fminf(fmaxf(__fsub_rn(fx[i], ex),
                                     static_cast<float>(-g.Dh)), g.hx);
        const float fy0 = floorf(ry);
        const float fx0 = floorf(rx);
        wy[i] = __fsub_rn(ry, fy0);
        wx[i] = __fsub_rn(rx, fx0);
        // window row of the top tap: il + fy0 + Rv + 1; ring row from rs
        int rt = rs + is + static_cast<int>(fy0) + g.Rv;
        if (rt >= ring_rows) rt -= ring_rows;
        int rb = rt + 1;
        if (rb >= ring_rows) rb -= ring_rows;
        int xa = x0 + jl + p + static_cast<int>(fx0) + g.Dh + 1;
        int xb = xa + 1;
        if (edge) {
          xa = min(max(xa, 0), g.W - 1);
          xb = min(max(xb, 0), g.W - 1);
        }
        top[i] = rt * line + xa - xs;
        bot[i] = rb * line + xa - xs;
        dc[i] = xb - xa;
      }
      for (int c = 0; c < cn; ++c) {
        const T* w = ring + c * g.span;
        float v[PX];
#pragma unroll
        for (int i = 0; i < PX; ++i) {
          const float t0 = lerp_rn(widen(w[top[i]]), widen(w[top[i] + dc[i]]),
                                   wx[i]);
          const float b0 = lerp_rn(widen(w[bot[i]]), widen(w[bot[i] + dc[i]]),
                                   wx[i]);
          v[i] = lerp_rn(t0, b0, wy[i]);
        }
        if constexpr (PX == 4) rotate_right(v, rot);
        store_px<PX>(out_m + (c0 + c) * HW + o, v);
      }
    }
    __syncthreads();  // every read of this strip's chunks is done
  }
}

// the prep's last step, one thread: the base from the two middle samples,
// the window origin clamped into the edge-padded frame, the clamp folded
// into the effective base
__device__ __forceinline__ void write_base(float lo, float hi, int comp,
                                           int blk, int bi, int bj,
                                           const PrepGeo& g,
                                           int* __restrict__ sy,
                                           int* __restrict__ sx,
                                           float* __restrict__ ey,
                                           float* __restrict__ ex) {
  const float base = rintf(__fmul_rn(__fadd_rn(lo, hi), 0.5f));
  const int raw =
      (comp ? bi * g.BH : bj * g.BW) + static_cast<int>(base) + g.pad;
  const int s = min(max(raw, 0), comp ? g.ymax : g.xmax);
  const float eff = __fsub_rn(base, static_cast<float>(raw - s));
  if (comp) {
    sy[blk] = s;
    ey[blk] = eff;
  } else {
    sx[blk] = s;
    ex[blk] = eff;
  }
}

// ascending bitonic sort of 32 R values held R to a lane (value e at lane
// e / R, register e % R); fully unrolled, so every register index is static
template <int R, int LOG_N>
__device__ __forceinline__ void warp_bitonic(float (&v)[R], int lane) {
#pragma unroll
  for (int lk = 1; lk <= LOG_N; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j >= R) {  // partner in lane ^ (j / R), same register
        const bool keep_min = ((lane & (j / R)) == 0) == (((lane * R) & k) == 0);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float o = __shfl_xor_sync(0xffffffffu, v[r], j / R);
          v[r] = keep_min ? fminf(v[r], o) : fmaxf(v[r], o);
        }
      } else {  // partner in this lane
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if ((r & j) == 0) {
            const bool asc = (((lane * R) | r) & k) == 0;
            const float a = v[r], b = v[r | j];
            v[r] = asc ? fminf(a, b) : fmaxf(a, b);
            v[r | j] = asc ? fmaxf(a, b) : fminf(a, b);
          }
        }
      }
    }
  }
}

template <int R>
__device__ __forceinline__ float sorted_at(const float (&v)[R], int e,
                                           int lane) {
  float x = v[0];
#pragma unroll
  for (int r = 1; r < R; ++r)
    if ((e & (R - 1)) == r) x = v[r];
  return __shfl_sync(0xffffffffu, x, e / R);
}

// up to 512 samples: one warp per (block, component), R = npow2 / 32 to a
// lane (at least 1), sorted in registers
template <int R, int LOG_N>
__global__ void __launch_bounds__(kThreads)
block_prep_warp_kernel(const float* __restrict__ flow, int* __restrict__ sy,
                       int* __restrict__ sx, float* __restrict__ ey,
                       float* __restrict__ ex, const PrepGeo g, int items) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (item >= items) return;  // the whole warp
  const int comp = item & 1;  // 0: x, 1: y
  const int blk = item >> 1;
  const int bj = blk % g.nbx;
  const int bi = (blk / g.nbx) % g.nby;
  const int m = blk / (g.nbx * g.nby);
  const float* plane =
      flow + (static_cast<int64_t>(m) * 2 + comp) * g.H * g.W;
  const int n = g.ny * g.nx;
  // the order in which samples enter does not matter: sample r 32 + lane
  float v[R];
  int iy = lane / g.nx, ix = lane - iy * g.nx;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float x = INFINITY;  // the power-of-two tail sorts last
    if (r * 32 + lane < n) {
      const int y = min(bi * g.BH + iy * g.step, g.H - 1);
      const int xx = min(bj * g.BW + ix * g.step, g.W - 1);
      x = __ldg(plane + static_cast<int64_t>(y) * g.W + xx);
    }
    v[r] = x;
    for (ix += 32; ix >= g.nx; ix -= g.nx) ++iy;
  }
  warp_bitonic<R, LOG_N>(v, lane);
  const float lo = sorted_at<R>(v, (n - 1) / 2, lane);
  const float hi = sorted_at<R>(v, n / 2, lane);
  if (lane == 0) write_base(lo, hi, comp, blk, bi, bj, g, sy, sx, ey, ex);
}

// more than 512 samples: one CTA per (block, component), sorted in shared
// memory
__global__ void __launch_bounds__(kThreads)
block_prep_kernel(const float* __restrict__ flow, int* __restrict__ sy,
                  int* __restrict__ sx, float* __restrict__ ey,
                  float* __restrict__ ex, const PrepGeo g) {
  extern __shared__ float vals[];
  const int bj = blockIdx.x, bi = blockIdx.y;
  const int m = blockIdx.z >> 1, comp = blockIdx.z & 1;  // comp 0: x, 1: y
  const float* plane =
      flow + (static_cast<int64_t>(m) * 2 + comp) * g.H * g.W;
  const int n = g.ny * g.nx;
  // samples of the block, the frame edge-replicated to whole blocks; the
  // power-of-two tail sorts last
  for (int t = threadIdx.x; t < g.npow2; t += kThreads) {
    float v = INFINITY;
    if (t < n) {
      const int iy = t / g.nx;
      const int ix = t - iy * g.nx;
      const int y = min(bi * g.BH + iy * g.step, g.H - 1);
      const int x = min(bj * g.BW + ix * g.step, g.W - 1);
      v = __ldg(plane + static_cast<int64_t>(y) * g.W + x);
    }
    vals[t] = v;
  }
  __syncthreads();
  for (int k = 2; k <= g.npow2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < g.npow2 / 2; i += kThreads) {
        const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int b = a | j;
        const float va = vals[a], vb = vals[b];
        if ((va > vb) == ((a & k) == 0)) {
          vals[a] = vb;
          vals[b] = va;
        }
      }
      __syncthreads();
    }
  }
  if (threadIdx.x == 0)
    write_base(vals[(n - 1) / 2], vals[n / 2], comp,
               (m * g.nby + bi) * g.nbx + bj, bi, bj, g, sy, sx, ey, ex);
}

template <typename T, int PX>
int launch_warp(const void* im, const float* flow, void* out, const int* sy,
                const int* sx, const float* ey, const float* ex, const Geo& g,
                int smem, cudaStream_t stream) {
  auto kernel = block_warp_kernel<T, PX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(g.nbx, g.nby, g.M);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(im), flow, static_cast<T*>(out), sy, sx, ey, ex,
      g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int block_warp_launch(const void* im, const void* flow, void* out,
                                 const void* sy, const void* sx,
                                 const void* ey, const void* ex,
                                 const int* geo, float hy, float hx,
                                 int is_bf16, int px, int smem,
                                 void* stream) {
  Geo g;
  memcpy(&g, geo, kGeoInts * sizeof(int));
  g.hy = hy;
  g.hx = hx;
  const float* fl = static_cast<const float*>(flow);
  const int* sy_i = static_cast<const int*>(sy);
  const int* sx_i = static_cast<const int*>(sx);
  const float* ey_f = static_cast<const float*>(ey);
  const float* ex_f = static_cast<const float*>(ex);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return px == 4 ? launch_warp<__nv_bfloat16, 4>(im, fl, out, sy_i, sx_i,
                                                   ey_f, ex_f, g, smem, st)
                   : launch_warp<__nv_bfloat16, 1>(im, fl, out, sy_i, sx_i,
                                                   ey_f, ex_f, g, smem, st);
  return px == 4 ? launch_warp<float, 4>(im, fl, out, sy_i, sx_i, ey_f, ex_f,
                                         g, smem, st)
                 : launch_warp<float, 1>(im, fl, out, sy_i, sx_i, ey_f, ex_f,
                                         g, smem, st);
}

template <int R, int LOG_N>
int launch_prep_warp(const float* flow, int* sy, int* sx, float* ey,
                     float* ex, const PrepGeo& g, int M, cudaStream_t stream) {
  const int items = 2 * M * g.nby * g.nbx;
  const int per_cta = kThreads / 32;
  block_prep_warp_kernel<R, LOG_N>
      <<<(items + per_cta - 1) / per_cta, kThreads, 0, stream>>>(
          flow, sy, sx, ey, ex, g, items);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int block_prep_launch(const void* flow, void* sy, void* sx,
                                 void* ey, void* ex, const int* geo, int M,
                                 void* stream) {
  PrepGeo g;
  memcpy(&g, geo, kPrepInts * sizeof(int));
  const float* fl = static_cast<const float*>(flow);
  int* sy_i = static_cast<int*>(sy);
  int* sx_i = static_cast<int*>(sx);
  float* ey_f = static_cast<float*>(ey);
  float* ex_f = static_cast<float*>(ex);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (g.npow2) {
    case 32: return launch_prep_warp<1, 5>(fl, sy_i, sx_i, ey_f, ex_f, g, M, st);
    case 64: return launch_prep_warp<2, 6>(fl, sy_i, sx_i, ey_f, ex_f, g, M, st);
    case 128: return launch_prep_warp<4, 7>(fl, sy_i, sx_i, ey_f, ex_f, g, M, st);
    case 256: return launch_prep_warp<8, 8>(fl, sy_i, sx_i, ey_f, ex_f, g, M, st);
    case 512: return launch_prep_warp<16, 9>(fl, sy_i, sx_i, ey_f, ex_f, g, M, st);
    default: break;
  }
  const int smem = g.npow2 * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      block_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(g.nbx, g.nby, 2 * M);
  block_prep_kernel<<<grid, kThreads, smem, st>>>(fl, sy_i, sx_i, ey_f, ex_f,
                                                  g);
  return static_cast<int>(cudaGetLastError());
}
