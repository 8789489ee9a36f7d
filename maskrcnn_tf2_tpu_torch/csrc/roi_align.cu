// Pyramid ROIAlign over channels-last FPN maps, forward and backward, for
// Hopper (sm_90a).
//
// The forward replaces two TPU kernels of maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:
// _fwd_kernel_grouped (through _grouped_fwd_impl, N >= GROUP_MIN ROIs, the
// 1000 proposals at 7x7) and _fwd_kernel (through _pyramid_fwd_impl, the 100
// detections at 14x14). Same math: each ROI takes its level from the FPN
// formula 4 + round_half_even(log2(sqrt(h*w) / image_scale)) clipped to the
// pyramid, and is pooled with crop_and_resize bilinear samples whose grid
// endpoints sit on the box corners scaled by (H_l - 1, W_l - 1); corners clamp
// to the map and zero-area boxes pool zeros (maskrcnn_tf2_tpu/ops/roi_align.py).
//
// What bounds it on this card: bytes. At the flagship shapes the [B, N, P, P, C]
// output (25 MB per image at 7x7 in bf16) outweighs the P2-P5 maps it samples
// (11 MB per image), and the work is 8 flops per output element. Each output
// vector needs four corner vectors, so the kernel also reads about four times
// the output's bytes from L2 and L1, and it has to keep enough 16-byte loads
// in flight to cover their latency.
//
// Design: a block pools a range of bin rows of one ROI of one image; the
// launcher splits a ROI's P rows over several blocks when there are too few
// ROIs to fill the card (the 14x14 call site). The block's first threads
// compute the ROI's level and the corners and weights of its P sample columns
// and its rows once, into shared memory, behind one barrier. Then threads run
// over (bin, channel vector): each loads its four corners as 16-byte vectors
// (8 bf16 or 4 float32 channels), sums the four weighted corners in float32 in
// the reference's order, rounds once to the output dtype and stores 16 bytes,
// so 32 threads cover one bin of 256 bf16 channels and a 256-thread block
// pools 8 bins at a time. In NHWC the C values of a pixel are contiguous, so
// every vector access is coalesced, and the bins of one ROI, pooled by one
// block, share corner pixels in L1. Where C or a pointer does not allow
// 16-byte access the wrapper asks for the scalar width (one channel per
// thread) of the same template. The output is written in ROI order, so there
// is no (level, tier) sort and no unsort slot as on the TPU. The TPU kernels'
// DMA rings, tiers and strip mode worked around VMEM; here the L2 cache holds
// the maps.
//
// The backward replaces _bwd_kernel_vmem (through _pyramid_bwd_impl, pyramids
// up to 88 MiB in f32) and _bwd_kernel (the serial read-modify-write above
// that), the gradient of the custom VJP _pyramid_roi_align_pallas. It is the
// transpose of the forward: each sample's pooled cotangent is added, times the
// same four bilinear weights, into zero-initialised float32 maps [B, H_l, W_l, C],
// which one cast pass then rounds to bf16 (the JAX package's .astype(dt)).
// What bounds it on this card: bytes. At the flagship's training shapes the
// cotangent read (10 MB at 7x7, 40 MB at 14x14, batch 2, bf16) and the bf16
// gradient maps written (22 MB) outweigh the 8 flops per cotangent element.
// Design: the TPU kernels keep an image's whole cotangent pyramid in VMEM
// across a sequential ROI axis; on Hopper blocks run in no order, so the same
// one-block-per-(ROI, image) layout as the forward adds with float32 atomics,
// coalesced across the contiguous NHWC channels. Nothing has to fit on chip,
// so the one kernel covers both TPU regimes. Atomics make the order of each
// sum vary between runs; the result is compared with a tolerance.
// Build without fast math: rintf rounds half to even like jnp.round, and the
// level boundaries need IEEE sqrt, division and log2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;

struct Pyramid {
  const void* data[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int levels;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_scalar(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_scalar(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Sample coordinate i of P along [lo, hi], in pixels of a map of extent dim_m1 + 1.
__device__ __forceinline__ float sample_coord(float lo, float hi, int i, int p, float dim_m1) {
  if (p > 1) {
    const float frac = static_cast<float>(i) / static_cast<float>(p - 1);
    return (lo + (hi - lo) * frac) * dim_m1;
  }
  return (0.5f * (lo + hi)) * dim_m1;
}

// 0-based FPN level of a non-empty box of height h and width w.
__device__ __forceinline__ int roi_level(float h, float w, float image_scale, int levels) {
  const int level = static_cast<int>(rintf(log2f(sqrtf(fmaxf(h * w, 1e-12f)) / image_scale))) + 4;
  return min(max(level, 2), 1 + levels) - 2;
}

struct Corner {
  int c0, c1;
  float t;
};

__device__ __forceinline__ Corner corners(float coord, float dim_m1) {
  const float c0 = fminf(fmaxf(floorf(coord), 0.0f), dim_m1);
  const float c1 = fminf(fmaxf(c0 + 1.0f, 0.0f), dim_m1);
  const float t = fminf(fmaxf(coord - c0, 0.0f), 1.0f);
  return {static_cast<int>(c0), static_cast<int>(c1), t};
}

constexpr int kThreads = 256;
constexpr int kMaxPool = 64;

// a[i] by selects: indexing a kernel parameter with a runtime value copies
// the whole struct to local memory in every thread
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxLevels], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// V consecutive channels of T as float32, and back: V = 1 is one scalar,
// V = 16 / sizeof(T) one 16-byte vector. bf16 widens exactly by a shift.
template <typename T, int V>
struct Channels;

template <typename T>
struct Channels<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float* f) { f[0] = to_float(*p); }
  static __device__ __forceinline__ void store(T* p, const float* f) { store_scalar(p, f[0]); }
};

template <>
struct Channels<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Channels<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void widen(unsigned u, float* f) {
    f[0] = __uint_as_float(u << 16);  // the lower half is the lower channel
    f[1] = __uint_as_float(u & 0xffff0000u);
  }
  static __device__ __forceinline__ unsigned narrow(const float* f) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(f[0]))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(f[1]))) << 16);
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    widen(r.x, f);
    widen(r.y, f + 2);
    widen(r.z, f + 4);
    widen(r.w, f + 6);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    *reinterpret_cast<uint4*>(p) = make_uint4(narrow(f), narrow(f + 2), narrow(f + 4), narrow(f + 6));
  }
};

// Block (x, y): ROI x / splits of image y, bin rows [rows * (x % splits), +rows).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(Pyramid pyr, const float4* __restrict__ boxes, int n, int c, int p, int splits,
                 int rows, float image_scale, T* __restrict__ out) {
  __shared__ int s_x0[kMaxPool], s_x1[kMaxPool], s_y0[kMaxPool], s_y1[kMaxPool];
  __shared__ float s_tx[kMaxPool], s_ty[kMaxPool];
  __shared__ int s_level;

  const int roi = blockIdx.x / splits;
  const int row0 = (blockIdx.x - roi * splits) * rows;
  const int nrows = min(rows, p - row0);
  const int b = blockIdx.y;
  const float4 box = boxes[static_cast<size_t>(b) * n + roi];
  const float y1 = box.x, x1 = box.y, y2 = box.z, x2 = box.w;
  T* dst = out + ((static_cast<size_t>(b) * n + roi) * p + row0) * p * c;
  const int vecs = c / V;  // channel vectors per bin
  const int items = nrows * p * vecs;

  if (!(y2 > y1 && x2 > x1)) {  // zero-area (padding) ROI pools zeros
    const float zero[V] = {};
    for (int k = threadIdx.x; k < items; k += blockDim.x) Channels<T, V>::store(dst + static_cast<size_t>(k) * V, zero);
    return;
  }
  // geometry once per block: columns in threads [0, p), rows in [p, p + nrows)
  for (int i = threadIdx.x; i < p + nrows; i += blockDim.x) {
    const int level = roi_level(y2 - y1, x2 - x1, image_scale, pyr.levels);
    const int wl = pick(pyr.w, level);
    if (i < p) {
      const float wm1 = static_cast<float>(wl - 1);
      const Corner cx = corners(sample_coord(x1, x2, i, p, wm1), wm1);
      s_x0[i] = cx.c0;
      s_x1[i] = cx.c1;
      s_tx[i] = cx.t;
    } else {
      const int iy = i - p;
      const float hm1 = static_cast<float>(pick(pyr.h, level) - 1);
      const Corner cy = corners(sample_coord(y1, y2, row0 + iy, p, hm1), hm1);
      s_y0[iy] = cy.c0 * wl;  // pixel index of the row start
      s_y1[iy] = cy.c1 * wl;
      s_ty[iy] = cy.t;
    }
    if (i == 0) s_level = level;
  }
  __syncthreads();
  const int level = s_level;
  const T* src = static_cast<const T*>(pick(pyr.data, level)) +
                 static_cast<size_t>(b) * pick(pyr.h, level) * pick(pyr.w, level) * c;

  for (int k = threadIdx.x; k < items; k += blockDim.x) {
    const int bin = k / vecs;
    const int ch = (k - bin * vecs) * V;
    const int iy = bin / p;
    const int ix = bin - iy * p;
    const float ty = s_ty[iy], tx = s_tx[ix];
    const float w00 = (1.0f - ty) * (1.0f - tx);
    const float w01 = (1.0f - ty) * tx;
    const float w10 = ty * (1.0f - tx);
    const float w11 = ty * tx;
    float a[V], bb[V], cc[V], d[V], o[V];
    Channels<T, V>::load(src + static_cast<size_t>(s_y0[iy] + s_x0[ix]) * c + ch, a);
    Channels<T, V>::load(src + static_cast<size_t>(s_y0[iy] + s_x1[ix]) * c + ch, bb);
    Channels<T, V>::load(src + static_cast<size_t>(s_y1[iy] + s_x0[ix]) * c + ch, cc);
    Channels<T, V>::load(src + static_cast<size_t>(s_y1[iy] + s_x1[ix]) * c + ch, d);
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = a[j] * w00 + bb[j] * w01 + cc[j] * w10 + d[j] * w11;
    Channels<T, V>::store(dst + static_cast<size_t>(k) * V, o);
  }
}

template <typename T, int V>
void launch_forward(const Pyramid& pyr, const float4* boxes, int b, int n, int c, int p,
                    float image_scale, void* out, cudaStream_t s) {
  // enough blocks of 256 threads to fill the card 8 deep: split the P bin
  // rows of a ROI when there are too few ROIs (132 SMs x 8 = 1056)
  const int rois = b * n;
  int splits = rois >= 1056 ? 1 : min(p, (1056 + rois - 1) / rois);
  const int rows = (p + splits - 1) / splits;
  splits = (p + rows - 1) / rows;
  const dim3 grid(n * splits, b);
  roi_align_kernel<T, V><<<grid, kThreads, 0, s>>>(pyr, boxes, n, c, p, splits, rows, image_scale,
                                                   static_cast<T*>(out));
}

struct GradPyramid {
  float* data[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int levels;
};

// T: the cotangent's dtype.
template <typename T>
__global__ void __launch_bounds__(256)
roi_align_backward_kernel(GradPyramid pyr, const float4* __restrict__ boxes, const T* __restrict__ dout,
                          int n, int c, int p, float image_scale) {
  const int roi = blockIdx.x;
  const int b = blockIdx.y;
  const float4 box = boxes[static_cast<size_t>(b) * n + roi];
  const float y1 = box.x, x1 = box.y, y2 = box.z, x2 = box.w;
  if (!(y2 > y1 && x2 > x1)) return;  // zero-area ROIs pooled zeros: no gradient
  const int level = roi_level(y2 - y1, x2 - x1, image_scale, pyr.levels);
  const int hl = pyr.h[level];
  const int wl = pyr.w[level];
  const float hm1 = static_cast<float>(hl - 1);
  const float wm1 = static_cast<float>(wl - 1);
  float* dst = pyr.data[level] + static_cast<size_t>(b) * hl * wl * c;
  const T* src = dout + (static_cast<size_t>(b) * n + roi) * p * p * c;

  for (int iy = 0; iy < p; ++iy) {
    const Corner cy = corners(sample_coord(y1, y2, iy, p, hm1), hm1);
    float* row0 = dst + static_cast<size_t>(cy.c0) * wl * c;
    float* row1 = dst + static_cast<size_t>(cy.c1) * wl * c;
    for (int ix = 0; ix < p; ++ix) {
      const Corner cx = corners(sample_coord(x1, x2, ix, p, wm1), wm1);
      const float w00 = (1.0f - cy.t) * (1.0f - cx.t);
      const float w01 = (1.0f - cy.t) * cx.t;
      const float w10 = cy.t * (1.0f - cx.t);
      const float w11 = cy.t * cx.t;
      float* a = row0 + static_cast<size_t>(cx.c0) * c;
      float* bb = row0 + static_cast<size_t>(cx.c1) * c;
      float* cc = row1 + static_cast<size_t>(cx.c0) * c;
      float* d = row1 + static_cast<size_t>(cx.c1) * c;
      const T* g = src + (static_cast<size_t>(iy) * p + ix) * c;
      for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
        const float v = to_float(g[ch]);
        atomicAdd(a + ch, v * w00);
        atomicAdd(bb + ch, v * w01);
        atomicAdd(cc + ch, v * w10);
        atomicAdd(d + ch, v * w11);
      }
    }
  }
}

__global__ void cast_to_bf16(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst, size_t count) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count; i += stride) {
    dst[i] = __float2bfloat16_rn(src[i]);
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// f0..f3: level maps [b, h_l, w_l, c] (unused levels null); boxes [b, n, 4]
// float32; out [b, n, p, p, c]. dtype 0 = float32, 1 = bfloat16. vec 1 asks
// for 16-byte channel vectors, which need c * itemsize and every map and
// output pointer to be multiples of 16 bytes; vec 0 for the scalar width.
// Returns a cudaError_t.
int roi_align_launch(const void* f0, const void* f1, const void* f2, const void* f3,
                     int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
                     int levels, const void* boxes, int b, int n, int c, int p,
                     float image_scale, int dtype, int vec, void* out, void* stream) {
  if (levels < 1 || levels > kMaxLevels || (dtype != 0 && dtype != 1) || p < 1 || p > kMaxPool) {
    return cudaErrorInvalidValue;
  }
  Pyramid pyr{{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}, levels};
  if (vec) {
    const int item = dtype == 0 ? 4 : 2;
    bool aligned = (static_cast<size_t>(c) * item) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    for (int l = 0; l < levels; ++l) aligned = aligned && reinterpret_cast<uintptr_t>(pyr.data[l]) % 16 == 0;
    if (!aligned) return cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* bx = static_cast<const float4*>(boxes);
  if (dtype == 0) {
    if (vec) launch_forward<float, 4>(pyr, bx, b, n, c, p, image_scale, out, s);
    else launch_forward<float, 1>(pyr, bx, b, n, c, p, image_scale, out, s);
  } else {
    if (vec) launch_forward<__nv_bfloat16, 8>(pyr, bx, b, n, c, p, image_scale, out, s);
    else launch_forward<__nv_bfloat16, 1>(pyr, bx, b, n, c, p, image_scale, out, s);
  }
  return cudaGetLastError();
}

// acc: float32 scratch holding the level maps [b, h_l, w_l, c] back to back;
// out: bfloat16 maps in the same layout (dtype 1), unused for dtype 0, where
// acc is the result. dout [b, n, p, p, c] in dtype; boxes [b, n, 4] float32.
// Returns a cudaError_t.
int roi_align_backward_launch(void* acc, void* out, int h0, int h1, int h2, int h3, int w0, int w1,
                              int w2, int w3, int levels, const void* boxes, int b, int n, int c,
                              int p, float image_scale, int dtype, const void* dout, void* stream) {
  if (levels < 1 || levels > kMaxLevels || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  GradPyramid pyr{};
  pyr.levels = levels;
  size_t total = 0;
  for (int l = 0; l < levels; ++l) {
    pyr.data[l] = static_cast<float*>(acc) + total;
    pyr.h[l] = hs[l];
    pyr.w[l] = ws[l];
    total += static_cast<size_t>(b) * hs[l] * ws[l] * c;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(acc, 0, total * sizeof(float), s);
  if (err != cudaSuccess) return err;
  if (n > 0 && b > 0) {
    const int threads = c >= 256 ? 256 : ((c + 31) / 32) * 32;
    const dim3 grid(n, b);
    const float4* bx = static_cast<const float4*>(boxes);
    if (dtype == 0) {
      roi_align_backward_kernel<float><<<grid, threads, 0, s>>>(
          pyr, bx, static_cast<const float*>(dout), n, c, p, image_scale);
    } else {
      roi_align_backward_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
          pyr, bx, static_cast<const __nv_bfloat16*>(dout), n, c, p, image_scale);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dtype == 1 && total > 0) {
    const size_t blocks = (total + 255) / 256;
    cast_to_bf16<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
        static_cast<const float*>(acc), static_cast<__nv_bfloat16*>(out), total);
  }
  return cudaGetLastError();
}

}  // extern "C"
