// Pyramid ROIAlign forward over channels-last FPN maps, for Hopper (sm_90a).
//
// Replaces two TPU kernels of maskrcnn_tf2_tpu/kernels/roi_align_pallas.py:
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
// (11 MB per image), and the work is 8 flops per output element.
//
// Design: one thread block per (ROI, image), threads over channels. In NHWC
// the C values of a pixel are contiguous, so the four corner reads of a sample
// and the write of the pooled pixel are coalesced. Every thread derives the
// ROI's level and sample geometry itself (a few flops, no barrier), sums the
// four weighted corners in float32 and rounds once to the output dtype. The
// output is written in ROI order, so there is no (level, tier) sort and no
// unsort slot as on the TPU. The TPU kernels' DMA rings, tiers and strip mode
// worked around VMEM; here the L2 cache holds the maps.
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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Sample coordinate i of P along [lo, hi], in pixels of a map of extent dim_m1 + 1.
__device__ __forceinline__ float sample_coord(float lo, float hi, int i, int p, float dim_m1) {
  if (p > 1) {
    const float frac = static_cast<float>(i) / static_cast<float>(p - 1);
    return (lo + (hi - lo) * frac) * dim_m1;
  }
  return (0.5f * (lo + hi)) * dim_m1;
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

template <typename T>
__global__ void __launch_bounds__(256)
roi_align_kernel(Pyramid pyr, const float4* __restrict__ boxes, int n, int c, int p,
                 float image_scale, T* __restrict__ out) {
  const int roi = blockIdx.x;
  const int b = blockIdx.y;
  const float4 box = boxes[static_cast<size_t>(b) * n + roi];
  const float y1 = box.x, x1 = box.y, y2 = box.z, x2 = box.w;
  T* dst = out + (static_cast<size_t>(b) * n + roi) * p * p * c;

  if (!(y2 > y1 && x2 > x1)) {  // zero-area (padding) ROI pools zeros
    for (int k = threadIdx.x; k < p * p * c; k += blockDim.x) store(dst + k, 0.0f);
    return;
  }
  const float h = y2 - y1;
  const float w = x2 - x1;
  int level = static_cast<int>(rintf(log2f(sqrtf(fmaxf(h * w, 1e-12f)) / image_scale))) + 4;
  level = min(max(level, 2), 1 + pyr.levels) - 2;

  const int hl = pyr.h[level];
  const int wl = pyr.w[level];
  const float hm1 = static_cast<float>(hl - 1);
  const float wm1 = static_cast<float>(wl - 1);
  const T* src = static_cast<const T*>(pyr.data[level]) + static_cast<size_t>(b) * hl * wl * c;

  for (int iy = 0; iy < p; ++iy) {
    const Corner cy = corners(sample_coord(y1, y2, iy, p, hm1), hm1);
    const T* row0 = src + static_cast<size_t>(cy.c0) * wl * c;
    const T* row1 = src + static_cast<size_t>(cy.c1) * wl * c;
    for (int ix = 0; ix < p; ++ix) {
      const Corner cx = corners(sample_coord(x1, x2, ix, p, wm1), wm1);
      const float w00 = (1.0f - cy.t) * (1.0f - cx.t);
      const float w01 = (1.0f - cy.t) * cx.t;
      const float w10 = cy.t * (1.0f - cx.t);
      const float w11 = cy.t * cx.t;
      const T* a = row0 + static_cast<size_t>(cx.c0) * c;
      const T* bb = row0 + static_cast<size_t>(cx.c1) * c;
      const T* cc = row1 + static_cast<size_t>(cx.c0) * c;
      const T* d = row1 + static_cast<size_t>(cx.c1) * c;
      T* o = dst + (static_cast<size_t>(iy) * p + ix) * c;
      for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
        const float v = to_float(a[ch]) * w00 + to_float(bb[ch]) * w01 +
                        to_float(cc[ch]) * w10 + to_float(d[ch]) * w11;
        store(o + ch, v);
      }
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// f0..f3: level maps [b, h_l, w_l, c] (unused levels null); boxes [b, n, 4]
// float32; out [b, n, p, p, c]. dtype 0 = float32, 1 = bfloat16.
// Returns a cudaError_t.
int roi_align_launch(const void* f0, const void* f1, const void* f2, const void* f3,
                     int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
                     int levels, const void* boxes, int b, int n, int c, int p,
                     float image_scale, int dtype, void* out, void* stream) {
  if (levels < 1 || levels > kMaxLevels || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  Pyramid pyr{{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}, levels};
  const int threads = c >= 256 ? 256 : ((c + 31) / 32) * 32;
  const dim3 grid(n, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* bx = static_cast<const float4*>(boxes);
  if (dtype == 0) {
    roi_align_kernel<float><<<grid, threads, 0, s>>>(pyr, bx, n, c, p, image_scale,
                                                     static_cast<float*>(out));
  } else {
    roi_align_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        pyr, bx, n, c, p, image_scale, static_cast<__nv_bfloat16*>(out));
  }
  return cudaGetLastError();
}

}  // extern "C"
