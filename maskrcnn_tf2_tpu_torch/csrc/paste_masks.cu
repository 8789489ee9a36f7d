// Mask paste of served detections into the original images, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package unmolds on the host
// (maskrcnn_tf2_tpu/export/inference.py::unmold_detections), and so did the
// port, one mask at a time (export/inference.py, data/transforms.py::unmold_mask).
// This kernel computes on the card what that host loop computes, bit for bit:
// for each image, the pixel boxes of its detections, the boxes of positive
// area in order (`keep`), and for every pixel of the original image and every
// kept slot the 28x28 class mask resized bilinearly into its box and
// thresholded at 0.5. The result is the image's masks in the layout the host
// returns, [H0, W0, K] (K = kept), one byte a mask pixel.
//
// What bounds it on this card: bytes written. A batch of 8 crowd images of
// 480x640 with 100 kept masks is 245.8 MB of output against 2.5 MB of masks
// read, 73 us at 3.35 TB/s. The host loop wrote each mask as a column of
// stride K bytes, a cache line touched per pixel; here neighbouring threads
// write neighbouring 16-byte pieces of the image's block, so each warp stores
// 512 contiguous bytes.
//
// Design: one launch a batch; grid (pieces of an image's block, image). Each
// block first settles its image's boxes in shared memory (the first
// detection of class 0 ends the list; the boxes of positive area get their
// slots by a block-wide scan), then each thread writes 16-byte pieces of the
// block: for each byte, its pixel and slot, 0 outside the slot's box, else the
// bilinear value against 0.5. Every byte of the image's [H0, W0, K] block is
// written, zeros included; blocks past it only settle the boxes and leave.
//
// Exactness. The box arithmetic is numpy's in unmold_detections: the window's
// shift and scale and the normalized boxes in float32 with IEEE division, the
// scale to pixels and the (0, 0, 1, 1) offset in float64, rounded half to
// even. The resize is PyTorch's CPU F.interpolate (float32, align_corners
// False) on a [1, 1, mh, mw] mask, which takes one of two paths of ATen's
// UpSampleKernel.cpp by the output's size: above 128 (height + width) the
// separable kernel, rows fma(x0, wx0, x1 * wx1) and the value
// fma(t0, wy0, t1 * wy1); at or below it the channels-last kernel, corner
// weights wy * wx rounded first and summed as
// fma(x11, w11, fma(x10, w10, fma(x00, w00, x01 * w01))). Every rounding
// step is an explicit __f*_rn / __d*_rn intrinsic, so nothing is contracted
// or reordered (the library is also built with -fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDetections = 1024;  // slots kept in shared memory
constexpr int kPieces = 32;           // 16-byte pieces a thread writes
constexpr int kSmallPath = 128;       // out_h + out_w at or below it: the channels-last kernel
constexpr unsigned kFull = 0xffffffffu;

// The source index and weights of one output index along one dimension
// (ATen's compute_source_index_and_lambda with align_corners false).
__device__ __forceinline__ void source_index(float scale, int d, int n_in, int n_out, int& i0,
                                             int& i1, float& l0, float& l1) {
  if (n_in == n_out) {
    i0 = d;
    i1 = d;
    l0 = 1.0f;
    l1 = 0.0f;
    return;
  }
  float src = __fmaf_rn(scale, __fadd_rn(static_cast<float>(d), 0.5f), -0.5f);
  if (src < 0.0f) src = 0.0f;
  i0 = min(static_cast<int>(floorf(src)), n_in - 1);
  l1 = fminf(fmaxf(__fsub_rn(src, static_cast<float>(i0)), 0.0f), 1.0f);
  i1 = i0 + (i0 < n_in - 1 ? 1 : 0);
  l0 = __fsub_rn(1.0f, l1);
}

struct Slot {
  int y1, x1, h, w;   // the box in pixels; h = w = 0 for an inverted box (nothing pasted)
  float sy, sx;       // mh / h and mw / w
  int det;            // the detection's index in the image
};

__global__ void __launch_bounds__(kThreads)
paste_masks_kernel(const float* __restrict__ det, const float* __restrict__ masks,
                   const float* __restrict__ meta, const int64_t* __restrict__ offsets, int d_max,
                   int mh, int mw, int meta_stride, int image_h, int image_w,
                   uint8_t* __restrict__ out, int32_t* __restrict__ kept_out) {
  __shared__ Slot slots[kMaxDetections];
  __shared__ int warp_counts[kThreads / 32];
  __shared__ int s_n;
  __shared__ int s_kept;

  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  det += static_cast<size_t>(b) * d_max * 6;
  masks += static_cast<size_t>(b) * d_max * mh * mw;
  meta += static_cast<size_t>(b) * meta_stride;
  const int oh = static_cast<int>(meta[1]);
  const int ow = static_cast<int>(meta[2]);

  // n: the first detection of class 0
  if (t == 0) {
    s_n = d_max;
    s_kept = 0;
  }
  __syncthreads();
  for (int d = t; d < d_max; d += kThreads) {
    if (det[d * 6 + 4] == 0.0f) atomicMin(&s_n, d);
  }
  __syncthreads();
  const int n = s_n;

  // the window's shift and scale, float32
  const float hm1 = static_cast<float>(image_h - 1);
  const float wm1 = static_cast<float>(image_w - 1);
  const float sy = __fdiv_rn(meta[7], hm1);
  const float sx = __fdiv_rn(meta[8], wm1);
  const float ey = __fdiv_rn(__fsub_rn(meta[9], 1.0f), hm1);
  const float ex = __fdiv_rn(__fsub_rn(meta[10], 1.0f), wm1);
  const float scy = fmaxf(__fsub_rn(ey, sy), 1e-10f);
  const float scx = fmaxf(__fsub_rn(ex, sx), 1e-10f);
  const double ohm1 = static_cast<double>(oh - 1);
  const double owm1 = static_cast<double>(ow - 1);

  // the boxes of positive area among the first n, in order: slot = their rank
  for (int base = 0; base < n; base += kThreads) {
    const int d = base + t;
    int y1 = 0, x1 = 0, y2 = 0, x2 = 0;
    bool keep = false;
    if (d < n) {
      const float* p = det + d * 6;
      y1 = static_cast<int>(rint(__dmul_rn(static_cast<double>(__fdiv_rn(__fsub_rn(p[0], sy), scy)), ohm1)));
      x1 = static_cast<int>(rint(__dmul_rn(static_cast<double>(__fdiv_rn(__fsub_rn(p[1], sx), scx)), owm1)));
      y2 = static_cast<int>(rint(__dadd_rn(
          __dmul_rn(static_cast<double>(__fdiv_rn(__fsub_rn(p[2], sy), scy)), ohm1), 1.0)));
      x2 = static_cast<int>(rint(__dadd_rn(
          __dmul_rn(static_cast<double>(__fdiv_rn(__fsub_rn(p[3], sx), scx)), owm1), 1.0)));
      keep = (y2 - y1) * (x2 - x1) > 0;
    }
    const unsigned ballot = __ballot_sync(kFull, keep);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = s_kept;
    for (int w = 0; w < warp; ++w) before += warp_counts[w];
    if (keep) {
      Slot s;
      s.y1 = y1;
      s.x1 = x1;
      const bool upright = y2 > y1 && x2 > x1;  // else the host pastes nothing
      s.h = upright ? y2 - y1 : 0;
      s.w = upright ? x2 - x1 : 0;
      s.sy = upright ? __fdiv_rn(static_cast<float>(mh), static_cast<float>(s.h)) : 0.0f;
      s.sx = upright ? __fdiv_rn(static_cast<float>(mw), static_cast<float>(s.w)) : 0.0f;
      s.det = d;
      slots[before + __popc(ballot & ((1u << lane) - 1))] = s;
    }
    __syncthreads();
    if (t == 0) {
      int total = s_kept;
      for (int w = 0; w < kThreads / 32; ++w) total += warp_counts[w];
      s_kept = total;
    }
    __syncthreads();
  }
  const int kept = s_kept;
  if (blockIdx.x == 0 && t == 0) kept_out[b] = kept;

  // the image's [oh, ow, kept] block, 16 bytes a piece
  const uint32_t bytes = static_cast<uint32_t>(oh) * static_cast<uint32_t>(ow) * static_cast<uint32_t>(kept);
  const uint32_t first = static_cast<uint32_t>(blockIdx.x) * kThreads * kPieces;
  if (kept == 0 || first * 16u >= bytes) return;
  uint8_t* block = out + offsets[b];
  for (int i = 0; i < kPieces; ++i) {
    const uint32_t piece = first + i * kThreads + t;
    const uint32_t f0 = piece * 16u;
    if (f0 >= bytes) break;
    const uint32_t pixel = f0 / static_cast<uint32_t>(kept);
    int k = static_cast<int>(f0 - pixel * static_cast<uint32_t>(kept));
    int y = static_cast<int>(pixel / static_cast<uint32_t>(ow));
    int x = static_cast<int>(pixel - static_cast<uint32_t>(y) * static_cast<uint32_t>(ow));
    uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (f0 + j < bytes) {
        const Slot& s = slots[k];
        const int dy = y - s.y1;
        const int dx = x - s.x1;
        if (static_cast<unsigned>(dy) < static_cast<unsigned>(s.h) &&
            static_cast<unsigned>(dx) < static_cast<unsigned>(s.w)) {
          int y0i, y1i, x0i, x1i;
          float ly0, ly1, lx0, lx1;
          source_index(s.sy, dy, mh, s.h, y0i, y1i, ly0, ly1);
          source_index(s.sx, dx, mw, s.w, x0i, x1i, lx0, lx1);
          const float* m = masks + static_cast<size_t>(s.det) * mh * mw;
          const float v00 = __ldg(m + y0i * mw + x0i);
          const float v01 = __ldg(m + y0i * mw + x1i);
          const float v10 = __ldg(m + y1i * mw + x0i);
          const float v11 = __ldg(m + y1i * mw + x1i);
          float v;
          if (s.h + s.w > kSmallPath) {
            const float t0 = __fmaf_rn(v00, lx0, __fmul_rn(v01, lx1));
            const float t1 = __fmaf_rn(v10, lx0, __fmul_rn(v11, lx1));
            v = __fmaf_rn(t0, ly0, __fmul_rn(t1, ly1));
          } else {
            const float w00 = __fmul_rn(ly0, lx0);
            const float w01 = __fmul_rn(ly0, lx1);
            const float w10 = __fmul_rn(ly1, lx0);
            const float w11 = __fmul_rn(ly1, lx1);
            v = __fmaf_rn(v11, w11, __fmaf_rn(v10, w10, __fmaf_rn(v00, w00, __fmul_rn(v01, w01))));
          }
          if (v >= 0.5f) words[j >> 2] |= 1u << (8 * (j & 3));
        }
        if (++k == kept) {
          k = 0;
          if (++x == ow) {
            x = 0;
            ++y;
          }
        }
      }
    }
    *reinterpret_cast<uint4*>(block + f0) = make_uint4(words[0], words[1], words[2], words[3]);
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// det [b, d, 6] float32, masks [b, d, mh, mw] float32 (each detection's class
// mask), meta [b, meta_stride] float32 (original shape at 1-2, window at 7-10),
// offsets [b] int64: where image i's block starts in out, 16-byte aligned,
// with room for roundup16(oh * ow * d) bytes; all on the card. out, device
// memory or pinned host memory (written over the host link): image i's
// [oh, ow, kept_i] masks at offsets[i]; kept [b] int32. largest: the largest
// oh * ow * d of the batch, which sets the grid's width. Returns a cudaError_t.
int paste_masks_launch(const void* det, const void* masks, const void* meta, const void* offsets,
                       int b, int d, int mh, int mw, int meta_stride, int image_h, int image_w,
                       int largest, void* out, void* kept, void* stream) {
  if (b < 0 || d < 0 || d > kMaxDetections || mh <= 0 || mw <= 0 || largest < 0 || b > 65535)
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  constexpr int64_t kBlockBytes = 16 * kThreads * kPieces;  // bytes of an image's block one CUDA block writes
  const int blocks_x = static_cast<int>((largest + kBlockBytes - 1) / kBlockBytes);
  if (blocks_x > 0) {  // else no block writes a byte (no detection slots, or empty images)
    cudaPointerAttributes where;
    const cudaError_t err = cudaPointerGetAttributes(&where, out);
    if (err != cudaSuccess) return err;
    if (where.type == cudaMemoryTypeHost) {
      out = where.devicePointer;  // pinned host memory, mapped into the card's address space
    } else if (where.type != cudaMemoryTypeDevice) {
      return cudaErrorInvalidValue;  // pageable host memory: the card cannot write it
    }
    if (out == nullptr) return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_x > 0 ? blocks_x : 1, b);
  paste_masks_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(det), static_cast<const float*>(masks), static_cast<const float*>(meta),
      static_cast<const int64_t*>(offsets), d, mh, mw, meta_stride, image_h, image_w,
      static_cast<uint8_t*>(out), static_cast<int32_t*>(kept));
  return cudaGetLastError();
}

}  // extern "C"
