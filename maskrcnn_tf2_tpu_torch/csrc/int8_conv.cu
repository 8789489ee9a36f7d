// Int8 convolution with a fused dequantize epilogue, for Hopper (sm_90a).
//
// Replaces what the JAX package leaves to XLA on the TPU: no Pallas kernel, but
// jax.lax.conv_general_dilated over s8 inputs and weights with an s32 result
// (maskrcnn_tf2_tpu/models/quant.py:76-84, Int8Conv; the Int8Dense and
// Int8FCOnPooled dot_generals at :190 and :224 are the same function over a
// 1x1 "image"), then XLA's fused epilogue y.astype(f32) * (sx * sw) + bias,
// cast to the compute dtype (:85-89). PyTorch has no int8 convolution on
// CUDA, and torch._int_mm is a matrix product whose k and n must be multiples
// of 8, which ResNeXt's 4-channel groups are not.
//
// Contract: x int8 NHWC [n, h, w, c] (the port's channels_last memory),
// w int8 [o, kh, kw, c / groups], flax's "SAME" pads (pad_top, pad_left; the
// bottom and right pads are the taps past the edge), sx a float32 scalar on
// the device, sw [o] and bias [o] float32 (bias may be null); y [n, ho, wo, o]
// in float32 or bfloat16. Every output is acc * (sx * sw[o]) (+ bias[o]),
// rounded at each step as PyTorch's element-wise ops round (the __*_rn
// intrinsics: no contraction into an FMA), then cast to nearest even. The
// int32 sums are exact in any order (|acc| <= K * 127^2 < 2^31 for K up to
// 133,000), so the result does not depend on the kernel's order.
//
// What bounds it on this card: operations. The flagship's sites are compute
// heavy (a batch of 2 at 512x512 is ~0.24 T int8 operations against tens of MB
// moved). The bound is the tensor cores' 1,979 int8 TOP/s; this first kernel
// uses dp4a on the CUDA cores (4 products and a sum a lane, ~125 TOP/s at
// most on an H100), so it sits far above that bound. Tensor-core s8
// (mma.sync m16n8k32 or wgmma) is the next step.
//
// Design: two kernels.
//   (a) int8_conv_tiled_kernel, groups == 1: an implicit GEMM of output
//       pixels (M = n*ho*wo) by output channels (o) over K = kh*kw*c. A block
//       of 256 threads owns a 128 x 64 output tile and walks K tap by tap
//       (ky, kx) in chunks of 32 channels (8 packed words): each step loads
//       the 128 pixels' and 64 filters' words into shared memory (rows padded
//       by 4 words, so the stores and the 16-byte reads are free of bank
//       conflicts; taps outside the image, channels past c and tiles past M or
//       o load zeros), then each thread runs 8 x 4 accumulators with dp4a,
//       reading three 16-byte vectors for every 32 dp4a.
//   (b) int8_conv_direct_kernel, groups > 1 (ResNeXt's 4-32 channel groups,
//       depthwise sites): one thread an output value, channels fastest, so a
//       warp writes contiguous outputs and reads one group's input pixel.
//   Both read packed 32-bit words where the channels allow (c, or c / groups,
//   a multiple of 4 and the pointers 4-byte aligned), else bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // output pixels a block
constexpr int kBN = 64;   // output channels a block
constexpr int kBKW = 8;   // packed words (4 channels each) a step
constexpr int kTM = 8;    // pixels a thread
constexpr int kTN = 4;    // channels a thread
constexpr int kRowA = kBM + 4;
constexpr int kRowB = kBN + 4;
constexpr int kLoadRows = kThreads / kBKW;  // 32 pixels or filters a load pass

struct Geometry {
  int n, h, w, c;
  int ho, wo, o;
  int kh, kw, stride, pad_top, pad_left, groups;
};

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// acc as float32, times (sx * sw[o]), plus bias[o]: three roundings, as
// acc.float() * (sx * sw) + bias in PyTorch.
__device__ __forceinline__ float dequantize(int acc, float scale, const float* bias, int o) {
  float v = __fmul_rn(__int2float_rn(acc), scale);
  if (bias != nullptr) v = __fadd_rn(v, bias[o]);
  return v;
}

// Four int8 values from p, those at or past `left` zero, packed as dp4a reads them.
__device__ __forceinline__ int32_t pack_bytes(const int8_t* p, int left) {
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (b < left) v |= static_cast<uint32_t>(static_cast<uint8_t>(p[b])) << (8 * b);
  }
  return static_cast<int32_t>(v);
}

template <bool kVec>
__device__ __forceinline__ int32_t load_word(const int8_t* p, int left) {
  if (kVec) return *reinterpret_cast<const int32_t*>(p);
  return pack_bytes(p, left);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_conv_tiled_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ sx, const float* __restrict__ sw,
                       const float* __restrict__ bias, T* __restrict__ y, Geometry g) {
  __shared__ __align__(16) int32_t a_tile[kBKW][kRowA];
  __shared__ __align__(16) int32_t b_tile[kBKW][kRowB];
  const int tid = threadIdx.x;
  const long long pixels = static_cast<long long>(g.n) * g.ho * g.wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int o0 = blockIdx.y * kBN;
  const long long k_total = static_cast<long long>(g.kh) * g.kw * g.c;

  // loader roles: word lw of pixels lp + 32 i and of filters lp + 32 i
  const int lw = tid % kBKW;
  const int lp = tid / kBKW;
  constexpr int kPixLoads = kBM / kLoadRows;
  constexpr int kFilLoads = kBN / kLoadRows;
  int pix_n[kPixLoads], pix_y[kPixLoads], pix_x[kPixLoads];
#pragma unroll
  for (int i = 0; i < kPixLoads; ++i) {
    const long long m = m0 + lp + kLoadRows * i;
    pix_n[i] = -1;
    pix_y[i] = 0;
    pix_x[i] = 0;
    if (m < pixels) {
      const long long per_image = static_cast<long long>(g.ho) * g.wo;
      const int r = static_cast<int>(m % per_image);
      pix_n[i] = static_cast<int>(m / per_image);
      pix_y[i] = (r / g.wo) * g.stride - g.pad_top;
      pix_x[i] = (r % g.wo) * g.stride - g.pad_left;
    }
  }

  // compute roles: pixels ty * 8 .. + 7, channels tx * 4 .. + 3 of the tile
  const int ty = tid / (kBN / kTN);
  const int tx = tid % (kBN / kTN);
  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int ky = 0; ky < g.kh; ++ky) {
    for (int kx = 0; kx < g.kw; ++kx) {
      const long long tap = static_cast<long long>(ky * g.kw + kx) * g.c;
      for (int c0 = 0; c0 < g.c; c0 += 4 * kBKW) {
        const int c = c0 + 4 * lw;
        const int left = g.c - c;
#pragma unroll
        for (int i = 0; i < kPixLoads; ++i) {
          int32_t v = 0;
          const int iy = pix_y[i] + ky;
          const int ix = pix_x[i] + kx;
          if (pix_n[i] >= 0 && left > 0 && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w) {
            const size_t at = ((static_cast<size_t>(pix_n[i]) * g.h + iy) * g.w + ix) * g.c + c;
            v = load_word<kVec>(x + at, left);
          }
          a_tile[lw][lp + kLoadRows * i] = v;
        }
#pragma unroll
        for (int i = 0; i < kFilLoads; ++i) {
          int32_t v = 0;
          const int o = o0 + lp + kLoadRows * i;
          if (o < g.o && left > 0) v = load_word<kVec>(w + static_cast<size_t>(o) * k_total + tap + c, left);
          b_tile[lw][lp + kLoadRows * i] = v;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kBKW; ++k) {
          const int4 a_lo = *reinterpret_cast<const int4*>(&a_tile[k][ty * kTM]);
          const int4 a_hi = *reinterpret_cast<const int4*>(&a_tile[k][ty * kTM + 4]);
          const int4 bv = *reinterpret_cast<const int4*>(&b_tile[k][tx * kTN]);
          const int a[kTM] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
          const int b[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

  const float s_x = *sx;
  float scale[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int o = o0 + tx * kTN + j;
    scale[j] = o < g.o ? __fmul_rn(s_x, sw[o]) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + ty * kTM + i;
    if (m >= pixels) continue;
    T* row = y + static_cast<size_t>(m) * g.o;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int o = o0 + tx * kTN + j;
      if (o < g.o) row[o] = from_float<T>(dequantize(acc[i][j], scale[j], bias, o));
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_conv_direct_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ sx, const float* __restrict__ sw,
                        const float* __restrict__ bias, T* __restrict__ y, Geometry g) {
  const size_t total = static_cast<size_t>(g.n) * g.ho * g.wo * g.o;
  const int cg = g.c / g.groups;
  const int og = g.o / g.groups;
  const size_t k_total = static_cast<size_t>(g.kh) * g.kw * cg;
  const float s_x = *sx;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int o = static_cast<int>(idx % g.o);
    const size_t m = idx / g.o;
    const int ox = static_cast<int>(m % g.wo);
    const int oy = static_cast<int>((m / g.wo) % g.ho);
    const size_t n = m / (static_cast<size_t>(g.wo) * g.ho);
    const int group = o / og;
    int acc = 0;
    for (int ky = 0; ky < g.kh; ++ky) {
      const int iy = oy * g.stride - g.pad_top + ky;
      if (iy < 0 || iy >= g.h) continue;
      for (int kx = 0; kx < g.kw; ++kx) {
        const int ix = ox * g.stride - g.pad_left + kx;
        if (ix < 0 || ix >= g.w) continue;
        const int8_t* px = x + ((n * g.h + iy) * g.w + ix) * g.c + static_cast<size_t>(group) * cg;
        const int8_t* pw = w + o * k_total + static_cast<size_t>(ky * g.kw + kx) * cg;
        if (kVec) {
          for (int q = 0; q < cg; q += 4) {
            acc = __dp4a(*reinterpret_cast<const int32_t*>(px + q), *reinterpret_cast<const int32_t*>(pw + q), acc);
          }
        } else {
          for (int q = 0; q < cg; ++q) acc += static_cast<int>(px[q]) * static_cast<int>(pw[q]);
        }
      }
    }
    y[idx] = from_float<T>(dequantize(acc, __fmul_rn(s_x, sw[o]), bias, o));
  }
}

template <typename T>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* sx, const float* sw, const float* bias,
                   T* y, const Geometry& g, cudaStream_t s, int* path) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const bool words = aligned && (g.c / g.groups) % 4 == 0;
  if (path != nullptr) *path = (g.groups == 1 ? 0 : 2) + (words ? 1 : 0);
  if (g.groups == 1) {
    const long long pixels = static_cast<long long>(g.n) * g.ho * g.wo;
    const dim3 grid(static_cast<unsigned>((pixels + kBM - 1) / kBM), (g.o + kBN - 1) / kBN);
    if (words) {
      int8_conv_tiled_kernel<T, true><<<grid, kThreads, 0, s>>>(x, w, sx, sw, bias, y, g);
    } else {
      int8_conv_tiled_kernel<T, false><<<grid, kThreads, 0, s>>>(x, w, sx, sw, bias, y, g);
    }
  } else {
    const size_t total = static_cast<size_t>(g.n) * g.ho * g.wo * g.o;
    const size_t blocks = (total + kThreads - 1) / kThreads;
    const unsigned grid = static_cast<unsigned>(blocks < (1u << 20) ? blocks : (1u << 20));
    if (words) {
      int8_conv_direct_kernel<T, true><<<grid, kThreads, 0, s>>>(x, w, sx, sw, bias, y, g);
    } else {
      int8_conv_direct_kernel<T, false><<<grid, kThreads, 0, s>>>(x, w, sx, sw, bias, y, g);
    }
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// x int8 [n, h, w, c]; w int8 [o, kh, kw, c / groups]; sx float32 [1]; sw
// float32 [o]; bias float32 [o] or null; y [n, ho, wo, o], float32 when
// out_dtype is 0, bfloat16 when 1. Writes the kernel it launched to *path
// when path is not null: 0 tiled on bytes, 1 tiled on packed words (dp4a),
// 2 direct on bytes, 3 direct on packed words. Returns a cudaError_t.
int int8_conv_launch(const void* x, const void* w, const void* sx, const void* sw, const void* bias, void* y,
                     int out_dtype, int n, int h, int w_in, int c, int o, int kh, int kw, int stride,
                     int pad_top, int pad_left, int groups, int ho, int wo, void* stream, int* path) {
  if (n < 0 || h <= 0 || w_in <= 0 || c <= 0 || o <= 0 || kh <= 0 || kw <= 0 || stride <= 0 ||
      groups <= 0 || c % groups != 0 || o % groups != 0 || ho <= 0 || wo <= 0 || pad_top < 0 || pad_left < 0) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const Geometry g{n, h, w_in, c, ho, wo, o, kh, kw, stride, pad_top, pad_left, groups};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  const float* bp = static_cast<const float*>(bias);
  if (out_dtype == 0) return launch<float>(xp, wp, sxp, swp, bp, static_cast<float*>(y), g, s, path);
  if (out_dtype == 1) {
    return launch<__nv_bfloat16>(xp, wp, sxp, swp, bp, static_cast<__nv_bfloat16*>(y), g, s, path);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
