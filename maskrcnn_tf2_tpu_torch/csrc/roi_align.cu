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
// transpose of the forward: each sample's pooled cotangent, times the same
// four bilinear weights, is added to the sample's four corner pixels of the
// ROI's level; sums in float32, one rounding to the cotangent's dtype (the JAX
// package's .astype(dt)); the output is one map [B, H_l, W_l, C] per level.
// What bounds it on this card: bytes. At the flagship's training shapes the
// cotangent read (10 MB at 7x7, 40 MB at 14x14, batch 2, bf16) and the bf16
// gradient maps written (22 MB) outweigh the 8 flops per cotangent element.
// Design: owner computes. The TPU kernels keep an image's whole cotangent
// pyramid in VMEM across a sequential ROI axis and add into it; on Hopper
// blocks run in no order, so the scatter is turned into a gather and every
// output value is summed by one thread and written once: no float32 scratch
// maps, no memset, no cast pass, no atomics. A block of 8 warps owns a 4x4
// tile of one level's map of one image and 32 channel vectors; each warp owns
// two pixels of the tile, the warp's lanes a pixel's channel vectors (16
// bytes each, 512 contiguous bytes a warp; two such loads a lane for aligned
// float32, or the scalar width as in the forward). The block
// (1) reads the image's boxes, 256 at a time, and keeps in ROI order those
//     whose sample footprint on its level, [c0 of the first sample, c1 of the
//     last], meets the tile (sample coordinates are monotone, so no corner
//     lies outside) and whose level this is; the level formula, with its IEEE
//     sqrt, division and log2, runs only for the few boxes that meet;
// (2) for up to 32 kept ROIs at a time writes the P row and P column corners
//     and weights to shared memory, with the forward's code, and from those
//     arrays the range of samples that have a corner on each tile row and
//     column (contiguous, since corners are monotone);
// (3) each warp, with a lane per kept ROI, counts the samples that reach each
//     of its pixels and numbers them by a scan in the order ROI, iy, ix; 32
//     samples at a time, a lane per sample, it queues in shared memory one term
//     (sample, weight) for each corner that is the pixel, in the order 00, 01,
//     10, 11, with the weight written as roi_align_backward_plain writes it,
//     wy * wx; then the lanes are channel vectors again and add the queued
//     terms in order, g * w, in float32 registers, the loads of both pixels
//     in flight together. Every pixel's sum runs in the order of the plain
//     version's index_add_ on the CPU, so float32 results are the same bits.
// Then one rounding and one store per pixel vector; pixels no ROI touches
// store zeros. A cotangent vector is read by the warps of its (up to) four
// corner pixels, mostly of one block, so from L1 or L2; HBM sees the cotangent
// about once, the boxes and the maps: what the bound counts. Nothing has to
// fit on chip but one tile's geometry, so the one kernel covers both TPU
// regimes, and its result is the same from run to run. What the time is made
// of at the flagship's training step (tune_roi_backward.py --ablate): the
// launch of the 2720 blocks, the box filter in each, the zero fill of the
// four fifths of the tiles no ROI reaches, and the dependent trips to memory
// (boxes, then cotangents) of the tiles that ROIs do reach, which is why the
// tile is small, the coarsest level's blocks, the heaviest, start first, and
// registers are capped for four blocks a multiprocessor in bf16.
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

// sample_coord of the first (end 0) or last (end 1) of the P samples, the same
// bits without the division: 0 / (p - 1) is 0 and (p - 1) / (p - 1) is 1.
__device__ __forceinline__ float end_coord(float lo, float hi, int end, int p, float dim_m1) {
  if (p > 1) return (lo + (hi - lo) * (end ? 1.0f : 0.0f)) * dim_m1;
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
// V = 16 / sizeof(T) one 16-byte vector, V = 8 float32 two of them. fetch
// returns the loaded bits and widen makes them float32 (bf16 widens exactly
// by a shift), so that a loop can keep several loads in flight in few
// registers; load is widen(fetch).
template <typename T, int V>
struct Channels;

template <typename T>
struct Channels<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw fetch(const T* p) { return *p; }
  static __device__ __forceinline__ void widen(Raw r, float* f) { f[0] = to_float(r); }
  static __device__ __forceinline__ void load(const T* p, float* f) { widen(fetch(p), f); }
  static __device__ __forceinline__ void store(T* p, const float* f) { store_scalar(p, f[0]); }
};

template <>
struct Channels<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw fetch(const float* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  static __device__ __forceinline__ void widen(Raw r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ void load(const float* p, float* f) { widen(fetch(p), f); }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Channels<float, 8> {
  struct Raw {
    uint4 lo, hi;
  };
  static __device__ __forceinline__ Raw fetch(const float* p) {
    return {Channels<float, 4>::fetch(p), Channels<float, 4>::fetch(p + 4)};
  }
  static __device__ __forceinline__ void widen(Raw r, float* f) {
    Channels<float, 4>::widen(r.lo, f);
    Channels<float, 4>::widen(r.hi, f + 4);
  }
  static __device__ __forceinline__ void load(const float* p, float* f) { widen(fetch(p), f); }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    Channels<float, 4>::store(p, f);
    Channels<float, 4>::store(p + 4, f + 4);
  }
};

template <>
struct Channels<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void widen2(unsigned u, float* f) {
    f[0] = __uint_as_float(u << 16);  // the lower half is the lower channel
    f[1] = __uint_as_float(u & 0xffff0000u);
  }
  static __device__ __forceinline__ unsigned narrow(const float* f) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(f[0]))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(f[1]))) << 16);
  }
  static __device__ __forceinline__ Raw fetch(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void widen(Raw r, float* f) {
    widen2(r.x, f);
    widen2(r.y, f + 2);
    widen2(r.z, f + 4);
    widen2(r.w, f + 6);
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) { widen(fetch(p), f); }
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

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kTileH = 4;  // a block's tile of one level's map, in pixels
constexpr int kTileW = 4;
constexpr int kPixPerWarp = kTileH * kTileW / kBwdWarps;
constexpr int kTileMax = kTileH > kTileW ? kTileH : kTileW;
constexpr int kRound = 32;  // kept ROIs whose geometry is in shared memory at a time: one per lane
constexpr int kQueue = 4 * 32;  // a pixel's terms at a time: 32 samples, at most four corners each
constexpr int kLoads = 2;  // cotangent vectors in flight for each of the warp's pixels
// Blocks of a multiprocessor: the registers of 4 (64 a thread) hold the bf16
// instantiation, the float32 one spills at that and gets those of 3.
template <typename T>
constexpr int kBwdBlocks = sizeof(T) == 2 ? 4 : 3;
constexpr unsigned kFullWarp = 0xffffffffu;
static_assert(kTileH * kTileW % kBwdWarps == 0, "every warp owns the same number of pixels");

struct GradPyramid {
  void* data[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int tile0[kMaxLevels];  // blockIdx.x of each level's first tile, coarsest level first
  int levels;
};

// Words of shared memory per kept ROI: c0 and t of the P rows and P columns,
// and one sample range per tile row and column; odd, so that lanes reading
// the same word of different ROIs hit different banks.
__host__ __device__ constexpr int geom_stride(int p) { return (4 * p + 2 * kTileMax) | 1; }

// The pixels a box's samples can touch on a map of (hm1 + 1) x (wm1 + 1):
// rows [c0 of the first sample, c1 of the last], packed lo | hi << 16, and
// columns likewise. Sample coordinates are monotone in the sample's index, so
// no corner lies outside. A zero-area box (it pooled zeros: no gradient)
// gets an empty range. Maps have at most 32767 pixels a side.
struct Footprint {
  int rows, cols;
};
constexpr int kNoPixels = 0x7fff;  // lo above any map, hi 0

__device__ __forceinline__ Footprint footprint(float4 box, int p, float hm1, float wm1) {
  const float y1 = box.x, x1 = box.y, y2 = box.z, x2 = box.w;
  if (!(y2 > y1 && x2 > x1)) return {kNoPixels, kNoPixels};
  return {corners(end_coord(y1, y2, 0, p, hm1), hm1).c0 | corners(end_coord(y1, y2, 1, p, hm1), hm1).c1 << 16,
          corners(end_coord(x1, x2, 0, p, wm1), wm1).c0 | corners(end_coord(x1, x2, 1, p, wm1), wm1).c1 << 16};
}

__device__ __forceinline__ bool meets(int range, int lo, int extent) {
  return (range & 0xffff) < lo + extent && (range >> 16) >= lo;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int below = __shfl_up_sync(kFullWarp, v, d);
    if (lane >= d) v += below;
  }
  return v;
}

// One pixel's next 32 samples, numbered from s0 in the order ROI, iy, ix, as
// terms (sample of the image's cotangent, weight bits) in `queue`: one for each
// corner of a sample that is pixel (y, x), in the order 00, 01, 10, 11, with
// the weight written as the plain version writes it. Lane e holds for kept ROI
// e the number of its samples that reach the pixel (`mine`), the running total
// (`upto`) and where they start (`range`: iy0 | ix0 << 8 | columns << 16).
// The whole warp calls this; returns the number of terms.
__device__ __forceinline__ int queue_terms(int2* queue, int s0, int samples, int mine, int upto, int range,
                                           const int* geom, int stride, const int* rois, int p, int y, int x,
                                           int hl, int wl, int lane) {
  const int s = s0 + lane;
  int e = 0;  // the ROI of sample s: the first with upto > s
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    if (__shfl_sync(kFullWarp, upto, e + step - 1) <= s) e += step;
  }
  const bool valid = s < samples;
  e = valid ? e : 0;
  const int e_upto = __shfl_sync(kFullWarp, upto, e);
  const int e_mine = __shfl_sync(kFullWarp, mine, e);
  const int e_range = __shfl_sync(kFullWarp, range, e);
  bool my0 = false, my1 = false, mx0 = false, mx1 = false;
  float ty = 0.0f, tx = 0.0f;
  int sample = 0;
  if (valid) {
    const int r = s - (e_upto - e_mine);
    const int columns = e_range >> 16;
    const int dy = r / columns;
    const int iy = (e_range & 0xff) + dy;
    const int ix = ((e_range >> 8) & 0xff) + r - dy * columns;
    const int* g = geom + e * stride;
    const int cy0 = g[iy], cx0 = g[p + ix];
    ty = __int_as_float(g[2 * p + iy]);
    tx = __int_as_float(g[3 * p + ix]);
    my0 = cy0 == y;
    my1 = min(cy0 + 1, hl - 1) == y;
    mx0 = cx0 == x;
    mx1 = min(cx0 + 1, wl - 1) == x;
    sample = (rois[e] * p + iy) * p + ix;
  }
  const int terms_mine = (my0 + my1) * (mx0 + mx1);
  const int terms_upto = warp_inclusive_scan(terms_mine, lane);
  int slot = terms_upto - terms_mine;
  if (my0 && mx0) queue[slot++] = make_int2(sample, __float_as_int((1.0f - ty) * (1.0f - tx)));
  if (my0 && mx1) queue[slot++] = make_int2(sample, __float_as_int((1.0f - ty) * tx));
  if (my1 && mx0) queue[slot++] = make_int2(sample, __float_as_int(ty * (1.0f - tx)));
  if (my1 && mx1) queue[slot++] = make_int2(sample, __float_as_int(ty * tx));
  return __shfl_sync(kFullWarp, terms_upto, 31);
}

// Block (x, y, z): tile x of the levels' tiles, channel vectors [32 y, 32 y + 32),
// image z. T: the cotangent's and the maps' dtype.
template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads, kBwdBlocks<T>)
roi_align_backward_kernel(GradPyramid pyr, const float4* __restrict__ boxes, const T* __restrict__ dout,
                          int n, int c, int p, float image_scale) {
  using Ch = Channels<T, V>;
  extern __shared__ int s_geom[];  // [kRound][geom_stride(p)]
  __shared__ float4 s_box[kBwdThreads];
  __shared__ int s_roi[kBwdThreads];
  __shared__ int s_count[kBwdWarps];
  __shared__ int2 s_queue[kBwdWarps][kPixPerWarp][kQueue];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int level = pyr.levels - 1;  // the coarsest level's tiles come first
#pragma unroll
  for (int l = kMaxLevels - 2; l >= 0; --l) {
    if (l < pyr.levels - 1 && static_cast<int>(blockIdx.x) >= pyr.tile0[l]) level = l;
  }
  const int hl = pick(pyr.h, level);
  const int wl = pick(pyr.w, level);
  const float hm1 = static_cast<float>(hl - 1);
  const float wm1 = static_cast<float>(wl - 1);
  const int tile = blockIdx.x - pick(pyr.tile0, level);
  const int tiles_x = (wl + kTileW - 1) / kTileW;
  const int tile_y = tile / tiles_x * kTileH;
  const int tile_x = (tile - tile / tiles_x * tiles_x) * kTileW;
  const int b = blockIdx.z;
  const int vec = blockIdx.y * 32 + lane;
  const bool live = vec < c / V;
  const int ch = vec * V;
  const int stride = geom_stride(p);
  const float4* image_boxes = boxes + static_cast<size_t>(b) * n;
  const T* src = dout + static_cast<size_t>(b) * n * p * p * c + ch;
  T* dst = static_cast<T*>(pick(pyr.data, level)) + static_cast<size_t>(b) * hl * wl * c + ch;

  float acc[kPixPerWarp][V];
#pragma unroll
  for (int k = 0; k < kPixPerWarp; ++k) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = 0.0f;
  }

  for (int first = 0; first < n; first += kBwdThreads) {
    // (1) the boxes whose footprint on this level meets the tile and whose
    // level this is, in ROI order; the level formula only for the few that meet
    const int roi = first + threadIdx.x;
    bool touch = false;
    float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (roi < n) {
      box = image_boxes[roi];
      const Footprint fp = footprint(box, p, hm1, wm1);
      touch = meets(fp.rows, tile_y, kTileH) && meets(fp.cols, tile_x, kTileW) &&
              roi_level(box.z - box.x, box.w - box.y, image_scale, pyr.levels) == level;
    }
    const unsigned vote = __ballot_sync(kFullWarp, touch);
    if (lane == 0) s_count[warp] = __popc(vote);
    __syncthreads();
    int before = 0, kept = 0;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) {
      const int cnt = s_count[w];
      if (w < warp) before += cnt;
      kept += cnt;
    }
    if (touch) {
      const int slot = before + __popc(vote & ((1u << lane) - 1u));
      s_roi[slot] = roi;
      s_box[slot] = box;
    }
    __syncthreads();

    for (int r0 = 0; r0 < kept; r0 += kRound) {
      const int count = min(kRound, kept - r0);
      // (2) corners and weights of the P rows and P columns of each kept ROI
      for (int k = threadIdx.x; k < count * 2 * p; k += kBwdThreads) {
        const int e = k / (2 * p);
        const int rem = k - e * 2 * p;
        const int axis = rem >= p;  // 0: rows, 1: columns
        const int i = rem - axis * p;
        const float4 bx = s_box[r0 + e];
        const float dim_m1 = axis ? wm1 : hm1;
        const Corner cr = corners(sample_coord(axis ? bx.y : bx.x, axis ? bx.w : bx.z, i, p, dim_m1), dim_m1);
        s_geom[e * stride + rem] = cr.c0;
        s_geom[e * stride + 2 * p + rem] = __float_as_int(cr.t);
      }
      __syncthreads();
      // the samples [lo, lo + count) that have a corner on each tile row and
      // column, packed lo | count << 8
      for (int k = threadIdx.x; k < count * 2 * kTileMax; k += kBwdThreads) {
        const int e = k / (2 * kTileMax);
        const int rem = k - e * 2 * kTileMax;
        const int axis = rem >= kTileMax;
        const int q = (axis ? tile_x : tile_y) + rem - axis * kTileMax;
        const int last = (axis ? wl : hl) - 1;
        const int* c0 = s_geom + e * stride + axis * p;
        int lo = p, end = 0;
        for (int i = 0; i < p; ++i) {
          const int a = c0[i];
          if (a == q || min(a + 1, last) == q) {
            lo = min(lo, i);
            end = i + 1;
          }
        }
        s_geom[e * stride + 4 * p + rem] = end > lo ? lo | ((end - lo) << 8) : 0;
      }
      __syncthreads();

      // (3) each warp gathers into its pixels. Lane e counts the samples of
      // kept ROI e that reach a pixel; a scan numbers them in the order ROI,
      // iy, ix; 32 at a time they become that pixel's terms in its queue; then
      // lanes are channel vectors again and add each pixel's terms in order,
      // the loads of all the warp's pixels in flight together.
      int mine[kPixPerWarp], range[kPixPerWarp], upto[kPixPerWarp], samples[kPixPerWarp];
      int most = 0;
#pragma unroll
      for (int k = 0; k < kPixPerWarp; ++k) {
        const int pix = k * kBwdWarps + warp;
        const int py = pix / kTileW;
        const int px = pix - py * kTileW;
        mine[k] = 0;
        range[k] = 0;
        if (lane < count && tile_y + py < hl && tile_x + px < wl) {
          const int ry = s_geom[lane * stride + 4 * p + py];
          const int rx = s_geom[lane * stride + 4 * p + kTileMax + px];
          mine[k] = (ry >> 8) * (rx >> 8);
          range[k] = (ry & 0xff) | ((rx & 0xff) << 8) | ((rx >> 8) << 16);
        }
        upto[k] = warp_inclusive_scan(mine[k], lane);
        samples[k] = __shfl_sync(kFullWarp, upto[k], 31);
        most = max(most, samples[k]);
      }
      for (int s0 = 0; s0 < most; s0 += 32) {
        int terms[kPixPerWarp];
        int most_terms = 0;
#pragma unroll
        for (int k = 0; k < kPixPerWarp; ++k) {
          const int pix = k * kBwdWarps + warp;
          terms[k] = 0;
          if (s0 < samples[k]) {  // the whole warp
            terms[k] = queue_terms(s_queue[warp][k], s0, samples[k], mine[k], upto[k], range[k], s_geom, stride,
                                   s_roi + r0, p, tile_y + pix / kTileW, tile_x + pix % kTileW, hl, wl, lane);
          }
          most_terms = max(most_terms, terms[k]);
        }
        __syncwarp();
        if (live) {
          for (int t0 = 0; t0 < most_terms; t0 += kLoads) {
            typename Ch::Raw raw[kPixPerWarp][kLoads];
#pragma unroll
            for (int k = 0; k < kPixPerWarp; ++k) {
#pragma unroll
              for (int j = 0; j < kLoads; ++j) {
                if (t0 + j < terms[k]) raw[k][j] = Ch::fetch(src + static_cast<size_t>(s_queue[warp][k][t0 + j].x) * c);
              }
            }
#pragma unroll
            for (int k = 0; k < kPixPerWarp; ++k) {
#pragma unroll
              for (int j = 0; j < kLoads; ++j) {
                if (t0 + j < terms[k]) {
                  float g[V];
                  Ch::widen(raw[k][j], g);
                  const float w = __int_as_float(s_queue[warp][k][t0 + j].y);
#pragma unroll
                  for (int v = 0; v < V; ++v) acc[k][v] = acc[k][v] + g[v] * w;
                }
              }
            }
          }
        }
        __syncwarp();  // before the next 32 samples overwrite the queues
      }
      __syncthreads();  // the next round overwrites the geometry
    }
  }

#pragma unroll
  for (int k = 0; k < kPixPerWarp; ++k) {
    const int pix = k * kBwdWarps + warp;
    const int y = tile_y + pix / kTileW;
    const int x = tile_x + pix % kTileW;
    if (live && y < hl && x < wl) Ch::store(dst + (static_cast<size_t>(y) * wl + x) * c, acc[k]);
  }
}

template <typename T, int V>
void launch_backward(const GradPyramid& pyr, int tiles, const float4* boxes, int b, int n, int c, int p,
                     float image_scale, const void* dout, cudaStream_t s) {
  const dim3 grid(tiles, (c / V + 31) / 32, b);
  const size_t shared = static_cast<size_t>(kRound) * geom_stride(p) * sizeof(int);
  roi_align_backward_kernel<T, V><<<grid, kBwdThreads, shared, s>>>(pyr, boxes, static_cast<const T*>(dout), n, c,
                                                                     p, image_scale);
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

// out: the level maps [b, h_l, w_l, c] back to back, in dtype, every element
// written by the kernel; dout [b, n, p, p, c] in dtype; boxes [b, n, 4]
// float32. vec as in roi_align_launch, over c, out and dout. Returns a
// cudaError_t.
int roi_align_backward_launch(void* out, int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
                              int levels, const void* boxes, int b, int n, int c, int p,
                              float image_scale, int dtype, int vec, const void* dout, void* stream) {
  if (levels < 1 || levels > kMaxLevels || (dtype != 0 && dtype != 1) || p < 1 || p > kMaxPool ||
      b < 1 || b > 65535 || n < 0 || c < 1 || h0 > 32767 || w0 > 32767 || h1 > 32767 || w1 > 32767 ||
      h2 > 32767 || w2 > 32767 || h3 > 32767 || w3 > 32767 || static_cast<size_t>(n) * p * p > 0x7fffffffu) {
    return cudaErrorInvalidValue;
  }
  const int item = dtype == 0 ? 4 : 2;
  if (vec && ((static_cast<size_t>(c) * item) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(dout) % 16 != 0)) {
    return cudaErrorMisalignedAddress;
  }
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  GradPyramid pyr{};
  pyr.levels = levels;
  size_t bytes = 0;
  for (int l = 0; l < levels; ++l) {
    pyr.data[l] = static_cast<char*>(out) + bytes;
    pyr.h[l] = hs[l];
    pyr.w[l] = ws[l];
    bytes += static_cast<size_t>(b) * hs[l] * ws[l] * c * item;
  }
  // Blocks start in the order of blockIdx.x: the coarsest level first. Its
  // tiles are few and keep the most ROIs each, the finest level's are many
  // and light, and fill the card while the heavy ones finish.
  int tiles = 0;
  for (int l = levels - 1; l >= 0; --l) {
    pyr.tile0[l] = tiles;
    tiles += ((hs[l] + kTileH - 1) / kTileH) * ((ws[l] + kTileW - 1) / kTileW);
  }
  if (tiles == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* bx = static_cast<const float4*>(boxes);
  if (dtype == 0) {
    if (vec && c % 8 == 0) launch_backward<float, 8>(pyr, tiles, bx, b, n, c, p, image_scale, dout, s);
    else if (vec) launch_backward<float, 4>(pyr, tiles, bx, b, n, c, p, image_scale, dout, s);
    else launch_backward<float, 1>(pyr, tiles, bx, b, n, c, p, image_scale, dout, s);
  } else {
    if (vec) launch_backward<__nv_bfloat16, 8>(pyr, tiles, bx, b, n, c, p, image_scale, dout, s);
    else launch_backward<__nv_bfloat16, 1>(pyr, tiles, bx, b, n, c, p, image_scale, dout, s);
  }
  return cudaGetLastError();
}

}  // extern "C"
