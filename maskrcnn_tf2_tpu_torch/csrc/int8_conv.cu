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
// 133,000), so neither the kernels' order nor a split of K changes a bit.
//
// What bounds it on this card. The flagship's 65 sites a request of 2 images
// are ~0.24 T int8 operations against ~0.49 GB moved: 0.124 ms at the tensor
// cores' 1,979 int8 TOP/s, 0.145 ms at 3.35 TB/s, so the request as a whole
// sits on the line between the two. Only the wide sites (the RPN conv and the
// FPN's 3x3 on P2 and P3, the mask head's convs) have enough work to fill the
// card; there the bound is the tensor cores' operations. The other ~55 sites (the 1x1s,
// C3-C5's 3x3s, P4-P6, the FCs) are small in M, N or both: a few thousand
// output tiles' worth of work at most, and what bounds them is filling 132
// SMs and the fixed latency of a launch (loads from a cold L2, the epilogue).
//
// Design: two kernels, and the plan that picks between them, the tile, the
// copy width and the split of K is made in Python (kernels/int8_conv.py::
// plan, its thresholds measured with tune_int8_conv.py --variants) and
// checked here.
//   (a) int8_conv_mma_kernel, groups == 1: an implicit GEMM of output pixels
//       (M = n*ho*wo) by output channels (N = o) over K = kh*kw*c in the
//       order (ky, kx, c), on the tensor cores: wgmma.mma_async m64nNk32
//       s8 x s8 -> s32, both operands from shared memory. x is NHWC and w is
//       [O, kh, kw, C], so both are K-major, the only layout wgmma takes for
//       int8, with no transpose. Two tiles: 128 x 128 (two warpgroups, each
//       m64n128, 64 int32 accumulators a thread) where there are more than
//       64 channels and half a wave of such tiles, else 64 x 64 (one
//       warpgroup, m64n64), so the small maps get more blocks. A block walks
//       K in 64-byte steps through a ring of 4 shared-memory stages, filled
//       by cp.async with zero-fill (src-size 0) for taps past the image edge,
//       pixels past M, filters past O and K past its end, so copy and
//       compute overlap; the epilogue's scales and bias ride in the first
//       copy group. Rows are 64 bytes with the 16-byte chunk c of row r at
//       c ^ ((r >> 1) & 3): the hardware's 64-byte swizzle, which the wgmma
//       descriptors name (mode B64, 512 bytes between 8-row groups), so the
//       tensor cores read the stage free of bank conflicts; each thread
//       fences its copies into the async proxy before the barrier that
//       publishes a stage. The copy width follows the channels: 16 bytes
//       (cp.async.cg) where c is a multiple of 16, 8 or 4 (cp.async.ca) where
//       it is a multiple of 8 or 4, and a named byte path (synchronous loads
//       into the same ring) for the others, the c = 3 stem; a copy never
//       straddles a tap because c is a multiple of its width. Where the
//       tiles still fill less than one wave of SMs (C4/C5, P5/P6, FC1), the
//       plan splits K into ranges, one a block: each block writes its int32
//       partial tile to a workspace in fragment order (coalesced 16-byte
//       stores), and the last block of a tile to arrive (an atomic counter
//       that it resets to zero) adds the others' partials. The epilogue
//       dequantizes into a tile staged in shared memory over the ring and
//       writes it in 16-byte chunks along the output rows: storing the
//       fragments directly (8 rows of 16 bytes an instruction) ran a 1x1
//       conv with 256 outputs at 128x128 below the dp4a version's speed.
//   (b) int8_conv_grouped_kernel, groups > 1 (ResNeXt's 32 groups of 4-32
//       channels; the depthwise sites under MASKRCNN_TPU_INT8_DW=1): a block
//       owns an 8 x 8 tile of output pixels of one image and 64 output
//       channels. It loads the input patch with its halo,
//       ((8-1)*s + kh) x ((8-1)*s + kw) pixels of the slice's input channels,
//       into shared memory once (zeros outside the image), and the slice's
//       weights; each thread then computes 4 neighbouring channels of 4
//       pixels from shared memory: dp4a over a group's words where the
//       group's channels are a multiple of 4 (the 4 channels share the group,
//       so each input word serves 4 outputs and each weight word 4 pixels),
//       char4 products where cg = 1 (depthwise: 4 channels from one word),
//       bytes otherwise. Tensor cores are not used for groups: at cg <= 32 a
//       group's product is too thin for an m16n8k32 tile, and these sites
//       are small next to the rest (ResNeXt-50's 16 take ~0.35 ms).
//
// The first tensor-core version ran mma.sync m16n8k32 fed by ldmatrix; in
// one chip call wgmma ran the flagship's 65 sites 6 % faster (the wide P2
// and P3 convs and FC1 15-16 %, no site slower beyond the noise) with the
// same bits, so it replaced it. One wgmma group stays in flight while the
// block refills the stage the previous one read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

struct Geometry {
  int n, h, w, c;
  int ho, wo, o;
  int kh, kw, stride, pad_top, pad_left, groups;
};

// acc as float32, times (sx * sw[o]), plus bias[o]: three roundings, as
// acc.float() * (sx * sw) + bias in PyTorch.
__device__ __forceinline__ float dequantize(int acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}
__device__ __forceinline__ float dequantize(int acc, float scale) {
  return __fmul_rn(__int2float_rn(acc), scale);
}

__device__ __forceinline__ float out_value(int acc, float scale, const float* bias, int o) {
  return bias != nullptr ? dequantize(acc, scale, bias[o]) : dequantize(acc, scale);
}

// ---------------------------------------------------------------------------
// (a) the tensor-core implicit GEMM
// ---------------------------------------------------------------------------

constexpr int kBK = 64;  // bytes of K a stage
constexpr int kStages = 4;
constexpr int kFarAway = -(1 << 29);  // a row past M: every tap falls outside the image
constexpr int kSmemAlign = 1024;      // the ring's base, for the 64-byte swizzle's 512-byte atoms

// A block's output tile: BM pixels by BN channels, a warpgroup (4 warps)
// for each 64 rows. wgmma m64nBNk32 leaves a warp 16 rows by all BN channels
// in m16n8 fragments: int4 j holds rows lane / 4 (x, y) and lane / 4 + 8
// (z, w), channels 8 j + 2 (lane % 4) and + 1.
template <int BM, int BN>
struct Tile {
  static constexpr int kBM = BM;
  static constexpr int kBN = BN;
  static constexpr int kThreads = 32 * BM / 16;
  static constexpr int kFragments = BN / 8;  // int4 accumulators a thread
  static constexpr int kStageBytes = (BM + BN) * kBK;
  static constexpr int kRowsOffset = kStages * kStageBytes;  // int4 [BM]: each row's pixel
  static constexpr int kOutRow = BN + 8;                     // elements a staged output row
  static constexpr int kOutBytes = BM * kOutRow * 4;         // the staged tile, float at most
  static constexpr int kParamsOffset =                       // float [2][BN]: sw and bias
      kRowsOffset + BM * 16 > kOutBytes ? kRowsOffset + BM * 16 : kOutBytes;
  static constexpr int kSmem = kParamsOffset + 2 * BN * 4 + kSmemAlign;
};
using BigTile = Tile<128, 128>;   // 2 warpgroups
using SmallTile = Tile<64, 64>;   // 1 warpgroup

struct MmaArgs {
  const int8_t* x;
  const int8_t* w;
  const float* sx;
  const float* sw;
  const float* bias;
  void* y;
  int4* workspace;  // split > 1: [split][tiles][kFragments][kThreads] int4
  int* counters;    // split > 1: [tiles], zero between launches
  Geometry g;
  int m_total, k_total, k_tiles, k_tiles_per_split, split;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte `col` (0..63) of row `row` of a 64-byte-row tile, its 16-byte chunks
// XOR-swizzled by the row pair.
__device__ __forceinline__ int swizzle(int row, int col) {
  return row * kBK + ((((col >> 4) ^ (row >> 1)) & 3) << 4) + (col & 15);
}

// V bytes from global to shared memory, zeros where !ok: cp.async for 4, 8
// and 16 bytes (src-size 0 makes the hardware write zeros), a plain byte
// otherwise.
template <int V>
__device__ __forceinline__ void copy_in(void* dst, const void* src, bool ok) {
  if constexpr (V == 1) {
    *static_cast<int8_t*>(dst) = ok ? *static_cast<const int8_t*>(src) : static_cast<int8_t>(0);
  } else {
    const int bytes = ok ? V : 0;
    if constexpr (V == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src), "n"(V),
                   "r"(bytes));
    }
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A wgmma shared-memory descriptor of a K-major operand stored as 64-byte
// rows in the 64-byte swizzle (chunk c of row r at c ^ ((r >> 1) & 3), the
// layout above): start address, 512 bytes between 8-row groups, mode B64.
__device__ __forceinline__ uint64_t sw64_descriptor(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

__device__ __forceinline__ void fence_async_proxy() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += a (64 x 32 bytes) . b (N x 32 bytes)^T, one warpgroup.
template <int N>
__device__ __forceinline__ void wgmma_s8(int4 (&d)[N / 8], uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_s8<128>(int4 (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0].x), "+r"(d[0].y), "+r"(d[0].z), "+r"(d[0].w),
        "+r"(d[1].x), "+r"(d[1].y), "+r"(d[1].z), "+r"(d[1].w),
        "+r"(d[2].x), "+r"(d[2].y), "+r"(d[2].z), "+r"(d[2].w),
        "+r"(d[3].x), "+r"(d[3].y), "+r"(d[3].z), "+r"(d[3].w),
        "+r"(d[4].x), "+r"(d[4].y), "+r"(d[4].z), "+r"(d[4].w),
        "+r"(d[5].x), "+r"(d[5].y), "+r"(d[5].z), "+r"(d[5].w),
        "+r"(d[6].x), "+r"(d[6].y), "+r"(d[6].z), "+r"(d[6].w),
        "+r"(d[7].x), "+r"(d[7].y), "+r"(d[7].z), "+r"(d[7].w),
        "+r"(d[8].x), "+r"(d[8].y), "+r"(d[8].z), "+r"(d[8].w),
        "+r"(d[9].x), "+r"(d[9].y), "+r"(d[9].z), "+r"(d[9].w),
        "+r"(d[10].x), "+r"(d[10].y), "+r"(d[10].z), "+r"(d[10].w),
        "+r"(d[11].x), "+r"(d[11].y), "+r"(d[11].z), "+r"(d[11].w),
        "+r"(d[12].x), "+r"(d[12].y), "+r"(d[12].z), "+r"(d[12].w),
        "+r"(d[13].x), "+r"(d[13].y), "+r"(d[13].z), "+r"(d[13].w),
        "+r"(d[14].x), "+r"(d[14].y), "+r"(d[14].z), "+r"(d[14].w),
        "+r"(d[15].x), "+r"(d[15].y), "+r"(d[15].z), "+r"(d[15].w)
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_s8<64>(int4 (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0].x), "+r"(d[0].y), "+r"(d[0].z), "+r"(d[0].w),
        "+r"(d[1].x), "+r"(d[1].y), "+r"(d[1].z), "+r"(d[1].w),
        "+r"(d[2].x), "+r"(d[2].y), "+r"(d[2].z), "+r"(d[2].w),
        "+r"(d[3].x), "+r"(d[3].y), "+r"(d[3].z), "+r"(d[3].w),
        "+r"(d[4].x), "+r"(d[4].y), "+r"(d[4].z), "+r"(d[4].w),
        "+r"(d[5].x), "+r"(d[5].y), "+r"(d[5].z), "+r"(d[5].w),
        "+r"(d[6].x), "+r"(d[6].y), "+r"(d[6].z), "+r"(d[6].w),
        "+r"(d[7].x), "+r"(d[7].y), "+r"(d[7].z), "+r"(d[7].w)
      : "l"(a), "l"(b), "r"(1));
}

// One stage: the BM pixels' and BN filters' bytes [kt * 64, kt * 64 + 64)
// of K. A thread keeps one column of V bytes, so it decodes its tap once.
template <typename Tl, int V>
__device__ __forceinline__ void load_stage(uint8_t* stage, const int4* rows, const MmaArgs& a, int o0, int kt,
                                           int tid) {
  constexpr int kCols = kBK / V;
  constexpr int kRowStep = Tl::kThreads / kCols;
  const Geometry& g = a.g;
  const int col = tid % kCols;
  const int r0 = tid / kCols;
  const int k = kt * kBK + col * V;
  const bool k_in = k < a.k_total;
  const int tap = k_in ? k / g.c : 0;
  const int ci = k - tap * g.c;
  const int ky = tap / g.kw;
  const int kx = tap - ky * g.kw;
  uint8_t* sa = stage;
  uint8_t* sb = stage + Tl::kBM * kBK;
#pragma unroll
  for (int i = 0; i < Tl::kBM / kRowStep; ++i) {
    const int r = r0 + i * kRowStep;
    const int4 p = rows[r];
    const int iy = p.y + ky;
    const int ix = p.z + kx;
    const bool ok = k_in && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
    const int8_t* src = ok ? a.x + ((static_cast<size_t>(p.x + iy) * g.w + ix) * g.c + ci) : a.x;
    copy_in<V>(sa + swizzle(r, col * V), src, ok);
  }
#pragma unroll
  for (int i = 0; i < Tl::kBN / kRowStep; ++i) {
    const int r = r0 + i * kRowStep;
    const int o = o0 + r;
    const bool ok = k_in && o < g.o;
    const int8_t* src = ok ? a.w + (static_cast<size_t>(o) * a.k_total + k) : a.w;
    copy_in<V>(sb + swizzle(r, col * V), src, ok);
  }
}

// Issue the stage's 64-byte step of K as one wgmma group: two k32 steps,
// this warpgroup's 64 rows of A against all of B (the second 32 bytes on).
template <typename Tl>
__device__ __forceinline__ void issue_stage(const uint8_t* stage, int4 (&acc)[Tl::kFragments], int warp) {
  const uint64_t da = sw64_descriptor(stage + (warp / 4) * 64 * kBK);
  const uint64_t db = sw64_descriptor(stage + Tl::kBM * kBK);
  wgmma_fence();
  wgmma_s8<Tl::kBN>(acc, da, db);
  wgmma_s8<Tl::kBN>(acc, da + 2, db + 2);
  wgmma_commit();
}

__device__ __forceinline__ void add_to(int4& a, const int4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <typename T>
__device__ __forceinline__ void store_two(T* p, float a, float b);
template <>
__device__ __forceinline__ void store_two<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_two<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}

template <typename T, typename Tl, int V>
__global__ void __launch_bounds__(Tl::kThreads, 256 / Tl::kThreads * 2) int8_conv_mma_kernel(MmaArgs a) {
  constexpr int kThreads = Tl::kThreads;
  constexpr int kFragments = Tl::kFragments;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  __shared__ int is_last;
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) &
                                             ~static_cast<uintptr_t>(kSmemAlign - 1));
  int4* rows = reinterpret_cast<int4*>(smem + Tl::kRowsOffset);
  float* params = reinterpret_cast<float*>(smem + Tl::kParamsOffset);
  const Geometry& g = a.g;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * Tl::kBM;
  const int o0 = blockIdx.y * Tl::kBN;
  const int kt0 = blockIdx.z * a.k_tiles_per_split;
  const int kt_count = min(a.k_tiles_per_split, a.k_tiles - kt0);
  const bool has_bias = a.bias != nullptr;
  const float s_x = *a.sx;

  for (int r = tid; r < Tl::kBM; r += kThreads) {
    const int m = m0 + r;
    int4 p = make_int4(0, kFarAway, kFarAway, 0);
    if (m < a.m_total) {
      const int per_image = g.ho * g.wo;
      const int n = m / per_image;
      const int rem = m - n * per_image;
      const int oy = rem / g.wo;
      const int ox = rem - oy * g.wo;
      p = make_int4(n * g.h, oy * g.stride - g.pad_top, ox * g.stride - g.pad_left, 0);
    }
    rows[r] = p;
  }
  // the epilogue's sw and bias ride in the first copy group
  for (int j = tid; j < Tl::kBN; j += kThreads) {
    const int o = o0 + j;
    copy_in<4>(params + j, a.sw + (o < g.o ? o : 0), o < g.o);
    if (has_bias) copy_in<4>(params + Tl::kBN + j, a.bias + (o < g.o ? o : 0), o < g.o);
  }
  __syncthreads();

  int4 acc[kFragments];
#pragma unroll
  for (int j = 0; j < kFragments; ++j) acc[j] = make_int4(0, 0, 0, 0);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_count) load_stage<Tl, V>(smem + s * Tl::kStageBytes, rows, a, o0, kt0 + s, tid);
    cp_async_commit();
  }
  // step it's wgmma runs while the block waits for step it - 1's and then
  // refills its stage
  for (int it = 0; it < kt_count; ++it) {
    cp_async_wait<kStages - 2>();
    fence_async_proxy();  // the copies, seen by wgmma's reads
    __syncthreads();      // stage it has landed for every thread
    issue_stage<Tl>(smem + (it % kStages) * Tl::kStageBytes, acc, warp);
    wgmma_wait<1>();  // this warpgroup's step it - 1 is done
    __syncthreads();  // every warpgroup's is: stage it - 1 is free
    const int next = it + kStages - 1;
    if (next < kt_count) load_stage<Tl, V>(smem + (next % kStages) * Tl::kStageBytes, rows, a, o0, kt0 + next, tid);
    cp_async_commit();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  if (a.split > 1) {
    const int tiles = gridDim.x * gridDim.y;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    int4* mine = a.workspace + (static_cast<size_t>(blockIdx.z) * tiles + tile) * kFragments * kThreads + tid;
#pragma unroll
    for (int j = 0; j < kFragments; ++j) mine[j * kThreads] = acc[j];
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(a.counters + tile, 1) == a.split - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    for (int s = 0; s < a.split; ++s) {
      if (s == static_cast<int>(blockIdx.z)) continue;
      const int4* other = a.workspace + (static_cast<size_t>(s) * tiles + tile) * kFragments * kThreads + tid;
#pragma unroll
      for (int j = 0; j < kFragments; ++j) add_to(acc[j], __ldcg(other + j * kThreads));
    }
    if (tid == 0) a.counters[tile] = 0;  // ready for the next launch on this stream
  }

  // the epilogue: dequantize each fragment into a tile staged in shared
  // memory over the ring, then store it in 16-byte chunks along the rows
  __syncthreads();  // every warpgroup is done with the ring
  T* out = reinterpret_cast<T*>(smem);
#pragma unroll
  for (int j = 0; j < kFragments; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    const float scale0 = __fmul_rn(s_x, params[col]);
    const float scale1 = __fmul_rn(s_x, params[col + 1]);
    const float bias0 = params[Tl::kBN + col];
    const float bias1 = params[Tl::kBN + col + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = warp * 16 + (lane >> 2) + half * 8;
      const int v0 = half ? acc[j].z : acc[j].x;
      const int v1 = half ? acc[j].w : acc[j].y;
      const float y0 = has_bias ? dequantize(v0, scale0, bias0) : dequantize(v0, scale0);
      const float y1 = has_bias ? dequantize(v1, scale1, bias1) : dequantize(v1, scale1);
      store_two<T>(out + row * Tl::kOutRow + col, y0, y1);
    }
  }
  __syncthreads();
  constexpr int kChunk = 16 / sizeof(T);  // outputs a 16-byte chunk
  constexpr int kChunksRow = Tl::kBN / kChunk;
  const bool rows_aligned = (g.o * static_cast<int>(sizeof(T))) % 16 == 0;
  T* y = static_cast<T*>(a.y);
  for (int i = tid; i < Tl::kBM * kChunksRow; i += kThreads) {
    const int r = i / kChunksRow;
    const int c = (i - r * kChunksRow) * kChunk;
    const int m = m0 + r;
    const int o = o0 + c;
    if (m >= a.m_total || o >= g.o) continue;
    const T* src = out + r * Tl::kOutRow + c;
    T* dst = y + static_cast<size_t>(m) * g.o + o;
    if (rows_aligned && o + kChunk <= g.o) {
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    } else {
      for (int j = 0; j < kChunk && o + j < g.o; ++j) dst[j] = src[j];
    }
  }
}

// ---------------------------------------------------------------------------
// (b) the grouped kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // threads a grouped block
constexpr int kGT = 8;         // output pixels a tile side
constexpr int kGC = 64;        // output channels a block

enum GroupedMode { kDepthwise = 1, kWords = 2, kBytes = 3 };

struct GroupedArgs {
  const int8_t* x;
  const int8_t* w;
  const float* sx;
  const float* sw;
  const float* bias;
  void* y;
  Geometry g;
  int cstride;  // bytes a patch pixel in shared memory
};

template <int V>
__device__ __forceinline__ void copy_patch(uint8_t* dst, const int8_t* src, bool ok) {
  if constexpr (V == 16) {
    *reinterpret_cast<int4*>(dst) = ok ? *reinterpret_cast<const int4*>(src) : make_int4(0, 0, 0, 0);
  } else if constexpr (V == 4) {
    *reinterpret_cast<int*>(dst) = ok ? *reinterpret_cast<const int*>(src) : 0;
  } else {
    *reinterpret_cast<int8_t*>(dst) = ok ? *src : static_cast<int8_t>(0);
  }
}

template <typename T>
__device__ __forceinline__ void store_quad(T* p, const float (&v)[4], int count, bool vector);
template <>
__device__ __forceinline__ void store_quad<float>(float* p, const float (&v)[4], int count, bool vector) {
  if (vector && count == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  for (int j = 0; j < count; ++j) p[j] = v[j];
}
template <>
__device__ __forceinline__ void store_quad<__nv_bfloat16>(__nv_bfloat16* p, const float (&v)[4], int count,
                                                          bool vector) {
  if (vector && count == 4) {
    __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
    __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = packed;
    return;
  }
  for (int j = 0; j < count; ++j) p[j] = __float2bfloat16_rn(v[j]);
}

template <typename T, int kMode, int V>
__global__ void __launch_bounds__(kThreads) int8_conv_grouped_kernel(GroupedArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Geometry& g = a.g;
  const int tid = threadIdx.x;
  const int og = g.o / g.groups;
  const int cg = g.c / g.groups;
  const int taps = g.kh * g.kw;
  const int kg = taps * cg;  // one filter's bytes
  const int tiles_x = (g.wo + kGT - 1) / kGT;
  const int oy0 = (blockIdx.x / tiles_x) * kGT;
  const int ox0 = (blockIdx.x % tiles_x) * kGT;
  const int n = blockIdx.y;
  const int o0 = blockIdx.z * kGC;
  const int o1 = min(o0 + kGC, g.o);
  const int cs0 = (o0 / og) * cg;            // the slice's input channels [cs0, cs1)
  const int cs1 = ((o1 - 1) / og + 1) * cg;
  const int ph = (kGT - 1) * g.stride + g.kh;
  const int pw = (kGT - 1) * g.stride + g.kw;
  uint8_t* patch = smem;
  int8_t* wsm = reinterpret_cast<int8_t*>(smem + ph * pw * a.cstride);

  // the input patch with its halo, zeros outside the image
  const int iy0 = oy0 * g.stride - g.pad_top;
  const int ix0 = ox0 * g.stride - g.pad_left;
  const int chunks = (cs1 - cs0) / V;
  for (int i = tid; i < ph * pw * chunks; i += kThreads) {
    const int q = i % chunks;
    const int pix = i / chunks;
    const int py = pix / pw;
    const int iy = iy0 + py;
    const int ix = ix0 + pix - py * pw;
    const bool ok = iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
    const int8_t* src = ok ? a.x + (((static_cast<size_t>(n) * g.h + iy) * g.w + ix) * g.c + cs0 + q * V) : a.x;
    copy_patch<V>(patch + pix * a.cstride + q * V, src, ok);
  }
  // the slice's filters: [channel][tap][cg], depthwise [tap][channel]
  const int nw = (o1 - o0) * kg;
  const int8_t* wsrc = a.w + static_cast<size_t>(o0) * kg;
  if constexpr (kMode == kDepthwise) {
    for (int i = tid; i < nw; i += kThreads) {
      const int j = i / taps;
      wsm[(i - j * taps) * kGC + j] = wsrc[i];
    }
  } else {
    int start = 0;
    if ((reinterpret_cast<uintptr_t>(wsrc) & 3) == 0) {
      start = nw & ~3;
      for (int i = tid; i < nw / 4; i += kThreads) {
        reinterpret_cast<int*>(wsm)[i] = reinterpret_cast<const int*>(wsrc)[i];
      }
    }
    for (int i = start + tid; i < nw; i += kThreads) wsm[i] = wsrc[i];
  }
  __syncthreads();

  // 4 neighbouring channels of the pixels (ty + 2 i, tx), i < 4, of the tile
  const int oc = (tid % (kGC / 4)) * 4;
  const int pg = tid / (kGC / 4);
  const int tx = pg % kGT;
  const int ty = pg / kGT;
  if (o0 + oc >= o1) return;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int ky = 0; ky < g.kh; ++ky) {
    for (int kx = 0; kx < g.kw; ++kx) {
      const int t = ky * g.kw + kx;
      int pix[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pix[i] = (((ty + 2 * i) * g.stride + ky) * pw + tx * g.stride + kx) * a.cstride;
      if constexpr (kMode == kDepthwise) {
        const char4 wv = *reinterpret_cast<const char4*>(wsm + t * kGC + oc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const char4 xv = *reinterpret_cast<const char4*>(patch + pix[i] + oc);
          acc[i][0] += xv.x * wv.x;
          acc[i][1] += xv.y * wv.y;
          acc[i][2] += xv.z * wv.z;
          acc[i][3] += xv.w * wv.w;
        }
      } else if constexpr (kMode == kWords) {
        const int in0 = ((o0 + oc) / og) * cg - cs0;  // the 4 channels' group
        const int8_t* wq = wsm + oc * kg + t * cg;
        for (int q = 0; q < cg; q += 4) {
          int wv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = *reinterpret_cast<const int*>(wq + j * kg + q);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int xw = *reinterpret_cast<const int*>(patch + pix[i] + in0 + q);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(xw, wv[j], acc[i][j]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = o0 + oc + j;
          if (o >= o1) break;
          const int in0 = (o / og) * cg - cs0;
          const int8_t* wq = wsm + (oc + j) * kg + t * cg;
          for (int q = 0; q < cg; ++q) {
            const int wv = wq[q];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][j] += static_cast<int>(reinterpret_cast<const int8_t*>(patch)[pix[i] + in0 + q]) * wv;
            }
          }
        }
      }
    }
  }

  const int count = min(4, o1 - (o0 + oc));
  const float s_x = *a.sx;
  float scale[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) scale[j] = j < count ? __fmul_rn(s_x, a.sw[o0 + oc + j]) : 0.0f;
  const bool vector = (g.o & 3) == 0;
  T* y = static_cast<T*>(a.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oy = oy0 + ty + 2 * i;
    const int ox = ox0 + tx;
    if (oy >= g.ho || ox >= g.wo) continue;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < count ? out_value(acc[i][j], scale[j], a.bias, o0 + oc + j) : 0.0f;
    store_quad<T>(y + ((static_cast<size_t>(n) * g.ho + oy) * g.wo + ox) * g.o + o0 + oc, v, count, vector);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

enum Kernel { kMma = 0 };

template <typename T, typename Tl, int V>
cudaError_t launch_mma(const MmaArgs& a, dim3 grid, cudaStream_t s) {
  auto kernel = int8_conv_mma_kernel<T, Tl, V>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, Tl::kThreads, Tl::kSmem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, typename Tl>
cudaError_t dispatch_mma_vec(const MmaArgs& a, int vec, dim3 grid, cudaStream_t s) {
  switch (vec) {
    case 16: return launch_mma<T, Tl, 16>(a, grid, s);
    case 8: return launch_mma<T, Tl, 8>(a, grid, s);
    case 4: return launch_mma<T, Tl, 4>(a, grid, s);
    case 1: return launch_mma<T, Tl, 1>(a, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_mma(const MmaArgs& a, int tile_m, int vec, dim3 grid, cudaStream_t s) {
  return tile_m == BigTile::kBM ? dispatch_mma_vec<T, BigTile>(a, vec, grid, s)
                                : dispatch_mma_vec<T, SmallTile>(a, vec, grid, s);
}

template <typename T, int kMode, int V>
cudaError_t launch_grouped(const GroupedArgs& a, dim3 grid, int smem, cudaStream_t s) {
  auto kernel = int8_conv_grouped_kernel<T, kMode, V>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int kMode>
cudaError_t dispatch_grouped_vec(const GroupedArgs& a, int vec, dim3 grid, int smem, cudaStream_t s) {
  switch (vec) {
    case 16: return launch_grouped<T, kMode, 16>(a, grid, smem, s);
    case 4: return launch_grouped<T, kMode, 4>(a, grid, smem, s);
    case 1: return launch_grouped<T, kMode, 1>(a, grid, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_grouped(const GroupedArgs& a, int mode, int vec, dim3 grid, int smem, cudaStream_t s) {
  switch (mode) {
    case kDepthwise: return dispatch_grouped_vec<T, kDepthwise>(a, vec, grid, smem, s);
    case kWords: return dispatch_grouped_vec<T, kWords>(a, vec, grid, smem, s);
    case kBytes: return dispatch_grouped_vec<T, kBytes>(a, vec, grid, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

extern "C" {

const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// x int8 [n, h, w, c]; w int8 [o, kh, kw, c / groups]; sx float32 [1]; sw
// float32 [o]; bias float32 [o] or null; y [n, ho, wo, o], float32 when
// out_dtype is 0, bfloat16 when 1. The plan (kernels/int8_conv.py::plan):
// kernel 0 the tensor-core GEMM (groups == 1) on tile_m x tile_m output tiles
// (128 or 64), 1 grouped depthwise, 2 grouped dp4a words, 3 grouped bytes;
// vec the bytes a copy of x (and of w for kernel 0); for kernel 0, K split
// into `split` ranges of k_tiles_per_split 64-byte steps, with workspace
// (int32, split * tiles * tile_m^2) and counters (int32 [tiles], all zero)
// when split > 1. Every choice is checked against the geometry and the
// pointers. Returns a cudaError_t.
int int8_conv_launch(const void* x, const void* w, const void* sx, const void* sw, const void* bias, void* y,
                     int out_dtype, int n, int h, int w_in, int c, int o, int kh, int kw, int stride, int pad_top,
                     int pad_left, int groups, int ho, int wo, int kernel, int tile_m, int vec, int split,
                     int k_tiles_per_split, void* workspace, void* counters, void* stream) {
  if (n < 0 || h <= 0 || w_in <= 0 || c <= 0 || o <= 0 || kh <= 0 || kw <= 0 || stride <= 0 || groups <= 0 ||
      c % groups != 0 || o % groups != 0 || ho <= 0 || wo <= 0 || pad_top < 0 || pad_left < 0 ||
      (out_dtype != 0 && out_dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  const Geometry g{n, h, w_in, c, ho, wo, o, kh, kw, stride, pad_top, pad_left, groups};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);

  if (kernel == kMma) {
    const long long m_total = static_cast<long long>(n) * ho * wo;
    const long long k_total = static_cast<long long>(kh) * kw * c;
    if (groups != 1 || m_total >= (1LL << 31) || k_total >= (1LL << 31) / 4 ||
        (tile_m != BigTile::kBM && tile_m != SmallTile::kBM)) {
      return cudaErrorInvalidValue;
    }
    if (vec != 1 && (c % vec != 0 || !aligned(x, vec) || !aligned(w, vec))) return cudaErrorMisalignedAddress;
    const int k_tiles = static_cast<int>((k_total + kBK - 1) / kBK);
    if (split < 1 || k_tiles_per_split < 1 || static_cast<long long>(split) * k_tiles_per_split < k_tiles ||
        static_cast<long long>(split - 1) * k_tiles_per_split >= k_tiles || split > 65535) {
      return cudaErrorInvalidValue;
    }
    if (split > 1 && (workspace == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
    MmaArgs a{xp, wp, static_cast<const float*>(sx), static_cast<const float*>(sw), static_cast<const float*>(bias),
              y, static_cast<int4*>(workspace), static_cast<int*>(counters), g, static_cast<int>(m_total),
              static_cast<int>(k_total), k_tiles, k_tiles_per_split, split};
    const dim3 grid(static_cast<unsigned>((m_total + tile_m - 1) / tile_m), (o + tile_m - 1) / tile_m, split);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    return out_dtype == 0 ? dispatch_mma<float>(a, tile_m, vec, grid, s)
                          : dispatch_mma<__nv_bfloat16>(a, tile_m, vec, grid, s);
  }

  // grouped: every slice of 64 output channels reads whole groups of input channels
  const int og = o / groups;
  const int cg = c / groups;
  if (groups == 1 || (kernel == kDepthwise && (cg != 1 || og != 1)) ||
      (kernel == kWords && (cg % 4 != 0 || og % 4 != 0)) || (kernel != kDepthwise && kernel != kWords &&
                                                             kernel != kBytes)) {
    return cudaErrorInvalidValue;
  }
  int csl = 0;
  for (int o0 = 0; o0 < o; o0 += kGC) {
    const int cs0 = (o0 / og) * cg;
    const int cs1 = ((std::min(o0 + kGC, o) - 1) / og + 1) * cg;
    if (vec != 1 && (cs0 % vec != 0 || cs1 % vec != 0)) return cudaErrorInvalidValue;
    csl = std::max(csl, cs1 - cs0);
  }
  if (vec != 1 && (vec != 4 && vec != 16)) return cudaErrorInvalidValue;
  if (vec != 1 && (c % vec != 0 || !aligned(x, vec))) return cudaErrorMisalignedAddress;
  const int cstride = (csl + 15) / 16 * 16;
  const int ph = (kGT - 1) * stride + kh;
  const int pw = (kGT - 1) * stride + kw;
  const long long smem =
      static_cast<long long>(ph) * pw * cstride + (static_cast<long long>(kGC) * kh * kw * cg + 15) / 16 * 16;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  GroupedArgs a{xp, wp, static_cast<const float*>(sx), static_cast<const float*>(sw), static_cast<const float*>(bias),
                y, g, cstride};
  const dim3 grid(static_cast<unsigned>(((ho + kGT - 1) / kGT) * ((wo + kGT - 1) / kGT)), n, (o + kGC - 1) / kGC);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  return out_dtype == 0 ? dispatch_grouped<float>(a, kernel, vec, grid, static_cast<int>(smem), s)
                        : dispatch_grouped<__nv_bfloat16>(a, kernel, vec, grid, static_cast<int>(smem), s);
}

}  // extern "C"
