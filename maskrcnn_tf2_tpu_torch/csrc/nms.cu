// Exact greedy non-max suppression over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces the TPU kernel maskrcnn_tf2_tpu/kernels/nms_pallas.py::_nms_kernel
// (called through greedy_keep_pallas from maskrcnn_tf2_tpu/ops/nms.py). Same
// result as the reference recurrence keep[i] = valid[i] & !any_{j<i, keep[j]}
// (iou(j, i) > t), with the reference's predicate inter / max(union, 1e-10) > t
// and box_area's clamps (ops/boxes.py), not the TPU kernel's inter > t * union.
//
// What bounds it on this card: not bytes (6000 boxes are 96 KB) and not
// arithmetic (a few million IoU tests), but the serial chain of the greedy
// order. Each tile of blockDim rows needs one barrier per kept row.
//
// Design: one thread block per image, so the batch is one launch. The block
// walks the sorted boxes in tiles of kThreads rows.
//   (a) Each thread tests its row against the compacted list of boxes kept so
//       far, held in shared memory (at most `limit` of them, 20 bytes each).
//       A kept box is never revisited, so the tile never reads the rows that
//       were suppressed before it.
//   (b) Chains inside the tile settle serially over its rows, in parallel over
//       the rows each kept row can suppress: one __syncthreads per kept row.
//   Survivors are appended in order, so the kernel writes the compacted
//   (positions, valid) output directly, and the block stops once `limit`
//   boxes are kept: no later box can enter the first `limit`.
// Build with -fmad=false: the predicate must round like PyTorch's separate
// element-wise ops, or ties at the threshold would resolve differently.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float area_of(float4 b) {
  return fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
}

__device__ __forceinline__ bool overlaps_above(float4 a, float area_a, float4 b,
                                               float area_b, float thr) {
  const float y1 = fmaxf(a.x, b.x);
  const float x1 = fmaxf(a.y, b.y);
  const float y2 = fminf(a.z, b.z);
  const float x2 = fminf(a.w, b.w);
  const float inter = fmaxf(y2 - y1, 0.0f) * fmaxf(x2 - x1, 0.0f);
  const float uni = area_a + area_b - inter;
  return inter / fmaxf(uni, 1e-10f) > thr;
}

__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                  int n, float thr, int limit, int32_t* __restrict__ out_pos,
                  uint8_t* __restrict__ out_valid) {
  extern __shared__ float4 kept[];  // [limit] boxes, then [limit] areas
  float* kept_area = reinterpret_cast<float*>(kept + limit);
  __shared__ float4 tile_box[kThreads];
  __shared__ float tile_area[kThreads];
  __shared__ int tile_alive[kThreads];
  __shared__ int s_count;

  const int t = threadIdx.x;
  boxes += static_cast<size_t>(blockIdx.x) * n;
  valid += static_cast<size_t>(blockIdx.x) * n;
  out_pos += static_cast<size_t>(blockIdx.x) * limit;
  out_valid += static_cast<size_t>(blockIdx.x) * limit;
  if (t == 0) s_count = 0;
  __syncthreads();

  for (int start = 0; start < n; start += kThreads) {
    int count = s_count;  // block-uniform: written before the last barrier
    if (count >= limit) break;
    const int i = start + t;
    float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float area = 0.0f;
    bool alive = false;
    if (i < n) {
      box = boxes[i];
      area = area_of(box);
      alive = valid[i] != 0;
    }
    // (a) suppression by every box kept before this tile
    for (int k = 0; alive && k < count; ++k) {
      if (overlaps_above(box, area, kept[k], kept_area[k], thr)) alive = false;
    }
    tile_box[t] = box;
    tile_area[t] = area;
    tile_alive[t] = alive;
    __syncthreads();

    // (b) greedy order inside the tile. tile_alive[r] is final when step r
    // reads it: only rows after r are written at step r, and every kept row's
    // step ends at a barrier.
    const int rows = min(kThreads, n - start);
    for (int r = 0; r < rows; ++r) {
      if (!tile_alive[r]) continue;  // block-uniform
      if (t == 0) {
        kept[count] = tile_box[r];
        kept_area[count] = tile_area[r];
        out_pos[count] = start + r;
        out_valid[count] = 1;
      }
      ++count;
      if (count >= limit) break;  // block-uniform
      if (t > r && alive &&
          overlaps_above(box, area, tile_box[r], tile_area[r], thr)) {
        alive = false;
        tile_alive[t] = 0;
      }
      __syncthreads();
    }
    if (t == 0) s_count = count;
    __syncthreads();
  }

  for (int k = s_count + t; k < limit; k += kThreads) {
    out_pos[k] = 0;
    out_valid[k] = 0;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// boxes [b, n, 4] float32 and valid [b, n] bool, score-sorted per image;
// out_pos [b, limit] int32 and out_valid [b, limit] bool. Returns a cudaError_t.
int greedy_nms_launch(const void* boxes, const void* valid, int b, int n, float thr,
                      int limit, void* out_pos, void* out_valid, void* stream) {
  const size_t smem = static_cast<size_t>(limit) * (sizeof(float4) + sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  greedy_nms_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid), n, thr,
      limit, static_cast<int32_t*>(out_pos), static_cast<uint8_t*>(out_valid));
  return cudaGetLastError();
}

}  // extern "C"
