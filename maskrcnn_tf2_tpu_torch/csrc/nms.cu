// Exact greedy non-max suppression over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces the TPU kernel maskrcnn_tf2_tpu/kernels/nms_pallas.py::_nms_kernel
// (called through greedy_keep_pallas from maskrcnn_tf2_tpu/ops/nms.py). Same
// result as the reference recurrence keep[i] = valid[i] & !any_{j<i, keep[j]}
// (iou(j, i) > t), with the reference's predicate inter / max(union, 1e-10) > t
// and box_area's clamps (ops/boxes.py), not the TPU kernel's inter > t * union.
//
// What bounds it on this card: not bytes (6000 boxes are 96 KB) and not the
// IoU tests the greedy order needs (a few million), but latency: the greedy
// order is a serial chain, and every test that could matter has to be done
// before the chain reaches it. A design with one block per image that tests
// each row against the boxes kept so far (the previous version) runs on 2 of
// 132 SMs and pays one block barrier per kept box.
//
// Design: two kernels, launched back to back on the stream by one launcher.
//   (a) nms_mask_kernel, over the whole card: a grid of (column block, row
//       block, image) blocks of 64 threads, of which those with column block
//       >= row block work. Thread i tests its row against the block's 64
//       columns and writes one 64-bit word: bit j is set where column j lies
//       after the row and overlaps it above the threshold. The row-major
//       workspace [B, N, ceil(N/64)] keeps a row's words contiguous; at
//       N = 6000 it is 4.5 MB per image, which stays in the 50 MB L2.
//   (b) nms_scan_kernel, one block per image, keeps the "removed" bitset of
//       all rows in shared memory (invalid rows and the padding past N start
//       removed, so they neither keep nor suppress) and walks 64-row chunks:
//       warp 0 settles the chunk's greedy chain in registers, taking the
//       lowest row not removed, keeping it and clearing the rows its diagonal
//       word suppresses (its word comes from the lane that loaded it, by
//       __shfl_sync), and appends the kept positions in order, stopping at
//       `limit`; then the whole block ORs the kept rows' words for later
//       chunks into the bitset: each of its 1024 threads owns one later word
//       and a share of the kept rows, so its loads are independent and
//       coalesced across threads, and it ORs them in a register before one
//       shared atomic. Two barriers per chunk (94 at N = 6000) replace one
//       per kept box, and each IoU test is made once, on all SMs, instead of
//       once per kept box on one SM.
//   The scan writes the compacted (positions, valid) output directly,
//   zero-padded past the kept count.
// Build with -fmad=false: the predicate must round like PyTorch's separate
// element-wise ops, or ties at the threshold would resolve differently.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaskThreads = 64;   // one row per thread, 64 columns per block
constexpr int kScanThreads = 1024;
constexpr int kMaxWords = 512;     // removed bitset in shared memory: N <= 32768
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float area_of(float4 b) {
  return fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
}

// a: the later box, b: the earlier one (the argument order of the reference).
__device__ __forceinline__ bool overlaps_above(float4 a, float area_a, float4 b,
                                               float area_b, float thr) {
  const float y1 = fmaxf(a.x, b.x);
  const float x1 = fmaxf(a.y, b.y);
  const float y2 = fminf(a.z, b.z);
  const float x2 = fminf(a.w, b.w);
  const float inter = fmaxf(y2 - y1, 0.0f) * fmaxf(x2 - x1, 0.0f);
  const float uni = area_a + area_b - inter;
  // 0 / max(union, 1e-10) is exactly 0 (the divisor is never NaN or 0), so
  // disjoint pairs skip the IEEE division
  const float iou = inter == 0.0f ? 0.0f : inter / fmaxf(uni, 1e-10f);
  return iou > thr;
}

__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float4* __restrict__ boxes, int n, int words, float thr,
                uint64_t* __restrict__ mask) {
  const int col_block = blockIdx.x;
  const int row_block = blockIdx.y;
  if (col_block < row_block) return;  // the scan never reads these words
  __shared__ float4 col_box[kMaskThreads];
  __shared__ float col_area[kMaskThreads];
  const int t = threadIdx.x;
  boxes += static_cast<size_t>(blockIdx.z) * n;
  const int col = col_block * kMaskThreads + t;
  if (col < n) {
    const float4 bx = boxes[col];
    col_box[t] = bx;
    col_area[t] = area_of(bx);
  }
  __syncthreads();
  const int row = row_block * kMaskThreads + t;
  if (row >= n) return;
  const float4 box = boxes[row];
  const float area = area_of(box);
  const int cols = min(kMaskThreads, n - col_block * kMaskThreads);
  uint64_t bits = 0;
  for (int j = col_block == row_block ? t + 1 : 0; j < cols; ++j) {
    if (overlaps_above(col_box[j], col_area[j], box, area, thr)) bits |= 1ull << j;
  }
  mask[(static_cast<size_t>(blockIdx.z) * n + row) * words + col_block] = bits;
}

// Word `c` of rows c*64 + lane and c*64 + 32 + lane (0 past n).
__device__ __forceinline__ void load_diagonal(const uint64_t* __restrict__ mask, int n, int words,
                                              int c, int lane, uint64_t& lo, uint64_t& hi) {
  const int r0 = c * 64 + lane;
  const int r1 = r0 + 32;
  lo = r0 < n ? mask[static_cast<size_t>(r0) * words + c] : 0;
  hi = r1 < n ? mask[static_cast<size_t>(r1) * words + c] : 0;
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const uint64_t* __restrict__ mask, const uint8_t* __restrict__ valid, int n,
                int limit, int32_t* __restrict__ out_pos, uint8_t* __restrict__ out_valid) {
  __shared__ unsigned long long removed[kMaxWords];
  __shared__ int kept_rows[64];
  __shared__ int s_kept;
  __shared__ int s_count;

  const int words = (n + 63) / 64;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  mask += static_cast<size_t>(blockIdx.x) * n * words;
  valid += static_cast<size_t>(blockIdx.x) * n;
  out_pos += static_cast<size_t>(blockIdx.x) * limit;
  out_valid += static_cast<size_t>(blockIdx.x) * limit;

  // invalid rows and the padding past n start removed
  for (int w = warp; w < words; w += kScanThreads / 32) {
    const int i0 = w * 64 + lane;
    const int i1 = i0 + 32;
    const unsigned lo = __ballot_sync(kFull, i0 >= n || valid[i0] == 0);
    const unsigned hi = __ballot_sync(kFull, i1 >= n || valid[i1] == 0);
    if (lane == 0) removed[w] = (static_cast<unsigned long long>(hi) << 32) | lo;
  }
  if (t == 0) s_count = 0;
  __syncthreads();

  int count = 0;  // kept so far; warp 0 owns it, the block reads s_count
  uint64_t d_lo = 0, d_hi = 0;
  if (warp == 0 && words > 0) load_diagonal(mask, n, words, 0, lane, d_lo, d_hi);

  for (int c = 0; c < words; ++c) {
    if (warp == 0) {
      // the chunk's greedy chain, lane-uniform: take the lowest live row,
      // keep it, and clear the later rows of the chunk that it suppresses
      uint64_t live = ~static_cast<uint64_t>(removed[c]);
      uint64_t kept = 0;
      int room = limit - count;
      while (live != 0 && room > 0) {
        const int r = __ffsll(static_cast<long long>(live)) - 1;
        const uint64_t row = __shfl_sync(kFull, r < 32 ? d_lo : d_hi, r & 31);
        kept |= 1ull << r;
        --room;
        live &= live - 1;
        live &= ~row;
      }
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h;
        if ((kept >> r) & 1) {
          const int rank = __popcll(kept & ((1ull << r) - 1));
          out_pos[count + rank] = c * 64 + r;
          out_valid[count + rank] = 1;
          kept_rows[rank] = c * 64 + r;
        }
      }
      count += __popcll(kept);
      if (lane == 0) {
        s_kept = __popcll(kept);
        s_count = count;
      }
      // the next diagonal loads while the block ORs this chunk's rows
      if (c + 1 < words) load_diagonal(mask, n, words, c + 1, lane, d_lo, d_hi);
    }
    __syncthreads();
    if (s_count >= limit) break;  // block-uniform
    // threads own (word, share of the kept rows): independent loads ORed in
    // a register, then one shared atomic per thread
    const int later = words - c - 1;
    const int nk = s_kept;
    if (later > 0 && nk > 0) {
      const int groups = max(1, kScanThreads / later);
      if (t < groups * later) {
        const int w = c + 1 + t % later;
        uint64_t acc = 0;
#pragma unroll 4
        for (int i = t / later; i < nk; i += groups) acc |= mask[static_cast<size_t>(kept_rows[i]) * words + w];
        if (acc != 0) atomicOr(&removed[w], static_cast<unsigned long long>(acc));
      }
    }
    __syncthreads();
  }

  for (int k = s_count + t; k < limit; k += kScanThreads) {
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
// mask: workspace of b * n * ceil(n / 64) uint64 words (uninitialised);
// out_pos [b, limit] int32 and out_valid [b, limit] bool. Returns a cudaError_t.
int greedy_nms_launch(const void* boxes, const void* valid, int b, int n, float thr,
                      int limit, void* mask, void* out_pos, void* out_valid, void* stream) {
  if (n < 0 || n > kMaxWords * 64 || b < 0 || limit < 0) return cudaErrorInvalidValue;
  if (b == 0 || limit == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (n + 63) / 64;
  if (n > 0) {
    const dim3 grid(words, words, b);
    nms_mask_kernel<<<grid, kMaskThreads, 0, s>>>(static_cast<const float4*>(boxes), n, words,
                                                  thr, static_cast<uint64_t*>(mask));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  nms_scan_kernel<<<b, kScanThreads, 0, s>>>(
      static_cast<const uint64_t*>(mask), static_cast<const uint8_t*>(valid), n, limit,
      static_cast<int32_t*>(out_pos), static_cast<uint8_t*>(out_valid));
  return cudaGetLastError();
}

}  // extern "C"
