// The y-segmented first-overlap sweep of the gridless rect step for
// sm_90a, behind a plain C interface (loaded with ctypes by
// magent_tpu_torch/ops/_build.py).
//
// One big world (16,384 to 65,536 slots) presents its [A] operands sorted
// by y.  Sorted row j belongs to segment s = j / 1024; the segment's
// partners are the sorted rows [start[s], start[s] + P), which hold every
// row within the caller's y-margin of the segment.  When the plan's
// overflow flag is set (some segment needed more than P rows), every query
// sweeps all A rows instead, so the result never depends on the plan.
//
//   rect_first_overlap_seg  the body that query rect j first overlaps in the
//                           grid path's cell scan order: min over gated
//                           bodies of k * stride + slot id, k the first
//                           overlapped cell; gate slot id != or < qslot_j
//
// Replaces magent_tpu/ops/attack_prefix.py _rect_overlap_core (the Pallas
// sweep over [S, 1024] queries x [S, P] gathered windows, S a leading grid
// axis) and its overflow branch rect_first_overlap_tpu with explicit slot
// operands.  The other two segmented sweeps, occupant_rect_seg and
// rank_prefix_seg, run on the split template in pair_kernels.cu.
//
// What bounds it here: integer compares and selects, 8 per pair (12 as
// written here), over A * P pairs (pursuit at map 1000: 37 segments x 1024
// rows x 2560 partners, 97.0 M pairs per gate); the operands are a few
// hundred KB and stay in L2.  Design: one thread per sorted query row, 128
// partner rows staged at a time in shared memory (a broadcast read per
// pair), partners in ascending row order.  blockIdx.x is a 128-row tile of
// a segment, so a launch has ceil(A / 128) blocks (293 at map 1000, for
// 132 SMs).  Each block reads start[s] and *overflow on the device and
// sweeps its window in place: no [S, P] gather, no host sync.  Rows past A
// are the pad sentinels of the plain version (empty rects): never staged,
// never written.  Slot ids are operands, so the gates compare ids, never
// positions, and lower_only has no triangular skip.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;      // threads per block == partners per stage
constexpr int kSegRows = 1024;  // SEG_ROWS of ops/attack_prefix.py
constexpr int kTilesPerSeg = kSegRows / kTile;
constexpr int kRectPad = -(1 << 20);  // RECT_PAD: a non-query's coordinate

// The partner rows [begin, end) of this block's segment.
struct Window {
  int begin, end;
};

__device__ __forceinline__ Window seg_window(const int* __restrict__ start,
                                             const bool* __restrict__ overflow,
                                             int A, int P) {
  if (*overflow) return {0, A};
  const int b = start[blockIdx.x / kTilesPerSeg];
  return {b, min(A, b + P)};
}

// The packed key is formed in unsigned arithmetic: for a pair that does not
// overlap, (ox - px) may be 2^20 and the product wraps; the select drops it.
// For an overlapping pair k < MB^2 and slot < A <= stride, so the key stays
// below 2^30 + A <= 2^31 - 1.
template <bool kLower>
__global__ void rect_first_overlap_seg_kernel(
    const int* __restrict__ qx, const int* __restrict__ qy,
    const int* __restrict__ tbw, const int* __restrict__ tbh,
    const int* __restrict__ x, const int* __restrict__ y,
    const int* __restrict__ bw, const int* __restrict__ bh,
    const int* __restrict__ slot, const int* __restrict__ start,
    const bool* __restrict__ overflow, int A, int P, int stride, int MB,
    int* __restrict__ out) {
  constexpr unsigned kNoneKey = 0x7fffffffu;
  __shared__ int s_x0[kTile], s_x1[kTile], s_y0[kTile], s_y1[kTile];
  __shared__ int s_slot[kTile];
  const int j = blockIdx.x * kTile + threadIdx.x;
  const Window w = seg_window(start, overflow, A, P);
  // a row past A queries the empty rect at RECT_PAD
  const int px = j < A ? qx[j] : kRectPad;
  const int py = j < A ? qy[j] : kRectPad;
  const int px1 = j < A ? px + tbw[j] : px;
  const int py1 = j < A ? py + tbh[j] : py;
  const int qs = j < A ? slot[j] : 0;
  unsigned best = kNoneKey;
  for (int i0 = w.begin; i0 < w.end; i0 += kTile) {
    const int i = i0 + threadIdx.x;
    if (i < w.end) {
      const int xi = x[i], yi = y[i];
      s_x0[threadIdx.x] = xi;
      s_x1[threadIdx.x] = xi + bw[i];
      s_y0[threadIdx.x] = yi;
      s_y1[threadIdx.x] = yi + bh[i];
      s_slot[threadIdx.x] = slot[i];
    }
    __syncthreads();
    const int n = min(kTile, w.end - i0);
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const int bs = s_slot[k];
      const int ox = max(px, s_x0[k]);
      const int oy = max(py, s_y0[k]);
      const bool ov = (ox < min(px1, s_x1[k])) & (oy < min(py1, s_y1[k])) &
                      (kLower ? bs < qs : bs != qs);
      const unsigned key =
          ((unsigned)(ox - px) * (unsigned)MB + (unsigned)(oy - py)) *
              (unsigned)stride + (unsigned)bs;
      best = min(best, ov ? key : kNoneKey);
    }
    __syncthreads();
  }
  if (j < A)
    out[j] = best == kNoneKey ? (1 << 30) : (int)(best % (unsigned)stride);
}

// the row tiles that hold a real row; each knows its segment
unsigned seg_blocks(int A) { return (unsigned)((A + kTile - 1) / kTile); }

}  // namespace

extern "C" int magent_rect_first_overlap_seg(
    const int* qx, const int* qy, const int* tbw, const int* tbh, const int* x,
    const int* y, const int* bw, const int* bh, const int* slot,
    const int* start, const bool* overflow, int A, int P, int stride,
    int max_body, int lower_only, int* out, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (lower_only)
    rect_first_overlap_seg_kernel<true>
        <<<seg_blocks(A), kTile, 0, (cudaStream_t)stream>>>(
            qx, qy, tbw, tbh, x, y, bw, bh, slot, start, overflow, A, P,
            stride, max_body, out);
  else
    rect_first_overlap_seg_kernel<false>
        <<<seg_blocks(A), kTile, 0, (cudaStream_t)stream>>>(
            qx, qy, tbw, tbh, x, y, bw, bh, slot, start, overflow, A, P,
            stride, max_body, out);
  return (int)cudaGetLastError();
}
