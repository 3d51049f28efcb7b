// Pairwise conflict-resolution kernels of the gridless engine step, for
// sm_90a, behind a plain C interface (loaded with ctypes by
// magent_tpu_torch/ops/_build.py).
//
// Each kernel answers, for every query slot j of every env b, a question
// over all slots i of the same env:
//
//   occupant      which slot's own cell equals query cell j (sum over
//                 matches, -1 if none), and that slot's hp
//   rank_prefix   P_j = sum_i [tgt_i == tgt_j and rank_i < rank_j] * dmg_i;
//                 the hp form also returns hp_t_j = hp[tgt_j] (0 for the
//                 no-target sentinel tgt_j = A)
//   move_resolve  lower-slot same-target count, lowest same-target slot,
//                 other slot standing on target cell j (sum over matches,
//                 -1 if none)
//   move_claims   the first two results of move_resolve alone (the grid
//                 path answers blocking from its occupancy grid)
//   occupant_rect       which body rect contains query cell j (multi-cell
//                       bodies; max slot, -1 if none), and its hp
//   rect_first_overlap  the first body, in the grid path's cell scan order,
//                       that query rect j overlaps (min of a packed key)
//
// Replaces magent_tpu/ops/attack_prefix.py occupant_tpu, rank_prefix_tpu
// (both forms), move_resolve_tpu, move_claims_tpu, occupant_rect_tpu and
// rect_first_overlap_tpu, which sweep (TI, TJ) tiles of the pair matrix on
// the TPU's vector unit.
//
// What bounds them here: integer compares and selects, ~4-12 per pair, over
// B * A^2 pairs (64M at battle's B=16, A=2000; 88M at pursuit's map-500
// single world, A=9375); the operands are a few tens of KB and stay in L2.  Design: one thread per query j, blockIdx.y = env;
// the block stages a tile of kTile i-side operands in shared memory (every
// thread then reads the same word: a broadcast, no bank conflicts) and the
// threads sweep i in ascending order, so float sums are taken in slot order
// and are deterministic.  The ragged tail of both axes is masked here; no
// sentinel padding is needed.  The caller's sentinels (queries 2^30, dead
// cells 2^29) pass through as ordinary values.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;  // threads per block == i-operands per staged tile

__global__ void occupant_kernel(const int* __restrict__ acell,
                                const int* __restrict__ cell,
                                const float* __restrict__ hp, int A,
                                int* __restrict__ tgt,
                                float* __restrict__ hpt) {
  __shared__ int s_cell[kTile];
  __shared__ float s_hp[kTile];
  const size_t row = (size_t)blockIdx.y * A;
  const int j = blockIdx.x * kTile + threadIdx.x;
  const int q = j < A ? acell[row + j] : 0;
  int cnt = 0, ssum = 0;
  float hsum = 0.f;
  for (int i0 = 0; i0 < A; i0 += kTile) {
    const int i = i0 + threadIdx.x;
    if (i < A) {
      s_cell[threadIdx.x] = cell[row + i];
      s_hp[threadIdx.x] = hp[row + i];
    }
    __syncthreads();
    const int n = min(kTile, A - i0);
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const bool m = s_cell[k] == q;
      cnt += m;
      ssum += m ? i0 + k : 0;
      hsum += m ? s_hp[k] : 0.f;
    }
    __syncthreads();
  }
  if (j < A) {
    tgt[row + j] = cnt > 0 ? ssum : -1;
    hpt[row + j] = hsum;
  }
}

// kHp: also write hp_t[j] = hp[tgt_j].  The TPU kernel sums a one-hot
// [i == tgt_j] * hp_i over the sweep; exactly one slot matches a real target
// and none matches the sentinel A, so one direct load gives the same value
// bit for bit (adding zeros is exact) without widening the pair loop.
template <bool kHp>
__global__ void rank_prefix_kernel(const int* __restrict__ tgt,
                                   const int* __restrict__ rank,
                                   const float* __restrict__ dmg,
                                   const float* __restrict__ hp, int A,
                                   float* __restrict__ P,
                                   float* __restrict__ hpt) {
  __shared__ int s_tgt[kTile];
  __shared__ int s_rank[kTile];
  __shared__ float s_dmg[kTile];
  const size_t row = (size_t)blockIdx.y * A;
  const int j = blockIdx.x * kTile + threadIdx.x;
  const int t = j < A ? tgt[row + j] : 0;
  const int r = j < A ? rank[row + j] : 0;
  if (kHp && j < A) hpt[row + j] = (0 <= t && t < A) ? hp[row + t] : 0.f;
  float p = 0.f;
  for (int i0 = 0; i0 < A; i0 += kTile) {
    const int i = i0 + threadIdx.x;
    if (i < A) {
      s_tgt[threadIdx.x] = tgt[row + i];
      s_rank[threadIdx.x] = rank[row + i];
      s_dmg[threadIdx.x] = dmg[row + i];
    }
    __syncthreads();
    const int n = min(kTile, A - i0);
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const bool m = (s_tgt[k] == t) & (s_rank[k] < r);
      p += m ? s_dmg[k] : 0.f;
    }
    __syncthreads();
  }
  if (j < A) P[row + j] = p;
}

__global__ void move_resolve_kernel(const int* __restrict__ tcell,
                                    const int* __restrict__ cell, int A,
                                    int* __restrict__ cnt_out,
                                    int* __restrict__ head_out,
                                    int* __restrict__ occ_out) {
  __shared__ int s_tcell[kTile];
  __shared__ int s_cell[kTile];
  const size_t row = (size_t)blockIdx.y * A;
  const int j = blockIdx.x * kTile + threadIdx.x;
  const int t = j < A ? tcell[row + j] : 0;
  int cnt = 0, head = A, ocnt = 0, osum = 0;
  for (int i0 = 0; i0 < A; i0 += kTile) {
    const int i = i0 + threadIdx.x;
    if (i < A) {
      s_tcell[threadIdx.x] = tcell[row + i];
      s_cell[threadIdx.x] = cell[row + i];
    }
    __syncthreads();
    const int n = min(kTile, A - i0);
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const int ii = i0 + k;
      const bool same = s_tcell[k] == t;
      cnt += same & (ii < j);
      head = min(head, same ? ii : A);
      const bool om = (s_cell[k] == t) & (ii != j);
      ocnt += om;
      osum += om ? ii : 0;
    }
    __syncthreads();
  }
  if (j < A) {
    cnt_out[row + j] = cnt;
    head_out[row + j] = head;
    occ_out[row + j] = ocnt > 0 ? osum : -1;
  }
}

// move_resolve's claim half: the slot itself always matches, so head <= j.
// Non-movers share one sentinel cell and count one another; the engine
// masks those rows, the kernel still answers them like the plain version.
__global__ void move_claims_kernel(const int* __restrict__ tcell, int A,
                                   int* __restrict__ cnt_out,
                                   int* __restrict__ head_out) {
  __shared__ int s_tcell[kTile];
  const size_t row = (size_t)blockIdx.y * A;
  const int j = blockIdx.x * kTile + threadIdx.x;
  const int t = j < A ? tcell[row + j] : 0;
  int cnt = 0, head = A;
  for (int i0 = 0; i0 < A; i0 += kTile) {
    const int i = i0 + threadIdx.x;
    if (i < A) s_tcell[threadIdx.x] = tcell[row + i];
    __syncthreads();
    const int n = min(kTile, A - i0);
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const int ii = i0 + k;
      const bool same = s_tcell[k] == t;
      cnt += same & (ii < j);
      head = min(head, same ? ii : A);
    }
    __syncthreads();
  }
  if (j < A) {
    cnt_out[row + j] = cnt;
    head_out[row + j] = head;
  }
}

// Multi-cell bodies: rects [x, x+bw) x [y, y+bh); an empty rect (bw = 0 or
// bh = 0) contains no cell and overlaps nothing, not even another empty
// rect at the same coordinates.  Query pads (-2^20 with tbw = tbh = 0) keep
// every edge far from int32 overflow.
//
// occupant_rect: the largest slot whose rect contains query cell (qx, qy)
// and the matches' summed hp.  Slots ascend, so the last match is the max;
// bodies are disjoint, so at most one slot matches and the sum equals the
// plain version's bit for bit.  kExcl skips the query's own slot.
template <bool kExcl>
__global__ void occupant_rect_kernel(const int* __restrict__ qx,
                                     const int* __restrict__ qy,
                                     const int* __restrict__ x,
                                     const int* __restrict__ y,
                                     const int* __restrict__ bw,
                                     const int* __restrict__ bh,
                                     const float* __restrict__ hp, int A,
                                     int* __restrict__ tgt,
                                     float* __restrict__ hpt) {
  __shared__ int s_x0[kTile], s_x1[kTile], s_y0[kTile], s_y1[kTile];
  __shared__ float s_hp[kTile];
  const size_t row = (size_t)blockIdx.y * A;
  const int j = blockIdx.x * kTile + threadIdx.x;
  const int px = j < A ? qx[row + j] : 0;
  const int py = j < A ? qy[row + j] : 0;
  int best = -1;
  float hsum = 0.f;
  for (int i0 = 0; i0 < A; i0 += kTile) {
    const int i = i0 + threadIdx.x;
    if (i < A) {
      const int xi = x[row + i], yi = y[row + i];
      s_x0[threadIdx.x] = xi;
      s_x1[threadIdx.x] = xi + bw[row + i];
      s_y0[threadIdx.x] = yi;
      s_y1[threadIdx.x] = yi + bh[row + i];
      s_hp[threadIdx.x] = hp[row + i];
    }
    __syncthreads();
    const int n = min(kTile, A - i0);
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const int ii = i0 + k;
      const bool m = (px >= s_x0[k]) & (px < s_x1[k]) & (py >= s_y0[k]) &
                     (py < s_y1[k]) & (!kExcl | (ii != j));
      best = m ? ii : best;
      hsum += m ? s_hp[k] : 0.f;
    }
    __syncthreads();
  }
  if (j < A) {
    tgt[row + j] = best;
    hpt[row + j] = hsum;
  }
}

// rect_first_overlap: per query rect [qx, qx+tbw) x [qy, qy+tbh), the min
// over gated bodies i of key = k * stride + i, where k indexes the first
// overlapped cell in the (i outer, j inner) scan order:
// k = (max(qx, x) - qx) * MB + (max(qy, y) - qy) < MB^2, so the key stays
// below 2^30 + A <= 2^31 - 1.  The key is formed in unsigned arithmetic:
// for a non-overlapping pair it may wrap, and the select discards it.
// kLower gates bodies to i < j (claims), else i != j (blocking); under
// kLower a block stops its sweep at its largest query slot.
template <bool kLower>
__global__ void rect_first_overlap_kernel(
    const int* __restrict__ qx, const int* __restrict__ qy,
    const int* __restrict__ tbw, const int* __restrict__ tbh,
    const int* __restrict__ x, const int* __restrict__ y,
    const int* __restrict__ bw, const int* __restrict__ bh, int A,
    int stride, int MB, int* __restrict__ out) {
  constexpr unsigned kNoneKey = 0x7fffffffu;
  __shared__ int s_x0[kTile], s_x1[kTile], s_y0[kTile], s_y1[kTile];
  const size_t row = (size_t)blockIdx.y * A;
  const int j = blockIdx.x * kTile + threadIdx.x;
  const int px = j < A ? qx[row + j] : 0;
  const int py = j < A ? qy[row + j] : 0;
  const int px1 = j < A ? px + tbw[row + j] : 0;
  const int py1 = j < A ? py + tbh[row + j] : 0;
  const int i_end = kLower ? min(A, ((int)blockIdx.x + 1) * kTile) : A;
  unsigned best = kNoneKey;
  for (int i0 = 0; i0 < i_end; i0 += kTile) {
    const int i = i0 + threadIdx.x;
    if (i < A) {
      const int xi = x[row + i], yi = y[row + i];
      s_x0[threadIdx.x] = xi;
      s_x1[threadIdx.x] = xi + bw[row + i];
      s_y0[threadIdx.x] = yi;
      s_y1[threadIdx.x] = yi + bh[row + i];
    }
    __syncthreads();
    const int n = min(kTile, i_end - i0);
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const int ii = i0 + k;
      const int ox = max(px, s_x0[k]);
      const int oy = max(py, s_y0[k]);
      const bool ov = (ox < min(px1, s_x1[k])) & (oy < min(py1, s_y1[k])) &
                      (kLower ? ii < j : ii != j);
      const unsigned key =
          ((unsigned)(ox - px) * (unsigned)MB + (unsigned)(oy - py)) *
              (unsigned)stride + (unsigned)ii;
      best = min(best, ov ? key : kNoneKey);
    }
    __syncthreads();
  }
  if (j < A)
    out[row + j] = best == kNoneKey ? (1 << 30) : (int)(best % (unsigned)stride);
}

dim3 pair_grid(int B, int A) { return dim3((A + kTile - 1) / kTile, B); }

}  // namespace

extern "C" int magent_occupant(const int* acell, const int* cell,
                               const float* hp, int B, int A, int* tgt,
                               float* hpt, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  occupant_kernel<<<pair_grid(B, A), kTile, 0, (cudaStream_t)stream>>>(
      acell, cell, hp, A, tgt, hpt);
  return (int)cudaGetLastError();
}

extern "C" int magent_rank_prefix(const int* tgt, const int* rank,
                                  const float* dmg, int B, int A, float* P,
                                  int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  rank_prefix_kernel<false>
      <<<pair_grid(B, A), kTile, 0, (cudaStream_t)stream>>>(
          tgt, rank, dmg, nullptr, A, P, nullptr);
  return (int)cudaGetLastError();
}

extern "C" int magent_rank_prefix_hp(const int* tgt, const int* rank,
                                     const float* dmg, const float* hp, int B,
                                     int A, float* P, float* hpt, int device,
                                     void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  rank_prefix_kernel<true>
      <<<pair_grid(B, A), kTile, 0, (cudaStream_t)stream>>>(
          tgt, rank, dmg, hp, A, P, hpt);
  return (int)cudaGetLastError();
}

extern "C" int magent_move_claims(const int* tcell, int B, int A, int* cnt,
                                  int* head, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  move_claims_kernel<<<pair_grid(B, A), kTile, 0, (cudaStream_t)stream>>>(
      tcell, A, cnt, head);
  return (int)cudaGetLastError();
}

extern "C" int magent_occupant_rect(const int* qx, const int* qy, const int* x,
                                    const int* y, const int* bw, const int* bh,
                                    const float* hp, int B, int A,
                                    int exclude_self, int* tgt, float* hpt,
                                    int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (exclude_self)
    occupant_rect_kernel<true>
        <<<pair_grid(B, A), kTile, 0, (cudaStream_t)stream>>>(
            qx, qy, x, y, bw, bh, hp, A, tgt, hpt);
  else
    occupant_rect_kernel<false>
        <<<pair_grid(B, A), kTile, 0, (cudaStream_t)stream>>>(
            qx, qy, x, y, bw, bh, hp, A, tgt, hpt);
  return (int)cudaGetLastError();
}

extern "C" int magent_rect_first_overlap(const int* qx, const int* qy,
                                         const int* tbw, const int* tbh,
                                         const int* x, const int* y,
                                         const int* bw, const int* bh, int B,
                                         int A, int stride, int max_body,
                                         int lower_only, int* out, int device,
                                         void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (lower_only)
    rect_first_overlap_kernel<true>
        <<<pair_grid(B, A), kTile, 0, (cudaStream_t)stream>>>(
            qx, qy, tbw, tbh, x, y, bw, bh, A, stride, max_body, out);
  else
    rect_first_overlap_kernel<false>
        <<<pair_grid(B, A), kTile, 0, (cudaStream_t)stream>>>(
            qx, qy, tbw, tbh, x, y, bw, bh, A, stride, max_body, out);
  return (int)cudaGetLastError();
}

extern "C" int magent_move_resolve(const int* tcell, const int* cell, int B,
                                   int A, int* cnt, int* head, int* occ,
                                   int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  move_resolve_kernel<<<pair_grid(B, A), kTile, 0, (cudaStream_t)stream>>>(
      tcell, cell, A, cnt, head, occ);
  return (int)cudaGetLastError();
}
