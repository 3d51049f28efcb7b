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
//
// Replaces magent_tpu/ops/attack_prefix.py occupant_tpu, rank_prefix_tpu
// (both forms), move_resolve_tpu and move_claims_tpu, which sweep (TI, TJ)
// tiles of the pair matrix on the TPU's vector unit.
//
// What bounds them here: integer compares and selects, ~4-7 per pair, over
// B * A^2 pairs (64M at battle's B=16, A=2000); the operands are a few tens
// of KB and stay in L2.  Design: one thread per query j, blockIdx.y = env;
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

extern "C" int magent_move_resolve(const int* tcell, const int* cell, int B,
                                   int A, int* cnt, int* head, int* occ,
                                   int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  move_resolve_kernel<<<pair_grid(B, A), kTile, 0, (cudaStream_t)stream>>>(
      tcell, cell, A, cnt, head, occ);
  return (int)cudaGetLastError();
}
