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
//   occupant_rect_seg, rank_prefix_seg
//                       occupant_rect and rank_prefix of one big world
//                       sorted by y, each query against its segment's
//                       window of rows (see "y-segmented sweeps" below)
//
// Replaces magent_tpu/ops/attack_prefix.py occupant_tpu, rank_prefix_tpu
// (both forms), move_resolve_tpu, move_claims_tpu, occupant_rect_tpu and
// rect_first_overlap_tpu, which sweep (TI, TJ) tiles of the pair matrix on
// the TPU's vector unit, and the segmented cores _occupant_rect_core and
// _rank_prefix_core (with their overflow branches, occupant_rect_tpu with
// bslot and rank_prefix_tpu over every row).
//
// What bounds them here: integer compares and selects, ~1-12 per pair, over
// B * A^2 pairs (64M at battle's B=16, A=2000; 88M at pursuit's map-500
// single world, A=9375); the operands are a few tens of KB and stay in L2.
// Two designs:
// - move_resolve: one thread per query j, blockIdx.y = env; the block
//   stages a tile of kTile i-side operands in shared memory (every thread
//   then reads the same word: a broadcast, no bank conflicts) and the
//   threads sweep i in ascending order.  The ragged tail of both axes is
//   masked; no sentinel padding is needed.
// - every other sweep: the split template below ("rect sweeps"), 4
//   queries per thread, the partner axis cut over the warps of a
//   thread-block cluster: occupant, move_claims (lower triangle only),
//   rank_prefix, occupant_rect, rect_first_overlap and the two segmented
//   sweeps occupant_rect_seg and rank_prefix_seg.
// The caller's sentinels (queries 2^30, dead cells 2^29) pass through as
// ordinary values.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 128;  // threads per block == i-operands per staged tile

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

// ------------------------------------------------------------- rect sweeps
// Multi-cell bodies: rects [x, x+bw) x [y, y+bh); an empty rect (bw = 0 or
// bh = 0) contains no cell and overlaps nothing, not even another empty
// rect at the same coordinates.  Query pads (-2^20 with tbw = tbh = 0) keep
// every edge far from int32 overflow.
//
// occupant_rect: the largest slot whose rect contains query cell (qx, qy)
// and the matches' summed hp; kExcl skips the query's own slot.
// rect_first_overlap: per query rect [qx, qx+tbw) x [qy, qy+tbh), the min
// over gated bodies i of key = k * stride + i, where k indexes the first
// overlapped cell in the (i outer, j inner) scan order:
// k = (max(qx, x) - qx) * MB + (max(qy, y) - qy) < MB^2, so the key stays
// below 2^30 + A <= 2^31 - 1; kLower gates bodies to i < j (claims), else
// i != j (blocking).
//
// What bounds them: 5 and 8 integer instructions per pair (rank_prefix:
// 2) over B * A^2 pairs (88M at pursuit's map-500 world, A = 9375, B = 1).
// One query per thread in blocks of 128 would leave 74 blocks for 132 SMs
// there, load 3-5 scalar shared words per pair, and under kLower give the
// last block twice the mean sweep.  Design (the split template, shared by
// occupant_rect, rect_first_overlap, rank_prefix, and the one-cell sweeps
// occupant and move_claims below):
// - query tiles of kRectTile = 32 * kQ slots: each lane holds kQ queries
//   (slots lane, lane + 32, ...) in registers, so a staged partner costs
//   one 128-bit broadcast load (rect edges, or rank_prefix's record (tgt,
//   rank, dmg bits)) and feeds kQ independent accumulator chains;
// - the tile's partner axis is cut into n = cluster * warps contiguous
//   ranges of equal slots (rect_range): warp w of the CTA of rank r in a
//   thread-block cluster sweeps range r * warps + w in ascending slot
//   order, staging 32 partners at a time in its own shared-memory slots
//   (no block barrier).  Every warp holds all of its tile's queries, so a
//   partner costs the same whether its pairs pass the gate or not: equal
//   slots, not equal pairs, balance the warps.  Under kLower a tile's
//   bodies end below its last slot, and the heaviest tiles launch first;
// - each CTA folds its warps' partials in range order, and the cluster's
//   rank-0 CTA folds the CTAs' in rank order through distributed shared
//   memory: one launch, no atomics, no scratch in device memory, a
//   deterministic result for a given split (rank_prefix's f32 sums are
//   taken in slot order within a range, then range by range);
// - the gate compare runs only on the bodies of the tile's own slots
//   [t0, t1): every other body passes it (i != j; i < j below t0, and a
//   kLower range ends below t1).  rank_prefix has no gate: its rank
//   compare depends on the data.
// The grid is (n_tiles * cluster, B) with clusters of (cluster, 1, 1); the
// host picks cluster and warps (ops/attack_prefix.py rect_split, from the
// SM count), and the CPU tests hold rect_range's Python twin (rect_bounds)
// to cover every gated pair once.

constexpr int kQ = 4;                 // queries per thread
constexpr int kRectTile = 32 * kQ;    // queries per tile
constexpr int kRectMaxWarps = 8;      // warps (body ranges) per CTA
constexpr int kRectMaxCluster = 8;    // CTAs per cluster (the portable size)
constexpr int kFar = 1 << 30;         // an edge past every real coordinate

// This warp's view of its tile: the tile's query slots [t0, t1) and the
// warp's body range [lo, hi), range s of n of [0, end) with end = A, or
// t1 - 1 under lower (no body at or above it has a pair i < j of the
// tile).  32-bit: the host checks A <= 2^24, and n <= 64.
struct RectRange {
  int t0, t1, lo, hi;
};

__device__ __forceinline__ RectRange rect_range(int A, int cluster,
                                                unsigned rank, bool lower) {
  const int n_tiles = (A + kRectTile - 1) / kRectTile;
  const int tile = (int)blockIdx.x / cluster;
  const int t = lower ? n_tiles - 1 - tile : tile;
  const unsigned n = cluster * (blockDim.x >> 5);
  const unsigned s = rank * (blockDim.x >> 5) + (threadIdx.x >> 5);
  RectRange r;
  r.t0 = t * kRectTile;
  r.t1 = min(A, r.t0 + kRectTile);
  const unsigned end = lower ? r.t1 - 1 : A;
  r.lo = (int)(s * end / n);
  r.hi = (int)((s + 1) * end / n);
  return r;
}

// Sweep bodies [lo, hi) in ascending slot order, 32 at a time through the
// warp's staging slots, the next 32 bodies' loads in flight while the
// current ones are tested; kGate: bodies of the tile's own slots.
template <bool kGate, class Sweep>
__device__ __forceinline__ void rect_sweep_range(Sweep& sw, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  typename Sweep::Body body;
  if (lo + lane < hi) body = sw.load(lo + lane);
  for (int base = lo; base < hi; base += 32) {
    if (base + lane < hi) sw.stage(lane, body, base + lane);
    __syncwarp();
    if (base + 32 + lane < hi) body = sw.load(base + 32 + lane);
    const int n = min(32, hi - base);
#pragma unroll 4
    for (int k = 0; k < n; ++k) sw.template test<kGate>(k, base + k);
    __syncwarp();
  }
}

template <class Sweep>
__device__ __forceinline__ void rect_sweep(Sweep& sw, const RectRange& r) {
  rect_sweep_range<false>(sw, r.lo, min(r.hi, r.t0));
  rect_sweep_range<true>(sw, max(r.lo, r.t0), min(r.hi, r.t1));
  rect_sweep_range<false>(sw, max(r.lo, r.t1), r.hi);
}

// Fold the warps' partials of the tile's nq queries in range order, then,
// in a cluster of several CTAs, the CTAs' in rank order through
// distributed shared memory (the rank-0 CTA reads every rank's fold; the
// others keep their shared memory until it is read); store(c, v) writes
// query c's result.
template <class P, class Store>
__device__ __forceinline__ void rect_combine(P (&part)[kRectMaxWarps][kRectTile],
                                             P (&cta)[kRectTile], int nq,
                                             int cluster, Store store) {
  const int warps = blockDim.x >> 5;
  __syncthreads();
  for (int c = threadIdx.x; c < nq; c += blockDim.x) {
    P v = part[0][c];
    for (int w = 1; w < warps; ++w) v = P::fold(v, part[w][c]);
    if (cluster == 1)
      store(c, v);
    else
      cta[c] = v;
  }
  if (cluster == 1) return;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  if (cl.block_rank() == 0) {
    for (int c = threadIdx.x; c < nq; c += blockDim.x) {
      P got[kRectMaxCluster];
#pragma unroll
      for (int r = 0; r < kRectMaxCluster; ++r)
        if (r < cluster) got[r] = *cl.map_shared_rank(&cta[c], r);
      P v = got[0];
#pragma unroll
      for (int r = 1; r < kRectMaxCluster; ++r)
        if (r < cluster) v = P::fold(v, got[r]);
      store(c, v);
    }
  }
  cl.sync();
}

// A range's partial of one occupant_rect query: slots ascend within a
// range, so its last match is its max; bodies are disjoint, so at most one
// slot matches a query and the hp summed in range order (adding zeros is
// exact) equals the plain version's bit for bit.  occupant_rect_seg keeps
// the max slot id itself; its hp sums equal the plain version's wherever a
// query matches at most two bodies (a + b = b + a), which holds for every
// query of the engine (its bodies never overlap).
struct OccupantPart {
  int best;
  float sum;
  __device__ static OccupantPart fold(OccupantPart a, OccupantPart b) {
    return {max(a.best, b.best), a.sum + b.sum};
  }
};

template <bool kExcl>
struct OccupantRectSweep {
  struct Body {
    int x, y, w, h;
    float hp;
  };

  const int *x, *y, *bw, *bh;
  const float* hp;
  int4* s_edge;  // the warp's 32 staging slots
  float* s_hp;
  int px[kQ], py[kQ], j[kQ], best[kQ];
  float hsum[kQ];

  __device__ __forceinline__ Body load(int i) const {
    return {x[i], y[i], bw[i], bh[i], hp[i]};
  }

  __device__ __forceinline__ void stage(int lane, const Body& b, int) {
    s_edge[lane] = make_int4(b.x, b.x + b.w, b.y, b.y + b.h);
    s_hp[lane] = b.hp;
  }

  template <bool kGate>
  __device__ __forceinline__ void test(int k, int i) {
    const int4 e = s_edge[k];
    const float h = s_hp[k];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      bool m = (e.x <= px[q]) & (px[q] < e.y) & (e.z <= py[q]) & (py[q] < e.w);
      if (kGate && kExcl) m &= i != j[q];
      best[q] = m ? i : best[q];
      hsum[q] += m ? h : 0.f;
    }
  }
};

template <bool kExcl>
__global__ void __launch_bounds__(32 * kRectMaxWarps)
occupant_rect_kernel(const int* __restrict__ qx, const int* __restrict__ qy,
                     const int* __restrict__ x, const int* __restrict__ y,
                     const int* __restrict__ bw, const int* __restrict__ bh,
                     const float* __restrict__ hp, int A, int cluster,
                     int* __restrict__ tgt, float* __restrict__ hpt) {
  __shared__ int4 s_edge[kRectMaxWarps][32];
  __shared__ float s_hp[kRectMaxWarps][32];
  __shared__ OccupantPart s_part[kRectMaxWarps][kRectTile];
  __shared__ OccupantPart s_cta[kRectTile];
  const RectRange r =
      rect_range(A, cluster, cg::this_cluster().block_rank(), false);
  const size_t row = (size_t)blockIdx.y * A;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  OccupantRectSweep<kExcl> sw;
  sw.x = x + row, sw.y = y + row, sw.bw = bw + row, sw.bh = bh + row;
  sw.hp = hp + row, sw.s_edge = s_edge[warp], sw.s_hp = s_hp[warp];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int j = r.t0 + lane + 32 * q;
    sw.j[q] = j;
    sw.px[q] = j < A ? qx[row + j] : 0;
    sw.py[q] = j < A ? qy[row + j] : 0;
    sw.best[q] = -1;
    sw.hsum[q] = 0.f;
  }
  rect_sweep(sw, r);
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    s_part[warp][lane + 32 * q] = {sw.best[q], sw.hsum[q]};
  rect_combine(s_part, s_cta, r.t1 - r.t0, cluster,
               [&](int c, const OccupantPart& v) {
                 tgt[row + r.t0 + c] = v.best;
                 hpt[row + r.t0 + c] = v.sum;
               });
}

// A range's partial of one rect_first_overlap query: the min key.
struct OverlapPart {
  unsigned key;
  __device__ static OverlapPart fold(OverlapPart a, OverlapPart b) {
    return {min(a.key, b.key)};
  }
};

// The key is formed from per-body terms staged once: with X = x * MB *
// stride and Y = y * stride + i (mod 2^32), a pair's key is
// max(X - qx * MB * stride, 0) + max(Y - qy * stride, i); for an
// overlapping pair |x - qx| and |y - qy| are below MB, so both differences
// are exact in int32.  A non-overlapping pair's terms may wrap, and the
// select discards them.  An empty body's left edge and an empty query's
// right edge are set past every coordinate, so four compares decide the
// overlap of two rects.
template <bool kLower>
struct RectOverlapSweep {
  struct Body {
    int x, y, w, h;
  };

  const int *x, *y, *bw, *bh;
  int4* s_edge;  // the warp's 32 staging slots
  int2* s_key;
  unsigned xs, ys;  // MB * stride, stride
  int px[kQ], py[kQ], px1[kQ], py1[kQ], j[kQ];
  unsigned pxs[kQ], pys[kQ], best[kQ];

  __device__ __forceinline__ Body load(int i) const {
    return {x[i], y[i], bw[i], bh[i]};
  }

  __device__ __forceinline__ void stage(int lane, const Body& b, int i) {
    const int x1 = b.x + b.w, y1 = b.y + b.h;
    s_edge[lane] =
        make_int4((x1 <= b.x) | (y1 <= b.y) ? kFar : b.x, x1, b.y, y1);
    s_key[lane] = make_int2((int)((unsigned)b.x * xs),
                            (int)((unsigned)b.y * ys + (unsigned)i));
  }

  template <bool kGate>
  __device__ __forceinline__ void test(int k, int i) {
    const int4 e = s_edge[k];
    const int2 c = s_key[k];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      bool ov = (e.x < px1[q]) & (px[q] < e.y) & (e.z < py1[q]) & (py[q] < e.w);
      if (kGate) ov &= kLower ? i < j[q] : i != j[q];
      const int dx = (int)((unsigned)c.x - pxs[q]);
      const int dy = (int)((unsigned)c.y - pys[q]);
      const unsigned key = (unsigned)max(dx, 0) + (unsigned)max(dy, i);
      best[q] = ov ? min(best[q], key) : best[q];
    }
  }
};

template <bool kLower>
__global__ void __launch_bounds__(32 * kRectMaxWarps)
rect_first_overlap_kernel(const int* __restrict__ qx,
                          const int* __restrict__ qy,
                          const int* __restrict__ tbw,
                          const int* __restrict__ tbh,
                          const int* __restrict__ x, const int* __restrict__ y,
                          const int* __restrict__ bw,
                          const int* __restrict__ bh, int A, int stride,
                          int MB, int cluster, int* __restrict__ out) {
  constexpr unsigned kNoneKey = 0x7fffffffu;
  __shared__ int4 s_edge[kRectMaxWarps][32];
  __shared__ int2 s_key[kRectMaxWarps][32];
  __shared__ OverlapPart s_part[kRectMaxWarps][kRectTile];
  __shared__ OverlapPart s_cta[kRectTile];
  const RectRange r =
      rect_range(A, cluster, cg::this_cluster().block_rank(), kLower);
  const size_t row = (size_t)blockIdx.y * A;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  RectOverlapSweep<kLower> sw;
  sw.x = x + row, sw.y = y + row, sw.bw = bw + row, sw.bh = bh + row;
  sw.s_edge = s_edge[warp], sw.s_key = s_key[warp];
  sw.xs = (unsigned)MB * (unsigned)stride, sw.ys = (unsigned)stride;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int j = r.t0 + lane + 32 * q;
    const int px = j < A ? qx[row + j] : 0, py = j < A ? qy[row + j] : 0;
    const int w = j < A ? tbw[row + j] : 0, h = j < A ? tbh[row + j] : 0;
    sw.j[q] = j;
    sw.px[q] = px;
    sw.py[q] = py;
    sw.px1[q] = (w <= 0) | (h <= 0) ? -kFar : px + w;
    sw.py1[q] = py + h;
    sw.pxs[q] = (unsigned)px * sw.xs;
    sw.pys[q] = (unsigned)py * sw.ys;
    sw.best[q] = kNoneKey;
  }
  rect_sweep(sw, r);
#pragma unroll
  for (int q = 0; q < kQ; ++q) s_part[warp][lane + 32 * q] = {sw.best[q]};
  rect_combine(s_part, s_cta, r.t1 - r.t0, cluster,
               [&](int c, const OverlapPart& v) {
                 out[row + r.t0 + c] =
                     v.key == kNoneKey ? (1 << 30)
                                       : (int)(v.key % (unsigned)stride);
               });
}

// A range's partial of one rank_prefix query: its damage summed in slot
// order.
struct RankPart {
  float p;
  __device__ static RankPart fold(RankPart a, RankPart b) {
    return {a.p + b.p};
  }
};

// P_j = sum_i [tgt_i == tgt_j and rank_i < rank_j] * dmg_i: a partner is
// staged as one int4 (tgt, rank, dmg bits, 0); two compares and a
// predicated add per pair.  Non-attackers' sentinel tgt = A matches other
// sentinels, as in the plain version.
struct RankPrefixSweep {
  struct Body {
    int t, r;
    float d;
  };

  const int *tgt, *rank;
  const float* dmg;
  int4* s_rec;  // the warp's 32 staging slots
  int t[kQ], r[kQ];
  float p[kQ];

  __device__ __forceinline__ Body load(int i) const {
    return {tgt[i], rank[i], dmg[i]};
  }

  __device__ __forceinline__ void stage(int lane, const Body& b, int) {
    s_rec[lane] = make_int4(b.t, b.r, __float_as_int(b.d), 0);
  }

  template <bool kGate>
  __device__ __forceinline__ void test(int k, int) {
    const int4 e = s_rec[k];
    const float d = __int_as_float(e.z);
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      if ((e.x == t[q]) & (e.y < r[q])) p[q] += d;
  }
};

// kHp: also write hp_t[j] = hp[tgt_j].  The TPU kernel sums a one-hot
// [i == tgt_j] * hp_i over the sweep; exactly one slot matches a real target
// and none matches the sentinel A, so one direct load per query gives the
// same value bit for bit (adding zeros is exact) without widening the pair
// loop.
template <bool kHp>
__global__ void __launch_bounds__(32 * kRectMaxWarps)
rank_prefix_kernel(const int* __restrict__ tgt, const int* __restrict__ rank,
                   const float* __restrict__ dmg,
                   const float* __restrict__ hp, int A, int cluster,
                   float* __restrict__ P, float* __restrict__ hpt) {
  __shared__ int4 s_rec[kRectMaxWarps][32];
  __shared__ RankPart s_part[kRectMaxWarps][kRectTile];
  __shared__ RankPart s_cta[kRectTile];
  const RectRange r =
      rect_range(A, cluster, cg::this_cluster().block_rank(), false);
  const size_t row = (size_t)blockIdx.y * A;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  RankPrefixSweep sw;
  sw.tgt = tgt + row, sw.rank = rank + row, sw.dmg = dmg + row;
  sw.s_rec = s_rec[warp];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int j = r.t0 + lane + 32 * q;
    sw.t[q] = j < A ? tgt[row + j] : 0;
    sw.r[q] = j < A ? rank[row + j] : 0;
    sw.p[q] = 0.f;
  }
  rect_sweep_range<false>(sw, r.lo, r.hi);
#pragma unroll
  for (int q = 0; q < kQ; ++q) s_part[warp][lane + 32 * q] = {sw.p[q]};
  rect_combine(s_part, s_cta, r.t1 - r.t0, cluster,
               [&](int c, const RankPart& v) {
                 const size_t j = row + r.t0 + c;
                 P[j] = v.p;
                 if (kHp) {
                   const int t = tgt[j];
                   hpt[j] = (0 <= t && t < A) ? hp[row + t] : 0.f;
                 }
               });
}

// ------------------------------------------------------- one-cell sweeps
// 1x1 bodies: a query matches a slot when their cells are equal.
//
// occupant: per query cell q_j, the slots i whose own cell equals it —
// their count, their slot ids summed and their hp summed (the plain
// version's sum over matches; the result is the slot sum, or -1 when
// none matched).  Live cells are unique and the sentinels differ (queries
// 2^30, dead cells 2^29), so in the engine a query matches at most one
// slot: the warp votes per partner and updates its queries only where one
// of its lanes matched, so a pair costs one compare.  The partial (count,
// slot sum, hp sum) folds by three adds in range order: the ints are
// exact in any order, the hp sum equals the plain version's bit for bit
// wherever a query matches at most two slots (a + b = b + a).
//
// move_claims: per slot j, cnt_j = #{i < j : t_i == t_j} and head_j = the
// lowest slot with t_i == t_j, which is j itself or lower, so both need
// only the pairs i < j: rect_range's lower form (the heaviest tiles first)
// with the i < j gate compared only on the tile's own slots, head starting
// at j; a compare, a predicated add and a predicated min per pair.
// Non-movers share one sentinel cell, so most rows match and a vote would
// not skip: none is taken.  The partial (cnt, head) folds by an add and a
// min: exact in every split.

// A range's partial of one occupant query.
struct CellOccupantPart {
  int cnt, ssum;
  float hsum;
  __device__ static CellOccupantPart fold(CellOccupantPart a,
                                          CellOccupantPart b) {
    return {a.cnt + b.cnt, a.ssum + b.ssum, a.hsum + b.hsum};
  }
};

// A partner is staged as one int2 (cell, hp bits).
struct OccupantSweep {
  struct Body {
    int cell;
    float hp;
  };

  const int* cell;
  const float* hp;
  int2* s_rec;  // the warp's 32 staging slots
  int q[kQ], cnt[kQ], ssum[kQ];
  float hsum[kQ];

  __device__ __forceinline__ Body load(int i) const {
    return {cell[i], hp[i]};
  }

  __device__ __forceinline__ void stage(int lane, const Body& b, int) {
    s_rec[lane] = make_int2(b.cell, __float_as_int(b.hp));
  }

  template <bool kGate>
  __device__ __forceinline__ void test(int k, int i) {
    const int2 e = s_rec[k];
    bool m[kQ];
    bool any = false;
#pragma unroll
    for (int c = 0; c < kQ; ++c) {
      m[c] = e.x == q[c];
      any |= m[c];
    }
    if (__any_sync(0xffffffffu, any)) {
      const float h = __int_as_float(e.y);
#pragma unroll
      for (int c = 0; c < kQ; ++c) {
        cnt[c] += m[c];
        ssum[c] += m[c] ? i : 0;
        hsum[c] += m[c] ? h : 0.f;
      }
    }
  }
};

__global__ void __launch_bounds__(32 * kRectMaxWarps)
occupant_kernel(const int* __restrict__ acell, const int* __restrict__ cell,
                const float* __restrict__ hp, int A, int cluster,
                int* __restrict__ tgt, float* __restrict__ hpt) {
  __shared__ int2 s_rec[kRectMaxWarps][32];
  __shared__ CellOccupantPart s_part[kRectMaxWarps][kRectTile];
  __shared__ CellOccupantPart s_cta[kRectTile];
  const RectRange r =
      rect_range(A, cluster, cg::this_cluster().block_rank(), false);
  const size_t row = (size_t)blockIdx.y * A;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  OccupantSweep sw;
  sw.cell = cell + row, sw.hp = hp + row, sw.s_rec = s_rec[warp];
#pragma unroll
  for (int c = 0; c < kQ; ++c) {
    const int j = r.t0 + lane + 32 * c;
    sw.q[c] = j < A ? acell[row + j] : kFar;  // a pad query: not written
    sw.cnt[c] = 0;
    sw.ssum[c] = 0;
    sw.hsum[c] = 0.f;
  }
  rect_sweep_range<false>(sw, r.lo, r.hi);
#pragma unroll
  for (int c = 0; c < kQ; ++c)
    s_part[warp][lane + 32 * c] = {sw.cnt[c], sw.ssum[c], sw.hsum[c]};
  rect_combine(s_part, s_cta, r.t1 - r.t0, cluster,
               [&](int c, const CellOccupantPart& v) {
                 tgt[row + r.t0 + c] = v.cnt > 0 ? v.ssum : -1;
                 hpt[row + r.t0 + c] = v.hsum;
               });
}

// A range's partial of one move_claims query.
struct ClaimPart {
  int cnt, head;
  __device__ static ClaimPart fold(ClaimPart a, ClaimPart b) {
    return {a.cnt + b.cnt, min(a.head, b.head)};
  }
};

// A partner is staged as its target cell.
struct MoveClaimsSweep {
  struct Body {
    int t;
  };

  const int* tcell;
  int* s_t;  // the warp's 32 staging slots
  int t[kQ], j[kQ], cnt[kQ], head[kQ];

  __device__ __forceinline__ Body load(int i) const { return {tcell[i]}; }

  __device__ __forceinline__ void stage(int lane, const Body& b, int) {
    s_t[lane] = b.t;
  }

  template <bool kGate>
  __device__ __forceinline__ void test(int k, int i) {
    const int e = s_t[k];
#pragma unroll
    for (int c = 0; c < kQ; ++c) {
      bool m = e == t[c];
      if (kGate) m &= i < j[c];
      cnt[c] += m;
      head[c] = m ? min(head[c], i) : head[c];
    }
  }
};

__global__ void __launch_bounds__(32 * kRectMaxWarps)
move_claims_kernel(const int* __restrict__ tcell, int A, int cluster,
                   int* __restrict__ cnt_out, int* __restrict__ head_out) {
  __shared__ int s_t[kRectMaxWarps][32];
  __shared__ ClaimPart s_part[kRectMaxWarps][kRectTile];
  __shared__ ClaimPart s_cta[kRectTile];
  const RectRange r =
      rect_range(A, cluster, cg::this_cluster().block_rank(), true);
  const size_t row = (size_t)blockIdx.y * A;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  MoveClaimsSweep sw;
  sw.tcell = tcell + row, sw.s_t = s_t[warp];
#pragma unroll
  for (int c = 0; c < kQ; ++c) {
    const int j = r.t0 + lane + 32 * c;
    sw.j[c] = j;
    sw.t[c] = j < A ? tcell[row + j] : 0;
    sw.cnt[c] = 0;
    sw.head[c] = j;  // the slot itself always matches
  }
  rect_sweep(sw, r);
#pragma unroll
  for (int c = 0; c < kQ; ++c)
    s_part[warp][lane + 32 * c] = {sw.cnt[c], sw.head[c]};
  rect_combine(s_part, s_cta, r.t1 - r.t0, cluster,
               [&](int c, const ClaimPart& v) {
                 cnt_out[row + r.t0 + c] = v.cnt;
                 head_out[row + r.t0 + c] = v.head;
               });
}

// ------------------------------------------------------ y-segmented sweeps
// One big world (16,384 to 65,536 slots) presents its [A] operands sorted
// by y.  Sorted row j belongs to segment j / kSegRows; the segment's
// partners are the sorted rows [start[s], min(A, start[s] + P)), which
// hold every row within the caller's y-margin of the segment; when the
// plan's overflow flag is set, every query sweeps [0, A) instead, so the
// result never depends on the plan.  Rows past A are the plain version's
// pad sentinels (empty rects, no target): never staged, never written.
//
// What bounds them: occupant_rect_seg 4 integer instructions per pair
// (four edge compares; a matching pair also takes a max of the slot id and
// an f32 add), rank_prefix_seg 2 and one f32 add, over A * P pairs
// (pursuit at map 1000: 37 segments x 1024 rows x 2560 or 3584 partners,
// 97.0 M or 135.8 M pairs).  Design: the split template above.  A 128-query tile
// lies in one segment (tile / kTilesPerSeg); seg_range cuts the tile's
// window into n = cluster * warps ranges of equal rows, read on the device
// from start and *overflow (no host sync, no [S, P] gather).  The window
// is y-sorted, not slot-sorted, so the occupant keeps the max slot id (a
// predicated max, not the last match), and OccupantPart's fold (max, then
// sum in range order) gives the plain version's results; rank_prefix_seg
// is positional (the rank keys carry the slot tie-break), so the sweep of
// rank_prefix serves it as it is.  The host picks cluster and warps
// (ops/attack_prefix.py seg_split), and the CPU tests hold seg_range's
// Python twin (seg_bounds) to cover every window row once per tile.
constexpr int kSegRows = 1024;  // SEG_ROWS of ops/attack_prefix.py
constexpr int kTilesPerSeg = kSegRows / kRectTile;

__device__ __forceinline__ RectRange seg_range(
    const int* __restrict__ start, const bool* __restrict__ overflow, int A,
    int P, int cluster, unsigned rank) {
  const int tile = (int)blockIdx.x / cluster;
  const unsigned n = cluster * (blockDim.x >> 5);
  const unsigned s = rank * (blockDim.x >> 5) + (threadIdx.x >> 5);
  RectRange r;
  r.t0 = tile * kRectTile;
  r.t1 = min(A, r.t0 + kRectTile);
  int begin = 0, end = A;
  if (!*overflow) {
    begin = start[tile / kTilesPerSeg];
    end = min(A, begin + P);
  }
  const unsigned len = end > begin ? (unsigned)(end - begin) : 0u;
  r.lo = begin + (int)(s * len / n);
  r.hi = begin + (int)((s + 1) * len / n);
  return r;
}

// occupant_rect over window rows carrying slot ids: a body is staged as its
// edges (one int4) and (slot id, hp bits) (one int2).
struct OccupantRectSegSweep {
  struct Body {
    int x, y, w, h, slot;
    float hp;
  };

  const int *x, *y, *bw, *bh, *slot;
  const float* hp;
  int4* s_edge;  // the warp's 32 staging slots
  int2* s_id;
  int px[kQ], py[kQ], best[kQ];
  float hsum[kQ];

  __device__ __forceinline__ Body load(int i) const {
    return {x[i], y[i], bw[i], bh[i], slot[i], hp[i]};
  }

  __device__ __forceinline__ void stage(int lane, const Body& b, int) {
    s_edge[lane] = make_int4(b.x, b.x + b.w, b.y, b.y + b.h);
    s_id[lane] = make_int2(b.slot, __float_as_int(b.hp));
  }

  // A query cell lies in few bodies of its window (in the engine's steps,
  // one at most), so the warp updates its queries only where one of its
  // lanes matched: the other pairs cost the four edge compares alone.
  template <bool kGate>
  __device__ __forceinline__ void test(int k, int) {
    const int4 e = s_edge[k];
    bool m[kQ];
    bool any = false;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      m[q] = (e.x <= px[q]) & (px[q] < e.y) & (e.z <= py[q]) & (py[q] < e.w);
      any |= m[q];
    }
    if (__any_sync(0xffffffffu, any)) {
      const int2 id = s_id[k];
      const float h = __int_as_float(id.y);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        best[q] = m[q] ? max(best[q], id.x) : best[q];
        hsum[q] += m[q] ? h : 0.f;
      }
    }
  }
};

__global__ void __launch_bounds__(32 * kRectMaxWarps)
occupant_rect_seg_kernel(const int* __restrict__ qx,
                         const int* __restrict__ qy,
                         const int* __restrict__ x, const int* __restrict__ y,
                         const int* __restrict__ bw, const int* __restrict__ bh,
                         const float* __restrict__ hp,
                         const int* __restrict__ slot,
                         const int* __restrict__ start,
                         const bool* __restrict__ overflow, int A, int P,
                         int cluster, int* __restrict__ tgt,
                         float* __restrict__ hpt) {
  __shared__ int4 s_edge[kRectMaxWarps][32];
  __shared__ int2 s_id[kRectMaxWarps][32];
  __shared__ OccupantPart s_part[kRectMaxWarps][kRectTile];
  __shared__ OccupantPart s_cta[kRectTile];
  const RectRange r = seg_range(start, overflow, A, P, cluster,
                                cg::this_cluster().block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  OccupantRectSegSweep sw;
  sw.x = x, sw.y = y, sw.bw = bw, sw.bh = bh, sw.slot = slot, sw.hp = hp;
  sw.s_edge = s_edge[warp], sw.s_id = s_id[warp];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int j = r.t0 + lane + 32 * q;
    sw.px[q] = j < A ? qx[j] : 0;
    sw.py[q] = j < A ? qy[j] : 0;
    sw.best[q] = -1;
    sw.hsum[q] = 0.f;
  }
  rect_sweep_range<false>(sw, r.lo, r.hi);
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    s_part[warp][lane + 32 * q] = {sw.best[q], sw.hsum[q]};
  rect_combine(s_part, s_cta, r.t1 - r.t0, cluster,
               [&](int c, const OccupantPart& v) {
                 tgt[r.t0 + c] = v.best;
                 hpt[r.t0 + c] = v.sum;
               });
}

__global__ void __launch_bounds__(32 * kRectMaxWarps)
rank_prefix_seg_kernel(const int* __restrict__ tgt,
                       const int* __restrict__ rank,
                       const float* __restrict__ dmg,
                       const int* __restrict__ start,
                       const bool* __restrict__ overflow, int A, int P,
                       int cluster, float* __restrict__ out) {
  __shared__ int4 s_rec[kRectMaxWarps][32];
  __shared__ RankPart s_part[kRectMaxWarps][kRectTile];
  __shared__ RankPart s_cta[kRectTile];
  const RectRange r = seg_range(start, overflow, A, P, cluster,
                                cg::this_cluster().block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  RankPrefixSweep sw;
  sw.tgt = tgt, sw.rank = rank, sw.dmg = dmg, sw.s_rec = s_rec[warp];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int j = r.t0 + lane + 32 * q;
    sw.t[q] = j < A ? tgt[j] : 0;
    sw.r[q] = j < A ? rank[j] : 0;
    sw.p[q] = 0.f;
  }
  rect_sweep_range<false>(sw, r.lo, r.hi);
#pragma unroll
  for (int q = 0; q < kQ; ++q) s_part[warp][lane + 32 * q] = {sw.p[q]};
  rect_combine(s_part, s_cta, r.t1 - r.t0, cluster,
               [&](int c, const RankPart& v) { out[r.t0 + c] = v.p; });
}

// Launch a rect sweep on (n_tiles * cluster, B) blocks of 32 * warps
// threads, in clusters of (cluster, 1, 1) when cluster > 1 (a cluster
// launch costs ~1 us more on the H100 at pursuit's map 64); a refused
// launch returns its error.
template <class... KArgs, class... Args>
int launch_rect(void (*kernel)(KArgs...), int B, int A, int cluster,
                int warps, cudaStream_t stream, Args... args) {
  if (cluster < 1 || cluster > kRectMaxCluster || warps < 1 ||
      warps > kRectMaxWarps)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((A + kRectTile - 1) / kRectTile * cluster, B);
  if (cluster == 1) {
    kernel<<<grid, 32 * warps, 0, stream>>>(args...);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

dim3 pair_grid(int B, int A) { return dim3((A + kTile - 1) / kTile, B); }

}  // namespace

extern "C" int magent_occupant(const int* acell, const int* cell,
                               const float* hp, int B, int A, int cluster,
                               int warps, int* tgt, float* hpt, int device,
                               void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  return launch_rect(occupant_kernel, B, A, cluster, warps,
                     (cudaStream_t)stream, acell, cell, hp, A, cluster, tgt,
                     hpt);
}

extern "C" int magent_rank_prefix(const int* tgt, const int* rank,
                                  const float* dmg, int B, int A, int cluster,
                                  int warps, float* P, int device,
                                  void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  return launch_rect(rank_prefix_kernel<false>, B, A, cluster, warps,
                     (cudaStream_t)stream, tgt, rank, dmg,
                     (const float*)nullptr, A, cluster, P, (float*)nullptr);
}

extern "C" int magent_rank_prefix_hp(const int* tgt, const int* rank,
                                     const float* dmg, const float* hp, int B,
                                     int A, int cluster, int warps, float* P,
                                     float* hpt, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  return launch_rect(rank_prefix_kernel<true>, B, A, cluster, warps,
                     (cudaStream_t)stream, tgt, rank, dmg, hp, A, cluster, P,
                     hpt);
}

extern "C" int magent_move_claims(const int* tcell, int B, int A, int cluster,
                                  int warps, int* cnt, int* head, int device,
                                  void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  return launch_rect(move_claims_kernel, B, A, cluster, warps,
                     (cudaStream_t)stream, tcell, A, cluster, cnt, head);
}

extern "C" int magent_occupant_rect(const int* qx, const int* qy, const int* x,
                                    const int* y, const int* bw, const int* bh,
                                    const float* hp, int B, int A,
                                    int exclude_self, int cluster, int warps,
                                    int* tgt, float* hpt, int device,
                                    void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  return launch_rect(exclude_self ? occupant_rect_kernel<true>
                                  : occupant_rect_kernel<false>,
                     B, A, cluster, warps, (cudaStream_t)stream, qx, qy, x, y,
                     bw, bh, hp, A, cluster, tgt, hpt);
}

extern "C" int magent_rect_first_overlap(const int* qx, const int* qy,
                                         const int* tbw, const int* tbh,
                                         const int* x, const int* y,
                                         const int* bw, const int* bh, int B,
                                         int A, int stride, int max_body,
                                         int lower_only, int cluster,
                                         int warps, int* out, int device,
                                         void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  return launch_rect(lower_only ? rect_first_overlap_kernel<true>
                                : rect_first_overlap_kernel<false>,
                     B, A, cluster, warps, (cudaStream_t)stream, qx, qy, tbw,
                     tbh, x, y, bw, bh, A, stride, max_body, cluster, out);
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

extern "C" int magent_occupant_rect_seg(const int* qx, const int* qy,
                                        const int* x, const int* y,
                                        const int* bw, const int* bh,
                                        const float* hp, const int* slot,
                                        const int* start, const bool* overflow,
                                        int A, int P, int cluster, int warps,
                                        int* tgt, float* hpt, int device,
                                        void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  return launch_rect(occupant_rect_seg_kernel, 1, A, cluster, warps,
                     (cudaStream_t)stream, qx, qy, x, y, bw, bh, hp, slot,
                     start, overflow, A, P, cluster, tgt, hpt);
}

extern "C" int magent_rank_prefix_seg(const int* tgt, const int* rank,
                                      const float* dmg, const int* start,
                                      const bool* overflow, int A, int P,
                                      int cluster, int warps, float* out,
                                      int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  return launch_rect(rank_prefix_seg_kernel, 1, A, cluster, warps,
                     (cudaStream_t)stream, tgt, rank, dmg, start, overflow, A,
                     P, cluster, out);
}
