// The window-gather cost ladder for sm_90a, behind a plain C interface
// (loaded with ctypes by magent_tpu_torch/ops/_build.py).  Measurement
// only: no path of the simulator calls it.
//
// Replaces scripts/profile_window.py ladder and shared_tile, the TPU's
// stripped variants of its replica window kernel.  Here each level adds one
// component of the cost of the port's own production layout,
// window_gather4_kernel (csrc/window_gather.cu): one block per (chunk of
// kChunk agents, env), a warp per window row, coalesced row copies.
//
//   floor  the warp-per-row store loop, writing 1.0
//   smem   + the per-agent word/aux reads into shared memory and the unpack
//          (writes float(rep + y8 + l128 + rry + rrl))
//   load   + the row read at the replica-offset corner
//          img[b, y8 + 4 sel_r + r, l128 + 64 sel_l + c]
//   roll1  + the residual row offset ry' (an address add here, a sublane
//          roll on the TPU)
//   roll2  + the residual lane offset rl': the true window
//   mask   + the multiply by the mask in shared memory: equal to
//          window_gather4 without an epilogue, bit for bit
//
// with word = rep << 29 | y8 << 15 | l128, aux = rry << 17 | rrl << 10,
// rep = 2 sel_r + sel_l, ry' = (16 - rry) % 16, rl' = (128 - rrl) % 128
// (ops/window_ladder.py precompute).  Reads past the image give zeros, as
// the TPU's zero-padded replicas do.
//
// window_shared_tile_kernel: one tile load per chunk of `chunk` agents, the
// Hopper form of the TPU variant that loads one aligned (16, 128) tile per
// chunk.  Blocks are cut at chunk boundaries (ceil(chunk / kChunk) blocks
// per chunk, each of at most kChunk agents of one chunk), so a block stages
// exactly one tile, that of its chunk's first agent, in shared memory (8 KB)
// and its warps copy every window row from there, shifted by the agent's own
// residuals, times the mask.
//
// What bounds them: bytes — the windows written (110.8 MB at the script's
// geometry, B=16, N=2048, 13x13x5) and, from load up, the image read
// (23.1 MB), which fits the 50 MB L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kChunk = 32;     // agents per block
constexpr int kRows = 16, kLanes = 128, kMinor = 64;  // the TPU's tile

enum Level { kFloor = 0, kSmem, kLoad, kRoll1, kRoll2, kMask };

struct Unpacked {
  int rep, y8, l128, rry, rrl;
};

// masked to the fields' widths: any int32 words give rows and lanes >= 0
__device__ __forceinline__ Unpacked unpack(int w, int x) {
  const unsigned uw = (unsigned)w, ux = (unsigned)x;
  return {(int)((uw >> 29) & 3u), (int)((uw >> 15) & 0x3FFFu),
          (int)(uw & 0x7FFFu), (int)((ux >> 17) & 0xFu),
          (int)((ux >> 10) & 0x7Fu)};
}

// one window row: dst[c] = row < Hp && lane0 + c < lanes ? src[c] : 0,
// times the mask row under kMul
template <bool kMul>
__device__ __forceinline__ void copy_row(const float* __restrict__ img_b,
                                         int row, int lane0, int Hp,
                                         int lanes, const float* m, int vwc,
                                         int lane, float* __restrict__ dst) {
  if (row >= Hp) {
    for (int c = lane; c < vwc; c += 32) dst[c] = 0.f;
    return;
  }
  const float* src = img_b + (size_t)row * lanes + lane0;
  const int n_in = min(vwc, lanes - lane0);
  for (int c = lane; c < vwc; c += 32) {
    float v = c < n_in ? src[c] : 0.f;
    if (kMul) v = __fmul_rn(v, m[c]);
    dst[c] = v;
  }
}

template <int L>
__global__ void window_ladder_kernel(const float* __restrict__ img,
                                     const int* __restrict__ word,
                                     const int* __restrict__ aux,
                                     const float* __restrict__ mask, int N,
                                     int Hp, int lanes, int vh, int vwc,
                                     float* __restrict__ out) {
  extern __shared__ float s_mask[];  // [vh * vwc], kMask only
  __shared__ int s_row[kChunk];
  __shared__ int s_lane[kChunk];
  __shared__ float s_val[kChunk];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kChunk;
  const int nc = min(kChunk, N - n0);
  if (L == kMask)
    for (int e = threadIdx.x; e < vh * vwc; e += blockDim.x) s_mask[e] = mask[e];
  if (L >= kSmem && threadIdx.x < nc) {
    const size_t a = (size_t)b * N + n0 + threadIdx.x;
    const Unpacked u = unpack(word[a], aux[a]);
    if (L == kSmem) {
      s_val[threadIdx.x] = (float)(u.rep + u.y8 + u.l128 + u.rry + u.rrl);
    } else {
      int row = u.y8 + 4 * (u.rep >> 1);
      int lane0 = u.l128 + kMinor * (u.rep & 1);
      if (L >= kRoll1) row += (kRows - u.rry) & (kRows - 1);
      if (L >= kRoll2) lane0 += (kLanes - u.rrl) & (kLanes - 1);
      s_row[threadIdx.x] = row;
      s_lane[threadIdx.x] = lane0;
    }
  }
  __syncthreads();

  const float* img_b = img + (size_t)b * Hp * lanes;
  float* out_b = out + ((size_t)b * N + n0) * vh * vwc;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int w = warp; w < nc * vh; w += n_warps) {  // w = agent * vh + row
    const int a = w / vh;
    const int r = w - a * vh;
    float* dst = out_b + (size_t)w * vwc;
    if (L == kFloor) {
      for (int c = lane; c < vwc; c += 32) dst[c] = 1.f;
    } else if (L == kSmem) {
      const float v = s_val[a];
      for (int c = lane; c < vwc; c += 32) dst[c] = v;
    } else {
      copy_row<L == kMask>(img_b, s_row[a] + r, s_lane[a], Hp, lanes,
                           s_mask + r * vwc, vwc, lane, dst);
    }
  }
}

__global__ void window_shared_tile_kernel(const float* __restrict__ img,
                                          const int* __restrict__ word,
                                          const int* __restrict__ aux,
                                          const float* __restrict__ mask,
                                          int N, int chunk, int per_chunk,
                                          int Hp, int lanes, int vh, int vwc,
                                          float* __restrict__ out) {
  extern __shared__ float s_mask[];  // [vh * vwc]
  __shared__ float s_tile[kRows * kLanes];
  __shared__ int s_dr[kChunk];
  __shared__ int s_dl[kChunk];
  const int b = blockIdx.y;
  const int first = blockIdx.x / per_chunk * chunk;
  const int n0 = first + blockIdx.x % per_chunk * kChunk;
  const int end = N - first < chunk ? N : first + chunk;
  const int nc = min(kChunk, end - n0);
  if (nc <= 0) return;  // past the last agent (a ragged last chunk)
  for (int e = threadIdx.x; e < vh * vwc; e += blockDim.x) s_mask[e] = mask[e];
  const size_t row_a = (size_t)b * N;
  const Unpacked u0 = unpack(word[row_a + first], aux[row_a + first]);
  const int row0 = u0.y8 + 4 * (u0.rep >> 1);
  const int lane0 = u0.l128 + kMinor * (u0.rep & 1);
  const float* img_b = img + (size_t)b * Hp * lanes;
  for (int e = threadIdx.x; e < kRows * kLanes; e += blockDim.x) {
    const int row = row0 + e / kLanes;
    const int col = lane0 + e % kLanes;
    s_tile[e] = row < Hp && col < lanes ? img_b[(size_t)row * lanes + col] : 0.f;
  }
  if (threadIdx.x < nc) {
    const Unpacked u = unpack(word[row_a + n0 + threadIdx.x],
                              aux[row_a + n0 + threadIdx.x]);
    s_dr[threadIdx.x] = (kRows - u.rry) & (kRows - 1);
    s_dl[threadIdx.x] = (kLanes - u.rrl) & (kLanes - 1);
  }
  __syncthreads();

  float* out_b = out + (row_a + n0) * vh * vwc;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int w = warp; w < nc * vh; w += n_warps) {  // w = agent * vh + row
    const int a = w / vh;
    const int r = w - a * vh;
    const float* src = s_tile + (r + s_dr[a]) * kLanes + s_dl[a];
    const float* m = s_mask + r * vwc;
    float* dst = out_b + (size_t)w * vwc;
    for (int c = lane; c < vwc; c += 32) dst[c] = __fmul_rn(src[c], m[c]);
  }
}

// a window fits its tile after the largest residual shifts (3 rows, 63
// lanes): ops/window_ladder.py MAX_VH, MAX_VWC
bool fits_tile(int vh, int vwc) {
  return vh > 0 && vh <= kRows - 3 && vwc > 0 && vwc <= kLanes - (kMinor - 1);
}

}  // namespace

extern "C" int magent_window_ladder(const float* img, const int* word,
                                    const int* aux, const float* mask,
                                    int level, int B, int N, int Hp,
                                    int lanes, int vh, int vwc, float* out,
                                    int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (!fits_tile(vh, vwc)) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kChunk - 1) / kChunk, B);
  const size_t smem = level == kMask ? (size_t)vh * vwc * sizeof(float) : 0;
  cudaStream_t s = (cudaStream_t)stream;
#define MAGENT_LADDER(L)                                              \
  window_ladder_kernel<L><<<grid, kThreads, smem, s>>>(img, word, aux, \
                                                       mask, N, Hp, lanes, \
                                                       vh, vwc, out)
  switch (level) {
    case kFloor: MAGENT_LADDER(kFloor); break;
    case kSmem: MAGENT_LADDER(kSmem); break;
    case kLoad: MAGENT_LADDER(kLoad); break;
    case kRoll1: MAGENT_LADDER(kRoll1); break;
    case kRoll2: MAGENT_LADDER(kRoll2); break;
    case kMask: MAGENT_LADDER(kMask); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef MAGENT_LADDER
  return (int)cudaGetLastError();
}

extern "C" int magent_window_shared_tile(const float* img, const int* word,
                                         const int* aux, const float* mask,
                                         int B, int N, int chunk, int Hp,
                                         int lanes, int vh, int vwc,
                                         float* out, int device,
                                         void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (!fits_tile(vh, vwc) || chunk <= 0) return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaSuccess;
  if (chunk > N) chunk = N;  // a chunk past N is one chunk: same windows
  const int per_chunk = (int)(((long long)chunk + kChunk - 1) / kChunk);
  const long long blocks =
      ((long long)N + chunk - 1) / chunk * (long long)per_chunk;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, B);
  const size_t smem = (size_t)vh * vwc * sizeof(float);
  window_shared_tile_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      img, word, aux, mask, N, chunk, per_chunk, Hp, lanes, vh, vwc, out);
  return (int)cudaGetLastError();
}
