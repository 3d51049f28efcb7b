// Per-agent view-window gather for sm_90a, behind a plain C interface
// (loaded with ctypes by magent_tpu_torch/ops/_build.py).
//
// out[b, n, r, c] = img[b, y_n + r, x_n * C + c] * mask[r, c]
//   for r < vh, c < vw * C, with (y_n, x_n) = divmod(pos[b, n], Wp)
//
// Replaces magent_tpu/ops/window_gather.py window_gather (the Pallas roll
// kernel), which loads an aligned superset of each window into vector
// registers and rotates it into place with pltpu.roll.
//
// What bounds it here: bytes.  Each call writes B*N*vh*vw*C floats (75.7 MB
// for one battle group at B=16, N=1000, 13x13x7) and reads the windows from
// a padded image of B*Hp*lanes floats (31.5 MB) that fits the 50 MB L2.
// Design: one block per (chunk of kChunk agents, env); a warp copies one
// window row at a time, lane c reading image lane x*C + c and writing output
// lane c, so loads and stores are coalesced along the row and the output of
// a block is one contiguous span.  No alignment trick is needed: the card
// loads at any 4-byte offset.  The mask sits in shared memory.  A window
// whose position would read outside the image is written as zeros (the
// caller's positions always lie inside: see padded_geometry).
//
// window_gather4 (below) adds the replica kernel's fused epilogue; it is
// bound by the same bytes (pursuit's two groups at map 64, B=16: 4.3 MB of
// windows written from a 5.5 MB image).
//
// Every kernel is templated on its output type T, float or __nv_bfloat16:
// the JAX kernels' out_dtype (magent_tpu/ops/window_gather.py, the stores at
// :154, :329, :365 and :538).  The window math stays float; only the store
// converts, rounding to nearest even (__float2bfloat16_rn, as XLA's
// astype(bfloat16) does).  bf16 halves the window bytes written (37.9 MB per
// battle group at B=16); the image read stays float.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

constexpr int kThreads = 256;  // 8 warps
constexpr int kChunk = 32;     // agents per block

template <typename T>
__global__ void window_gather_kernel(const float* __restrict__ img,
                                     const int* __restrict__ pos,
                                     const float* __restrict__ mask, int N,
                                     int Hp, int lanes, int Wp, int C, int vh,
                                     int vwc, T* __restrict__ out) {
  extern __shared__ float s_mask[];  // [vh * vwc]
  __shared__ long long s_base[kChunk];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kChunk;
  const int nc = min(kChunk, N - n0);
  for (int e = threadIdx.x; e < vh * vwc; e += blockDim.x) s_mask[e] = mask[e];
  if (threadIdx.x < nc) {
    const int p = pos[(size_t)b * N + n0 + threadIdx.x];
    const int yy = p / Wp;
    const int xx = p - yy * Wp;
    const bool ok = p >= 0 && yy + vh <= Hp && xx * C + vwc <= lanes;
    s_base[threadIdx.x] = ok ? (long long)yy * lanes + (long long)xx * C : -1;
  }
  __syncthreads();

  const float* img_b = img + (size_t)b * Hp * lanes;
  T* out_b = out + ((size_t)b * N + n0) * vh * vwc;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int w = warp; w < nc * vh; w += n_warps) {  // w = agent * vh + row
    const int a = w / vh;
    const int r = w - a * vh;
    const long long base = s_base[a];
    T* dst = out_b + (size_t)w * vwc;
    if (base < 0) {
      for (int c = lane; c < vwc; c += 32) store(dst + c, 0.f);
      continue;
    }
    const float* src = img_b + base + (long long)r * lanes;
    const float* m = s_mask + r * vwc;
    for (int c = lane; c < vwc; c += 32) store(dst + c, src[c] * m[c]);
  }
}

// window_gather4: the same row copy with the fused epilogue of the TPU's
// replica kernel (magent_tpu/ops/window_gather.py window_gather4), whose
// four shifted image replicas only work around the TPU's aligned loads:
//
//   out = ((src * mask + mm[b]) + [cell_id == self_cell] * mm_mask) * act
//   cell_id = r * vw + c / C,  pos = tl * 1024 + self_cell
//
// kMM adds the pooled minimap and the self mark, kAct scales by liveness;
// the launcher instantiates kMM only with kAct, as the observation calls it.
// The caller keeps tl * 1024 + self_cell inside int32 (at most 2**21 image
// cells).
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn: no
// FMA contraction), in the plain version's order, so the result equals it
// bit for bit.  mask, mm_img[b] and mm_mask sit in shared memory.
template <typename T, bool kMM, bool kAct>
__global__ void window_gather4_kernel(
    const float* __restrict__ img, const int* __restrict__ pos,
    const float* __restrict__ mask, const float* __restrict__ mm_img,
    const float* __restrict__ mm_mask, const int* __restrict__ act, int N,
    int Hp, int lanes, int Wp, int C, int vh, int vw, T* __restrict__ out) {
  extern __shared__ float s_buf[];  // mask | mm_img[b] | mm_mask
  __shared__ long long s_base[kChunk];
  __shared__ int s_self[kChunk];
  __shared__ float s_act[kChunk];
  const int vwc = vw * C;
  const int n_win = vh * vwc;
  float* s_mask = s_buf;
  float* s_mm = s_buf + n_win;
  float* s_mmm = s_buf + 2 * n_win;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kChunk;
  const int nc = min(kChunk, N - n0);
  for (int e = threadIdx.x; e < n_win; e += blockDim.x) {
    s_mask[e] = mask[e];
    if (kMM) {
      s_mm[e] = mm_img[(size_t)b * n_win + e];
      s_mmm[e] = mm_mask[e];
    }
  }
  if (threadIdx.x < nc) {
    const size_t a = (size_t)b * N + n0 + threadIdx.x;
    const int p = pos[a];
    const int tl = p >> 10;
    const int yy = tl / Wp;
    const int xx = tl - yy * Wp;
    const bool ok = p >= 0 && yy + vh <= Hp && xx * C + vwc <= lanes;
    s_base[threadIdx.x] = ok ? (long long)yy * lanes + (long long)xx * C : -1;
    s_self[threadIdx.x] = p & 1023;
    s_act[threadIdx.x] = kAct ? (float)act[a] : 1.f;
  }
  __syncthreads();

  const float* img_b = img + (size_t)b * Hp * lanes;
  T* out_b = out + ((size_t)b * N + n0) * n_win;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int w = warp; w < nc * vh; w += n_warps) {  // w = agent * vh + row
    const int a = w / vh;
    const int r = w - a * vh;
    const long long base = s_base[a];
    const float* src = img_b + (base < 0 ? 0 : base) + (long long)r * lanes;
    const int off = r * vwc;
    T* dst = out_b + (size_t)w * vwc;
    for (int c = lane; c < vwc; c += 32) {
      float v = base < 0 ? 0.f : __fmul_rn(src[c], s_mask[off + c]);
      if (kMM) {
        v = __fadd_rn(v, s_mm[off + c]);
        v = __fadd_rn(v, r * vw + c / C == s_self[a] ? s_mmm[off + c] : 0.f);
      }
      if (kAct) v = __fmul_rn(v, s_act[a]);
      store(dst + c, v);  // one rounding, after the whole epilogue
    }
  }
}

// window_gather_banded: the windows of a band-ordered position table
// (magent_tpu/ops/window_gather.py window_gather_banded, which the JAX
// package runs for images above its VMEM budget: the TPU sorts agents by
// 32-row image band so that a program holds one band in VMEM).  Here the
// table, built in PyTorch, gives consecutive blocks the agents of one band,
// so a band's rows (48 rows x 21.5 KB at pursuit map 1000: too large for
// shared memory) are read from L2 by the blocks after the first.  One
// block per (chunk of `chunk` table rows, env); the warps copy window rows
// as window_gather_kernel does.  Dummy rows point at their band's first
// row; window rows past the image read as zeros, as the TPU kernel reads
// the zero rows padded below its last band.  A pure copy times the mask:
// equal to the plain version exactly.
constexpr int kMaxBandChunk = 128;  // _MAX_BAND_CHUNK of ops/window_gather.py

template <typename T>
__global__ void window_gather_banded_kernel(const float* __restrict__ img,
                                            const int* __restrict__ pos,
                                            const float* __restrict__ mask,
                                            int n_pad, int chunk, int Hp,
                                            int lanes, int Wp, int C, int vh,
                                            int vwc, T* __restrict__ out) {
  extern __shared__ float s_mask[];  // [vh * vwc]
  __shared__ int s_row[kMaxBandChunk];
  __shared__ int s_lane[kMaxBandChunk];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * chunk;
  for (int e = threadIdx.x; e < vh * vwc; e += blockDim.x) s_mask[e] = mask[e];
  for (int a = threadIdx.x; a < chunk; a += blockDim.x) {
    const int p = pos[(size_t)b * n_pad + n0 + a];
    const int yy = p / Wp;
    const int xx = p - yy * Wp;
    const bool ok = p >= 0 && xx * C + vwc <= lanes;
    s_row[a] = ok ? yy : Hp;  // a row at Hp or below reads as zeros
    s_lane[a] = ok ? xx * C : 0;
  }
  __syncthreads();

  const float* img_b = img + (size_t)b * Hp * lanes;
  T* out_b = out + ((size_t)b * n_pad + n0) * vh * vwc;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int w = warp; w < chunk * vh; w += n_warps) {  // w = agent * vh + row
    const int a = w / vh;
    const int r = w - a * vh;
    const int row = s_row[a] + r;
    T* dst = out_b + (size_t)w * vwc;
    if (row >= Hp) {
      for (int c = lane; c < vwc; c += 32) store(dst + c, 0.f);
      continue;
    }
    const float* src = img_b + (size_t)row * lanes + s_lane[a];
    const float* m = s_mask + r * vwc;
    for (int c = lane; c < vwc; c += 32) store(dst + c, src[c] * m[c]);
  }
}

template <typename T>
int launch_banded(const float* img, const int* pos, const float* mask, int B,
                  int n_pad, int chunk, int Hp, int lanes, int Wp, int C,
                  int vh, int vwc, T* out, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (chunk <= 0 || chunk > kMaxBandChunk || n_pad % chunk)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_pad / chunk, B);
  const size_t smem = (size_t)vh * vwc * sizeof(float);
  window_gather_banded_kernel<T>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(
          img, pos, mask, n_pad, chunk, Hp, lanes, Wp, C, vh, vwc, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gather4(const float* img, const int* pos, const float* mask,
                   const float* mm_img, const float* mm_mask, const int* act,
                   int B, int N, int Hp, int lanes, int Wp, int C, int vh,
                   int vw, T* out, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((N + kChunk - 1) / kChunk, B);
  const bool mm = mm_img != nullptr;
  const size_t smem = (size_t)(mm ? 3 : 1) * vh * vw * C * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
#define MAGENT_G4(MM, ACT)                                               \
  window_gather4_kernel<T, MM, ACT><<<grid, kThreads, smem, s>>>(        \
      img, pos, mask, mm_img, mm_mask, act, N, Hp, lanes, Wp, C, vh, vw, \
      out)
  if (mm && !act) return (int)cudaErrorInvalidValue;  // minimap needs act
  if (mm) MAGENT_G4(true, true);
  else if (act) MAGENT_G4(false, true);
  else MAGENT_G4(false, false);
#undef MAGENT_G4
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gather(const float* img, const int* pos, const float* mask, int B,
                  int N, int Hp, int lanes, int Wp, int C, int vh, int vwc,
                  T* out, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid((N + kChunk - 1) / kChunk, B);
  const size_t smem = (size_t)vh * vwc * sizeof(float);
  window_gather_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      img, pos, mask, N, Hp, lanes, Wp, C, vh, vwc, out);
  return (int)cudaGetLastError();
}

}  // namespace

// One C entry per kernel and output type, so that the launch counters and
// the profiler tell the two stores apart.
extern "C" int magent_window_gather_banded(const float* img, const int* pos,
                                           const float* mask, int B, int n_pad,
                                           int chunk, int Hp, int lanes,
                                           int Wp, int C, int vh, int vwc,
                                           float* out, int device,
                                           void* stream) {
  return launch_banded(img, pos, mask, B, n_pad, chunk, Hp, lanes, Wp, C, vh,
                       vwc, out, device, stream);
}

extern "C" int magent_window_gather_banded_bf16(
    const float* img, const int* pos, const float* mask, int B, int n_pad,
    int chunk, int Hp, int lanes, int Wp, int C, int vh, int vwc,
    __nv_bfloat16* out, int device, void* stream) {
  return launch_banded(img, pos, mask, B, n_pad, chunk, Hp, lanes, Wp, C, vh,
                       vwc, out, device, stream);
}

extern "C" int magent_window_gather4(const float* img, const int* pos,
                                     const float* mask, const float* mm_img,
                                     const float* mm_mask, const int* act,
                                     int B, int N, int Hp, int lanes, int Wp,
                                     int C, int vh, int vw, float* out,
                                     int device, void* stream) {
  return launch_gather4(img, pos, mask, mm_img, mm_mask, act, B, N, Hp, lanes,
                        Wp, C, vh, vw, out, device, stream);
}

extern "C" int magent_window_gather4_bf16(
    const float* img, const int* pos, const float* mask, const float* mm_img,
    const float* mm_mask, const int* act, int B, int N, int Hp, int lanes,
    int Wp, int C, int vh, int vw, __nv_bfloat16* out, int device,
    void* stream) {
  return launch_gather4(img, pos, mask, mm_img, mm_mask, act, B, N, Hp, lanes,
                        Wp, C, vh, vw, out, device, stream);
}

extern "C" int magent_window_gather(const float* img, const int* pos,
                                    const float* mask, int B, int N, int Hp,
                                    int lanes, int Wp, int C, int vh, int vwc,
                                    float* out, int device, void* stream) {
  return launch_gather(img, pos, mask, B, N, Hp, lanes, Wp, C, vh, vwc, out,
                       device, stream);
}

extern "C" int magent_window_gather_bf16(const float* img, const int* pos,
                                         const float* mask, int B, int N,
                                         int Hp, int lanes, int Wp, int C,
                                         int vh, int vwc, __nv_bfloat16* out,
                                         int device, void* stream) {
  return launch_gather(img, pos, mask, B, N, Hp, lanes, Wp, C, vh, vwc, out,
                       device, stream);
}

extern "C" const char* magent_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
