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
// What bounds it here: bytes.  Each call writes B*N*vh*vw*C values (75.7
// MB of f32 for one battle group at B=16, N=1000, 13x13x7; 37.9 MB of bf16)
// and reads the windows from a padded image of B*Hp*lanes floats (31.5 MB)
// that fits the 50 MB L2.  Design (window_gather_kernel):
// - the call's output is one contiguous run of B*N*E values (E = vh*vwc:
//   windows of consecutive agents, and of consecutive envs, touch), cut
//   into 16-byte vectors of kVec values (4 f32 or 8 bf16) and those into
//   spans of `per` vectors, per a multiple of 32 (ops/window_gather.py
//   gather_split, gather_spans): every span starts 16-byte aligned whatever
//   N and E are (torch.empty's storage is), and only the call's last
//   vector may be partial (stored value by value);
// - block g writes span g (blocks of many spans, persistent, ran slower:
//   their barriers between spans cost more than the tables they save); it
//   first builds two shared tables: off[w] = r * lanes + c beside mask[w]
//   as one int2 (w a value's place in its window), and the image offset of
//   each agent the span touches (-1 for a window that would leave the
//   image: written as zeros);
// - a warp takes tiles of 32 vectors: lane l loads values l, l + 32, ... of
//   the tile from img + base[agent] + off[w], so the warp's image loads and
//   table reads are consecutive (whole cache lines, no bank conflicts), then
//   writes them, multiplied and converted, to its staging slots and stores
//   the tile's vector l as one 16-byte store (neighbouring lanes,
//   neighbouring vectors).  (Issuing two or four tiles' loads before
//   their stores measured no faster on the H100, at battle's B=16 or B=1.)
//   A lane's first value finds its agent with one float multiply by 1/E
//   (corrected to the exact quotient); its other values lie 32 apart, so
//   in a window wider than the tile they cross at most one window boundary
//   and pick between two agents' offsets without a branch (a per-value
//   loop to the next agent compiled to a divergent branch per value).
// Every load is kept, also under a zero mask entry: the plain version's
// img * 0 is -0.0 for a negative image value and NaN for a non-finite one,
// and the kernel returns the same bits.  (Skipping those loads for images
// known to be non-negative, a third of battle's 13x13 circle, measured no
// faster on the H100: the L2 reads are not what bounds the kernel.)
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

// Values of T per 16-byte vector: 4 f32 or 8 bf16.
template <typename T>
constexpr int kVecOf = 16 / (int)sizeof(T);

// Dynamic shared memory of a block of `per` vectors: the window table (E
// int2) and the image offsets of the agents its span touches (one more
// entry: a lane reads its next agent's offset too).
template <typename T>
__host__ __device__ constexpr long long gather_agents(long long per, int E) {
  return per * kVecOf<T> / E + 3;
}

constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 512;  // a warp tile: 32 16-byte vectors

// The loads of lane values x, x + 32, ..., x + 32 * (kVec - 1) of a warp
// tile (x < 2^24, counted from the block's first agent): each value's
// image value (0 where ok is false) and mask entry.  kWide: E > 32 * (kVec
// - 1), so the lane's values cross at most one window boundary and pick
// between two agents' offsets without a branch; else they step agent by
// agent.
template <int kVec, bool kWide>
__device__ __forceinline__ void load_tile(const float* __restrict__ img,
                                          const int2* s_tab,
                                          const int* s_base, int E,
                                          float inv_e, int x,
                                          float (&val)[kVec],
                                          float (&m)[kVec], bool (&ok)[kVec]) {
  int a = __float2int_rz(__int2float_rn(x) * inv_e);
  a += (x - a * E >= E) - (x - a * E < 0);  // the exact quotient
  int w = x - a * E;
  if (kWide) {
    const int base0 = s_base[a];
    const int base1 = s_base[a + 1];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const bool next = w + 32 * k >= E;
      const int2 tab = s_tab[w + 32 * k - (next ? E : 0)];
      const int base = next ? base1 : base0;
      ok[k] = base >= 0;
      val[k] = ok[k] ? img[base + tab.x] : 0.f;
      m[k] = __int_as_float(tab.y);
    }
  } else {
    int base = s_base[a];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k) {
        w += 32;
        while (w >= E) {  // the next agent's window
          w -= E;
          base = s_base[++a];
        }
      }
      const int2 tab = s_tab[w];
      ok[k] = base >= 0;
      val[k] = ok[k] ? img[base + tab.x] : 0.f;
      m[k] = __int_as_float(tab.y);
    }
  }
}

// A block's warp tiles: a tile's loads, then through the warp's staging
// slots into 16-byte vectors, lane l storing the tile's vector l.
template <typename T, bool kWide>
__device__ __forceinline__ void gather_tiles(
    const float* __restrict__ img, const int2* s_tab, const int* s_base,
    uint4* s_raw, int E, int w0, int n_el, T* __restrict__ out_blk) {
  constexpr int kVec = kVecOf<T>;
  constexpr int kTile = 32 * kVec;  // values of a warp tile
  const float inv_e = 1.f / (float)E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (n_el + kTile - 1) / kTile;  // per % 32 == 0
  T* slot = reinterpret_cast<T*>(s_raw);
  for (int t = warp; t < n_tiles; t += kWarps) {
    float val[kVec], m[kVec];
    bool ok[kVec];
    // loads: lane reads values lane, lane + 32, ... of the tile, so a
    // warp's loads and table reads are consecutive
    load_tile<kVec, kWide>(img, s_tab, s_base, E, inv_e,
                           w0 + t * kTile + lane, val, m, ok);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      store(slot + k * 32 + lane, ok[k] ? __fmul_rn(val[k], m[k]) : 0.f);
    __syncwarp();
    const int e = t * kTile + lane * kVec;  // the vector's first value
    if (e < n_el) {
      if (e + kVec <= n_el) {
        *reinterpret_cast<uint4*>(out_blk + e) = s_raw[lane];
      } else {  // the call's last vector, partial
        const T* src = slot + lane * kVec;
        for (int k = 0; k < n_el - e; ++k) out_blk[e + k] = src[k];
      }
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const float* __restrict__ img, const int* __restrict__ pos,
                     const float* __restrict__ mask, long long total, int N,
                     int Hp, int lanes, int Wp, int C, int vh, int vwc,
                     int per, T* __restrict__ out) {
  extern __shared__ int2 s_tab[];  // [E] (off, mask bits) | agents' offsets
  __shared__ uint4 s_raw[kWarps][kTileBytes / 16];
  const int E = vh * vwc;
  int* s_base = reinterpret_cast<int*>(s_tab + E);
  const int na = (int)gather_agents<T>(per, E);
  const long long n_agents = total / E;
  // the window table: r = e / vwc from the f32 quotient (e < 2^24),
  // corrected to the exact one
  const float inv_vwc = 1.f / (float)vwc;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int r = __float2int_rz(__int2float_rn(e) * inv_vwc);
    int c = e - r * vwc;
    if (c < 0) {
      --r;
      c += vwc;
    } else if (c >= vwc) {
      ++r;
      c -= vwc;
    }
    s_tab[e] = make_int2(r * lanes + c, __float_as_int(mask[e]));
  }
  const long long e0 = (long long)blockIdx.x * per * kVecOf<T>;
  const int n_el = (int)min((long long)per * kVecOf<T>, total - e0);
  const long long a0 = e0 / E;
  const int w0 = (int)(e0 - a0 * E);
  for (int a = threadIdx.x; a < na; a += blockDim.x) {
    const long long ga = a0 + a;
    int base = -1;
    if (ga < n_agents) {
      const int b = (int)(ga / N);
      const int p = pos[ga];
      const int yy = p / Wp;
      const int xx = p - yy * Wp;
      if (p >= 0 && yy + vh <= Hp && xx * C + vwc <= lanes)
        base = (b * Hp + yy) * lanes + xx * C;  // < B*Hp*lanes < 2^31
    }
    s_base[a] = base;
  }
  __syncthreads();

  T* out_blk = out + e0;
  uint4* s_warp = s_raw[threadIdx.x >> 5];
  if (E > 32 * (kVecOf<T> - 1))
    gather_tiles<T, true>(img, s_tab, s_base, s_warp, E, w0, n_el, out_blk);
  else
    gather_tiles<T, false>(img, s_tab, s_base, s_warp, E, w0, n_el, out_blk);
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

// per: vectors per block (ops/window_gather.py gather_split).
template <typename T>
int launch_gather(const float* img, const int* pos, const float* mask, int B,
                  int N, int Hp, int lanes, int Wp, int C, int vh, int vwc,
                  int per, T* out, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const long long total = (long long)B * N * vh * vwc;
  // whole warp tiles of 32 vectors per span; a span's values, plus one
  // window, stay below 2^24 (the float quotient)
  if (per < 32 || per % 32 ||
      (long long)per * kVecOf<T> + (long long)vh * vwc > (1 << 24))
    return (int)cudaErrorInvalidValue;
  auto kernel = window_gather_kernel<T>;
  const long long span = (long long)per * kVecOf<T>;
  const long long blocks = (total + span - 1) / span;
  const size_t smem = (size_t)vh * vwc * sizeof(int2) +
                      (size_t)gather_agents<T>(per, vh * vwc) * sizeof(int);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem + kWarps * kTileBytes > 48 * 1024) {  // + staging
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      img, pos, mask, total, N, Hp, lanes, Wp, C, vh, vwc, per, out);
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
                                    int per, float* out, int device,
                                    void* stream) {
  return launch_gather(img, pos, mask, B, N, Hp, lanes, Wp, C, vh, vwc, per,
                       out, device, stream);
}

extern "C" int magent_window_gather_bf16(const float* img, const int* pos,
                                         const float* mask, int B, int N,
                                         int Hp, int lanes, int Wp, int C,
                                         int vh, int vwc, int per,
                                         __nv_bfloat16* out, int device,
                                         void* stream) {
  return launch_gather(img, pos, mask, B, N, Hp, lanes, Wp, C, vh, vwc, per,
                       out, device, stream);
}

extern "C" const char* magent_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
