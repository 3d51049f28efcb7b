// Per-agent view-window gathers for sm_90a, behind a plain C interface
// (loaded with ctypes by magent_tpu_torch/ops/_build.py).
//
// out[b, n, r, c] = img[b, y_n + r, x_n * C + c] * mask[r, c]
//   for r < vh, c < vw * C, with (y_n, x_n) = divmod(pos[b, n], Wp)
//
// One kernel template, window_gather_kernel<T, kForm, kEpi>, serves the
// three window entry points of ops/window_gather.py, each a TPU kernel of
// magent_tpu/ops/window_gather.py:
// - kUnpacked, window_gather (the Pallas roll kernel, which loads an aligned
//   superset of each window into vector registers and rotates it into place
//   with pltpu.roll): a window that would leave the image is zeros;
// - kPacked, window_gather4 (the replica kernel, whose four shifted image
//   replicas only work around the TPU's aligned loads): pos = tl * 1024 +
//   self_cell, the same zero rule, and the fused epilogue below;
// - kBanded, window_gather_banded (the banded kernel, which the JAX package
//   runs for images above its VMEM budget: the TPU sorts agents by 32-row
//   image band so that a program holds one band in VMEM).  Here the image
//   (22.6 MB at pursuit map 1000) sits in the 50 MB L2, so no band order is
//   needed: the kernel writes each window straight to its slot.  Window rows
//   at or past Hp read as zeros (the TPU kernel reads the zero rows padded
//   below its last band); a negative position, or one whose window leaves
//   the image on the right, gives a whole-window zero.  The band-ordered
//   form runs the same kernel over the band table's positions.
//
// What bounds them here: bytes.  A call writes B*N*vh*vw*C values (75.7 MB
// of f32 for one battle group at B=16, N=1000, 13x13x7; 37.9 MB of bf16;
// 2-2.7 MB for pursuit's groups at map 64, B=16; 30-42 MB at map 1000) and
// reads the windows from a padded image that fits the 50 MB L2.  Design:
// - the call's output is one contiguous run of B*N*E values (E = vh*vwc:
//   windows of consecutive agents, and of consecutive envs, touch), cut
//   into 16-byte vectors of kVec values (4 f32 or 8 bf16) and those into
//   spans of `per` vectors, per a multiple of 32 (ops/window_gather.py
//   gather_split, gather_spans): every span starts 16-byte aligned whatever
//   N and E are (torch.empty's storage is), and only the call's last
//   vector may be partial (stored value by value);
// - block g writes span g (blocks of many spans, persistent, ran slower:
//   their barriers between spans cost more than the tables they save); it
//   first builds its shared tables: per window value w, its image offset
//   r * lanes + c beside mask[w] (with the minimap epilogue also mm_mask[w]
//   and its minimap cell r * vw + c / C, as one int4); per agent the span
//   touches, its window's image offset (-1 for a window written as zeros)
//   and what the form needs besides (the env image's end, liveness, self
//   cell, the env's minimap offset), one array each.  A span may cross
//   agents and envs;
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
//   and pick between two agents' records without a branch (a per-value
//   loop to the next agent compiled to a divergent branch per value).
// Every load is kept, also under a zero mask entry: the plain version's
// img * 0 is -0.0 for a negative image value and NaN for a non-finite one,
// and the kernel returns the same bits.  (Skipping those loads for images
// known to be non-negative, a third of battle's 13x13 circle, measured no
// faster on the H100: the L2 reads are not what bounds the kernel.)
//
// The epilogues (kEpi), applied per value after the masked load:
//   kAct:      v * act
//   kMinimap:  ((v + mm_img[b][w]) + [cell(w) == self] * mm_mask[w]) * act
// every product and sum rounded on its own (__fmul_rn / __fadd_rn: no FMA
// contraction), in the plain versions' order, so the result equals them bit
// for bit.  window_gather4 rounds to T once, at the store.  The banded
// form's epilogue is the observation's (magent_tpu/core/observe.py:378-401):
// the JAX route stores the kernel's windows in T, then runs the epilogue in
// f32 and rounds again, so the kernel rounds v to T before the epilogue too.
//
// Every form is templated on its output type T, float or __nv_bfloat16:
// the JAX kernels' out_dtype (magent_tpu/ops/window_gather.py, the stores at
// :154, :329, :365 and :538).  The window math stays float; only the store
// converts, rounding to nearest even (__float2bfloat16_rn, as XLA's
// astype(bfloat16) does).  bf16 halves the window bytes written; the image
// read stays float.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// v as T stores it, back in float
__device__ __forceinline__ float rounded(float v, const float*) { return v; }
__device__ __forceinline__ float rounded(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 512;  // a warp tile: 32 16-byte vectors

// how a position names its window (see the head of this file)
constexpr int kUnpacked = 0, kPacked = 1, kBanded = 2;
// the epilogues
constexpr int kNoEpi = 0, kAct = 1, kMinimap = 2;

// Values of T per 16-byte vector: 4 f32 or 8 bf16.
template <typename T>
constexpr int kVecOf = 16 / (int)sizeof(T);

// Agents whose records a block of `per` vectors holds: those its span
// touches, and one more (a lane reads its next agent's record too).
template <typename T>
__host__ __device__ constexpr long long gather_agents(long long per, int E) {
  return per * kVecOf<T> / E + 3;
}

// Per window value: (image offset, mask bits), and with the minimap
// (mm_mask bits, minimap cell).
template <int kEpi>
using TabOf = typename std::conditional<kEpi == kMinimap, int4, int2>::type;

// 32-bit words of an agent's record: its window's image offset; kBanded:
// its env image's end offset; kAct, kMinimap: liveness; kMinimap: self cell
// and its env's minimap offset.
__host__ __device__ constexpr int agent_words(int form, int epi) {
  return 1 + (form == kBanded) + (epi >= kAct) + 2 * (epi == kMinimap);
}

struct WindowArgs {
  const float* img;        // [B, Hp, lanes]
  const int* pos;          // [B, N]
  const float* mask;       // [vh, vwc]
  const float* mm_img;     // kMinimap: [B, vh, vwc]
  const float* mm_mask;    // kMinimap: [vh, vwc]; kBanded: [C]
  const int* act;          // kAct, kMinimap: [B, N]
  const int* self_cell;    // kBanded with kMinimap: [B, N]
  int B, N, Hp, lanes, Wp, C, vh, vw, per;
};

// The shared per-agent arrays of a block (agent_words of them, na each).
template <int kForm, int kEpi>
struct Agents {
  int* base;
  int* limit;
  float* act;
  int* self;
  int* mm;

  __device__ __forceinline__ Agents(int* words, int na) {
    base = words;
    words += na;
    if (kForm == kBanded) {
      limit = words;
      words += na;
    }
    if (kEpi >= kAct) {
      act = reinterpret_cast<float*>(words);
      words += na;
    }
    if (kEpi == kMinimap) {
      self = words;
      mm = words + na;
    }
  }
};

// One agent's record, as a lane holds it.
template <int kForm, int kEpi>
struct Agent {
  int base, limit = 0, self = 0, mm = 0;
  float act = 1.f;

  __device__ __forceinline__ void read(const Agents<kForm, kEpi>& t, int a) {
    base = t.base[a];
    if (kForm == kBanded) limit = t.limit[a];
    if (kEpi >= kAct) act = t.act[a];
    if (kEpi == kMinimap) {
      self = t.self[a];
      mm = t.mm[a];
    }
  }

  // a lane's record for one value: next's or this one's, field by field
  // (a select of whole records went through local memory)
  __device__ __forceinline__ Agent pick(bool take_next,
                                        const Agent& next) const {
    Agent g;
    g.base = take_next ? next.base : base;
    if (kForm == kBanded) g.limit = take_next ? next.limit : limit;
    if (kEpi >= kAct) g.act = take_next ? next.act : act;
    if (kEpi == kMinimap) {
      g.self = take_next ? next.self : self;
      g.mm = take_next ? next.mm : mm;
    }
    return g;
  }
};

// What a lane loads for one value: the image value (0 where ok is false),
// the mask entry, and the epilogue's operands.
template <int kVec>
struct Loads {
  float val[kVec], m[kVec], act[kVec], mmv[kVec], mark[kVec];
  bool ok[kVec];
};

template <int kForm, int kEpi, int kVec>
__device__ __forceinline__ void load_value(const float* __restrict__ img,
                                           const float* __restrict__ mm_img,
                                           TabOf<kEpi> tab, int w,
                                           const Agent<kForm, kEpi>& g, int k,
                                           Loads<kVec>& l) {
  bool ok = g.base >= 0;
  // rows at or past Hp: the value's offset reaches the env image's end
  // (c + x * C < lanes, so no row index is needed)
  if (kForm == kBanded) ok = ok && g.base + tab.x < g.limit;
  l.ok[k] = ok;
  l.val[k] = ok ? img[g.base + tab.x] : 0.f;
  l.m[k] = __int_as_float(tab.y);
  if (kEpi >= kAct) l.act[k] = g.act;
  if constexpr (kEpi == kMinimap) {
    l.mmv[k] = mm_img[g.mm + w];
    l.mark[k] = tab.w == g.self ? __int_as_float(tab.z) : 0.f;
  }
}

// The loads of lane values x, x + 32, ..., x + 32 * (kVec - 1) of a warp
// tile (x < 2^24, counted from the block's first agent).  kWide: E > 32 *
// (kVec - 1), so the lane's values cross at most one window boundary and
// pick between two agents' records without a branch; else they step agent
// by agent.
template <int kForm, int kEpi, int kVec, bool kWide>
__device__ __forceinline__ void load_tile(const float* __restrict__ img,
                                          const float* __restrict__ mm_img,
                                          const TabOf<kEpi>* s_tab,
                                          const Agents<kForm, kEpi>& agents,
                                          int E, float inv_e, int x,
                                          Loads<kVec>& l) {
  int a = __float2int_rz(__int2float_rn(x) * inv_e);
  a += (x - a * E >= E) - (x - a * E < 0);  // the exact quotient
  int w = x - a * E;
  if (kWide) {
    Agent<kForm, kEpi> g0, g1;
    g0.read(agents, a);
    g1.read(agents, a + 1);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const bool next = w + 32 * k >= E;
      const int wk = w + 32 * k - (next ? E : 0);
      load_value<kForm, kEpi, kVec>(img, mm_img, s_tab[wk], wk,
                                    g0.pick(next, g1), k, l);
    }
  } else {
    Agent<kForm, kEpi> g;
    g.read(agents, a);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k) {
        w += 32;
        while (w >= E) {  // the next agent's window
          w -= E;
          g.read(agents, ++a);
        }
      }
      load_value<kForm, kEpi, kVec>(img, mm_img, s_tab[w], w, g, k, l);
    }
  }
}

// A block's warp tiles: a tile's loads, then the epilogue, then through the
// warp's staging slots into 16-byte vectors, lane l storing the tile's
// vector l.
template <typename T, int kForm, int kEpi, bool kWide>
__device__ __forceinline__ void gather_tiles(
    const float* __restrict__ img, const float* __restrict__ mm_img,
    const TabOf<kEpi>* s_tab, const Agents<kForm, kEpi>& agents,
    uint4* s_raw, int E, int w0, int n_el, T* __restrict__ out_blk) {
  constexpr int kVec = kVecOf<T>;
  constexpr int kTile = 32 * kVec;  // values of a warp tile
  const float inv_e = 1.f / (float)E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (n_el + kTile - 1) / kTile;  // per % 32 == 0
  T* slot = reinterpret_cast<T*>(s_raw);
  for (int t = warp; t < n_tiles; t += kWarps) {
    Loads<kVec> l;
    // loads: lane reads values lane, lane + 32, ... of the tile, so a
    // warp's loads and table reads are consecutive
    load_tile<kForm, kEpi, kVec, kWide>(img, mm_img, s_tab, agents, E,
                                        inv_e, w0 + t * kTile + lane, l);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float v = l.ok[k] ? __fmul_rn(l.val[k], l.m[k]) : 0.f;
      // the banded route's first rounding: the kernel's store, before the
      // observation's epilogue
      if (kForm == kBanded && kEpi != kNoEpi) v = rounded(v, slot);
      if (kEpi == kMinimap) {
        v = __fadd_rn(v, l.mmv[k]);
        v = __fadd_rn(v, l.mark[k]);
      }
      if (kEpi >= kAct) v = __fmul_rn(v, l.act[k]);
      store(slot + k * 32 + lane, v);
    }
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

// Blocks per SM the compiler must fit without the minimap epilogue: 8 for
// f32 windows (32 registers), 6 for bf16 (40).  Unbounded, the template's
// unpacked form took 40 and 48 registers and ran 8% and 4% longer at
// battle B=16 than with these (tools/profile_gather.py, H100).
template <typename T, int kEpi>
constexpr int kMinBlocks = kEpi == kMinimap ? 1 : sizeof(T) == 4 ? 8 : 6;

template <typename T, int kForm, int kEpi>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, kEpi>))
window_gather_kernel(WindowArgs arg, long long total, T* __restrict__ out) {
  using Tab = TabOf<kEpi>;
  extern __shared__ int4 s_dyn[];  // window table | agents' records
  __shared__ uint4 s_raw[kWarps][kTileBytes / 16];
  const int vwc = arg.vw * arg.C;
  const int E = arg.vh * vwc;
  Tab* s_tab = reinterpret_cast<Tab*>(s_dyn);
  const int na = (int)gather_agents<T>(arg.per, E);
  const Agents<kForm, kEpi> agents(reinterpret_cast<int*>(s_tab + E), na);
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
    Tab t;
    t.x = r * arg.lanes + c;
    t.y = __float_as_int(arg.mask[e]);
    if constexpr (kEpi == kMinimap) {
      const int q = c / arg.C;
      t.z = __float_as_int(kForm == kBanded ? arg.mm_mask[c - q * arg.C]
                                            : arg.mm_mask[e]);
      t.w = r * arg.vw + q;  // the value's minimap cell
    }
    s_tab[e] = t;
  }
  const long long e0 = (long long)blockIdx.x * arg.per * kVecOf<T>;
  const int n_el = (int)min((long long)arg.per * kVecOf<T>, total - e0);
  const long long a0 = e0 / E;
  const int w0 = (int)(e0 - a0 * E);
  const int image = arg.Hp * arg.lanes;
  for (int a = threadIdx.x; a < na; a += blockDim.x) {
    const long long ga = a0 + a;
    int base = -1, limit = 0, self = -1, mm = 0;
    float live = 0.f;
    if (ga < n_agents) {
      const int b = (int)(ga / arg.N);
      const int p = arg.pos[ga];
      const int tl = kForm == kPacked ? p >> 10 : p;
      const int yy = tl / arg.Wp;
      const int xx = tl - yy * arg.Wp;
      const bool rows_in = kForm == kBanded ? yy < arg.Hp
                                            : yy + arg.vh <= arg.Hp;
      if (p >= 0 && rows_in && xx * arg.C + vwc <= arg.lanes)
        base = b * image + yy * arg.lanes + xx * arg.C;  // < B*Hp*lanes
      if (kForm == kBanded) limit = (b + 1) * image;
      if (kEpi >= kAct) live = (float)arg.act[ga];
      if (kEpi == kMinimap) {
        self = kForm == kPacked ? (p & 1023) : arg.self_cell[ga];
        mm = b * E;
      }
    }
    agents.base[a] = base;
    if (kForm == kBanded) agents.limit[a] = limit;
    if (kEpi >= kAct) agents.act[a] = live;
    if (kEpi == kMinimap) {
      agents.self[a] = self;
      agents.mm[a] = mm;
    }
  }
  __syncthreads();

  T* out_blk = out + e0;
  uint4* s_warp = s_raw[threadIdx.x >> 5];
  if (E > 32 * (kVecOf<T> - 1))
    gather_tiles<T, kForm, kEpi, true>(arg.img, arg.mm_img, s_tab, agents,
                                       s_warp, E, w0, n_el, out_blk);
  else
    gather_tiles<T, kForm, kEpi, false>(arg.img, arg.mm_img, s_tab, agents,
                                        s_warp, E, w0, n_el, out_blk);
}

template <typename T, int kForm, int kEpi>
int launch_form(const WindowArgs& arg, T* out, cudaStream_t stream) {
  const int E = arg.vh * arg.vw * arg.C;
  const long long total = (long long)arg.B * arg.N * E;
  auto kernel = window_gather_kernel<T, kForm, kEpi>;
  const long long span = (long long)arg.per * kVecOf<T>;
  const long long blocks = (total + span - 1) / span;
  const size_t smem =
      (size_t)E * sizeof(TabOf<kEpi>) +
      (size_t)gather_agents<T>(arg.per, E) * agent_words(kForm, kEpi) * 4;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem + kWarps * kTileBytes > 48 * 1024) {  // + staging
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(arg, total, out);
  return (int)cudaGetLastError();
}

// arg.per: vectors per block (ops/window_gather.py gather_split); the
// epilogue follows the operands given (the minimap comes with act).
template <typename T, int kForm>
int launch(const WindowArgs& arg, T* out, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  // whole warp tiles of 32 vectors per span; a span's values, plus one
  // window, stay below 2^24 (the float quotient)
  if (arg.per < 32 || arg.per % 32 ||
      (long long)arg.per * kVecOf<T> + (long long)arg.vh * arg.vw * arg.C >
          (1 << 24))
    return (int)cudaErrorInvalidValue;
  if (arg.mm_img && !arg.act) return (int)cudaErrorInvalidValue;
  if (kForm == kBanded && arg.mm_img && !arg.self_cell)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (kForm == kUnpacked) {
    if (arg.mm_img || arg.act) return (int)cudaErrorInvalidValue;
    return launch_form<T, kForm, kNoEpi>(arg, out, s);
  } else {
    if (arg.mm_img) return launch_form<T, kForm, kMinimap>(arg, out, s);
    if (arg.act) return launch_form<T, kForm, kAct>(arg, out, s);
    return launch_form<T, kForm, kNoEpi>(arg, out, s);
  }
}

WindowArgs args_of(const float* img, const int* pos, const float* mask,
                   const float* mm_img, const float* mm_mask, const int* act,
                   const int* self_cell, int B, int N, int Hp, int lanes,
                   int Wp, int C, int vh, int vw, int per) {
  return WindowArgs{img, pos, mask, mm_img, mm_mask, act, self_cell,
                    B,   N,   Hp,   lanes,  Wp,      C,   vh, vw, per};
}

}  // namespace

// One C entry per entry point and output type, so that the launch counters
// and the profiler tell them apart.
extern "C" int magent_window_gather(const float* img, const int* pos,
                                    const float* mask, int B, int N, int Hp,
                                    int lanes, int Wp, int C, int vh, int vwc,
                                    int per, float* out, int device,
                                    void* stream) {
  return launch<float, kUnpacked>(
      args_of(img, pos, mask, nullptr, nullptr, nullptr, nullptr, B, N, Hp,
              lanes, Wp, C, vh, vwc / C, per),
      out, device, stream);
}

extern "C" int magent_window_gather_bf16(const float* img, const int* pos,
                                         const float* mask, int B, int N,
                                         int Hp, int lanes, int Wp, int C,
                                         int vh, int vwc, int per,
                                         __nv_bfloat16* out, int device,
                                         void* stream) {
  return launch<__nv_bfloat16, kUnpacked>(
      args_of(img, pos, mask, nullptr, nullptr, nullptr, nullptr, B, N, Hp,
              lanes, Wp, C, vh, vwc / C, per),
      out, device, stream);
}

extern "C" int magent_window_gather4(const float* img, const int* pos,
                                     const float* mask, const float* mm_img,
                                     const float* mm_mask, const int* act,
                                     int B, int N, int Hp, int lanes, int Wp,
                                     int C, int vh, int vw, int per,
                                     float* out, int device, void* stream) {
  return launch<float, kPacked>(
      args_of(img, pos, mask, mm_img, mm_mask, act, nullptr, B, N, Hp, lanes,
              Wp, C, vh, vw, per),
      out, device, stream);
}

extern "C" int magent_window_gather4_bf16(
    const float* img, const int* pos, const float* mask, const float* mm_img,
    const float* mm_mask, const int* act, int B, int N, int Hp, int lanes,
    int Wp, int C, int vh, int vw, int per, __nv_bfloat16* out, int device,
    void* stream) {
  return launch<__nv_bfloat16, kPacked>(
      args_of(img, pos, mask, mm_img, mm_mask, act, nullptr, B, N, Hp, lanes,
              Wp, C, vh, vw, per),
      out, device, stream);
}

extern "C" int magent_window_gather_banded(
    const float* img, const int* pos, const float* mask, const float* mm_img,
    const float* mm_maskc, const int* act, const int* self_cell, int B, int N,
    int Hp, int lanes, int Wp, int C, int vh, int vw, int per, float* out,
    int device, void* stream) {
  return launch<float, kBanded>(
      args_of(img, pos, mask, mm_img, mm_maskc, act, self_cell, B, N, Hp,
              lanes, Wp, C, vh, vw, per),
      out, device, stream);
}

extern "C" int magent_window_gather_banded_bf16(
    const float* img, const int* pos, const float* mask, const float* mm_img,
    const float* mm_maskc, const int* act, const int* self_cell, int B, int N,
    int Hp, int lanes, int Wp, int C, int vh, int vw, int per,
    __nv_bfloat16* out, int device, void* stream) {
  return launch<__nv_bfloat16, kBanded>(
      args_of(img, pos, mask, mm_img, mm_maskc, act, self_cell, B, N, Hp,
              lanes, Wp, C, vh, vw, per),
      out, device, stream);
}

extern "C" const char* magent_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
