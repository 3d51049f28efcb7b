// The GRU cell's gate math for sm_90a, forward and backward, behind a plain
// C interface (loaded with ctypes by magent_tpu_torch/ops/_build.py; the
// wrapper and the plain versions are ops/gru_cell.py).
//
// Replaces no TPU kernel: the JAX package leaves flax's GRUCell to XLA,
// which fuses the gates into the programs around the matmuls.  Run as
// PyTorch ops, the cell is ~12-15 elementwise kernels per step, each
// reading and writing a whole [N, H] tensor.  Here everything between the
// six projections and the new state is one pass:
//
//   r = sigmoid(xr + ar), z = sigmoid(xz + az), n = tanh(xn + r * an),
//   h' = (1 - z) * n + z * h
//
// with x* the input's projections (ir, iz, in, their biases added) and a*
// the state's (hr, hz, hn).  Two forms, fixed by the caller:
// - kAct, DRQNNet's acting cell (builtin/torch_model/drqn.py GRUCell): the
//   whole cell in the net's type T, rounded where PyTorch's ops on T round:
//   the state h (f32) to T, each sum, product and activation to T; the
//   arithmetic itself in f32 registers, as PyTorch's opmath.  Writes h'
//   widened to f32 (the net's carried state and its heads are f32).
// - kCarry, split_unroll's carry step: the projections in T, the gates'
//   adds and the rest in f32 (an plus hn's f32 bias, then as above), the
//   reset keep (one bool per row: carry = keep ? h' : 0) fused.  Writes
//   the f32 carry, the f32 output h' and the carry in T (the next step's
//   three state matmuls read it).
// Each operation is one IEEE f32 operation (__fadd_rn, __fmul_rn, ...), so
// that nvcc contracts no product and sum into an fma the plain version does
// not have; sigmoid is 1 / (1 + expf(-x)) and tanh tanhf, as PyTorch's.
//
// The backward recomputes the gates from the saved projections and state
// at the forward's rounding points and keeps every intermediate gradient
// in f32 registers.  It writes the four distinct pre-activation gradients
// in T for the matmuls' backward (r's, shared by ir and hr; z's; in's; hn's
// = r x in's) and the state's direct gradient (z x the incoming one) in
// f32; the carry form also hn's in f32, where its bias wants a gradient.
// The carry form takes up to three incoming gradients (carry, output,
// carry in T), any of them absent (a null pointer reads as zeros).
//
// What bounds it: bytes.  Per element of [N, H] (bf16 projections, f32
// state): the acting forward reads 16 and writes 4; the carry forward
// reads 16 and writes 10; the backward reads 20 (24 for the carry form's
// three gradients) and writes 12.  At battle_drqn's N = 102,400, H = 512
// that is 0.31-0.50 ms a launch at 3.35 TB/s, against ~15 passes over the
// same tensors as PyTorch ops.  Design: one thread per 8 contiguous values
// of a row (H % 8 == 0), 16-byte loads and stores, no shared memory and no
// reduction, a grid-stride loop over N * H / 8 with at most 8 blocks of 256
// threads per SM (ops/gru_cell.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;

enum Form { kAct = 0, kCarry = 1 };

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the top half of its f32
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 u;
  u.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  u.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  u.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
  u.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = u;
}

// x rounded to T, as a PyTorch op with outputs in T stores it
template <typename T>
struct Round {
  __device__ static __forceinline__ float of(float x) { return x; }
};
template <>
struct Round<__nv_bfloat16> {
  __device__ static __forceinline__ float of(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// The forward's values at its rounding points (R: the acting form's
// rounding to T, the identity in the carry form's f32).
struct Gates {
  float hd, r, z, an, n, omz;
};

template <typename R>
__device__ __forceinline__ Gates gates(float h, float xr, float xz, float xn,
                                       float ar, float az, float an) {
  Gates g;
  g.hd = R::of(h);
  g.r = R::of(sigmoid(R::of(__fadd_rn(xr, ar))));
  g.z = R::of(sigmoid(R::of(__fadd_rn(xz, az))));
  g.an = an;
  const float p = R::of(__fmul_rn(g.r, an));
  g.n = R::of(tanhf(R::of(__fadd_rn(xn, p))));
  g.omz = R::of(__fsub_rn(1.0f, g.z));
  return g;
}

template <typename R>
__device__ __forceinline__ float new_state(const Gates& g) {
  return R::of(__fadd_rn(R::of(__fmul_rn(g.omz, g.n)),
                         R::of(__fmul_rn(g.z, g.hd))));
}

// The row and the column of vector v's first value (32-bit division where
// it suffices).
__device__ __forceinline__ void row_col(long long v, long long vecs, int wvec,
                                        long long* row, int* col) {
  if (vecs <= 0xFFFFFFFFLL) {
    const unsigned q = (unsigned)v / (unsigned)wvec;
    *row = q;
    *col = (int)((unsigned)v - q * (unsigned)wvec) * kVec;
  } else {
    *row = v / wvec;
    *col = (int)(v - *row * wvec) * kVec;
  }
}

template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads)
    gru_cell_kernel(long long vecs, int width, const float* __restrict__ h,
                    const T* __restrict__ xr, const T* __restrict__ xz,
                    const T* __restrict__ xn, const T* __restrict__ ar,
                    const T* __restrict__ az, const T* __restrict__ an,
                    const float* __restrict__ bias,
                    const unsigned char* __restrict__ keep,
                    float* __restrict__ out, float* __restrict__ out_state,
                    T* __restrict__ out_dt) {
  using R = typename std::conditional<kForm == kAct, Round<T>,
                                      Round<float>>::type;
  const int wvec = width / kVec;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < vecs;
       v += step) {
    const long long e = v * kVec;
    float fh[kVec], fxr[kVec], fxz[kVec], fxn[kVec], fsr[kVec], fsz[kVec],
        fsn[kVec];
    load8(h + e, fh);
    load8(xr + e, fxr);
    load8(xz + e, fxz);
    load8(xn + e, fxn);
    load8(ar + e, fsr);
    load8(az + e, fsz);
    load8(an + e, fsn);
    bool kept = true;
    if (kForm == kCarry) {
      long long row;
      int col;
      row_col(v, vecs, wvec, &row, &col);
      float fb[kVec];
      load8(bias + col, fb);
#pragma unroll
      for (int i = 0; i < kVec; ++i) fsn[i] = __fadd_rn(fsn[i], fb[i]);
      kept = keep == nullptr || keep[row] != 0;
    }
    float o[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      o[i] = new_state<R>(gates<R>(fh[i], fxr[i], fxz[i], fxn[i], fsr[i],
                                   fsz[i], fsn[i]));
    }
    if (kForm == kAct) {
      store8(out + e, o);
    } else {
      store8(out_state + e, o);
      if (!kept) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) o[i] = 0.0f;
      }
      store8(out + e, o);
      store8(out_dt + e, o);
    }
  }
}

// The carry form's gradient of the carry in T is g_dt; every other
// incoming gradient is f32.
template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads)
    gru_cell_backward_kernel(
        long long vecs, int width, const float* __restrict__ h,
        const T* __restrict__ xr, const T* __restrict__ xz,
        const T* __restrict__ xn, const T* __restrict__ ar,
        const T* __restrict__ az, const T* __restrict__ an,
        const float* __restrict__ bias, const unsigned char* __restrict__ keep,
        const float* __restrict__ g, const float* __restrict__ g_out,
        const T* __restrict__ g_dt, T* __restrict__ gr, T* __restrict__ gz,
        T* __restrict__ gn, T* __restrict__ ghn, float* __restrict__ gh,
        float* __restrict__ ghn32) {
  using R = typename std::conditional<kForm == kAct, Round<T>,
                                      Round<float>>::type;
  const int wvec = width / kVec;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < vecs;
       v += step) {
    const long long e = v * kVec;
    float fh[kVec], fxr[kVec], fxz[kVec], fxn[kVec], fsr[kVec], fsz[kVec],
        fsn[kVec], fg[kVec];
    load8(h + e, fh);
    load8(xr + e, fxr);
    load8(xz + e, fxz);
    load8(xn + e, fxn);
    load8(ar + e, fsr);
    load8(az + e, fsz);
    load8(an + e, fsn);
    if (kForm == kAct) {
      load8(g + e, fg);
    } else {
      long long row;
      int col;
      row_col(v, vecs, wvec, &row, &col);
      float fb[kVec], t[kVec];
      load8(bias + col, fb);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        fsn[i] = __fadd_rn(fsn[i], fb[i]);
        fg[i] = 0.0f;
      }
      // the carry's gradient: from the next step's cell and, through the
      // carry in T, from its matmuls; the reset passes it where kept
      if (keep == nullptr || keep[row] != 0) {
        if (g != nullptr) {
          load8(g + e, t);
#pragma unroll
          for (int i = 0; i < kVec; ++i) fg[i] = t[i];
        }
        if (g_dt != nullptr) {
          load8(g_dt + e, t);
#pragma unroll
          for (int i = 0; i < kVec; ++i) fg[i] = __fadd_rn(fg[i], t[i]);
        }
      }
      if (g_out != nullptr) {
        load8(g_out + e, t);
#pragma unroll
        for (int i = 0; i < kVec; ++i) fg[i] = __fadd_rn(t[i], fg[i]);
      }
    }
    float o_r[kVec], o_z[kVec], o_n[kVec], o_hn[kVec], o_h[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const Gates s = gates<R>(fh[i], fxr[i], fxz[i], fxn[i], fsr[i], fsz[i],
                               fsn[i]);
      const float d = fg[i];
      // h' = omz * n + z * hd
      const float d_n = __fmul_rn(d, s.omz);
      const float d_z = __fsub_rn(__fmul_rn(d, s.hd), __fmul_rn(d, s.n));
      o_h[i] = __fmul_rn(d, s.z);
      // n = tanh(xn + r * an); r, z = sigmoid(.)
      const float d_sn = __fmul_rn(d_n, __fsub_rn(1.0f, __fmul_rn(s.n, s.n)));
      const float d_r = __fmul_rn(d_sn, s.an);
      o_hn[i] = __fmul_rn(d_sn, s.r);
      o_n[i] = d_sn;
      o_r[i] = __fmul_rn(__fmul_rn(d_r, __fsub_rn(1.0f, s.r)), s.r);
      o_z[i] = __fmul_rn(__fmul_rn(d_z, __fsub_rn(1.0f, s.z)), s.z);
    }
    store8(gr + e, o_r);
    store8(gz + e, o_z);
    store8(gn + e, o_n);
    store8(ghn + e, o_hn);
    store8(gh + e, o_h);
    if (kForm == kCarry && ghn32 != nullptr) store8(ghn32 + e, o_hn);
  }
}

bool aligned(const void* p) {
  return ((unsigned long long)p & 15ull) == 0;
}

template <typename T, int kForm>
int launch_forward(long long rows, int width, const float* h, const void* xr,
                   const void* xz, const void* xn, const void* ar,
                   const void* az, const void* an, const float* bias,
                   const unsigned char* keep, float* out, float* out_state,
                   void* out_dt, int blocks, cudaStream_t s) {
  gru_cell_kernel<T, kForm><<<blocks, kThreads, 0, s>>>(
      rows * (width / kVec), width, h, static_cast<const T*>(xr),
      static_cast<const T*>(xz), static_cast<const T*>(xn),
      static_cast<const T*>(ar), static_cast<const T*>(az),
      static_cast<const T*>(an), bias, keep, out, out_state,
      static_cast<T*>(out_dt));
  return (int)cudaGetLastError();
}

template <typename T, int kForm>
int launch_backward(long long rows, int width, const float* h, const void* xr,
                    const void* xz, const void* xn, const void* ar,
                    const void* az, const void* an, const float* bias,
                    const unsigned char* keep, const float* g,
                    const float* g_out, const void* g_dt, void* gr, void* gz,
                    void* gn, void* ghn, float* gh, float* ghn32, int blocks,
                    cudaStream_t s) {
  gru_cell_backward_kernel<T, kForm><<<blocks, kThreads, 0, s>>>(
      rows * (width / kVec), width, h, static_cast<const T*>(xr),
      static_cast<const T*>(xz), static_cast<const T*>(xn),
      static_cast<const T*>(ar), static_cast<const T*>(az),
      static_cast<const T*>(an), bias, keep, g, g_out,
      static_cast<const T*>(g_dt), static_cast<T*>(gr), static_cast<T*>(gz),
      static_cast<T*>(gn), static_cast<T*>(ghn), gh, ghn32);
  return (int)cudaGetLastError();
}

}  // namespace

// form: kAct or kCarry; bf16: T is __nv_bfloat16 (else float).  Acting
// form: out = h' (f32).  Carry form: out = the carry (f32), out_state = h'
// (f32), out_dt = the carry in T; bias = hn's f32 bias [width], keep = one
// bool per row or null.  Every pointer but keep 16-byte aligned, every
// [rows, width] operand contiguous, width % 8 == 0.
extern "C" int magent_gru_cell(int form, int bf16, long long rows, int width,
                               const float* h, const void* xr, const void* xz,
                               const void* xn, const void* ar, const void* az,
                               const void* an, const float* bias,
                               const unsigned char* keep, float* out,
                               float* out_state, void* out_dt, int blocks,
                               int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (rows <= 0) return (int)cudaSuccess;
  if (width <= 0 || width % kVec != 0 || blocks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ptrs[] = {h, xr, xz, xn, ar, az, an, out};
  for (const void* p : ptrs) {
    if (p == nullptr || !aligned(p)) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  using BF = __nv_bfloat16;
  if (form == kAct) {
    if (bf16) {
      return launch_forward<BF, kAct>(rows, width, h, xr, xz, xn, ar, az, an,
                                      nullptr, nullptr, out, nullptr, nullptr,
                                      blocks, s);
    }
    return launch_forward<float, kAct>(rows, width, h, xr, xz, xn, ar, az, an,
                                       nullptr, nullptr, out, nullptr, nullptr,
                                       blocks, s);
  }
  if (form != kCarry || bias == nullptr || !aligned(bias) ||
      out_state == nullptr || !aligned(out_state) || out_dt == nullptr ||
      !aligned(out_dt)) {
    return (int)cudaErrorInvalidValue;
  }
  if (bf16) {
    return launch_forward<BF, kCarry>(rows, width, h, xr, xz, xn, ar, az, an,
                                      bias, keep, out, out_state, out_dt,
                                      blocks, s);
  }
  return launch_forward<float, kCarry>(rows, width, h, xr, xz, xn, ar, az, an,
                                       bias, keep, out, out_state, out_dt,
                                       blocks, s);
}

// The backward of magent_gru_cell's form on the same operands.  Acting form:
// g = the gradient of h' (f32).  Carry form: g = the carry's (f32), g_out =
// h''s (f32), g_dt = the carry in T's, each null when absent; ghn32 = hn's
// gradient in f32, or null.  Writes gr, gz, gn, ghn in T and gh in f32.
extern "C" int magent_gru_cell_backward(
    int form, int bf16, long long rows, int width, const float* h,
    const void* xr, const void* xz, const void* xn, const void* ar,
    const void* az, const void* an, const float* bias,
    const unsigned char* keep, const float* g, const float* g_out,
    const void* g_dt, void* gr, void* gz, void* gn, void* ghn, float* gh,
    float* ghn32, int blocks, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (rows <= 0) return (int)cudaSuccess;
  if (width <= 0 || width % kVec != 0 || blocks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ptrs[] = {h, xr, xz, xn, ar, az, an, gr, gz, gn, ghn, gh};
  for (const void* p : ptrs) {
    if (p == nullptr || !aligned(p)) return (int)cudaErrorInvalidValue;
  }
  const void* optional[] = {g, g_out, g_dt, ghn32};
  for (const void* p : optional) {
    if (p != nullptr && !aligned(p)) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  using BF = __nv_bfloat16;
  if (form == kAct) {
    if (g == nullptr) return (int)cudaErrorInvalidValue;
    if (bf16) {
      return launch_backward<BF, kAct>(rows, width, h, xr, xz, xn, ar, az, an,
                                       nullptr, nullptr, g, nullptr, nullptr,
                                       gr, gz, gn, ghn, gh, nullptr, blocks,
                                       s);
    }
    return launch_backward<float, kAct>(rows, width, h, xr, xz, xn, ar, az,
                                        an, nullptr, nullptr, g, nullptr,
                                        nullptr, gr, gz, gn, ghn, gh, nullptr,
                                        blocks, s);
  }
  if (form != kCarry || bias == nullptr || !aligned(bias)) {
    return (int)cudaErrorInvalidValue;
  }
  if (bf16) {
    return launch_backward<BF, kCarry>(rows, width, h, xr, xz, xn, ar, az, an,
                                       bias, keep, g, g_out, g_dt, gr, gz, gn,
                                       ghn, gh, ghn32, blocks, s);
  }
  return launch_backward<float, kCarry>(rows, width, h, xr, xz, xn, ar, az,
                                        an, bias, keep, g, g_out, g_dt, gr, gz,
                                        gn, ghn, gh, ghn32, blocks, s);
}
