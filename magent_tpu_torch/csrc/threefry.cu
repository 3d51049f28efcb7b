// Threefry-2x32 (20 rounds) for sm_90a, behind a plain C interface (loaded
// with ctypes by magent_tpu_torch/ops/_build.py): each public draw of
// magent_tpu_torch/random.py on a CUDA key is one launch of this kernel.
//
// Replaces no TPU kernel: the JAX package draws with jax.random, which XLA
// fuses into the programs around it.  The port's plain version
// (random.py threefry2x32 and the draws around it) runs the rounds as int64
// tensor ops on uint32 words, ~175 eager launches per threefry call; this
// kernel gives the same words, bit for bit.
//
// Keys are int64 rows [..., 2] holding uint32 words, read at a row stride
// (a key taken as a slice of split's output needs no copy).  The draw's
// flat index t covers rows x count counters: row = t / count, counter n =
// t - row * count, and each row draws its own stream, as jax.vmap over
// single keys would.  The mode selects the tail:
//
//   kWords    split / fold_in: counter (0, base + n); both words, int64,
//             to out[t] = {x0, x1} ([..., num, 2] and [..., 2])
//   kBits     counter (n >> 32, n & 0xFFFFFFFF); x0 ^ x1, int64
//   kUniform  the bits' top 23 in a float's mantissa in [1, 2), minus 1;
//             outside [0, 1) scaled as random.py uniform scales: the float32
//             product, exact in double, plus lo in double, one rounding to
//             float32, then max(., lo)
//   kRandint  the row's two halves of split(key) (counters (0, 0), (0, 1)),
//             hi and lo bits from them at n, and randint's wrap-around
//             arithmetic: ((hi % span) * mult + lo % span) % span + minval,
//             every product and sum mod 2**32; mult from the host
//
// What bounds it: integer operations, ~80 per threefry evaluation (20 adds,
// 20 funnel-shift rotations and 20 xors in the rounds, ~17 in the key
// schedule and injections), one evaluation per counter (kRandint two, and
// two per row for its subkeys); the bytes written are 4 or 8 per counter
// (16 for kWords).  Design: one thread per counter in a grid-stride loop
// over at most 8 blocks of 256 threads per SM (ops/threefry.py); a thread
// re-reads its key row (and re-derives randint's subkeys) only when its row
// changes.  A draw of a few keys is one block.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kParity = 0x1BD11BDAu;

enum Mode { kWords = 0, kBits = 1, kUniform = 2, kRandint = 3 };

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return __funnelshift_l(x, x, r);
}

#define MAGENT_MIX(r) \
  x0 += x1;           \
  x1 = rotl(x1, r) ^ x0;
#define MAGENT_EVEN MAGENT_MIX(13) MAGENT_MIX(15) MAGENT_MIX(26) MAGENT_MIX(6)
#define MAGENT_ODD MAGENT_MIX(17) MAGENT_MIX(29) MAGENT_MIX(16) MAGENT_MIX(24)

// random.py threefry2x32: the key schedule (k0, k1, k0 ^ k1 ^ parity),
// five groups of four rounds, each followed by a key injection
__device__ __forceinline__ uint2 threefry(uint2 k, unsigned x0, unsigned x1) {
  const unsigned k2 = k.x ^ k.y ^ kParity;
  x0 += k.x;
  x1 += k.y;
  MAGENT_EVEN x0 += k.y; x1 += k2 + 1u;
  MAGENT_ODD  x0 += k2;  x1 += k.x + 2u;
  MAGENT_EVEN x0 += k.x; x1 += k.y + 3u;
  MAGENT_ODD  x0 += k.y; x1 += k2 + 4u;
  MAGENT_EVEN x0 += k2;  x1 += k.x + 5u;
  return make_uint2(x0, x1);
}

#undef MAGENT_ODD
#undef MAGENT_EVEN
#undef MAGENT_MIX

__device__ __forceinline__ unsigned bits_at(uint2 k, long long n) {
  const uint2 r = threefry(k, (unsigned)((unsigned long long)n >> 32),
                           (unsigned)n);
  return r.x ^ r.y;
}

struct Tail {
  unsigned base, span, mult;
  int minval, scaled;
  float lo, scale;
};

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(const long long* __restrict__ key, long long stride,
                    long long count, long long total, Tail tail,
                    void* __restrict__ out) {
  long long last = -1;
  uint2 k = make_uint2(0u, 0u), khi = k, klo = k;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
       t < total; t += step) {
    long long row;
    if (total <= 0xFFFFFFFFLL) {  // 32-bit division where it suffices
      row = (unsigned)t / (unsigned)count;
    } else {
      row = t / count;
    }
    const long long n = t - row * count;
    if (row != last) {
      last = row;
      k = make_uint2((unsigned)key[row * stride],
                     (unsigned)key[row * stride + 1]);
      if (kMode == kRandint) {
        khi = threefry(k, 0u, 0u);
        klo = threefry(k, 0u, 1u);
      }
    }
    if (kMode == kWords) {
      const uint2 r = threefry(k, 0u, tail.base + (unsigned)n);
      reinterpret_cast<longlong2*>(out)[t] =
          make_longlong2((long long)r.x, (long long)r.y);
    } else if (kMode == kBits) {
      static_cast<long long*>(out)[t] = (long long)bits_at(k, n);
    } else if (kMode == kUniform) {
      float f = __uint_as_float((bits_at(k, n) >> 9) | 0x3F800000u) - 1.0f;
      if (tail.scaled) {
        const double s = __dadd_rn(__dmul_rn((double)f, (double)tail.scale),
                                   (double)tail.lo);
        const float v = __double2float_rn(s);
        f = v < tail.lo ? tail.lo : v;
      }
      static_cast<float*>(out)[t] = f;
    } else {
      const unsigned hi = bits_at(khi, n), lo = bits_at(klo, n);
      unsigned off = (hi % tail.span) * tail.mult;
      off = (off + lo % tail.span) % tail.span;
      static_cast<int*>(out)[t] = (int)(off + (unsigned)tail.minval);
    }
  }
}

}  // namespace

extern "C" int magent_threefry(const long long* key, long long stride,
                               long long count, long long total, int mode,
                               unsigned base, unsigned span, unsigned mult,
                               int minval, float lo, float scale, int scaled,
                               int blocks, void* out, int device,
                               void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (total <= 0) return (int)cudaSuccess;
  if (count <= 0 || blocks <= 0 || (mode == kRandint && span == 0u))
    return (int)cudaErrorInvalidValue;
  const Tail tail{base, span, mult, minval, scaled, lo, scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kWords:
      threefry_kernel<kWords><<<blocks, kThreads, 0, s>>>(key, stride, count,
                                                          total, tail, out);
      break;
    case kBits:
      threefry_kernel<kBits><<<blocks, kThreads, 0, s>>>(key, stride, count,
                                                         total, tail, out);
      break;
    case kUniform:
      threefry_kernel<kUniform><<<blocks, kThreads, 0, s>>>(
          key, stride, count, total, tail, out);
      break;
    case kRandint:
      threefry_kernel<kRandint><<<blocks, kThreads, 0, s>>>(
          key, stride, count, total, tail, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
