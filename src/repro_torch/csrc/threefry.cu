// threefry2x32 draws for NVIDIA Hopper (sm_90a): the port's random numbers.
//
// Replaces no Pallas kernel.  The JAX package draws through jax.random,
// which XLA lowers to threefry2x32 over the counters; the port reproduced it
// word for word as int64 torch ops (repro_torch/random.py), about 170
// elementwise kernels a draw, each reading and writing 8-byte words.  This
// kernel takes their place on the card: one launch hashes a draw's counter
// range under each of K keys and writes the requested draw directly.
//
// What it computes, in JAX's partitionable layout: element i of a draw that
// starts at counter `start` hashes the 64-bit counter start + i, its high
// word and its low word, under the key (k0, k1); with y0, y1 the two output
// words (20 rounds, rotations 13 15 26 6 / 17 29 16 24, a key injection
// every 4 rounds) the kind selects:
//
//   pairs      y0, y1 as two int64 words (split's new keys)
//   bits       y0 ^ y1 as an int32 word (the unsigned bits, same 32 bits)
//   uniform    f = (b >> 9) * 2^-23, then max(lo, f * span + lo) in float32,
//              span a power of two (the product is exact, the add rounds)
//   normal     Giles' erfinv of the uniform on (nextafter(-1, 0), 1), times
//              sqrt(2), in the order random.py's torch ops take
//   bernoulli  uniform on [0, 1) < p, as a byte
//
// The float maps use the _rn intrinsics, which nvcc does not contract into
// FMAs, so each step rounds as the separate torch kernels do; log1pf and
// sqrtf are the IEEE library functions (no fast math).
//
// Bound: the integer ALU's instruction rate.  A counter costs about 73 int32
// instructions (2 + 20 x (add, funnel-shift rotate, xor) + 5 x 2 key adds
// and the final xor) and writes 4 bytes.  The 20 rotations (SHF) and 21
// xors (LOP3) run only on the integer ALU pipe, 64 results a clock an SM:
// ~16.7 T a second on the H100 SXM (132 SMs x 1.98 GHz), 2.5 ns a thousand
// counters, against 1.2 ns for the 4-byte writes at 3.35 TB/s.  nvcc
// emits most of the 32 adds as IMAD on the FMA pipe, beside the ALU's
// work: the hash, not the memory, sets the pace.
//
// Design: everything in uint32 registers, with no masking (the words wrap
// as unsigned 32-bit values do) and __funnelshift_l for each rotation (one
// SHF).  A thread hashes 4 consecutive counters (four independent chains
// keep the integer pipes fed) and stores them as one 16-byte vector (4 bytes
// for bernoulli); the row's few counters before the first aligned group and
// after the last are written one by one.  The key words are read once per
// block from device memory (a captured CUDA graph replays under whatever
// key the buffer holds); blockIdx.y strides over the K keys, so a vmapped
// draw over clients is one launch.  No shared memory; the grid is sized to
// about 16 blocks of 256 threads an SM over all keys and strides over the
// rest.  The kernel allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Kind : int { kPairs = 0, kBits = 1, kUniform = 2, kNormal = 3,
                  kBernoulli = 4 };

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;
constexpr int kVec = 4;                       // counters a thread's group
constexpr unsigned int kMaxGridY = 65535;

struct Key {
  uint32_t k0, k1, k2;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32, 20 rounds, of the counter c under key.
__device__ __forceinline__ void hash(const Key& key, uint64_t c, uint32_t& y0,
                                     uint32_t& y1) {
  uint32_t x0 = static_cast<uint32_t>(c >> 32) + key.k0;
  uint32_t x1 = static_cast<uint32_t>(c) + key.k1;
#define TF_ROUND(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
#define TF_EVEN TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ODD TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_EVEN x0 += key.k1; x1 += key.k2 + 1u;
  TF_ODD  x0 += key.k2; x1 += key.k0 + 2u;
  TF_EVEN x0 += key.k0; x1 += key.k1 + 3u;
  TF_ODD  x0 += key.k1; x1 += key.k2 + 4u;
  TF_EVEN x0 += key.k2; x1 += key.k0 + 5u;
#undef TF_ODD
#undef TF_EVEN
#undef TF_ROUND
  y0 = x0;
  y1 = x1;
}

// Uniform from bits b: the float in [1, 2) with mantissa b >> 9, less 1
// (exact), times the span (exact: a power of two), plus lo (one rounding),
// then max(lo, .) as torch.maximum takes it on the card.
__device__ __forceinline__ float uniform(uint32_t b, float lo, float span) {
  const float f = __fmul_rn(__uint2float_rn(b >> 9), 1.0f / 8388608.0f);
  return fmaxf(lo, __fadd_rn(__fmul_rn(f, span), lo));
}

// Giles' single-precision erfinv as random._erfinv takes it on the card:
// w = -log1p(x * -x); below 5, p(w - 2.5), else p(sqrt(w) - 3), Horner's
// rule with one rounding a product and one a sum; the coefficients are
// the float64 constants rounded to float32, as torch.where makes them.
__device__ __forceinline__ float normal_of(float x) {
  const float w = -log1pf(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  const float t = lt ? __fadd_rn(w, -2.5f) : __fadd_rn(sqrtf(w), -3.0f);
#define TF_C(a, b) (lt ? static_cast<float>(a) : static_cast<float>(b))
  float p = TF_C(2.81022636e-08, -0.000200214257);
  p = __fadd_rn(TF_C(3.43273939e-07, 0.000100950558), __fmul_rn(p, t));
  p = __fadd_rn(TF_C(-3.5233877e-06, 0.00134934322), __fmul_rn(p, t));
  p = __fadd_rn(TF_C(-4.39150654e-06, -0.00367342844), __fmul_rn(p, t));
  p = __fadd_rn(TF_C(0.00021858087, 0.00573950773), __fmul_rn(p, t));
  p = __fadd_rn(TF_C(-0.00125372503, -0.0076224613), __fmul_rn(p, t));
  p = __fadd_rn(TF_C(-0.00417768164, 0.00943887047), __fmul_rn(p, t));
  p = __fadd_rn(TF_C(0.246640727, 1.00167406), __fmul_rn(p, t));
  p = __fadd_rn(TF_C(1.50140941, 2.83297682), __fmul_rn(p, t));
#undef TF_C
  const float e = fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7f800000))
                                   : __fmul_rn(p, x);
  return __fmul_rn(e, static_cast<float>(1.4142135623730951));
}

struct Params {
  float lo, span, p;
};

template <int KIND>
struct Out {
  using T = float;
};
template <> struct Out<kPairs> { using T = longlong2; };
template <> struct Out<kBits> { using T = uint32_t; };
template <> struct Out<kBernoulli> { using T = uint8_t; };

template <int KIND>
__device__ __forceinline__ typename Out<KIND>::T draw(const Key& key,
                                                      uint64_t c,
                                                      const Params& q) {
  uint32_t y0, y1;
  hash(key, c, y0, y1);
  if constexpr (KIND == kPairs) {
    return make_longlong2(static_cast<long long>(y0),
                          static_cast<long long>(y1));
  } else if constexpr (KIND == kBits) {
    return y0 ^ y1;
  } else if constexpr (KIND == kUniform) {
    return uniform(y0 ^ y1, q.lo, q.span);
  } else if constexpr (KIND == kNormal) {
    return normal_of(uniform(y0 ^ y1, q.lo, q.span));
  } else {
    return uniform(y0 ^ y1, q.lo, q.span) < q.p ? 1 : 0;
  }
}

template <typename T>
struct Vec4 {
  T v[kVec];
};

__device__ __forceinline__ uint32_t word(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t word(uint32_t x) { return x; }

// One group's outputs in one store: 16 bytes of 4-byte words, 4 bytes of
// bytes; pairs are already 16 bytes each.
template <typename T>
__device__ __forceinline__ void store4(T* dst, const Vec4<T>& x) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(word(x.v[0]), word(x.v[1]), word(x.v[2]), word(x.v[3]));
  } else if constexpr (sizeof(T) == 1) {
    *reinterpret_cast<uint32_t*>(dst) =
        static_cast<uint32_t>(x.v[0]) | static_cast<uint32_t>(x.v[1]) << 8 |
        static_cast<uint32_t>(x.v[2]) << 16 |
        static_cast<uint32_t>(x.v[3]) << 24;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[j] = x.v[j];
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const long long* __restrict__ keys, int64_t K, uint64_t start,
                int64_t n, Params q, void* __restrict__ out) {
  using T = typename Out<KIND>::T;
  constexpr int64_t kAlign = sizeof(T) * kVec > 16 ? 16 : sizeof(T) * kVec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int64_t k = blockIdx.y; k < K; k += gridDim.y) {
    Key key;
    key.k0 = static_cast<uint32_t>(keys[2 * k]);
    key.k1 = static_cast<uint32_t>(keys[2 * k + 1]);
    key.k2 = key.k0 ^ key.k1 ^ 0x1BD11BDAu;
    T* row = static_cast<T*>(out) + k * n;
    // counters before the first kAlign-aligned group of the row
    const int64_t mis = static_cast<int64_t>(
        reinterpret_cast<uintptr_t>(row) % kAlign / sizeof(T));
    const int64_t to_align = mis == 0 ? 0 : kAlign / sizeof(T) - mis;
    const int64_t head = to_align < n ? to_align : n;
    const int64_t groups = (n - head) / kVec;
    const uint64_t first = start + static_cast<uint64_t>(head);
    for (int64_t g = tid; g < groups; g += stride) {
      const uint64_t c = first + static_cast<uint64_t>(g) * kVec;
      Vec4<T> x;
#pragma unroll
      for (int j = 0; j < kVec; ++j) x.v[j] = draw<KIND>(key, c + j, q);
      store4(row + head + g * kVec, x);
    }
    // the head and the tail (fewer than kVec each), by block 0's threads
    if (blockIdx.x == 0) {
      const int64_t tail = head + groups * kVec;
      const int64_t t = threadIdx.x;
      if (t < head) row[t] = draw<KIND>(key, start + t, q);
      if (t < n - tail) row[tail + t] = draw<KIND>(key, start + tail + t, q);
    }
  }
}

template <int KIND>
void launch(const long long* keys, int64_t K, uint64_t start, int64_t n,
            Params q, void* out, int sms, cudaStream_t stream) {
  const int64_t groups = n / kVec + 1;
  int64_t per_row = (groups + kThreads - 1) / kThreads;
  const int64_t gy = K < kMaxGridY ? K : kMaxGridY;
  int64_t cap = (static_cast<int64_t>(sms) * kBlocksPerSm + gy - 1) / gy;
  if (cap < 1) cap = 1;
  if (per_row > cap) per_row = cap;
  dim3 grid(static_cast<unsigned int>(per_row), static_cast<unsigned int>(gy));
  threefry_kernel<KIND><<<grid, kThreads, 0, stream>>>(keys, K, start, n, q,
                                                       out);
}

}  // namespace

// C entry point, loaded with ctypes.  keys: K x 2 int64 words on the device
// (the low 32 bits of each are the key word); out: K x n outputs of the
// kind (K x n x 2 int64 for pairs, int32 for bits, float32 for uniform and
// normal, a byte for bernoulli), contiguous.  lo and span: the uniform's
// float32 low end and span (a power of two); p: bernoulli's float32
// probability.  sms: the card's SM count.  Returns cudaGetLastError()
// after the launch (non-zero means the launch was refused); an unknown
// kind returns cudaErrorInvalidValue.
extern "C" int threefry_draw(const void* keys, long long K,
                             unsigned long long start, long long n, int kind,
                             float lo, float span, float p, void* out, int sms,
                             void* stream) {
  if (K <= 0 || n <= 0) return 0;
  const Params q{lo, span, p};
  const auto* k = static_cast<const long long*>(keys);
  auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kPairs: launch<kPairs>(k, K, start, n, q, out, sms, s); break;
    case kBits: launch<kBits>(k, K, start, n, q, out, sms, s); break;
    case kUniform: launch<kUniform>(k, K, start, n, q, out, sms, s); break;
    case kNormal: launch<kNormal>(k, K, start, n, q, out, sms, s); break;
    case kBernoulli: launch<kBernoulli>(k, K, start, n, q, out, sms, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
