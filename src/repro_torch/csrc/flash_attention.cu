// Flash attention forward (GQA; causal, sliding window, per-row valid
// length) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas.
// For every batch row b, query head h and query i (absolute position
// q_offset + i), with KV head h / rep:
//
//   s_j = (q_i . k_j) * scale                    for keys j that are valid:
//         j < min(Sk, kv_len[b]),  and j <= q_offset + i if causal,
//         and j > q_offset + i - window if a window is given
//   o_i = sum_j softmax(s)_j v_j                 (fp32 throughout)
//
// Masked scores take the finite value -1e30, as in the reference, so a tile
// in which a row has no valid key adds terms that the next valid key's
// correction factor exp(-1e30 - m) wipes out.  A query row with no valid key
// at all (never on the serving path) is left undefined.
//
// Bound, on the H100 SXM.  OLMo-1B prefill (B 4, S 1024, H 16, hd 128,
// causal, bf16): 4*B*H*hd*S(S+1)/2 = 17.2 GFLOP a layer, 17.4 us at the
// 989 TFLOP/s of the bf16 tensor cores, against 67.1 MB of q, k, v and o,
// 20.0 us at 3.35 TB/s: about 20 us a layer, bytes-bound at the
// tensor-core rate.  This kernel runs on the CUDA cores (67 TFLOP/s fp32),
// so its own floor is about 0.26 ms a layer and it is bound by operations.
// Decode (one query against a cache of ~1055 positions): the K/V read, about
// 34.6 MB a layer, 10.3 us; there it is bound by bytes and by the few blocks
// (B*H = 64) that share the card.
//
// Design, simple first (wgmma and TMA come later):
// - one block of 256 threads per (query tile, head, batch row); the tile is
//   64 queries, or 16 when Sq <= 16 (decode);
// - the block loops over tiles of 64 keys, staged in shared memory as fp32
//   (dynamic shared memory, ~118 KB at hd 128), with an online softmax in
//   fp32 registers: each thread owns BQ/16 query rows and 4 keys of the
//   score tile and BQ/16 rows x hd/16 columns of the output accumulator;
//   row maxima and sums are reduced across the 16 lanes of a half-warp;
// - key tiles that no query of the tile can see (past kv_len, past the
//   causal diagonal, before the window) are skipped, so causal prefill does
//   about half the work and decode reads only the valid prefix of the cache;
// - q, k and v are read in the (B, S, heads, hd) layout through strides, with
//   16-byte loads where the base and strides allow, so nothing is padded or
//   transposed; ragged Sq and Sk are masked here;
// - the kv_len array is read on the device (no host sync); a null pointer
//   means one length for every row.
// The kernel allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // 16 x 16
constexpr int kBK = 64;             // keys per shared-memory tile
constexpr int kLDP = kBK + 16;      // row stride of the probability tile
constexpr float kNegInf = -1e30f;   // the reference's finite mask value

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_len;                // (B,) on the device, or null
  int kv_len_all;                   // the length for every row when null
  int Sq, Sk, H, rep;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, window;               // window <= 0: none
  int64_t q_offset;
  float scale;
  int q_vec, k_vec, v_vec;          // 16-byte loads allowed
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Stage rows [0, nrows) of a (ROWS, HD) slice (row stride `stride` elements,
// last dimension contiguous) into dst as fp32 with row stride LD; rows
// [nrows, ROWS) become zero.
template <int HD, int ROWS, int LD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t stride,
                                      int nrows, bool vec) {
  if (vec) {
    constexpr int N = 16 / sizeof(T);
    constexpr int CH = HD / N;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
      const int r = idx / CH;
      const int c = (idx - r * CH) * N;
      float x[N];
      if (r < nrows) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < N; ++i) x[i] = to_float(e[i]);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) x[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < N; i += 4)
        *reinterpret_cast<float4*>(dst + r * LD + c + i) =
            make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * HD; idx += kThreads) {
      const int r = idx / HD;
      const int c = idx - r * HD;
      dst[r * LD + c] = r < nrows ? to_float(src[r * stride + c]) : 0.0f;
    }
  }
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD, int BQ>
constexpr int smem_bytes() {
  return (BQ * (HD + 4) + kBK * (HD + 4) + kBK * HD + BQ * kLDP) *
         static_cast<int>(sizeof(float));
}

template <int HD, int BQ, typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  constexpr int RM = BQ / 16;       // query rows per thread
  constexpr int RN = kBK / 16;      // keys per thread
  constexpr int CN = HD / 16;       // output columns per thread
  constexpr int LDQ = HD + 4;       // +4: conflict-free 16-byte reads
  constexpr int LDK = HD + 4;
  constexpr int LDV = HD;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + BQ * LDQ;
  float* vs = ks + kBK * LDK;
  float* ps = vs + kBK * LDV;

  const int tx = threadIdx.x & 15;  // key / output column lane
  const int ty = threadIdx.x >> 4;  // query row group
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nq = min(BQ, p.Sq - q0);
  const TQ* q = static_cast<const TQ*>(p.q) + b * p.q_sb + h * p.q_sh +
                q0 * p.q_ss;
  const TKV* k = static_cast<const TKV*>(p.k) + b * p.k_sb +
                 (h / p.rep) * p.k_sh;
  const TKV* v = static_cast<const TKV*>(p.v) + b * p.v_sb +
                 (h / p.rep) * p.v_sh;

  // the keys some query of this tile can see: [lo, hi)
  const int64_t kv_valid = min64(
      p.Sk, p.kv_len != nullptr ? p.kv_len[b] : p.kv_len_all);
  const int64_t first_q = p.q_offset + q0;
  int64_t hi = kv_valid;
  if (p.causal) hi = min64(hi, first_q + nq);
  int64_t lo = 0;
  if (p.window > 0) lo = max64(lo, first_q - p.window + 1);
  lo = lo / kBK * kBK;

  stage<HD, BQ, LDQ>(qs, q, p.q_ss, nq, p.q_vec);

  float m[RM], l[RM], acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.0f;
  }

  for (int64_t k0 = lo; k0 < hi; k0 += kBK) {
    const int nk = static_cast<int>(min64(kBK, p.Sk - k0));
    __syncthreads();                // the last tile's readers are done
    stage<HD, kBK, LDK>(ks, k + k0 * p.k_ss, p.k_ss, nk, p.k_vec);
    stage<HD, kBK, LDV>(vs, v + k0 * p.v_ss, p.v_ss, nk, p.v_vec);
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; d += 4) {
      float4 a[RM], c[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < RN; ++j)
        c[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LDK + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

    // mask, online softmax, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int64_t qpos = first_q + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int64_t kpos = k0 + tx + 16 * j;
        bool ok = kpos < kv_valid;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < RN; ++j)
        ps[(ty + 16 * i) * kLDP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P V: rows ty + 16 i, columns tx + 16 c
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pr[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pr[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kLDP + j);
      float vv[4][CN];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < CN; ++c) vv[jj][c] = vs[(j + jj) * LDV + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          acc[i][c] = fmaf(pr[i].x, vv[0][c], acc[i][c]);
          acc[i][c] = fmaf(pr[i].y, vv[1][c], acc[i][c]);
          acc[i][c] = fmaf(pr[i].z, vv[2][c], acc[i][c]);
          acc[i][c] = fmaf(pr[i].w, vv[3][c], acc[i][c]);
        }
    }
  }

  // o is (B, Sq, H, HD), contiguous, in q's type
  TQ* o = static_cast<TQ*>(p.o) +
          ((static_cast<int64_t>(b) * p.Sq + q0) * p.H + h) * HD;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CN; ++c)
        store(o + static_cast<int64_t>(r) * p.H * HD + tx + 16 * c,
              acc[i][c] / den);
    }
  }
}

template <int HD, int BQ, typename TQ, typename TKV>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD, BQ>();
  auto kernel = flash_attention_kernel<HD, BQ, TQ, TKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD, typename TQ, typename TKV>
cudaError_t launch_tile(const Params& p, int B, cudaStream_t stream) {
  return p.Sq <= 16 ? launch<HD, 16, TQ, TKV>(p, B, stream)
                    : launch<HD, 64, TQ, TKV>(p, B, stream);
}

template <typename TQ, typename TKV>
cudaError_t launch_hd(const Params& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_tile<32, TQ, TKV>(p, B, stream);
    case 64: return launch_tile<64, TQ, TKV>(p, B, stream);
    case 80: return launch_tile<80, TQ, TKV>(p, B, stream);
    case 128: return launch_tile<128, TQ, TKV>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, loaded with ctypes.  Pointers are device pointers; strides
// are in elements, and each operand's last dimension is contiguous.  o is
// (B, Sq, H, hd), contiguous, in q's type.  q_bf16 / kv_bf16 give the types
// (bfloat16 or float32; q float32 with a bfloat16 K/V cache is allowed).
// Returns cudaGetLastError() after the launch (or the error that stopped
// it): non-zero means the kernel did not run.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* kv_len,
    int kv_len_all, int q_bf16, int kv_bf16, int B, int Sq, int Sk, int H,
    int KV, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, int window,
    long long q_offset, float scale, int q_vec, int k_vec, int v_vec,
    void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.kv_len = static_cast<const int*>(kv_len);
  p.kv_len_all = kv_len_all;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.rep = H / KV;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = scale;
  p.q_vec = q_vec;
  p.k_vec = k_vec;
  p.v_vec = v_vec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!q_bf16 && !kv_bf16) return launch_hd<float, float>(p, B, hd, s);
  if (q_bf16 && kv_bf16)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(p, B, hd, s);
  if (!q_bf16 && kv_bf16) return launch_hd<float, __nv_bfloat16>(p, B, hd, s);
  return cudaErrorInvalidValue;
}
