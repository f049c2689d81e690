// Flash attention backward (GQA; causal, sliding window) for NVIDIA Hopper
// (sm_90a).
//
// The gradient of the function that
// repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// computes.  The reference differentiates no Pallas kernel: its train step
// takes the gradient of blockwise_attention (repro/models/attention.py) with
// XLA.  The port computes that attention with its forward kernels on the
// card, so the gradient comes from this kernel.  For every batch row b,
// query head h, query i and key j (KV head h / rep), with the forward's
// masks (causal: j <= i; window w: j > i - w; every j < Sk):
//
//   s_ij  = (q_i . k_j) * scale,   P_ij = exp(s_ij - lse_i)  (0 if masked)
//   dP_ij = dO_i . v_j,            D_i = sum_j P_ij dP_ij
//   dS_ij = P_ij (dP_ij - D_i)
//   dq_i  = scale * sum_j dS_ij k_j
//   dk_j  = scale * sum_{i, h in j's group} dS_ij q_i
//   dv_j  = sum_{i, h in j's group} P_ij dO_i
//
// all in fp32, the results in the inputs' type (float32 or bfloat16).  The
// queries' absolute positions start at 0 and every key is valid (training);
// the wrapper raises on anything else.
//
// The log-sum-exp and D are recomputed here, not written by the forward:
// the serving routes' sources and launches stay as they are, and the
// forward under activation checkpointing runs twice a step while only the
// second run's statistics would be read.  Their cost is one more pass of q
// k^T and dO v^T.  D is sum_j P dP, not FlashAttention-2's dO . O from the
// forward's output, which in bf16 swamps dS where a row's attention spreads
// over many alike keys (flash_attention_bwd_hopper.cu says more).
//
// Bound, on the H100 SXM.  OLMo-1B's train shape (B 4, S 1024, H 16 on 16,
// hd 128, causal, bf16): the gradient needs 5 products over the valid
// pairs against the forward's 2, 2.5 x 17.2 = 43.0 GFLOP, 0.0434 ms at
// the 989 TFLOP/s of the bf16 tensor cores; q, k, v, dO, dq, dk and dv
// are ~117 MB, 0.035 ms.  Jamba (H 32 on 8): 85.9 GFLOP, 0.0868 ms.  This
// kernel runs on the CUDA cores (67 TFLOP/s fp32) and does 9 products (q
// k^T and dO v^T three times each, and the three gradients), so its own
// floor is about 1 ms at OLMo's shape: simple first, the tensor cores
// later (flash_attention_bwd_hopper.cu).
//
// Design (FlashAttention-2's backward, Dao 2023):
// - dq pass, one block of 256 threads per (query tile of 64, head, batch
//   row): q and dO of the tile staged in shared memory as fp32; a first
//   loop over the visible key tiles stages k and v and recomputes each
//   row's log-sum-exp and D (online max, sum and sum of P dP, as the
//   forward's softmax), and both statistics go to a (B, H, Sq) scratch for
//   the dk/dv pass; a second loop over the
//   same key tiles stages k and v, recomputes P and dS, and accumulates dq
//   in registers (each thread 4 rows x hd/16 columns);
// - dk/dv pass, one block per (key tile of 64, KV head, batch row): k and
//   v of the tile stay in shared memory while the block walks every query
//   head of its group and every query tile that can see the tile,
//   recomputing P and dS from the scratch statistics, and accumulates dk
//   and dv in registers: the sum over a KV head's query heads needs no
//   atomics, and the result does not depend on scheduling;
// - the score tiles are 64 x 64, each thread 4 x 4 of them, row maxima and
//   sums reduced across the 16 lanes of a half-warp; tiles that no pair
//   of the block can see are skipped, so causal attention does about half
//   the work.
// The kernels allocate nothing and do not synchronise.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // 16 x 16
constexpr int kBQ = 64;             // queries of a tile
constexpr int kBK = 64;             // keys of a tile
constexpr int kLDP = kBK + 16;      // row stride of a score tile
constexpr float kNegInf = -1e30f;   // the reference's finite mask value

struct Params {
  const void* q;                    // (B, Sq, H, hd), contiguous
  const void* k;                    // (B, Sk, KV, hd)
  const void* v;
  const void* dout;                 // (B, Sq, H, hd)
  void* dq;
  void* dk;
  void* dv;
  float* lse;                       // (B, H, Sq) scratch
  float* delta;                     // (B, H, Sq) scratch
  int Sq, Sk, H, KV, rep;
  int causal, window;               // window <= 0: none
  float scale;
  int vec;                          // 16-byte loads allowed
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Stage rows [0, nrows) of a (ROWS, HD) slice (row stride `stride`
// elements, last dimension contiguous) into dst as fp32 with row stride LD;
// rows [nrows, ROWS) become zero.
template <int HD, int ROWS, int LD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t stride,
                                      int nrows, bool vec) {
  if (vec) {
    constexpr int N = 16 / sizeof(T);
    constexpr int CH = HD / N;
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

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// s = A B^T for rows ty + 16 i of A (as) and rows tx + 16 j of B (bs), both
// (64, HD) fp32 tiles with row stride LD; with TWO, also t = C E^T.
template <int HD, int LD, bool TWO>
__device__ __forceinline__ void products(const float* as, const float* bs,
                                         const float* cs, const float* es,
                                         float (&s)[4][4], float (&t)[4][4],
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.0f;
      t[i][j] = 0.0f;
    }
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
      }
    if (TWO) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(cs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(es + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          t[i][j] = fmaf(a[i].x, c[j].x, t[i][j]);
          t[i][j] = fmaf(a[i].y, c[j].y, t[i][j]);
          t[i][j] = fmaf(a[i].z, c[j].z, t[i][j]);
          t[i][j] = fmaf(a[i].w, c[j].w, t[i][j]);
        }
    }
  }
}

template <int HD>
constexpr int dq_smem_floats() {
  return 2 * kBQ * (HD + 4) + 2 * kBK * (HD + 4) + kBQ * kLDP;
}

template <int HD>
constexpr int dkdv_smem_floats() {
  return 2 * kBK * (HD + 4) + 2 * kBQ * (HD + 4) + 2 * kBQ * kLDP + 2 * kBQ;
}

// The dq pass, with the rows' log-sum-exp and D written for the dk/dv pass.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p) {
  constexpr int CN = HD / 16;       // output columns per thread
  constexpr int LD = HD + 4;        // +4: conflict-free 16-byte reads
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kBQ * LD;
  float* ks = dos + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* dss = vs + kBK * LD;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nq = min(kBQ, p.Sq - q0);
  const int64_t q_rs = static_cast<int64_t>(p.H) * HD;     // a position's row
  const int64_t k_rs = static_cast<int64_t>(p.KV) * HD;
  const int64_t qbase = (static_cast<int64_t>(b) * p.Sq + q0) * q_rs +
                        static_cast<int64_t>(h) * HD;
  const int64_t kbase = static_cast<int64_t>(b) * p.Sk * k_rs +
                        static_cast<int64_t>(h / p.rep) * HD;
  const T* q = static_cast<const T*>(p.q) + qbase;
  const T* dout = static_cast<const T*>(p.dout) + qbase;
  const T* k = static_cast<const T*>(p.k) + kbase;
  const T* v = static_cast<const T*>(p.v) + kbase;

  // the keys some query of this tile can see: [lo, hi)
  int hi = p.Sk;
  if (p.causal) hi = min(hi, q0 + nq);
  int lo = 0;
  if (p.window > 0) lo = max(lo, q0 - p.window + 1);
  lo = lo / kBK * kBK;

  stage<HD, kBQ, LD>(qs, q, q_rs, nq, p.vec);
  stage<HD, kBQ, LD>(dos, dout, q_rs, nq, p.vec);
  __syncthreads();

  // the rows' log-sum-exp, as the forward's online softmax, and
  // D_i = sum_j P_ij dP_ij with the same running rescale
  float m[4], l[4], a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
    a[i] = 0.0f;
  }
  float s[4][4], t[4][4];
  for (int k0 = lo; k0 < hi; k0 += kBK) {
    const int nk = min(kBK, p.Sk - k0);
    __syncthreads();
    stage<HD, kBK, LD>(ks, k + k0 * k_rs, k_rs, nk, p.vec);
    stage<HD, kBK, LD>(vs, v + k0 * k_rs, k_rs, nk, p.vec);
    __syncthreads();
    products<HD, LD, true>(qs, ks, dos, vs, s, t, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(p, qpos, k0 + tx + 16 * j) ? s[i][j] * p.scale
                                                      : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.0f, dsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        sum += e;
        dsum = fmaf(e, t[i][j], dsum);
      }
      const float c = expf(m[i] - m_new);
      l[i] = l[i] * c + half_warp_sum(sum);
      a[i] = a[i] * c + half_warp_sum(dsum);
      m[i] = m_new;
    }
  }
  float lse[4], delta[4];
  const int64_t stat = (static_cast<int64_t>(b) * p.H + h) * p.Sq + q0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse[i] = m[i] + logf(l[i]);
    delta[i] = a[i] / l[i];
    const int r = ty + 16 * i;
    if (tx == 0 && r < nq) {
      p.lse[stat + r] = lse[i];
      p.delta[stat + r] = delta[i];
    }
  }

  // dq = scale * dS K
  float acc[4][CN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.0f;
  for (int k0 = lo; k0 < hi; k0 += kBK) {
    const int nk = min(kBK, p.Sk - k0);
    __syncthreads();                // the last tile's readers are done
    stage<HD, kBK, LD>(ks, k + k0 * k_rs, k_rs, nk, p.vec);
    stage<HD, kBK, LD>(vs, v + k0 * k_rs, k_rs, nk, p.vec);
    __syncthreads();
    products<HD, LD, true>(qs, ks, dos, vs, s, t, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = visible(p, qpos, k0 + tx + 16 * j)
                              ? expf(s[i][j] * p.scale - lse[i]) : 0.0f;
        dss[(ty + 16 * i) * kLDP + tx + 16 * j] = pij * (t[i][j] - delta[i]);
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d4[i] = *reinterpret_cast<const float4*>(dss + (ty + 16 * i) * kLDP + j);
      float kk[4][CN];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < CN; ++c) kk[jj][c] = ks[(j + jj) * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          acc[i][c] = fmaf(d4[i].x, kk[0][c], acc[i][c]);
          acc[i][c] = fmaf(d4[i].y, kk[1][c], acc[i][c]);
          acc[i][c] = fmaf(d4[i].z, kk[2][c], acc[i][c]);
          acc[i][c] = fmaf(d4[i].w, kk[3][c], acc[i][c]);
        }
    }
  }

  T* dq = static_cast<T*>(p.dq) + qbase;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
#pragma unroll
      for (int c = 0; c < CN; ++c)
        store(dq + r * q_rs + tx + 16 * c, acc[i][c] * p.scale);
    }
  }
}

// The dk/dv pass: one key tile of one KV head, summed over the group's
// query heads and the query tiles that see it.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(const Params p) {
  constexpr int CN = HD / 16;
  constexpr int LD = HD + 4;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kBK * LD;
  float* qs = vs + kBK * LD;
  float* dos = qs + kBQ * LD;
  float* ps = dos + kBQ * LD;
  float* dss = ps + kBQ * kLDP;
  float* lse_s = dss + kBQ * kLDP;
  float* delta_s = lse_s + kBQ;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int nk = min(kBK, p.Sk - k0);
  const int64_t q_rs = static_cast<int64_t>(p.H) * HD;
  const int64_t k_rs = static_cast<int64_t>(p.KV) * HD;
  const int64_t kbase = (static_cast<int64_t>(b) * p.Sk + k0) * k_rs +
                        static_cast<int64_t>(kvh) * HD;
  stage<HD, kBK, LD>(ks, static_cast<const T*>(p.k) + kbase, k_rs, nk, p.vec);
  stage<HD, kBK, LD>(vs, static_cast<const T*>(p.v) + kbase, k_rs, nk, p.vec);

  // the queries that can see some key of this tile: [qlo, qhi)
  int qlo = p.causal ? k0 : 0;
  int qhi = p.Sq;
  if (p.window > 0) qhi = min(qhi, k0 + nk - 1 + p.window);
  qlo = qlo / kBQ * kBQ;

  float dk[4][CN], dv[4][CN];       // keys ty + 16 i, columns tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      dk[i][c] = 0.0f;
      dv[i][c] = 0.0f;
    }
  float s[4][4], t[4][4];
  for (int hh = 0; hh < p.rep; ++hh) {
    const int h = kvh * p.rep + hh;
    for (int q0 = qlo; q0 < qhi; q0 += kBQ) {
      const int nq = min(kBQ, p.Sq - q0);
      const int64_t qbase = (static_cast<int64_t>(b) * p.Sq + q0) * q_rs +
                            static_cast<int64_t>(h) * HD;
      const int64_t stat = (static_cast<int64_t>(b) * p.H + h) * p.Sq + q0;
      __syncthreads();              // the last tile's readers are done
      stage<HD, kBQ, LD>(qs, static_cast<const T*>(p.q) + qbase, q_rs, nq,
                         p.vec);
      stage<HD, kBQ, LD>(dos, static_cast<const T*>(p.dout) + qbase, q_rs,
                         nq, p.vec);
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        lse_s[r] = r < nq ? p.lse[stat + r] : 0.0f;
        delta_s[r] = r < nq ? p.delta[stat + r] : 0.0f;
      }
      __syncthreads();
      products<HD, LD, true>(qs, ks, dos, vs, s, t, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int qpos = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = qpos < p.Sq && visible(p, qpos, k0 + tx + 16 * j);
          const float pij = ok ? expf(s[i][j] * p.scale - lse_s[r]) : 0.0f;
          ps[r * kLDP + tx + 16 * j] = pij;
          dss[r * kLDP + tx + 16 * j] = pij * (t[i][j] - delta_s[r]);
        }
      }
      __syncthreads();
      // dv += P^T dO, dk += dS^T Q
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float pk[4], dsk[4], dov[CN], qv[CN];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pk[i] = ps[r * kLDP + ty + 16 * i];
          dsk[i] = dss[r * kLDP + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          dov[c] = dos[r * LD + tx + 16 * c];
          qv[c] = qs[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CN; ++c) {
            dv[i][c] = fmaf(pk[i], dov[c], dv[i][c]);
            dk[i][c] = fmaf(dsk[i], qv[c], dk[i][c]);
          }
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk) + kbase;
  T* dvp = static_cast<T*>(p.dv) + kbase;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < nk) {
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        store(dkp + r * k_rs + tx + 16 * c, dk[i][c] * p.scale);
        store(dvp + r * k_rs + tx + 16 * c, dv[i][c]);
      }
    }
  }
}

template <int HD, typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int dq_smem = dq_smem_floats<HD>() * static_cast<int>(sizeof(float));
  constexpr int kv_smem = dkdv_smem_floats<HD>() * static_cast<int>(sizeof(float));
  auto dq = dq_kernel<HD, T>;
  auto dkdv = dkdv_kernel<HD, T>;
  cudaError_t err = cudaFuncSetAttribute(
      dq, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err != cudaSuccess) return err;
  dq<<<dim3((p.Sq + kBQ - 1) / kBQ, p.H, B), kThreads, dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((p.Sk + kBK - 1) / kBK, p.KV, B), kThreads, kv_smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Params& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32, T>(p, B, stream);
    case 64: return launch<64, T>(p, B, stream);
    case 80: return launch<80, T>(p, B, stream);
    case 128: return launch<128, T>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, loaded with ctypes.  Pointers are device pointers to
// contiguous arrays: q, dout and dq (B, Sq, H, hd); k, v, dk and dv (B,
// Sk, KV, hd); all of one type, bfloat16 (bf16 != 0) or float32; lse and
// delta (B, H, Sq) float32 scratch.  window <= 0: none.  Returns
// cudaGetLastError() after the launches (or the error that stopped them):
// non-zero means a kernel did not run.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    void* dq, void* dk, void* dv, void* lse, void* delta,
    int bf16, int B, int Sq, int Sk, int H, int KV, int hd, int causal,
    int window, float scale, int vec, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || B > 65535) return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  p.rep = H / KV;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.vec = vec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_hd<__nv_bfloat16>(p, B, hd, s)
              : launch_hd<float>(p, B, hd, s);
}
