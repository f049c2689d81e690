// Selective-SSM scan backward for NVIDIA Hopper (sm_90a).
//
// The gradient of the function that
// repro/kernels/ssm_scan/ssm_scan.py::ssm_scan_pallas computes (the
// reference's train step differentiates its chunked associative scan,
// repro/models/ssm.py:98, with XLA; the port computes that scan with its
// forward kernel on the card, so the gradient comes from this kernel).
// With a_t = exp(dt_t A), u_t = dt_t x_t and h_t = a_t h_{t-1} + u_t B_t,
// y_t = sum_n h_t C_t, given dy (B, S, D) and dh, the gradient of h_{S-1}
// (zeros when null), the state's gradient g_t runs backward:
//
//   g_t   = a_{t+1} g_{t+1} + dy_t C_t          (g_{S-1} = dh + dy C)
//   du_t  = sum_n g_t B_t       dx_t = du_t dt_t
//   ddt_t = du_t x_t + sum_n g_t (a_t h_{t-1}) A
//   dA   += sum_{b,t} g_t (a_t h_{t-1}) dt_t
//   dB_t  = sum_d g_t u_t       dC_t = sum_d dy_t h_t
//   dh0   = a_0 g_0
//
// in float32: dx and ddt (B, S, D), dA (D, N), dB and dC (B, S, N), dh0
// (B, D, N) when the forward had an h0.
//
// Bound, on the H100 SXM.  Jamba's train shape (B 4, S 1024, D 8192, N 16):
// x, dt and dy read and dx and ddt written are 5 x 134.2 MB, with B, C, A
// and their gradients 673.2 MB, 0.2010 ms at 3.35 TB/s; the forward's
// 536.9 M exponentials, recomputed once, 0.1284 ms at 16 a clock on each
// SM.  So bytes bound it.
//
// The recurrence is serial in t, so the card is filled only by the (b, d,
// n) in flight.  The design keeps more of them in flight than one thread
// a channel (8 warps an SM at Jamba's shape), keeps the states of a tile
// in registers rather than shared memory, and overlaps the loads with the
// steps:
// - four lanes a channel, each with N / 4 of its states (and their A,
//   g, dA) in registers; a block is 64 channels of one batch row, 256
//   threads, so Jamba's shape runs 4096 warps, 4 times the channels'
//   count of threads;
// - pass 1 runs the recurrence from h0 and stores the state before every
//   kT-th step, (B, ceil(S / kT), D, N) float32 (the wrapper's scratch).
//   It is a pass of the backward: the forward kernel stays as it is, and
//   under activation checkpointing the forward runs twice a step while
//   the stored states are needed once;
// - pass 2 walks the tiles of kT steps in reverse.  Each lane takes its
//   stored states at the tile's start (the next tile's are loaded during
//   this one), recomputes the tile's kT x N / 4 states into registers,
//   then steps back through the tile carrying g; with h_{t-1} at hand,
//   a_t h_{t-1} is one product, so no state is divided by a decay that
//   may underflow;
// - in both passes x, dt (and dy), B (and C) of the coming tiles arrive by
//   cp.async (16 bytes where D and the pointers allow, 4 otherwise) in a
//   ring of kStages tiles in shared memory while a tile's steps run, one
//   __syncthreads a tile, as in the forward kernel (ssm_scan.cu);
// - du and the step's share of ddt sum over a channel's 4 lanes in two
//   shuffles (a two-value transpose); dB_t and dC_t sum over channels:
//   a warp's 8 channels by a transpose reduction over lane bits 2-4 (7
//   shuffles for 8 values at N 16), the block's warps through shared
//   memory after each tile, and each block writes its sums for every step
//   to a scratch that pass 3 adds over the blocks of a batch row in a
//   fixed order; dA's partials, one per (b, d, n), are added over the
//   batch rows there too.  No atomics: the gradient is the same, bit for
//   bit, on every run, so a train step reproduces;
// - exponentials are ex2.approx of dt A log2(e), as the forward's; each is
//   taken three times (pass 1, the tile's recompute, the step back).
// The kernels allocate nothing and do not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 4;            // lanes of a channel
constexpr int kChannels = 64;        // channels of a block
constexpr int kThreads = kChannels * kLanes;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 8;                // steps of a tile, between stored states
constexpr int kStages = 4;           // tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const float* x;                    // (B, S, D)
  const float* dt;                   // (B, S, D)
  const float* A;                    // (D, N)
  const float* Bc;                   // (B, S, N)
  const float* Cc;                   // (B, S, N)
  const float* h0;                   // (B, D, N) or null
  const float* dy;                   // (B, S, D)
  const float* dh;                   // (B, D, N) or null
  float* ckpt;                       // (B, ceil(S / kT), D, N)
  float* part;                       // (B, S, blocks, 2N): dB, dC by block
  float* dA_part;                    // (B, D, N)
  float* dx;
  float* ddt;
  float* dA;
  float* dB;
  float* dC;
  float* dh0;                        // (B, D, N) or null
  int S;
  int D;
  bool vec_rows;                     // x, dt, dy rows by 16-byte copies
  bool vec_rest;                     // A, B, C, h0, dh, dh0 16-byte aligned
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int P>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(P) : "memory");
}

// K consecutive floats at p into v (and back): float4 or float2 accesses
// where p is aligned for them.
template <int K>
__device__ __forceinline__ void load_vec(float (&v)[K], const float* p,
                                         bool aligned) {
  if constexpr (K % 4 == 0) {
    if (aligned) {
#pragma unroll
      for (int i = 0; i < K / 4; ++i) {
        const float4 q = reinterpret_cast<const float4*>(p)[i];
        v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z;
        v[4 * i + 3] = q.w;
      }
      return;
    }
  } else if constexpr (K % 2 == 0) {
    if (aligned) {
#pragma unroll
      for (int i = 0; i < K / 2; ++i) {
        const float2 q = reinterpret_cast<const float2*>(p)[i];
        v[2 * i] = q.x; v[2 * i + 1] = q.y;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = p[i];
}

template <int K>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[K],
                                          bool aligned) {
  if constexpr (K % 4 == 0) {
    if (aligned) {
#pragma unroll
      for (int i = 0; i < K / 4; ++i)
        reinterpret_cast<float4*>(p)[i] =
            make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      return;
    }
  } else if constexpr (K % 2 == 0) {
    if (aligned) {
#pragma unroll
      for (int i = 0; i < K / 2; ++i)
        reinterpret_cast<float2*>(p)[i] = make_float2(v[2 * i], v[2 * i + 1]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) p[i] = v[i];
}

// One stage of the ring: x, dt and dy of the block's channels at [t][c],
// then B and C of its batch row at [t][n].
template <int N>
struct Stage {
  static constexpr int kX = 0;
  static constexpr int kDt = kX + kT * kChannels;
  static constexpr int kDy = kDt + kT * kChannels;
  static constexpr int kB = kDy + kT * kChannels;
  static constexpr int kC = kB + kT * N;
  static constexpr int kFloats = kC + kT * N;
};

// Rows row .. row + steps - 1 of the block's batch row into one stage:
// x, dt and B, and with REV dy and C.  Channels past D are left as they
// are: the lanes past D read zeros in their place.
template <int N, bool REV>
__device__ __forceinline__ void load_tile(float* st, const Args& a,
                                          int64_t row, int steps, int d0) {
  using L = Stage<N>;
  const int tid = threadIdx.x;
  constexpr int R = REV ? 3 : 2;              // row arrays copied
  if (a.vec_rows) {
    constexpr int Q = kChannels / 4;          // 16-byte pieces of a row
    for (int i = tid; i < R * steps * Q; i += kThreads) {
      const int arr = i / (steps * Q);
      const int rem = i - arr * steps * Q;
      const int t = rem / Q, j = (rem % Q) * 4;
      if (d0 + j < a.D) {                     // D % 4 == 0: all 4 or none
        const int64_t off = (row + t) * a.D + d0 + j;
        const float* src = arr == 0 ? a.x : arr == 1 ? a.dt : a.dy;
        cp_async16(st + L::kX + arr * kT * kChannels + t * kChannels + j,
                   src + off);
      }
    }
  } else {
    for (int i = tid; i < R * steps * kChannels; i += kThreads) {
      const int arr = i / (steps * kChannels);
      const int rem = i - arr * steps * kChannels;
      const int t = rem / kChannels, j = rem % kChannels;
      if (d0 + j < a.D) {
        const int64_t off = (row + t) * a.D + d0 + j;
        const float* src = arr == 0 ? a.x : arr == 1 ? a.dt : a.dy;
        cp_async4(st + L::kX + arr * kT * kChannels + t * kChannels + j,
                  src + off);
      }
    }
  }
  // B (and C): steps * N consecutive floats from row * N
  constexpr int M = REV ? 2 : 1;
  if (a.vec_rest) {
    for (int i = tid; i < M * steps * N / 4; i += kThreads) {
      const int arr = i / (steps * N / 4), k = i % (steps * N / 4);
      cp_async16(st + L::kB + arr * kT * N + 4 * k,
                 (arr == 0 ? a.Bc : a.Cc) + row * N + 4 * k);
    }
  } else {
    for (int i = tid; i < M * steps * N; i += kThreads) {
      const int arr = i / (steps * N), k = i % (steps * N);
      cp_async4(st + L::kB + arr * kT * N + k,
                (arr == 0 ? a.Bc : a.Cc) + row * N + k);
    }
  }
}

// Pass 1: the state before every kT-th step.
template <int N>
__global__ void __launch_bounds__(kThreads) state_kernel(const Args a) {
  constexpr int NL = N / kLanes;
  using L = Stage<N>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int c = tid / kLanes, q = lane % kLanes;
  const int d0 = blockIdx.x * kChannels, d = d0 + c;
  const bool live = d < a.D;
  const int b = blockIdx.y;
  const int S = a.S, D = a.D;
  const int tiles = (S + kT - 1) / kT;
  const int64_t row0 = static_cast<int64_t>(b) * S;
  const int64_t state = (static_cast<int64_t>(b) * D + d) * N + q * NL;

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < tiles)
      load_tile<N, false>(smem + k * L::kFloats, a, row0 + k * kT,
                          min(kT, S - k * kT), d0);
    cp_async_commit();
  }
  float a2[NL], h[NL];
  if (live) {
    load_vec(a2, a.A + static_cast<int64_t>(d) * N + q * NL, a.vec_rest);
    if (a.h0 != nullptr) load_vec(h, a.h0 + state, a.vec_rest);
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    a2[i] = live ? a2[i] * kLog2e : 0.f;
    if (!live || a.h0 == nullptr) h[i] = 0.f;
  }

  for (int k = 0; k < tiles; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = k + kStages - 1;
    if (next < tiles)
      load_tile<N, false>(smem + (next % kStages) * L::kFloats, a,
                          row0 + static_cast<int64_t>(next) * kT,
                          min(kT, S - next * kT), d0);
    cp_async_commit();
    if (live)
      store_vec(a.ckpt + (static_cast<int64_t>(b) * tiles + k) * D * N
                + static_cast<int64_t>(d) * N + q * NL, h, a.vec_rest);
    const float* st = smem + (k % kStages) * L::kFloats;
    const int steps = min(kT, S - k * kT);
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      if (j < steps) {
        const float dtt = live ? st[L::kDt + j * kChannels + c] : 0.f;
        const float u = dtt * (live ? st[L::kX + j * kChannels + c] : 0.f);
        float bv[NL];
        load_vec(bv, st + L::kB + j * N + q * NL, true);
#pragma unroll
        for (int i = 0; i < NL; ++i)
          h[i] = fmaf(h[i], ex2(dtt * a2[i]), u * bv[i]);
      }
    }
  }
}

// Lane l of the warp gets the sum over the warp's 8 channels (lane bits
// 2-4) of v[(l / 4) / (8 / V)] of its own quarter (lane bits 0-1), V a
// power of two up to 8: halving exchanges, then plain sums over the lanes
// holding the same index.
template <int V>
__device__ __forceinline__ float channel_transpose_sum(float (&v)[V],
                                                       int lane) {
  int o = 16;
#pragma unroll
  for (int m = V / 2; m >= 1; m >>= 1, o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < m; ++i) {
      const float send = upper ? v[i] : v[i + m];
      const float keep = upper ? v[i + m] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float r = v[0];
#pragma unroll
  for (; o >= kLanes; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  return r;
}

template <int N>
constexpr int reverse_smem_floats() {
  return kStages * Stage<N>::kFloats + kT * kWarps * 2 * N;
}

// Pass 2: the tiles in reverse, each recomputed from its stored state.
template <int N>
__global__ void __launch_bounds__(kThreads) reverse_kernel(const Args a) {
  constexpr int NL = N / kLanes;     // states of a lane
  constexpr int V = 2 * NL;          // a lane's dB and dC partials of a step
  using L = Stage<N>;
  extern __shared__ __align__(16) float smem[];
  float* red = smem + kStages * L::kFloats;   // [kT][kWarps][2N]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / kLanes, q = lane % kLanes;
  const int d0 = blockIdx.x * kChannels, d = d0 + c;
  const bool live = d < a.D;
  const int b = blockIdx.y;
  const int S = a.S, D = a.D;
  const int tiles = (S + kT - 1) / kT;
  const int64_t row0 = static_cast<int64_t>(b) * S;
  const int64_t state = (static_cast<int64_t>(b) * D + d) * N + q * NL;
  // this lane's sum of dB / dC after the transpose: index idx of its
  // quarter's values, written by one lane of each group of 8 / V
  const int idx = (lane / kLanes) / (8 / V);
  const bool writer = (lane / kLanes) % (8 / V) == 0;
  const int out = idx < NL ? q * NL + idx : N + q * NL + idx - NL;
  auto ckpt_at = [&](int k) {
    return a.ckpt + (static_cast<int64_t>(b) * tiles + k) * D * N
           + static_cast<int64_t>(d) * N + q * NL;
  };

  // the ring takes tiles in reverse: the i-th tile walked is tiles - 1 - i
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    const int k = tiles - 1 - i;
    if (k >= 0)
      load_tile<N, true>(smem + i * L::kFloats, a,
                         row0 + static_cast<int64_t>(k) * kT,
                         min(kT, S - k * kT), d0);
    cp_async_commit();
  }
  // lanes past D carry zeros: every partial they add is 0
  float a2[NL], g[NL], dA[NL], hn[NL];
  if (live) {
    load_vec(a2, a.A + static_cast<int64_t>(d) * N + q * NL, a.vec_rest);
    if (a.dh != nullptr) load_vec(g, a.dh + state, a.vec_rest);
    load_vec(hn, ckpt_at(tiles - 1), a.vec_rest);
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    a2[i] = live ? a2[i] * kLog2e : 0.f;
    if (!live || a.dh == nullptr) g[i] = 0.f;
    if (!live) hn[i] = 0.f;
    dA[i] = 0.f;
  }

  for (int i = 0; i < tiles; ++i) {
    const int k = tiles - 1 - i;
    const int t0 = k * kT;
    const int steps = min(kT, S - t0);
    // tile i has landed, and everyone is done with tile i - 1's stage and
    // with red
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = k - (kStages - 1);
    if (next >= 0)
      load_tile<N, true>(smem + ((i + kStages - 1) % kStages) * L::kFloats,
                         a, row0 + static_cast<int64_t>(next) * kT, kT, d0);
    cp_async_commit();
    float h[NL];
#pragma unroll
    for (int n = 0; n < NL; ++n) h[n] = hn[n];
    if (live && k > 0) load_vec(hn, ckpt_at(k - 1), a.vec_rest);
    const float* st = smem + (i % kStages) * L::kFloats;

    // the tile's states, h before each step
    float hs[kT][NL];
#pragma unroll
    for (int j = 0; j < kT; ++j) {
#pragma unroll
      for (int n = 0; n < NL; ++n) hs[j][n] = h[n];
      if (j < steps) {
        const float dtt = live ? st[L::kDt + j * kChannels + c] : 0.f;
        const float u = dtt * (live ? st[L::kX + j * kChannels + c] : 0.f);
        float bv[NL];
        load_vec(bv, st + L::kB + j * N + q * NL, true);
#pragma unroll
        for (int n = 0; n < NL; ++n)
          h[n] = fmaf(h[n], ex2(dtt * a2[n]), u * bv[n]);
      }
    }

    // back through the tile
#pragma unroll
    for (int j = kT - 1; j >= 0; --j) {
      if (j < steps) {               // the same for every thread
        const float dtt = live ? st[L::kDt + j * kChannels + c] : 0.f;
        const float xt = live ? st[L::kX + j * kChannels + c] : 0.f;
        const float dyt = live ? st[L::kDy + j * kChannels + c] : 0.f;
        float bv[NL], cv[NL], v[V];
        load_vec(bv, st + L::kB + j * N + q * NL, true);
        load_vec(cv, st + L::kC + j * N + q * NL, true);
        const float u = dtt * xt;
        float du = 0.f, sda = 0.f;
#pragma unroll
        for (int n = 0; n < NL; ++n) {
          const float e = ex2(dtt * a2[n]);
          const float hp = hs[j][n];
          const float ah = hp * e;                    // a_t h_{t-1}
          const float ht = fmaf(hp, e, u * bv[n]);    // h_t, as the forward
          const float gn = fmaf(dyt, cv[n], g[n]);    // g_t
          v[n] = gn * u;
          v[NL + n] = dyt * ht;
          du = fmaf(gn, bv[n], du);
          const float gah = gn * ah;
          sda = fmaf(gah, a2[n], sda);
          dA[n] = fmaf(gah, dtt, dA[n]);
          g[n] = gn * e;                              // a_t g_t
        }
        // dx and ddt: this lane's shares, summed over the channel's lanes
        // (a two-value transpose: even quarters end with dx, odd with ddt)
        const float px = du * dtt;
        const float pt = fmaf(du, xt, sda * kLn2);   // a2 = A log2(e)
        const bool odd = (lane & 1) != 0;
        float r = (odd ? pt : px)
                  + __shfl_xor_sync(0xffffffffu, odd ? px : pt, 1);
        r += __shfl_xor_sync(0xffffffffu, r, 2);
        if (live && q < 2) {
          const int64_t off = (row0 + t0 + j) * D + d;
          (q == 0 ? a.dx : a.ddt)[off] = r;
        }
        const float s = channel_transpose_sum<V>(v, lane);
        if (writer) red[(j * kWarps + warp) * 2 * N + out] = s;
      }
    }
    __syncthreads();
    for (int e = tid; e < steps * 2 * N; e += kThreads) {
      const int j = e / (2 * N), col = e % (2 * N);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[(j * kWarps + w) * 2 * N + col];
      a.part[((row0 + t0 + j) * gridDim.x + blockIdx.x) * 2 * N + col] = s;
    }
  }

  if (live) {
    if (a.dh0 != nullptr) store_vec(a.dh0 + state, g, a.vec_rest);
    store_vec(a.dA_part + state, dA, a.vec_rest);
  }
}

// Pass 3: dB and dC, the channel blocks' sums added in block order; dA,
// the batch rows' added in row order.
template <int N>
__global__ void __launch_bounds__(256) finish_kernel(const Args a, int B,
                                                     int blocks) {
  constexpr int V = 2 * N;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t rows = static_cast<int64_t>(B) * a.S;
  for (int64_t i = first; i < rows * V; i += stride) {
    const int64_t r = i / V;
    const int c = static_cast<int>(i % V);
    const float* p = a.part + r * blocks * V + c;
    float s = 0.f;
    for (int k = 0; k < blocks; ++k) s += p[static_cast<int64_t>(k) * V];
    if (c < N) a.dB[r * N + c] = s;
    else a.dC[r * N + c - N] = s;
  }
  const int64_t dn = static_cast<int64_t>(a.D) * N;
  for (int64_t i = first; i < dn; i += stride) {
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += a.dA_part[b * dn + i];
    a.dA[i] = s;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int N>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int ring = kStages * Stage<N>::kFloats * 4;
  constexpr int smem = reverse_smem_floats<N>() * 4;
  auto state = state_kernel<N>;
  auto reverse = reverse_kernel<N>;
  // the shared-memory attributes, once for each card in turn
  static int set_for = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != set_for) {
    err = cudaFuncSetAttribute(
        state, cudaFuncAttributeMaxDynamicSharedMemorySize, ring);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          reverse, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set_for = dev;
  }
  const dim3 grid((a.D + kChannels - 1) / kChannels, B);
  state<<<grid, kThreads, ring, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reverse<<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t work = static_cast<int64_t>(B) * a.S * 2 * N;
  const int finish_blocks = static_cast<int>(
      work / 256 + 1 < 4096 ? work / 256 + 1 : 4096);
  finish_kernel<N><<<finish_blocks, 256, 0, stream>>>(a, B, grid.x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The steps between stored states and the channels of a block, for the
// wrapper's scratch.
extern "C" int ssm_scan_bwd_ckpt_steps() { return kT; }
extern "C" int ssm_scan_bwd_block_channels() { return kChannels; }

// C entry point, loaded with ctypes.  Pointers are device pointers to
// contiguous float32 arrays; h0, dh and dh0 may be null.  Scratch: ckpt
// holds (B, ceil(S / kT), D, N) floats, part (B, S, ceil(D / 64), 2N) and
// dA_part (B, D, N).  N must be 4, 8 or 16, and B at most 65535.  Returns
// cudaGetLastError() after the launches: non-zero means a launch was
// refused (or an argument was, as cudaErrorInvalidValue).
extern "C" int ssm_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* Bc, const void* Cc, const void* h0,
                            const void* dy, const void* dh, void* ckpt,
                            void* part, void* dA_part, void* dx, void* ddt,
                            void* dA, void* dB, void* dC, void* dh0, int B,
                            int S, int D, int N, void* stream) {
  if (B <= 0 || D <= 0 || S <= 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const float*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bc = static_cast<const float*>(Bc);
  a.Cc = static_cast<const float*>(Cc);
  a.h0 = static_cast<const float*>(h0);
  a.dy = static_cast<const float*>(dy);
  a.dh = static_cast<const float*>(dh);
  a.ckpt = static_cast<float*>(ckpt);
  a.part = static_cast<float*>(part);
  a.dA_part = static_cast<float*>(dA_part);
  a.dx = static_cast<float*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dB = static_cast<float*>(dB);
  a.dC = static_cast<float*>(dC);
  a.dh0 = static_cast<float*>(dh0);
  a.S = S;
  a.D = D;
  a.vec_rows = D % 4 == 0 && aligned16(x) && aligned16(dt) && aligned16(dy);
  a.vec_rest = aligned16(A) && aligned16(Bc) && aligned16(Cc) &&
               aligned16(h0) && aligned16(dh) && aligned16(dh0) &&
               aligned16(ckpt) && aligned16(dA_part);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return launch<4>(a, B, s);
    case 8: return launch<8>(a, B, s);
    case 16: return launch<16>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
