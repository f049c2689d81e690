// Selective-SSM scan backward for NVIDIA Hopper (sm_90a).
//
// The gradient of the function that
// repro/kernels/ssm_scan/ssm_scan.py::ssm_scan_pallas computes (the
// reference's train step differentiates its chunked associative scan,
// repro/models/ssm.py, with XLA; the port computes that scan with its
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
// x, dt and dy read and dx and ddt written are 5 x 134.2 MB = 671 MB,
// 0.200 ms at 3.35 TB/s; the forward's 536.9 M exponentials, recomputed
// once, 0.128 ms at 16 a clock on each SM.  So bytes bound it.
//
// Design, simple first: the forward's layout, one thread per (channel,
// batch row) with its N states in registers, 128 channels a block.
// - Pass 1 runs the recurrence from h0 and stores the state at every kT-th
//   step, (B, ceil(S / kT), D, N) float32 (the wrapper's scratch: 268 MB at
//   Jamba's shape, read back once).  It is a pass of the backward: the
//   forward kernel stays as it is, and under activation checkpointing the
//   forward runs twice a step while the checkpoints are needed once.
// - Pass 2 walks the tiles of kT steps in reverse.  Each thread reloads its
//   state at the tile's start, recomputes the tile's states into shared
//   memory (kT x N x 128 floats, 64 KB at N 16: registers cannot hold
//   them), then steps back through the tile carrying g in registers; with
//   h_{t-1} at hand, a_t h_{t-1} is one product, so no state is divided.
//   dA accumulates in registers, one partial per (b, d, n).
// - dB_t and dC_t sum over the channels: each warp reduces its 2N partials
//   by a transpose reduction (2N - 1 shuffles leave lane l with the warp's
//   sum of partial l), the block's warps through shared memory after each
//   tile; each block writes its sums for every step to a scratch, and
//   pass 3 adds the blocks of a batch row in a fixed order.  dA's
//   partials, one per (b, d, n), are added over the batch rows there too.
//   No atomics: the gradient is the same, bit for bit, on every run, so a
//   train step reproduces.
// - Exponentials are ex2.approx of dt A log2(e), as the forward's.  Every
//   exponential is computed three times (pass 1, the tile's recompute, the
//   step back).
// The kernels allocate nothing and do not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // channels of a block
constexpr int kWarps = kThreads / 32;
constexpr int kT = 8;                // steps between stored states
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
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Lane l of the warp gets the warp's sum of v[l % V] (V a power of two up
// to 32): halving exchanges, then plain sums over the lanes holding the
// same index.
template <int V>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[V]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = V / 2; o >= 1; o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float send = upper ? v[i] : v[i + o];
      const float keep = upper ? v[i + o] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float r = v[0];
#pragma unroll
  for (int o = V; o < 32; o <<= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  return r;
}

// Pass 1: the state before every kT-th step.
template <int N>
__global__ void __launch_bounds__(kThreads) ckpt_kernel(const Args a) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= a.D) return;
  const int b = blockIdx.y;
  const int S = a.S, D = a.D;
  const int tiles = (S + kT - 1) / kT;
  const int64_t row0 = static_cast<int64_t>(b) * S;
  float a2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = a.A[static_cast<int64_t>(d) * N + n] * kLog2e;
    h[n] = a.h0 != nullptr ? a.h0[(static_cast<int64_t>(b) * D + d) * N + n]
                           : 0.f;
  }
  for (int k = 0; k < tiles; ++k) {
    float* c = a.ckpt + ((static_cast<int64_t>(b) * tiles + k) * D + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) c[n] = h[n];
    const int t0 = k * kT;
    const int steps = min(kT, S - t0);
    float xs[kT], dts[kT];
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int64_t off = (row0 + t0 + j) * D + d;
      xs[j] = j < steps ? a.x[off] : 0.f;
      dts[j] = j < steps ? a.dt[off] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      if (j < steps) {
        const float* bt = a.Bc + (row0 + t0 + j) * N;
        const float u = dts[j] * xs[j];
#pragma unroll
        for (int n = 0; n < N; ++n)
          h[n] = fmaf(h[n], ex2(dts[j] * a2[n]), u * bt[n]);
      }
    }
  }
}

template <int N>
constexpr int reverse_smem_floats() {
  return kT * N * kThreads + kT * 2 * N + kT * kWarps * 2 * N;
}

// Pass 2: the tiles in reverse, each recomputed from its stored state.
template <int N>
__global__ void __launch_bounds__(kThreads) reverse_kernel(const Args a) {
  constexpr int V = 2 * N;           // dB and dC partials of a step
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                  // [kT][N][kThreads]: h before step j
  float* bcs = hs + kT * N * kThreads;   // [kT][2N]: B_t, then C_t
  float* red = bcs + kT * V;         // [kT][kWarps][2N]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = blockIdx.x * kThreads + tid;
  const bool live = d < a.D;
  const int b = blockIdx.y;
  const int S = a.S, D = a.D;
  const int tiles = (S + kT - 1) / kT;
  const int64_t row0 = static_cast<int64_t>(b) * S;
  const int64_t state = (static_cast<int64_t>(b) * D + d) * N;

  // lanes past D carry zeros: every partial they add is 0
  float a2[N], g[N], dA[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = live ? a.A[static_cast<int64_t>(d) * N + n] * kLog2e : 0.f;
    g[n] = live && a.dh != nullptr ? a.dh[state + n] : 0.f;
    dA[n] = 0.f;
  }

  for (int k = tiles - 1; k >= 0; --k) {
    const int t0 = k * kT;
    const int steps = min(kT, S - t0);
    __syncthreads();                 // the last tile's bcs and red are read
    for (int i = tid; i < steps * V; i += kThreads) {
      const int j = i / V, c = i % V;
      const int64_t r = (row0 + t0 + j) * N;
      bcs[i] = c < N ? a.Bc[r + c] : a.Cc[r + c - N];
    }
    float xs[kT], dts[kT], dys[kT], h[N];
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int64_t off = (row0 + t0 + j) * D + d;
      const bool in = live && j < steps;
      xs[j] = in ? a.x[off] : 0.f;
      dts[j] = in ? a.dt[off] : 0.f;
      dys[j] = in ? a.dy[off] : 0.f;
    }
    const float* c = a.ckpt + ((static_cast<int64_t>(b) * tiles + k) * D + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = live ? c[n] : 0.f;
    __syncthreads();

    // the tile's states, h before each step, into this thread's column
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      if (j < steps) {
        const float* bt = bcs + j * V;
        const float u = dts[j] * xs[j];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          hs[(j * N + n) * kThreads + tid] = h[n];
          h[n] = fmaf(h[n], ex2(dts[j] * a2[n]), u * bt[n]);
        }
      }
    }

    // back through the tile
#pragma unroll
    for (int j = kT - 1; j >= 0; --j) {
      if (j < steps) {               // the same for every thread
        const float* bt = bcs + j * V;
        const float* ct = bt + N;
        const float dtt = dts[j], xt = xs[j], dyt = dys[j];
        const float u = dtt * xt;
        float v[V];
        float du = 0.f, sda = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float e = ex2(dtt * a2[n]);
          const float hp = hs[(j * N + n) * kThreads + tid];
          const float ah = hp * e;                    // a_t h_{t-1}
          const float ht = fmaf(hp, e, u * bt[n]);    // h_t, as the forward
          const float gn = fmaf(dyt, ct[n], g[n]);    // g_t
          v[n] = gn * u;
          v[N + n] = dyt * ht;
          du = fmaf(gn, bt[n], du);
          const float gah = gn * ah;
          sda = fmaf(gah, a2[n], sda);
          dA[n] = fmaf(gah, dtt, dA[n]);
          g[n] = gn * e;                              // a_t g_t
        }
        if (live) {
          const int64_t off = (row0 + t0 + j) * D + d;
          a.dx[off] = du * dtt;
          a.ddt[off] = fmaf(du, xt, sda * kLn2);     // a2 = A log2(e)
        }
        const float r = warp_transpose_sum<V>(v);
        if (lane < V) red[(j * kWarps + warp) * V + lane] = r;
      }
    }
    __syncthreads();
    for (int i = tid; i < steps * V; i += kThreads) {
      const int j = i / V, c = i % V;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[(j * kWarps + w) * V + c];
      a.part[((row0 + t0 + j) * gridDim.x + blockIdx.x) * V + c] = s;
    }
  }

  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (a.dh0 != nullptr) a.dh0[state + n] = g[n];
      a.dA_part[state + n] = dA[n];
    }
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

template <int N>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = reverse_smem_floats<N>() * static_cast<int>(sizeof(float));
  auto reverse = reverse_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      reverse, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.D + kThreads - 1) / kThreads, B);
  ckpt_kernel<N><<<grid, kThreads, 0, stream>>>(a);
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
extern "C" int ssm_scan_bwd_block_channels() { return kThreads; }

// C entry point, loaded with ctypes.  Pointers are device pointers to
// contiguous float32 arrays; h0, dh and dh0 may be null.  Scratch: ckpt
// holds (B, ceil(S / kT), D, N) floats, part (B, S, ceil(D / 128), 2N) and
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return launch<4>(a, B, s);
    case 8: return launch<8>(a, B, s);
    case 16: return launch<16>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
