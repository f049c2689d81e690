// Selective-SSM scan (the Mamba recurrence) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/ssm_scan/ssm_scan.py::ssm_scan_pallas.  For every batch row
// b, channel d < D and state index n < N, from h_{-1} = h0 (zeros when no h0
// is given):
//
//   h_t[d, n] = exp(dt_t[d] * A[d, n]) * h_{t-1}[d, n]
//               + (dt_t[d] * x_t[d]) * B_t[n]
//   y_t[d]    = sum_n h_t[d, n] * C_t[n]
//
// It returns y (B, S, D) and the last state h (B, D, N), both float32; the
// D-skip and the gate are the caller's.  Inputs are float32 and contiguous:
// x and dt (B, S, D), A (D, N), B and C (B, S, N), h0 (B, D, N).
//
// Bound, on the H100 SXM.  Jamba's prefill (B 4, S 1024, D 8192, N 16):
// exponentials B*S*D*N = 537 M, 0.128 ms at 16 a clock on each of 132 SMs
// at 1.98 GHz (the CUDA Programming Guide's throughput table for compute
// capability 9.0); bytes: x, dt and y are 134.2 MB each, and B, C, A and h
// add ~3 MB, 406 MB in all, 0.121 ms at 3.35 TB/s.  So the exponentials
// bound it, just above the bytes, and the kernel has to keep the MUFU pipe
// fed and the memory busy at once.  Jamba's decode (S 1, h0 in place):
// 5.1 MB, mostly h read and written, 0.0015 ms; a launch takes longer.
//
// Design:
// - one thread per (channel, batch row) holds its N states h[n] and
//   A[n] * log2(e) in registers across all S steps; a block is 128
//   threads, 128 consecutive channels of one batch row, so a warp's loads
//   of x and dt and its store of y are whole 128-byte lines;
// - each step is N independent exponentials a thread, each one FMUL and
//   one ex2.approx.ftz (exp(v) = 2^(v log2 e)), then h = h * e + (dt x) B
//   as FMUL + FFMA and y += h C as one FFMA, in ascending n; there is no
//   reduction across threads;
// - the steps go in tiles of kT: x and dt of the block's channels and B
//   and C of its batch row are copied by cp.async (16 bytes where D and the
//   pointers allow, 4 otherwise, decided before the launch) into a ring of
//   kStages tiles in shared memory, so the next tiles' loads are in flight
//   while a tile's steps run, with one __syncthreads a tile; B_t and C_t
//   are read as float4 broadcasts;
// - the steps are unrolled by 16 with no branch among them: in a block
//   whose channels are all below D every lane stores y unconditionally, so
//   the compiler schedules 16 steps' exponentials and loads as one block (a
//   store under `if` puts a convergence barrier between the steps), and
//   __launch_bounds__ asks for two blocks an SM, as many as the ring's
//   shared memory allows, which leaves the compiler up to 255 registers a
//   thread to interleave them (PERF.md has the times of each choice);
// - a decode step (S = 1) takes a branch of the same kernel without the
//   ring and without shared memory: every load of a thread (h0, A, x, dt,
//   B_t, C_t) goes out before its first use, and the grid (D / 128 blocks
//   per row) is one wave;
// - h0 may be null (zeros), and h_out may be h0 itself, so that decode updates
//   the cached state in place: each thread reads its own elements of h0
//   before the scan and writes the same elements of h_out after it;
// - ex2.approx has a relative error of ~2^-22, a few ulp of the decay;
//   through the recurrence it grows by at most ~1 / (1 - e^{dt A}), ~1e-6
//   at the dt the model feeds it, far below the 1e-4 the tests hold it to.
// The kernel allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // threads of a block: its channels
constexpr int kT = 32;               // steps of a tile
constexpr int kStages = 3;           // tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bc;
  const float* Cc;
  const float* h0;                   // may be null; may equal h_out
  float* y;
  float* h_out;
  int S;
  int D;
  bool vec_rows;                     // x and dt rows by 16-byte copies
  bool vec_rest;                     // A, h0, h_out, B and C 16-byte aligned
};

// Floats of one stage of the ring (x and dt of the block's channels, B and
// C of its batch row, for kT steps) and the ring's bytes: two blocks an SM.
template <int N>
constexpr int kStageFloats = 2 * kT * kThreads + 2 * kT * N;
template <int N>
constexpr int kSmemBytes = kStages * kStageFloats<N> * 4;

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

// K consecutive floats at p into v: float4 (or float2) loads where p is
// aligned for them.
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

// One step for one thread: its N states advance, and the sum of h C over
// them is returned.
template <int N>
__device__ __forceinline__ float step(float (&h)[N], const float (&a2)[N],
                                      float dtt, float xt,
                                      const float (&bv)[N],
                                      const float (&cv)[N]) {
  const float u = dtt * xt;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float e = ex2(dtt * a2[i]);
    h[i] = fmaf(h[i], e, u * bv[i]);
    acc = fmaf(h[i], cv[i], acc);
  }
  return acc;
}

// Tile rows row .. row + steps - 1 of the block's batch row into one stage
// of the ring: x and dt at [t][c], B and C at [t][n].  Channels past D and
// steps past S are left as they are: no thread stores what they feed.
template <int N>
__device__ __forceinline__ void load_tile(float* st, const Args& a,
                                          int64_t row, int steps, int d0) {
  constexpr int C = kThreads;
  float* xs = st;
  float* dts = st + kT * C;
  float* bs = st + 2 * kT * C;
  float* cs = bs + kT * N;
  const int tid = threadIdx.x;
  if (a.vec_rows) {
    constexpr int Q = C / 4;                 // 16-byte pieces of a row
    for (int i = tid; i < steps * Q; i += kThreads) {
      const int t = i / Q, j = (i % Q) * 4;
      if (d0 + j < a.D) {                    // D % 4 == 0: all 4 or none
        const int64_t off = (row + t) * a.D + d0 + j;
        cp_async16(xs + t * C + j, a.x + off);
        cp_async16(dts + t * C + j, a.dt + off);
      }
    }
  } else {
    for (int i = tid; i < steps * C; i += kThreads) {
      const int t = i / C, j = i % C;
      if (d0 + j < a.D) {
        const int64_t off = (row + t) * a.D + d0 + j;
        cp_async4(xs + t * C + j, a.x + off);
        cp_async4(dts + t * C + j, a.dt + off);
      }
    }
  }
  // B and C: steps * N consecutive floats from row * N
  const float* bsrc = a.Bc + row * N;
  const float* csrc = a.Cc + row * N;
  if (a.vec_rest) {
    for (int i = tid; i < steps * N / 4; i += kThreads) {
      cp_async16(bs + 4 * i, bsrc + 4 * i);
      cp_async16(cs + 4 * i, csrc + 4 * i);
    }
  } else {
    for (int i = tid; i < steps * N; i += kThreads) {
      cp_async4(bs + i, bsrc + i);
      cp_async4(cs + i, csrc + i);
    }
  }
}

// The steps of one tile for one thread; yp is y at the tile's first step.
// ALL: every lane of the block stores (no channel past D), so the stores
// are not branched around and the unrolled steps form one block for the
// scheduler to interleave.  Otherwise only the lanes where ``store`` holds
// do.
template <int N, int STEPS, bool ALL>
__device__ __forceinline__ void scan_tile(const float* st, int steps,
                                          float (&h)[N], const float (&a2)[N],
                                          int c, float* yp, int D,
                                          bool store) {
  constexpr int C = kThreads;
  const float* xs = st;
  const float* dts = st + kT * C;
  const float* bs = st + 2 * kT * C;
  const float* cs = bs + kT * N;
  const int n = STEPS > 0 ? STEPS : steps;
#pragma unroll 16
  for (int t = 0; t < n; ++t) {
    float bv[N], cv[N];
    load_vec(bv, bs + t * N, true);
    load_vec(cv, cs + t * N, true);
    const float yv = step<N>(h, a2, dts[t * C + c], xs[t * C + c], bv, cv);
    if (ALL || store) *yp = yv;
    yp += D;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
ssm_scan_kernel(const Args a) {
  constexpr int C = kThreads;
  extern __shared__ __align__(16) float smem[];

  const int c = threadIdx.x;
  const int S = a.S, D = a.D;
  const int d0 = blockIdx.x * C;
  const int d = d0 + c;
  const bool live = d < D;
  const int b = blockIdx.y;
  const int64_t row0 = static_cast<int64_t>(b) * S;     // step 0's row
  const int64_t state = (static_cast<int64_t>(b) * D + d) * N;

  // A[d] log2(e) and h0 (zeros without one, and past D) into registers
  float a2[N], h[N];
  auto load_state = [&] {
    if (live) {
      load_vec(a2, a.A + static_cast<int64_t>(d) * N, a.vec_rest);
      if (a.h0 != nullptr) load_vec(h, a.h0 + state, a.vec_rest);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      a2[i] = live ? a2[i] * kLog2e : 0.f;
      if (!live || a.h0 == nullptr) h[i] = 0.f;
    }
  };

  if (S == 1) {
    // decode: every load before the first use, no shared memory
    float bv[N], cv[N];
    load_vec(bv, a.Bc + static_cast<int64_t>(b) * N, a.vec_rest);
    load_vec(cv, a.Cc + static_cast<int64_t>(b) * N, a.vec_rest);
    load_state();
    const float xt = live ? a.x[row0 * D + d] : 0.f;
    const float dtt = live ? a.dt[row0 * D + d] : 0.f;
    const float yv = step<N>(h, a2, dtt, xt, bv, cv);
    if (live) {
      a.y[row0 * D + d] = yv;
      store_vec(a.h_out + state, h, a.vec_rest);
    }
    return;
  }

  // the ring: tiles 0 .. kStages - 2 go out before the state is read
  const int tiles = (S + kT - 1) / kT;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < tiles)
      load_tile<N>(smem + k * kStageFloats<N>, a, row0 + k * kT,
                   min(kT, S - k * kT), d0);
    cp_async_commit();
  }
  load_state();

  const bool full = d0 + C <= D;          // every channel of the block live
  float* yp = a.y + row0 * D + d;
  for (int k = 0; k < tiles; ++k) {
    // tile k has landed (this thread's copies), and after the barrier
    // everyone's have and everyone is done with tile k - 1, whose stage
    // tile k + kStages - 1 takes
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = k + kStages - 1;
    if (next < tiles)
      load_tile<N>(smem + (next % kStages) * kStageFloats<N>, a,
                   row0 + static_cast<int64_t>(next) * kT,
                   min(kT, S - next * kT), d0);
    cp_async_commit();
    const float* st = smem + (k % kStages) * kStageFloats<N>;
    const int steps = min(kT, S - k * kT);
    if (steps == kT && full)
      scan_tile<N, kT, true>(st, kT, h, a2, c, yp, D, live);
    else
      scan_tile<N, 0, false>(st, steps, h, a2, c, yp, D, live);
    yp += static_cast<int64_t>(kT) * D;
  }
  if (live) store_vec(a.h_out + state, h, a.vec_rest);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int N>
int launch(const Args& a, int B, cudaStream_t stream) {
  auto kernel = ssm_scan_kernel<N>;
  // the shared-memory attribute, once for each card in turn
  static int set_for = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != set_for) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<N>);
    if (err != cudaSuccess) return err;
    set_for = dev;
  }
  const dim3 grid((a.D + kThreads - 1) / kThreads, B);
  kernel<<<grid, kThreads, a.S == 1 ? 0 : kSmemBytes<N>, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, loaded with ctypes.  Pointers are device pointers to
// contiguous float32 arrays; h0 may be null (zeros) and h_out may equal h0.
// N must be 4, 8 or 16, and B at most 65535 (the grid's second dimension).
// Returns cudaGetLastError() after the launch: non-zero means the launch was
// refused (or an argument was, as cudaErrorInvalidValue).
extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bc, const void* Cc, const void* h0,
                            void* y, void* h_out, int B, int S, int D, int N,
                            void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (S < 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const float*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.Bc = static_cast<const float*>(Bc);
  a.Cc = static_cast<const float*>(Cc);
  a.h0 = static_cast<const float*>(h0);
  a.y = static_cast<float*>(y);
  a.h_out = static_cast<float*>(h_out);
  a.S = S;
  a.D = D;
  a.vec_rows = D % 4 == 0 && aligned16(x) && aligned16(dt);
  a.vec_rest = aligned16(A) && aligned16(Bc) && aligned16(Cc) &&
               aligned16(h0) && aligned16(h_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return launch<4>(a, B, s);
    case 8: return launch<8>(a, B, s);
    case 16: return launch<16>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
