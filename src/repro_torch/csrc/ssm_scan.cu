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
// Bound, on the H100 SXM, at Jamba's prefill shape (B 4, S 1024, D 8192,
// N 16).  Bytes: x, dt and y are 134.2 MB each and B, C, A and h add about
// 3 MB, ~406 MB in all, 0.121 ms at 3.35 TB/s.  Exponentials: B*S*D*N =
// 537 M, 0.128 ms at 16 a clock on each of 132 SMs at 1.98 GHz (the CUDA
// Programming Guide's throughput table for compute capability 9.0).  FP32
// arithmetic: ~7 flops per (b, t, d, n), 3.8 GFLOP, 0.056 ms at 67 TFLOP/s.
// So the exponentials bound it, just above the bytes.  A decode step (S = 1)
// moves ~4 MB (h in and out) and is bound by its launch.
//
// Design, simple first:
// - one block of 256 threads per (tile of 256 / N channels, batch row); one
//   thread per (channel, n) holds h in a register across all S steps, so the
//   state never goes to device memory between steps;
// - the steps go in tiles of 4N: x and dt for the block's channels, and B and
//   C, are staged in shared memory by coalesced loads of the whole block, so
//   a step never waits on device memory; the tile's y is gathered in shared
//   memory and written back row by row;
// - the sum over n is a __shfl_xor_sync butterfly within each group of N
//   lanes (N = 4, 8 or 16 divides the warp, and the groups are aligned);
//   every lane takes part, also those of channels past D, which hold zeros;
// - h0 may be null (zeros), and h_out may be h0 itself, so that decode updates
//   the cached state in place: each thread reads its own element of h0 before
//   the scan and writes the same element of h_out after it;
// - expf, not __expf, and no fast math: the exponentials are those of the
//   plain version to about an ulp.
// The kernel allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bc,
                const float* __restrict__ Cc, const float* h0,
                float* __restrict__ y, float* h_out, int S, int D) {
  constexpr int kDC = kThreads / N;   // channels of one block
  constexpr int kT = 4 * N;           // steps of one shared-memory tile
  __shared__ float xs[kT][kDC];
  __shared__ float dts[kT][kDC];
  __shared__ float ys[kT][kDC];
  __shared__ float bs[kT][N];
  __shared__ float cs[kT][N];

  const int tid = threadIdx.x;
  const int c = tid / N;
  const int n = tid % N;
  const int d0 = blockIdx.x * kDC;
  const int d = d0 + c;
  const bool live = d < D;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * S;  // step 0's row
  const int64_t state = (static_cast<int64_t>(blockIdx.y) * D + d) * N + n;

  const float a = live ? A[static_cast<int64_t>(d) * N + n] : 0.f;
  float h = (live && h0 != nullptr) ? h0[state] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int steps = min(kT, S - t0);
    for (int i = tid; i < kT * kDC; i += kThreads) {
      const int t = i / kDC, j = i % kDC;
      const bool ok = t < steps && d0 + j < D;
      const int64_t off = (row0 + t0 + t) * D + d0 + j;
      xs[t][j] = ok ? x[off] : 0.f;
      dts[t][j] = ok ? dt[off] : 0.f;
    }
    for (int i = tid; i < kT * N; i += kThreads) {
      const int t = i / N, j = i % N;
      const bool ok = t < steps;
      const int64_t off = (row0 + t0 + t) * N + j;
      bs[t][j] = ok ? Bc[off] : 0.f;
      cs[t][j] = ok ? Cc[off] : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float dtt = dts[t][c];
      h = h * expf(dtt * a) + (dtt * xs[t][c]) * bs[t][n];
      float p = h * cs[t][n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) ys[t][c] = p;
    }
    __syncthreads();
    // the next tile's loads touch xs, dts, bs and cs only, and its steps
    // write ys after the barrier that follows those loads
    for (int i = tid; i < steps * kDC; i += kThreads) {
      const int t = i / kDC, j = i % kDC;
      if (d0 + j < D) y[(row0 + t0 + t) * D + d0 + j] = ys[t][j];
    }
  }
  if (live) h_out[state] = h;
}

template <int N>
int launch(const float* x, const float* dt, const float* A, const float* Bc,
           const float* Cc, const float* h0, float* y, float* h_out, int B,
           int S, int D, cudaStream_t stream) {
  constexpr int kDC = kThreads / N;
  const dim3 grid((D + kDC - 1) / kDC, B);
  ssm_scan_kernel<N><<<grid, kThreads, 0, stream>>>(x, dt, A, Bc, Cc, h0, y,
                                                    h_out, S, D);
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
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Bf = static_cast<const float*>(Bc);
  const auto* Cf = static_cast<const float*>(Cc);
  const auto* h0f = static_cast<const float*>(h0);
  auto* yf = static_cast<float*>(y);
  auto* hf = static_cast<float*>(h_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return launch<4>(xf, dtf, Af, Bf, Cf, h0f, yf, hf, B, S, D, s);
    case 8: return launch<8>(xf, dtf, Af, Bf, Cf, h0f, yf, hf, B, S, D, s);
    case 16: return launch<16>(xf, dtf, Af, Bf, Cf, h0f, yf, hf, B, S, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
