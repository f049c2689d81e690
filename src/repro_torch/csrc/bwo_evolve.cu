// Fused BWO generation (mutation + procreation) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/bwo_evolve/bwo_evolve.py::bwo_evolve_pallas.  For each
// child row i and gene j < D:
//
//   p1 = pop[p1_idx[i], j]            p2 = pop[p2_idx[i], j]
//   mask  = (bits2 & 0xFF) < thresh   (thresh = int(pm_gene * 256))
//   u     = ((bits2 >> 8) & 0xFFFFFF) / 2^24
//   noise = (2u - 1) * mut_scale * (|p1| + 1e-3)
//   p1m   = p1 + noise * mask * row_gate[i]
//   alpha = bits1 / 2^32              (uint32 -> float rounds to nearest)
//   child = alpha * p1m + (1 - alpha) * p2
//
// Bound: memory.  A launch reads the distinct parent rows (at most n_par of
// the P rows), both bit planes (P x Dp 32-bit words each) and writes the
// child (P x D floats); about 15 floating-point operations per gene are
// far below the card's rate.  At the FedBWO main path (P = 6,
// D = 2,465,322, Dp = 2,465,408, n_par = 3) that is about 207 MB, about
// 62 us at the H100 SXM's 3.35 TB/s.
//
// Design, simple first: a row of blocks per child row (blockIdx.y = i),
// threads striding over the genes with coalesced 4-byte loads.  Each block
// reads its row's two parent indices and gate itself (the TPU version
// prefetched them as scalars).  pop is read unpadded with row stride D and
// the bits with row stride Dp; the tail past D is never touched, so the
// caller pads nothing.  The arithmetic uses the _rn intrinsics, which the
// compiler does not contract into FMAs, so each step rounds as the plain
// PyTorch version's separate operations do.  The kernel allocates nothing
// and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void bwo_evolve_kernel(const float* __restrict__ pop,
                                  const int32_t* __restrict__ p1_idx,
                                  const int32_t* __restrict__ p2_idx,
                                  const uint32_t* __restrict__ bits1,
                                  const uint32_t* __restrict__ bits2,
                                  const float* __restrict__ row_gate,
                                  float* __restrict__ out,
                                  int64_t D, int64_t Dp, uint32_t thresh,
                                  float mut_scale) {
  const int64_t i = blockIdx.y;
  const float* p1_row = pop + static_cast<int64_t>(p1_idx[i]) * D;
  const float* p2_row = pop + static_cast<int64_t>(p2_idx[i]) * D;
  const uint32_t* b1_row = bits1 + i * Dp;
  const uint32_t* b2_row = bits2 + i * Dp;
  float* out_row = out + i * D;
  const float gate = row_gate[i];

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < D; j += stride) {
    const float p1 = p1_row[j];
    const float p2 = p2_row[j];
    const uint32_t b1 = b1_row[j];
    const uint32_t b2 = b2_row[j];

    const float mask = (b2 & 0xFFu) < thresh ? 1.0f : 0.0f;
    // exact: a 24-bit integer times a power of two
    const float u = static_cast<float>((b2 >> 8) & 0xFFFFFFu) *
                    (1.0f / 16777216.0f);
    const float centred = __fadd_rn(__fmul_rn(2.0f, u), -1.0f);
    const float noise = __fmul_rn(__fmul_rn(centred, mut_scale),
                                  __fadd_rn(fabsf(p1), 1e-3f));
    const float p1m = __fadd_rn(p1, __fmul_rn(__fmul_rn(noise, mask), gate));
    const float alpha = __fmul_rn(__uint2float_rn(b1), 1.0f / 4294967296.0f);
    out_row[j] = __fadd_rn(__fmul_rn(alpha, p1m),
                           __fmul_rn(__fadd_rn(1.0f, -alpha), p2));
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksX = 65535;

}  // namespace

// C entry point, loaded with ctypes.  Pointers are device pointers; bits are
// 32-bit words (an int32 view of the unsigned values).  Returns
// cudaGetLastError() after the launch: non-zero means the launch was refused.
extern "C" int bwo_evolve_f32(const void* pop, const void* p1_idx,
                              const void* p2_idx, const void* bits1,
                              const void* bits2, const void* row_gate,
                              void* out, int P, long long D, long long Dp,
                              unsigned int thresh, float mut_scale,
                              void* stream) {
  if (P <= 0 || D <= 0) return 0;
  int64_t blocks_x = (D + kThreads - 1) / kThreads;
  if (blocks_x > kMaxBlocksX) blocks_x = kMaxBlocksX;
  dim3 grid(static_cast<unsigned int>(blocks_x), static_cast<unsigned int>(P));
  bwo_evolve_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pop), static_cast<const int32_t*>(p1_idx),
      static_cast<const int32_t*>(p2_idx), static_cast<const uint32_t*>(bits1),
      static_cast<const uint32_t*>(bits2), static_cast<const float*>(row_gate),
      static_cast<float*>(out), D, Dp, thresh, mut_scale);
  return static_cast<int>(cudaGetLastError());
}
