// Flash attention backward in float32 on Hopper's tensor cores (sm_90a):
// 3xTF32 products by wgmma, TMA loads and mbarriers, at hd 64.
//
// The gradient of the function that
// repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// computes (:99), for float32 at hd 64; flash_attention_bwd.cu keeps the
// other float32 calls on the CUDA cores and flash_attention_bwd_hopper.cu
// takes bf16.  The reference differentiates no Pallas kernel: its train
// step takes the gradient of blockwise_attention (repro/models/attention.py)
// with XLA.  For every batch row b, query head h, query i and key j (KV
// head h / rep), with the forward's masks (causal: j <= i; window w: j > i
// - w; every j < Sk):
//
//   s_ij  = (q_i . k_j) * scale,   P_ij = exp(s_ij - lse_i)  (0 if masked)
//   dP_ij = dO_i . v_j,            D_i = sum_j P_ij dP_ij
//   dS_ij = P_ij (dP_ij - D_i)
//   dq_i  = scale * sum_j dS_ij k_j
//   dk_j  = scale * sum_{i, h in j's group} dS_ij q_i
//   dv_j  = sum_{i, h in j's group} P_ij dO_i
//
// float32 in and out.  The queries' positions start at 0 and every key is
// valid (training).  D is sum_j P dP from the recomputed P and dP, not dO .
// O (flash_attention_bwd_hopper.cu says why).
//
// Precision: every product runs as 3xTF32 (flash_attention_tf32.cu says
// more): each operand x split into hi = tf32(x), x itself as the tensor
// cores read it, and lo = x - hi, and a b taken as hi_a hi_b + hi_a lo_b +
// lo_a hi_b, so the gradients keep float32's 1e-4 of their largest entry,
// which plain TF32 misses (tests/test_torch_tf32x3.py emulates both on the
// CPU).  Each tile's gradient product goes into a fresh accumulator that
// the CUDA cores add to dq, dk or dv in fp32: the tensor cores' own sums
// cut toward zero, and that bias grows with the length of the sum.
//
// Bound, on the H100 SXM at 700 W.  The function needs 5 products over the
// valid pairs.  Whisper-medium's encoder at its train shape (B 4, 1500 x
// 1500, 16 heads on 16, hd 64): 92.2 GFLOP, 1.376 ms at the CUDA cores' 67
// TFLOP/s, 0.559 ms as 3xTF32 at 495 TFLOP/s (3 x 92.2 GFLOP of tensor-core
// work), against 0.0514 ms for 172 MB of q, k, v, dO, dq, dk and dv.  Its
// cross-attention (448 queries on 1500 frames): 27.5 GFLOP, 0.167 ms as
// 3xTF32.  So the products bound it.  This design does 9 products over the
// pairs (27 on the tensor cores), so its own floor is 1.8 x the bound's.
//
// Design: flash_attention_bwd_hopper.cu's split of the gradient into a dq
// kernel and a dk/dv kernel, with no atomics anywhere, so two launches give
// the same bits.  Both kernels have three warpgroups: in the first, one
// thread issues TMA loads and three warps split each arrived float32 tile
// into tf32 hi and lo tiles (a second ring of 2 stages, fenced to the
// async proxy for wgmma; a warp's unit is 4 columns of 32 rows, a row a
// lane, the loads of two units in flight together); the other two are
// consumers.  wgmma takes tf32 operands K-major only, so where an operand
// is the B of a gradient product (K for dq, Q and dO for dk and dv) the
// split warps also write it transposed, (hd, rows), in the same pass, with
// the rows of each group of 8 permuted to the order in which the consumers
// hold the register A operand (the accumulator's columns 2t and 2t + 1
// where tf32's A fragment has t and t + 4).  The operand that stays for the
// whole block is an A operand the consumers hold: K or V in the dk/dv
// kernel as hi and lo fragments in registers; Q and dO in the dq kernel
// with their hi in registers and their lo written over them in the block's
// own tiles, an A operand from shared memory (both parts in registers
// spilled).  So wgmma reads shared memory only for the
// streamed tiles, and each kernel fits the 227 KB.  Blocks are numbered
// head by head, so the blocks at work at one time share a few heads' K and
// V (Q and dO) through L2.
// - dq kernel: one block per (128-query tile, head, batch row), heaviest
//   first within a head; each consumer owns 64 query rows.  Q and dO come
//   in once; K and V of every visible 32-key tile stream twice through the
//   rings.  Pass 1: S = Q K^T and dP = dO V^T (m64n32k8), the rows' online
//   max, sum and sum of P dP; lse (log2 units) and D go to an fp32 (2, B, H,
//   Sq_pad) scratch the wrapper allocates, rows past Sq at lse 1e30, so
//   their P is exactly 0.  Pass 2: S and dP again, dS in registers, dQ +=
//   dS K (m64n64k8, B the K^T tiles), the tile's product in S's and dP's
//   registers.  5 products a pair.
// - dk/dv kernel: one block per (64-key tile, KV head, batch row), the first
//   key tiles first.  K and V stay (the dV consumer holds K, the dK consumer
//   V); Q, dO and the rows' (lse, D) of every visible 32-query tile of
//   every query head of the group stream through the rings.  The dV
//   consumer: S^T = K Q^T, P^T, dV += P^T dO (B dO^T); the dK consumer:
//   dP^T = V dO^T, dS^T = P^T (dP^T - D), dK += dS^T Q (B Q^T), with P^T
//   handed over in fp32 through a double-buffered shared-memory exchange
//   under named barriers.  4 products a pair.
// - Tiles that no pair of a warpgroup can see are never computed; only
//   tiles that cross a boundary are masked.  Rows past Sq and keys past Sk
//   arrive as TMA zeros.
// Like the forward, both kernels are bound by issue slots more than by the
// tensor cores (tools/flash_attention_tf32_ablation.py times each part).
// Nothing here allocates or synchronises; the entry point returns the CUDA
// error of its launches (or of a tensor map's encoding, as 1000 +
// CUresult).  A wait on an mbarrier that lasts seconds traps.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's finite mask value
constexpr float kNoRow = 1e30f;     // a padding row's lse: its P is 0
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers --
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - start > (4ll << 30)) __trap();   // ~2 s: a broken pipeline
  }
}

// ------------------------------------------------------------------ TMA --
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Stores of this thread to shared memory become visible to wgmma's reads
// (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// --------------------------------------------------------------- 3xTF32 --
// x = hi + lo for 3xTF32.  The tensor cores read a float32 operand's top
// 19 bits (sign, exponent, 10 of the 23 mantissa bits) and ignore the rest,
// so x itself serves as hi (tf32(x), cut toward zero), and lo is the exact
// remainder x - tf32(x), of which they read the top 19 bits in turn: a b
// then comes to ~2^-20 of itself.  (Clearing hi's low bits by hand gives
// the same bits on the H100, and rounding both parts with cvt.rna.tf32.f32
// takes longer: tools/flash_attention_tf32_ablation.py.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xFFFFE000u));
}

// 2^x in one instruction (subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- wgmma --
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers across the
// asynchronous window of a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (bytes; stored in 16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)             // leading: 16 B
         | (static_cast<uint64_t>(1024 >> 4) << 32)     // 8 rows: 1024 B
         | (1ull << 62);
}

// d (64 x 32, fp32) = (scale_d ? d : 0) + A (64 x 8, tf32 in registers)
// B (8 x 32); B from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n32k8(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 32, fp32) += A (64 x 8) B (8 x 32), both from shared memory,
// K-major.
__device__ __forceinline__ void wgmma_m64n32k8_ss(float (&d)[16], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, 1, 1, 1;"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db));
}

// d (64 x 64, fp32) = (scale_d ? d : 0) + A (64 x 8, tf32 in registers)
// B (8 x 64); B from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ====================================================== shared by both ==
constexpr int kHD = 64;             // the head dim this route takes
constexpr int kPanel = 32;          // float32 columns in a 128-byte row
constexpr int kThreads = 384;       // loader/splitter + 2 consumer warpgroups
constexpr int kSplitWarps = 3;      // warps 1-3 of the first warpgroup
constexpr int kStages = 2;          // the raw ring and the split ring
constexpr int kDqRows = 128;        // dq kernel: queries of a block (2 x 64)
constexpr int kDqKeys = 32;         //            keys of a streamed tile
constexpr int kKvKeys = 64;         // dk/dv kernel: keys of a block
constexpr int kKvRows = 32;         //               queries of a tile
constexpr int kPBufs = 2;           //               P^T exchange buffers

struct Params {
  float* dq;                        // (B, Sq, H, 64), contiguous
  float* dk;                        // (B, Sk, KV, 64)
  float* dv;
  float* stats;                     // (2, B, H, sq_pad): lse (log2), D
  int Sq, Sk, H, KV, B, rep, sq_pad;
  int n_qtiles, n_ktiles;           // 128-query tiles; 64-key tiles
  int causal, window;               // window <= 0: none
  float scale, scale_log2;
};

__device__ __forceinline__ bool pair_ok(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// Some pair of queries [q0, q0 + nq) and keys [k0, k0 + nk) (each clipped
// to its length) is visible.
__device__ __forceinline__ bool tile_visible(const Params& p, int q0, int nq,
                                             int k0, int nk) {
  if (q0 >= p.Sq || k0 >= p.Sk) return false;
  const int qmax = min(q0 + nq - 1, p.Sq - 1);
  const int kmax = min(k0 + nk - 1, p.Sk - 1);
  if (p.causal && k0 > qmax) return false;
  if (p.window > 0 && kmax <= q0 - p.window) return false;
  return true;
}

// Some pair of the tile is not: it has to be masked.
__device__ __forceinline__ bool tile_masked(const Params& p, int q0, int nq,
                                            int k0, int nk) {
  return k0 + nk > p.Sk || (p.causal && k0 + nk - 1 > q0)
      || (p.window > 0 && k0 <= q0 + nq - 1 - p.window);
}

// Byte offset of element (row, col) in a tile of 32-column panels, 128-byte
// swizzled as TMA writes it and wgmma reads it; `panel_bytes` apart.
__device__ __forceinline__ uint32_t swz(int row, int col, int panel_bytes) {
  return (col / kPanel) * panel_bytes + row * 128
         + ((((col % kPanel) >> 2) ^ (row & 7)) << 4) + ((col & 3) << 2);
}

// The transposed tile's column (within its group of 8) that holds row m of
// the group: the consumers hold the A operand's columns 2t and 2t + 1
// where tf32's A fragment has t and t + 4.
__device__ __forceinline__ int perm_col(int m) {
  return (m >> 1) + 4 * (m & 1);
}

// One pass of the split warps over a raw (ROWS x 64) tile as TMA wrote it
// (32-column panels of ROWS x 128 bytes).  A warp's unit is 4 columns of
// the 32 rows of one panel, a row a lane; the loads of 4 units go out
// before their stores, so their latencies overlap.  SAME: hi and lo at the
// raw offsets; TRANS: hi and lo transposed into (64, ROWS) tiles (panels of
// 64 x 128 bytes), rows permuted by perm_col within each group of 8, 32
// distinct banks for each store.  w: the warp's index among the split
// warps.
template <int ROWS, bool SAME, bool TRANS>
__device__ __forceinline__ void split_tile(const uint8_t* raw, uint8_t* s_hi,
                                           uint8_t* s_lo, uint8_t* t_hi,
                                           uint8_t* t_lo, int w, int lane) {
  constexpr int kBatch = 2;
  if constexpr (SAME && !TRANS) {
    // the same offsets: float4 by float4, a thread's next to its neighbour's
    constexpr int kVecs = ROWS * kHD / 4, kStride = 32 * kSplitWarps;
    for (int i0 = w * 32 + lane; i0 < kVecs; i0 += kBatch * kStride) {
      float4 x[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (i0 + i * kStride < kVecs)
          x[i] = reinterpret_cast<const float4*>(raw)[i0 + i * kStride];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (i0 + i * kStride >= kVecs) continue;
        uint4 h, l;
        split_tf32(x[i].x, h.x, l.x);
        split_tf32(x[i].y, h.y, l.y);
        split_tf32(x[i].z, h.z, l.z);
        split_tf32(x[i].w, h.w, l.w);
        reinterpret_cast<uint4*>(s_hi)[i0 + i * kStride] = h;
        reinterpret_cast<uint4*>(s_lo)[i0 + i * kStride] = l;
      }
    }
    return;
  }
  constexpr int kUnits = (kHD / 4) * (ROWS / kPanel);
  for (int u0 = w; u0 < kUnits; u0 += kBatch * kSplitWarps) {
    float4 x[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int u = u0 + i * kSplitWarps;
      if (u < kUnits)
        x[i] = *reinterpret_cast<const float4*>(
            raw + swz((u / (kHD / 4)) * kPanel + lane, (u % (kHD / 4)) * 4,
                      ROWS * 128));
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int u = u0 + i * kSplitWarps;
      if (u >= kUnits) continue;
      const int row = (u / (kHD / 4)) * kPanel + lane;
      const int d0 = (u % (kHD / 4)) * 4;
      uint4 h, l;
      split_tf32(x[i].x, h.x, l.x);
      split_tf32(x[i].y, h.y, l.y);
      split_tf32(x[i].z, h.z, l.z);
      split_tf32(x[i].w, h.w, l.w);
      if (SAME) {
        const uint32_t off = swz(row, d0, ROWS * 128);
        *reinterpret_cast<uint4*>(s_hi + off) = h;
        *reinterpret_cast<uint4*>(s_lo + off) = l;
      }
      if (TRANS) {
        const int col = (row & ~7) + perm_col(row & 7);
        const uint32_t hs[4] = {h.x, h.y, h.z, h.w};
        const uint32_t ls[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t off = swz(d0 + e, col, kHD * 128);
          *reinterpret_cast<uint32_t*>(t_hi + off) = hs[e];
          *reinterpret_cast<uint32_t*>(t_lo + off) = ls[e];
        }
      }
    }
  }
}

// 64 rows of a (ROWS x 64) float32 tile, from row r0, as hi and lo A
// fragments: k-step kk holds (row g, column 8 kk + t), (g + 8, 8 kk + t),
// (g, 8 kk + t + 4), (g + 8, 8 kk + t + 4) of the warp's 16 rows.
template <int ROWS>
__device__ __forceinline__ void load_a(const uint8_t* raw, int r0,
                                       uint32_t (&ah)[8][4],
                                       uint32_t (&al)[8][4]) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int row = r0 + warp * 16 + lane / 4, tc = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kHD / 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = *reinterpret_cast<const float*>(
          raw + swz(row + 8 * (e & 1), 8 * kk + tc + 4 * (e >> 1),
                    ROWS * 128));
      split_tf32(x, ah[kk][e], al[kk][e]);
    }
  }
}

// The dq kernel's A operands, 64 rows of the 128-row Q or dO tile from row
// r0: hi (x itself) into registers as load_a's fragments, lo = x - tf32(x)
// written back over x in the tile, where it is issue_s_lo's A operand.
// The caller fences and syncs the warpgroup before wgmma reads it.
__device__ __forceinline__ void load_a_lo_in_place(uint8_t* tile, int r0,
                                                   uint32_t (&ah)[8][4]) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int row = r0 + warp * 16 + lane / 4, tc = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kHD / 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float* at = reinterpret_cast<float*>(
          tile + swz(row + 8 * (e & 1), 8 * kk + tc + 4 * (e >> 1),
                     kDqRows * 128));
      uint32_t lo;
      split_tf32(*at, ah[kk][e], lo);
      *at = __uint_as_float(lo);
    }
  }
}

// S (64 x 32) = A B^T over hd as issue_s, with A's lo from shared memory:
// rows a_lo .. of the 128-row tile's 2 panels.
__device__ __forceinline__ void issue_s_lo(float (&s)[16],
                                           const uint32_t (&ah)[8][4],
                                           uint32_t a_lo, uint32_t b_hi,
                                           uint32_t b_lo) {
  const uint64_t a0 = sw128_desc(a_lo);
  const uint64_t h0 = sw128_desc(b_hi), l0 = sw128_desc(b_lo);
#pragma unroll
  for (int kk = 0; kk < kHD / 8; ++kk) {
    const uint32_t off = ((kk / 4) * (32 * 128) + (kk % 4) * 32) >> 4;
    const uint32_t a_off = ((kk / 4) * (kDqRows * 128) + (kk % 4) * 32) >> 4;
    const uint64_t dh = h0 + off, dl = l0 + off;
    if (kk == 0) {
      wgmma_m64n32k8(s, ah[kk], dh, 0);
      wgmma_m64n32k8_ss(s, a0 + a_off, dh);
    } else {
      wgmma_m64n32k8_ss(s, a0 + a_off, dh);
      wgmma_m64n32k8(s, ah[kk], dh, 1);
    }
    wgmma_m64n32k8(s, ah[kk], dl, 1);
  }
}

// S (64 x 32) = A B^T over hd: A from registers, B a 32-row tile's hi and
// lo (K-major, 2 panels of 32 x 128 bytes); 8 k-steps, each as lo_a hi_b
// + hi_a lo_b + hi_a hi_b.
__device__ __forceinline__ void issue_s(float (&s)[16],
                                        const uint32_t (&ah)[8][4],
                                        const uint32_t (&al)[8][4],
                                        uint32_t b_hi, uint32_t b_lo) {
  const uint64_t h0 = sw128_desc(b_hi), l0 = sw128_desc(b_lo);
#pragma unroll
  for (int kk = 0; kk < kHD / 8; ++kk) {
    // the start address is the descriptor's low field, in 16-byte units
    const uint32_t off = ((kk / 4) * (32 * 128) + (kk % 4) * 32) >> 4;
    const uint64_t dh = h0 + off, dl = l0 + off;
    wgmma_m64n32k8(s, al[kk], dh, kk > 0);
    wgmma_m64n32k8(s, ah[kk], dl, 1);
    wgmma_m64n32k8(s, ah[kk], dh, 1);
  }
}

// acc (64 x 64) = A B: A (64 x 32) as 4 register k-steps, B the
// transposed tile's hi and lo (64 rows of hd, 32 K-major columns).  The
// callers add acc to their sums in fp32 on the CUDA cores: the tensor
// cores' own sums cut toward zero, and over a long sum (47 key tiles of
// Whisper's encoder) that bias grows to ~1e-5 of the result.
__device__ __forceinline__ void issue_grad(float (&acc)[32],
                                           const uint32_t (&ah)[4][4],
                                           const uint32_t (&al)[4][4],
                                           uint32_t b_hi, uint32_t b_lo) {
  const uint64_t h0 = sw128_desc(b_hi), l0 = sw128_desc(b_lo);
#pragma unroll
  for (int kj = 0; kj < 4; ++kj) {
    const uint64_t dh = h0 + kj * 2, dl = l0 + kj * 2;   // 32 bytes on
    wgmma_m64n64k8(acc, al[kj], dh, kj > 0);
    wgmma_m64n64k8(acc, ah[kj], dl, 1);
    wgmma_m64n64k8(acc, ah[kj], dh, 1);
  }
}

// A 64 x 32 accumulator as hi and lo A fragments of the next product:
// k-step n8 takes columns 8 n8 .. 8 n8 + 7 as (row g, 2t), (g + 8, 2t),
// (g, 2t + 1), (g + 8, 2t + 1), which the transposed B tiles' permuted
// rows match.
__device__ __forceinline__ void to_a(const float (&x)[16],
                                     uint32_t (&ah)[4][4],
                                     uint32_t (&al)[4][4]) {
#pragma unroll
  for (int n8 = 0; n8 < 4; ++n8) {
    split_tf32(x[4 * n8 + 0], ah[n8][0], al[n8][0]);
    split_tf32(x[4 * n8 + 2], ah[n8][1], al[n8][1]);
    split_tf32(x[4 * n8 + 1], ah[n8][2], al[n8][2]);
    split_tf32(x[4 * n8 + 3], ah[n8][3], al[n8][3]);
  }
}

// A (64 x 64) accumulator to rows [r0, r0 + 64) of a (B, S, heads, 64)
// float32 array at `base` (the batch row's and head's first element),
// times f; rows at or past S dropped.
__device__ __forceinline__ void store_rows(float* base, int64_t row_stride,
                                           int r0, int S,
                                           const float (&acc)[32], float f) {
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int row = r0 + (tid / 32) * 16 + lane / 4, tc = lane % 4;
#pragma unroll
  for (int n8 = 0; n8 < kHD / 8; ++n8) {
    const int col = 8 * n8 + 2 * tc;
    if (row < S)
      *reinterpret_cast<float2*>(base + row * row_stride + col) =
          make_float2(acc[4 * n8 + 0] * f, acc[4 * n8 + 1] * f);
    if (row + 8 < S)
      *reinterpret_cast<float2*>(base + (row + 8) * row_stride + col) =
          make_float2(acc[4 * n8 + 2] * f, acc[4 * n8 + 3] * f);
  }
}

// The split warps' loop: for each of `n` tiles, wait for its raw stage and
// a free split stage, split it (fn(raw stage, split stage, it)), fence,
// and free the raw stage and fill the split one.
template <typename F>
__device__ __forceinline__ void split_loop(int n, uint64_t* raw_full,
                                           uint64_t* raw_empty,
                                           uint64_t* split_full,
                                           uint64_t* split_empty, F fn) {
  for (int it = 0; it < n; ++it) {
    const int s = it % kStages;
    mbar_wait(&raw_full[s], (it / kStages) & 1);
    if (it >= kStages) mbar_wait(&split_empty[s], ((it / kStages) + 1) & 1);
    fn(s, it);
    fence_async_smem();
    __syncwarp();
    if (threadIdx.x % 32 == 0) {
      mbar_arrive(&raw_empty[s]);
      mbar_arrive(&split_full[s]);
    }
  }
}

// The barriers both kernels use: the block's resident tiles, then full
// and empty for each stage of the raw and the split ring.
struct Bars {
  uint64_t* once;
  uint64_t* raw_full;
  uint64_t* raw_empty;
  uint64_t* split_full;
  uint64_t* split_empty;
  static constexpr int kCount = 1 + 4 * kStages;
  __device__ explicit Bars(uint8_t* at) {
    once = reinterpret_cast<uint64_t*>(at);
    raw_full = once + 1;
    raw_empty = raw_full + kStages;
    split_full = raw_empty + kStages;
    split_empty = split_full + kStages;
  }
  __device__ void init() const {
    mbar_init(once, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&raw_full[s], 1);
      mbar_init(&raw_empty[s], kSplitWarps);
      mbar_init(&split_full[s], kSplitWarps);
      mbar_init(&split_empty[s], 8);   // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
};

// ============================================================ dq kernel ==
struct DqSmem {
  static constexpr int kRows = kDqRows * kHD * 4;      // Q, or dO
  static constexpr int kTile = kDqKeys * kHD * 4;      // K, V or a split
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kRows;
  static constexpr int kRaw = kDO + kRows;             // [stage][K, V]
  // [stage][K hi, K lo, V hi, V lo, K^T hi, K^T lo]
  static constexpr int kSplit = kRaw + kStages * 2 * kTile;
  static constexpr int kBars = kSplit + kStages * 6 * kTile;
  static constexpr int kBytes = kBars + Bars::kCount * 8 + 1024;
};
static_assert(DqSmem::kBytes <= 232448, "shared memory");

// The keys a 128-query tile sees, as 32-key tiles from lo.
__device__ __forceinline__ void dq_key_tiles(const Params& p, int q0, int& lo,
                                             int& n) {
  int hi = p.Sk;
  if (p.causal) hi = min(hi, min(q0 + kDqRows, p.Sq));
  int first = 0;
  if (p.window > 0) first = max(0, q0 - p.window + 1);
  lo = first / kDqKeys * kDqKeys;
  n = hi > lo ? (hi - lo + kDqKeys - 1) / kDqKeys : 0;
}

__global__ void __launch_bounds__(kThreads, 1)
fa_tf32_dq_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = DqSmem;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle pattern repeats every 8 rows of 128 B
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Bars bars(smem + L::kBars);

  // the work item, head by head and within a head heaviest first (the
  // last query tiles see the most keys), so the blocks at work at one time
  // share the K and V of a few heads through L2
  const int w = blockIdx.x;
  const int hb = w / p.n_qtiles;
  const int q0 = (p.n_qtiles - 1 - (w - hb * p.n_qtiles)) * kDqRows;
  const int h = hb % p.H, b = hb / p.H;
  const int kvh = h / p.rep;
  int lo, n_tiles;
  dq_key_tiles(p, q0, lo, n_tiles);

  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      // ------------------------------------------------ TMA producer --
      mbar_expect_tx(bars.once, 2 * L::kRows);
      for (int c = 0; c < kHD / kPanel; ++c) {
        tma_load_4d(smem + L::kQ + c * kDqRows * 128, &tq, bars.once,
                    c * kPanel, h, q0, b);
        tma_load_4d(smem + L::kDO + c * kDqRows * 128, &tdo, bars.once,
                    c * kPanel, h, q0, b);
      }
      // both passes read K and V of every visible key tile
      for (int it = 0; it < 2 * n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages)
          mbar_wait(&bars.raw_empty[s], ((it / kStages) + 1) & 1);
        const int k0 = lo + (it % n_tiles) * kDqKeys;
        uint8_t* raw = smem + L::kRaw + s * 2 * L::kTile;
        mbar_expect_tx(&bars.raw_full[s], 2 * L::kTile);
        for (int c = 0; c < kHD / kPanel; ++c) {
          tma_load_4d(raw + c * kDqKeys * 128, &tk, &bars.raw_full[s],
                      c * kPanel, kvh, k0, b);
          tma_load_4d(raw + L::kTile + c * kDqKeys * 128, &tv,
                      &bars.raw_full[s], c * kPanel, kvh, k0, b);
        }
      }
    } else if (threadIdx.x >= 32) {
      // --------------------------------------------- the split warps --
      const int sw = threadIdx.x / 32 - 1, lane = threadIdx.x % 32;
      split_loop(2 * n_tiles, bars.raw_full, bars.raw_empty, bars.split_full,
                 bars.split_empty, [&](int s, int it) {
        const uint8_t* raw = smem + L::kRaw + s * 2 * L::kTile;
        uint8_t* split = smem + L::kSplit + s * 6 * L::kTile;
        if (it < n_tiles)
          split_tile<kDqKeys, true, false>(raw, split, split + L::kTile,
                                           nullptr, nullptr, sw, lane);
        else                        // pass 2: K^T too, the B of dQ += dS K
          split_tile<kDqKeys, true, true>(raw, split, split + L::kTile,
                                          split + 4 * L::kTile,
                                          split + 5 * L::kTile, sw, lane);
        split_tile<kDqKeys, true, false>(raw + L::kTile, split + 2 * L::kTile,
                                         split + 3 * L::kTile, nullptr,
                                         nullptr, sw, lane);
      });
    }
    return;
  }
  // ------------------------------------------------------- consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int cw = wg - 1;                        // 64-row half of the tile
  const int tid = threadIdx.x - wg * 128;
  const int warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tc = lane % 4;
  const int row0 = cw * 64 + warp * 16 + gr;    // and row0 + 8
  const int qpos0 = q0 + row0, qpos1 = qpos0 + 8;
  const int qw0 = q0 + cw * 64;                 // this warpgroup's rows

  // Q's and dO's hi in registers, their lo in place of them in the tiles
  uint32_t qh[8][4], oh[8][4];
  mbar_wait(bars.once, 0);
  load_a_lo_in_place(smem + L::kQ, cw * 64, qh);
  load_a_lo_in_place(smem + L::kDO, cw * 64, oh);
  fence_async_smem();
  asm volatile("bar.sync %0, 128;" :: "r"(1 + cw) : "memory");
  const uint32_t q_lo = smem_u32(smem + L::kQ) + cw * 64 * 128;
  const uint32_t do_lo = smem_u32(smem + L::kDO) + cw * 64 * 128;

  // pass 1: the rows' log-sum-exp, as the forward's online softmax, in
  // log2 units, and D = sum_j P dP with the same running rescale
  // S and dP side by side: pass 2 takes dQ's tile product into the pair
  // once dS has left them for its A fragments
  float sdp[32];
  float (&s)[16] = *reinterpret_cast<float(*)[16]>(sdp);
  float (&dp)[16] = *reinterpret_cast<float(*)[16]>(sdp + 16);
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f, a0 = 0.0f,
        a1 = 0.0f;
  int it = 0;
  for (int t = 0; t < n_tiles; ++t, ++it) {
    const int st = it % kStages;
    const int k0 = lo + t * kDqKeys;
    mbar_wait(&bars.split_full[st], (it / kStages) & 1);
    if (tile_visible(p, qw0, 64, k0, kDqKeys)) {
      const uint32_t split = smem_u32(smem + L::kSplit + st * 6 * L::kTile);
      wgmma_fence();
      issue_s_lo(s, qh, q_lo, split, split + L::kTile);
      issue_s_lo(dp, oh, do_lo, split + 2 * L::kTile, split + 3 * L::kTile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      const bool masked = tile_masked(p, qw0, 64, k0, kDqKeys);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n8 = 0; n8 < kDqKeys / 8; ++n8) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * n8 + e] * p.scale_log2;
          if (masked && !pair_ok(p, e < 2 ? qpos0 : qpos1,
                                 k0 + 8 * n8 + 2 * tc + (e & 1)))
            x = kNegInf;
          s[4 * n8 + e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
      l0 *= c0;
      a0 *= c0;
      l1 *= c1;
      a1 *= c1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n8 = 0; n8 < kDqKeys / 8; ++n8) {
        const float e0 = ex2(s[4 * n8 + 0] - mn0);
        const float e1 = ex2(s[4 * n8 + 1] - mn0);
        const float e2 = ex2(s[4 * n8 + 2] - mn1);
        const float e3 = ex2(s[4 * n8 + 3] - mn1);
        l0 += e0 + e1;
        l1 += e2 + e3;
        a0 = fmaf(e0, dp[4 * n8 + 0], fmaf(e1, dp[4 * n8 + 1], a0));
        a1 = fmaf(e2, dp[4 * n8 + 2], fmaf(e3, dp[4 * n8 + 3], a1));
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.split_empty[st]);
  }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    a0 += __shfl_xor_sync(0xffffffffu, a0, off);
    a1 += __shfl_xor_sync(0xffffffffu, a1, off);
  }
  const float lse0 = qpos0 < p.Sq ? m0 + log2f(l0) : kNoRow;
  const float lse1 = qpos1 < p.Sq ? m1 + log2f(l1) : kNoRow;
  const float d0 = qpos0 < p.Sq ? a0 / l0 : 0.0f;
  const float d1 = qpos1 < p.Sq ? a1 / l1 : 0.0f;
  if (tc == 0) {
    const int64_t stat = (static_cast<int64_t>(b) * p.H + h) * p.sq_pad;
    const int64_t plane = static_cast<int64_t>(p.B) * p.H * p.sq_pad;
    p.stats[stat + qpos0] = lse0;
    p.stats[stat + qpos1] = lse1;
    p.stats[plane + stat + qpos0] = d0;
    p.stats[plane + stat + qpos1] = d1;
  }

  // pass 2: dQ += dS K
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.0f;
  for (int t = 0; t < n_tiles; ++t, ++it) {
    const int st = it % kStages;
    const int k0 = lo + t * kDqKeys;
    mbar_wait(&bars.split_full[st], (it / kStages) & 1);
    if (tile_visible(p, qw0, 64, k0, kDqKeys)) {
      const uint32_t split = smem_u32(smem + L::kSplit + st * 6 * L::kTile);
      wgmma_fence();
      issue_s_lo(s, qh, q_lo, split, split + L::kTile);
      issue_s_lo(dp, oh, do_lo, split + 2 * L::kTile, split + 3 * L::kTile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      const bool masked = tile_masked(p, qw0, 64, k0, kDqKeys);
#pragma unroll
      for (int n8 = 0; n8 < kDqKeys / 8; ++n8) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr = ex2(s[4 * n8 + e] * p.scale_log2
                           - (e < 2 ? lse0 : lse1));
          if (masked && !pair_ok(p, e < 2 ? qpos0 : qpos1,
                                 k0 + 8 * n8 + 2 * tc + (e & 1)))
            pr = 0.0f;
          s[4 * n8 + e] = pr * (dp[4 * n8 + e] - (e < 2 ? d0 : d1));
        }
      }
      uint32_t dh[4][4], dl[4][4];
      to_a(s, dh, dl);
      wgmma_fence();
      issue_grad(sdp, dh, dl, split + 4 * L::kTile, split + 5 * L::kTile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sdp);
#pragma unroll
      for (int kj = 0; kj < 4; ++kj) {
        fence_regs(dh[kj]);
        fence_regs(dl[kj]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] += sdp[i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.split_empty[st]);
  }

  // dq = scale dS K, rows past Sq dropped
  const int64_t row_stride = static_cast<int64_t>(p.H) * kHD;
  store_rows(p.dq + static_cast<int64_t>(b) * p.Sq * row_stride
             + static_cast<int64_t>(h) * kHD, row_stride, q0 + cw * 64, p.Sq,
             dq, p.scale);
}

// ========================================================= dk/dv kernel ==
struct KvSmem {
  static constexpr int kKeys = kKvKeys * kHD * 4;      // K, and V
  static constexpr int kTile = kKvRows * kHD * 4;      // Q, dO or a split
  static constexpr int kStatBytes = 2 * kKvRows * 4;   // lse, then D
  // stages padded to 1024 bytes: the swizzled tiles need that alignment
  static constexpr int kRawStage = (2 * kTile + kStatBytes + 1023) / 1024
                                   * 1024;
  static constexpr int kSplitStage = (8 * kTile + kStatBytes + 1023) / 1024
                                     * 1024;
  static constexpr int kPBytes = kKvKeys * kKvRows * 4;  // P^T, fp32
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKeys;
  static constexpr int kRaw = kV + kKeys;              // [stage][Q, dO, stats]
  // [stage][Q hi, Q lo, dO hi, dO lo, Q^T hi, Q^T lo, dO^T hi, dO^T lo,
  // stats]
  static constexpr int kSplit = kRaw + kStages * kRawStage;
  static constexpr int kP = kSplit + kStages * kSplitStage;
  static constexpr int kBars = kP + kPBufs * kPBytes;
  static constexpr int kBytes = kBars + Bars::kCount * 8 + 1024;
};
static_assert(KvSmem::kBytes <= 232448, "shared memory");

// The queries a 64-key tile is seen by, as 32-query tiles [lo, hi).
__device__ __forceinline__ void kv_query_tiles(const Params& p, int k0,
                                               int& lo, int& hi) {
  int first = p.causal ? k0 : 0;
  int last = p.Sq;                              // exclusive
  if (p.window > 0) last = min(last, min(k0 + kKvKeys, p.Sk) - 1 + p.window);
  lo = first / kKvRows;
  hi = last > first ? (last + kKvRows - 1) / kKvRows : lo;
}

// Named barriers between the two consumer warpgroups (256 threads): P^T of
// buffer i written (kPFull + i) and read (kPEmpty + i); 0 is
// __syncthreads'.
constexpr int kPFull = 1;
constexpr int kPEmpty = kPFull + kPBufs;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" :: "r"(id) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
fa_tf32_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = KvSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Bars bars(smem + L::kBars);

  // the work item, KV head by KV head and within one the first key tiles
  // first (they are seen by the most queries), so the blocks at work at one
  // time share the Q and dO of a few heads through L2
  const int w = blockIdx.x;
  const int g = w / p.n_ktiles;
  const int k0 = (w - g * p.n_ktiles) * kKvKeys;
  const int kvh = g % p.KV, b = g / p.KV;
  int qt_lo, qt_hi;
  kv_query_tiles(p, k0, qt_lo, qt_hi);
  const int n_tiles = p.rep * (qt_hi - qt_lo);

  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      // ------------------------------------------------ TMA producer --
      mbar_expect_tx(bars.once, 2 * L::kKeys);
      for (int c = 0; c < kHD / kPanel; ++c) {
        tma_load_4d(smem + L::kK + c * kKvKeys * 128, &tk, bars.once,
                    c * kPanel, kvh, k0, b);
        tma_load_4d(smem + L::kV + c * kKvKeys * 128, &tv, bars.once,
                    c * kPanel, kvh, k0, b);
      }
      const int64_t plane = static_cast<int64_t>(p.B) * p.H * p.sq_pad;
      const int per_head = qt_hi - qt_lo;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages)
          mbar_wait(&bars.raw_empty[s], ((it / kStages) + 1) & 1);
        const int h = kvh * p.rep + it / per_head;
        const int q0 = (qt_lo + it % per_head) * kKvRows;
        const float* lse = p.stats
            + (static_cast<int64_t>(b) * p.H + h) * p.sq_pad;
        uint8_t* raw = smem + L::kRaw + s * L::kRawStage;
        mbar_expect_tx(&bars.raw_full[s], 2 * L::kTile + L::kStatBytes);
        for (int c = 0; c < kHD / kPanel; ++c) {
          tma_load_4d(raw + c * kKvRows * 128, &tq, &bars.raw_full[s],
                      c * kPanel, h, q0, b);
          tma_load_4d(raw + L::kTile + c * kKvRows * 128, &tdo,
                      &bars.raw_full[s], c * kPanel, h, q0, b);
        }
        bulk_load(raw + 2 * L::kTile, lse + q0, kKvRows * 4,
                  &bars.raw_full[s]);
        bulk_load(raw + 2 * L::kTile + kKvRows * 4, lse + plane + q0,
                  kKvRows * 4, &bars.raw_full[s]);
      }
    } else if (threadIdx.x >= 32) {
      // --------------------------------------------- the split warps --
      const int st = threadIdx.x - 32;
      const int sw = st / 32, lane = st % 32;
      split_loop(n_tiles, bars.raw_full, bars.raw_empty, bars.split_full,
                 bars.split_empty, [&](int s, int) {
        const uint8_t* raw = smem + L::kRaw + s * L::kRawStage;
        uint8_t* split = smem + L::kSplit + s * L::kSplitStage;
        split_tile<kKvRows, true, true>(raw, split, split + L::kTile,
                                        split + 4 * L::kTile,
                                        split + 5 * L::kTile, sw, lane);
        split_tile<kKvRows, true, true>(raw + L::kTile, split + 2 * L::kTile,
                                        split + 3 * L::kTile,
                                        split + 6 * L::kTile,
                                        split + 7 * L::kTile, sw, lane);
        const float* stats = reinterpret_cast<const float*>(raw + 2 * L::kTile);
        float* to = reinterpret_cast<float*>(split + 8 * L::kTile);
        if (st < 2 * kKvRows) to[st] = stats[st];
      });
    }
    return;
  }
  // ------------------------------------------------------- consumers --
  // Warpgroup 1 owns dV: S^T = K Q^T, P^T, dV += P^T dO.  Warpgroup 2 owns
  // dK: dP^T = V dO^T, dS^T = P^T (dP^T - D) with P^T from warpgroup 1
  // through shared memory, dK += dS^T Q.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const bool owns_dv = wg == 1;
  const int tid = threadIdx.x - wg * 128;
  const int warp = tid / 32, lane = tid % 32;
  const int tc = lane % 4;
  const int kpos0 = k0 + warp * 16 + lane / 4, kpos1 = kpos0 + 8;
  float* p_exchange = reinterpret_cast<float*>(smem + L::kP);

  // K (the dV consumer's) or V (the dK consumer's) as A fragments
  uint32_t ah[8][4], al[8][4];
  mbar_wait(bars.once, 0);
  load_a<kKvKeys>(smem + (owns_dv ? L::kK : L::kV), 0, ah, al);

  // the accumulator, dV or dK: element 4 n8 + e is key kpos0 + 8 (e / 2),
  // column 8 n8 + 2 tc + e % 2 of hd
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  const int per_head = qt_hi - qt_lo;
  int pt = 0;                                   // visible tiles
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int q0 = (qt_lo + it % per_head) * kKvRows;
    mbar_wait(&bars.split_full[st], (it / kStages) & 1);
    if (tile_visible(p, q0, kKvRows, k0, kKvKeys)) {
      const uint8_t* split = smem + L::kSplit + st * L::kSplitStage;
      const uint32_t sp = smem_u32(split);
      const float* lse_s = reinterpret_cast<const float*>(split + 8 * L::kTile);
      const float* d_s = lse_s + kKvRows;
      // P^T of this tile, element e of thread tid at [e][tid]
      float* pbuf = p_exchange + (pt % kPBufs) * (kKvKeys * kKvRows);
      // S^T (dP^T) in the first half; the gradient's tile product, once
      // P^T (dS^T) has left it for its A fragments, in the whole
      float part[32];
      float (&s)[16] = *reinterpret_cast<float(*)[16]>(part);
      wgmma_fence();
      // S^T = K Q^T or dP^T = V dO^T: B the 32-query tile's hi and lo
      issue_s(s, ah, al, sp + (owns_dv ? 0 : 2) * L::kTile,
              sp + (owns_dv ? 1 : 3) * L::kTile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      if (owns_dv) {
        const bool masked = tile_masked(p, q0, kKvRows, k0, kKvKeys);
#pragma unroll
        for (int n8 = 0; n8 < kKvRows / 8; ++n8) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * n8 + 2 * tc + (e & 1);
            float x = ex2(s[4 * n8 + e] * p.scale_log2 - lse_s[col]);
            if (masked && !pair_ok(p, q0 + col, e < 2 ? kpos0 : kpos1))
              x = 0.0f;
            s[4 * n8 + e] = x;
          }
        }
        if (pt >= kPBufs) named_sync(kPEmpty + pt % kPBufs);
#pragma unroll
        for (int i = 0; i < 16; ++i) pbuf[i * 128 + tid] = s[i];
        named_arrive(kPFull + pt % kPBufs);
      } else {
        named_sync(kPFull + pt % kPBufs);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          s[i] = pbuf[i * 128 + tid]
                 * (s[i] - d_s[8 * (i / 4) + 2 * tc + (i & 1)]);
        named_arrive(kPEmpty + pt % kPBufs);
      }
      // P^T or dS^T as the A operand of dV += P^T dO or dK += dS^T Q, B
      // the transposed dO or Q
      uint32_t xh[4][4], xl[4][4];
      to_a(s, xh, xl);
      wgmma_fence();
      issue_grad(part, xh, xl, sp + (owns_dv ? 6 : 4) * L::kTile,
                 sp + (owns_dv ? 7 : 5) * L::kTile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
#pragma unroll
      for (int kj = 0; kj < 4; ++kj) {
        fence_regs(xh[kj]);
        fence_regs(xl[kj]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += part[i];
      ++pt;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars.split_empty[st]);
  }
  // the reads of the last buffers have no next write to wait for them
  if (owns_dv)
    for (int t = pt > kPBufs ? pt - kPBufs : 0; t < pt; ++t)
      named_sync(kPEmpty + t % kPBufs);

  // dv = P^T dO, dk = scale dS^T Q; keys past Sk dropped
  const int64_t row_stride = static_cast<int64_t>(p.KV) * kHD;
  store_rows((owns_dv ? p.dv : p.dk) + static_cast<int64_t>(b) * p.Sk
             * row_stride + static_cast<int64_t>(kvh) * kHD, row_stride, k0,
             p.Sk, acc, owns_dv ? 1.0f : p.scale);
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry points, so
// the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-d map over a contiguous (B, S, heads, 64) float32 array: boxes of
// `rows` positions x 32 columns of one head of one batch row, 128-byte
// swizzled; out-of-range positions read as zeros.
int make_map(CUtensorMap* map, const void* base, int B, int S, int heads,
             int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHD),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t s_h = static_cast<cuuint64_t>(kHD) * 4;
  const cuuint64_t strides[3] = {s_h, s_h * heads, s_h * heads * S};
  const cuuint32_t box[4] = {kPanel, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

// The shared-memory attribute of `kernel`, once for each card in turn.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int& set_for) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev == set_for) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) set_for = dev;
  return err;
}

// The autograd engine runs a backward on a thread of its own, where no CUDA
// context need be current until a runtime call makes one so; the tensor
// maps' driver call fails without one (error 1201).  So the entry point
// makes the context of `ptr`'s device current first.
int make_current(const void* ptr) {
  cudaPointerAttributes attr;
  cudaError_t e = cudaPointerGetAttributes(&attr, ptr);
  if (e == cudaSuccess) e = cudaSetDevice(attr.device);
  return e;
}

}  // namespace

// C entry point, loaded with ctypes.  Pointers are device pointers to
// contiguous float32 arrays with 16-byte-aligned bases: q, dout and dq (B,
// Sq, H, 64); k, v, dk and dv (B, Sk, KV, 64); stats a float32 (2, B, H,
// sq_pad) scratch with sq_pad = Sq rounded up to a multiple of 128.  hd
// must be 64; window <= 0 means none.  Returns 0 or the error that kept
// its kernels from running.
extern "C" int flash_attention_tf32_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    void* dq, void* dk, void* dv, void* stats, int B,
    int Sq, int Sk, int H, int KV, int hd, int causal, int window,
    float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || hd != kHD) return cudaErrorInvalidValue;
  Params p;
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.stats = static_cast<float*>(stats);
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  p.B = B;
  p.rep = H / KV;
  p.n_qtiles = (Sq + kDqRows - 1) / kDqRows;
  p.sq_pad = p.n_qtiles * kDqRows;
  p.n_ktiles = (Sk + kKvKeys - 1) / kKvKeys;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  const long long dq_blocks = static_cast<long long>(p.n_qtiles) * H * B;
  const long long kv_blocks = static_cast<long long>(p.n_ktiles) * KV * B;
  if (dq_blocks > 0x7fffffffll || kv_blocks > 0x7fffffffll)
    return cudaErrorInvalidValue;

  CUtensorMap tq128, tdo128, tk32, tv32, tq32, tdo32, tk64, tv64;
  int err = make_current(q);
  if (err == 0) err = make_map(&tq128, q, B, Sq, H, kDqRows);
  if (err == 0) err = make_map(&tdo128, dout, B, Sq, H, kDqRows);
  if (err == 0) err = make_map(&tk32, k, B, Sk, KV, kDqKeys);
  if (err == 0) err = make_map(&tv32, v, B, Sk, KV, kDqKeys);
  if (err == 0) err = make_map(&tq32, q, B, Sq, H, kKvRows);
  if (err == 0) err = make_map(&tdo32, dout, B, Sq, H, kKvRows);
  if (err == 0) err = make_map(&tk64, k, B, Sk, KV, kKvKeys);
  if (err == 0) err = make_map(&tv64, v, B, Sk, KV, kKvKeys);
  if (err != 0) return err;

  static int dq_set = -1, kv_set = -1;
  cudaError_t e = allow_smem(fa_tf32_dq_kernel, DqSmem::kBytes, dq_set);
  if (e == cudaSuccess) e = allow_smem(fa_tf32_dkdv_kernel, KvSmem::kBytes, kv_set);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the dq kernel writes the statistics the dk/dv kernel reads
  fa_tf32_dq_kernel<<<static_cast<int>(dq_blocks), kThreads, DqSmem::kBytes,
                      s>>>(tq128, tdo128, tk32, tv32, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fa_tf32_dkdv_kernel<<<static_cast<int>(kv_blocks), kThreads, KvSmem::kBytes,
                        s>>>(tq32, tdo32, tk64, tv64, p);
  return cudaGetLastError();
}
