// Flash attention backward on Hopper's tensor cores (sm_90a): wgmma, TMA
// and mbarriers, for bf16 at hd 64 or 128.
//
// The gradient of the function that
// repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// computes (:78).  The reference differentiates no Pallas kernel: its
// train step takes the gradient of blockwise_attention
// (repro/models/attention.py:224) with XLA.  The port computes that
// attention with its forward kernels on the card, so the gradient comes
// from this kernel (and, for float32 or hd 32 / 80, from
// flash_attention_bwd.cu on the CUDA cores).  For every batch row b, query
// head h, query i and key j (KV head h / rep), with the forward's masks
// (causal: j <= i; window w: j > i - w; every j < Sk):
//
//   s_ij  = (q_i . k_j) * scale,   P_ij = exp(s_ij - lse_i)  (0 if masked)
//   dP_ij = dO_i . v_j,            D_i = sum_j P_ij dP_ij
//   dS_ij = P_ij (dP_ij - D_i)
//   dq_i  = scale * sum_j dS_ij k_j
//   dk_j  = scale * sum_{i, h in j's group} dS_ij q_i
//   dv_j  = sum_{i, h in j's group} P_ij dO_i
//
// bf16 in and out, fp32 accumulators.  P and dS enter the gradient
// products as the register A operand, in bf16.  Each is split into its
// rounded value and the rounded remainder, and both go through the
// product, so P and dS reach the sums at ~2^-17 of themselves.  Rounded
// once, as FlashAttention-2 and -3 do, they put the gradients 4-7.5e-3 of
// their largest entry from the fp32 plain version on the reference's test
// shapes, against a tolerance of 2^-7; the remainders' products cost 9-10 %
// of the time at the train shapes (H100 80GB HBM3, 700 W,
// tools/flash_attention_bwd_ablation.py).  The queries' positions start at
// 0 and every key is valid (training).
//
// D is taken as sum_j P_ij dP_ij from the recomputed P and dP in fp32, not
// as FlashAttention-2 takes it, dO_i . O_i from the forward's bf16 output:
// where a row's attention spreads over many alike keys (Whisper's
// cross-attention over a deep encoder's 1500 frames), dS is a difference
// of near-equal numbers, and O's rounding to bf16 (2^-9) swamps it: dq at
// 8.8e-2 and 0.36 of its largest entry from autograd's with keys 5 % and
// 1 % apart, against 2.1e-3 and 2.6e-3 (bf16's own rounding) this way
// (tools/flash_bwd_accuracy.py cpu, the plain versions).
//
// Bound, on the H100 SXM at 700 W.  The function needs 5 products over the
// valid pairs (q k^T, dO v^T and the three gradients), 2.5 times the
// forward's 2.  OLMo-1B's train shape (B 4, S 1024, 16 heads on 16, hd
// 128, causal): 43.0 GFLOP, 0.0435 ms at the 989 TFLOP/s of the bf16
// tensor cores, against 117.4 MB of q, k, v, dO, dq, dk and dv read once
// and written once, 0.0350 ms at 3.35 TB/s.  Jamba (32 heads on 8): 86.0
// GFLOP, 0.0869 ms, over 134.2 MB, 0.0401 ms.  So the products bound it,
// and every one of them has to run on the tensor cores: on the CUDA cores
// (67 TFLOP/s fp32) the gradient alone takes ~0.65 ms at OLMo's shape.
// The bound is the function's; this design does 9 products, 12 with the
// remainders' (below).
//
// Design: FlashAttention-2's split of the gradient into a dq pass and a
// dk/dv pass, each on wgmma as FlashAttention-3 maps it onto Hopper, with
// no atomics anywhere, so two launches give the same bits.
// - Statistics.  The rows' log-sum-exp and D are recomputed by the dq
//   kernel in a first pass over the keys on wgmma (Q K^T and dO V^T, the
//   sums online as the forward's softmax); the forward does not write
//   them, so the forward sources and serving's launches stay as they are.
//   Both go to an fp32 (2, B, H, Sq_pad) scratch the wrapper allocates
//   (the log-sum-exp in log2 units; rows past Sq get 1e30, so their P is
//   exactly 0).
// - dq kernel: one block per (128-query tile, head, batch row), numbered
//   heaviest first (under a causal mask the last query tiles see the most
//   keys).  Three warpgroups: a producer whose one thread issues TMA
//   loads (setmaxnreg gives its registers to the others) and two consumers
//   that each own 64 query rows.  Q and dO of the tile come in once; K
//   (pass 1) and K and V (pass 2) of every visible 64-key tile stream
//   through a ring of 2 stages, 128-byte swizzled, with mbarriers for
//   "full" (transaction bytes) and "empty" (the 8 consumer warps).
//   Pass 1: S = Q K^T and dP = dO V^T (wgmma SS, both K-major), the rows'
//   online max, sum and sum of P dP.  Pass 2: S and dP again, P and dS in
//   registers, dQ += dS K with dS as the register A operand and K as the
//   transposed (MN-major) B operand, as the forward's P V.  5 products a
//   pair (6 with the remainder's).
// - dk/dv kernel: one block per (64-key tile, KV head, batch row), the
//   first key tiles first (they see the most queries under a causal mask).
//   K and V of the tile come in by TMA and stay; the producer streams Q,
//   dO and the rows' (lse, D) of every visible 64-query tile of every
//   query head of the KV head's group through a ring of 2 stages (TMA for
//   the tiles, a bulk copy for the statistics).  The two consumers split
//   the products, not the keys: one owns dV (S^T = K Q^T by SS, P^T =
//   exp2(S^T scale log2 e - lse) in registers with the per-query lse read
//   from the stage's shared memory, dV += P^T dO by RS with dO as the
//   MN-major B), the other dK (dP^T = V dO^T, dS^T = P^T (dP^T - D),
//   dK += dS^T Q), with P^T handed over in fp32 through a double-buffered
//   shared-memory exchange under named barriers.  A consumer that held dK
//   and dV at hd 128 (128 registers) beside S^T and dP^T (64) would not fit
//   the 168 registers a thread of a 384-thread block has, and ptxas then
//   serialises every wgmma (-Xptxas -v says so).  The sum over a KV head's
//   query heads stays in the block's registers.  4 products a pair (6 with
//   the remainders').
// - Tiles that no pair of a warpgroup can see (past the causal diagonal,
//   before the window, past Sk) are never computed; only tiles that cross
//   a boundary are masked.  Rows past Sq and keys past Sk arrive as TMA
//   zeros; masks and the padding rows' lse make their P exactly 0.
// - The accumulator of S (or S^T) is wgmma's m64nN fp32 layout: element
//   4 n8 + e of a thread is row 16 warp + g + 8 (e / 2), column 8 n8 +
//   2 t + e % 2 (g = lane / 4, t = lane % 4); packed in pairs to bf16 it is
//   already the A fragment of the next product (k-step n8 / 2), as in the
//   forward's P V.
// Nothing here allocates or synchronises; the entry point returns the CUDA
// error of its launches (or of a tensor map's encoding, as 1000 +
// CUresult).  A wait on an mbarrier that lasts seconds traps, so a fault in
// the pipeline ends the kernel with an error instead of hanging the card.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's finite mask value
constexpr float kNoRow = 1e30f;     // a padding row's lse: its P is 0
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

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

// ---------------------------------------------------------------- wgmma --
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous window of a wgmma.
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
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

// d (64 x 64, fp32) = (scale_d ? d : 0) + A (64 x 16) B (16 x 64); A and B
// from shared memory, both K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 in registers) B (16 x 64); B from
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 in registers) B (16 x 128); B from
// shared memory, MN-major (transposed): two 64-column atoms, the
// descriptor's leading offset apart.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as bf16 pairs hi + lo: hi the rounded values, lo the rounded
// remainders, so hi + lo carries x to ~2^-17 of itself.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// =================================================== shared by both ==
constexpr int kPanel = 64;          // bf16 columns in a 128-byte swizzle row
constexpr int kThreads = 384;       // producer + 2 consumer warpgroups
constexpr int kStages = 2;          // the streamed tiles' ring
constexpr int kDqRows = 128;        // dq kernel: queries of a block (2 x 64)
constexpr int kDqKeys = 64;         //            keys of a streamed tile
constexpr int kKvKeys = 64;         // dk/dv kernel: keys of a block
constexpr int kKvRows = 64;         //               queries of a tile
constexpr int kPBufs = 2;           //               P^T exchange buffers

struct Params {
  const bf16* dout;                 // (B, Sq, H, hd), contiguous
  bf16* dq;                         // (B, Sq, H, hd)
  bf16* dk;                         // (B, Sk, KV, hd)
  bf16* dv;
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

// Some pair of queries [q0, q0 + 64) and keys [k0, k0 + 64) (each clipped
// to its length) is visible.
__device__ __forceinline__ bool tile_visible(const Params& p, int q0, int k0) {
  if (q0 >= p.Sq || k0 >= p.Sk) return false;
  const int qmax = min(q0 + 63, p.Sq - 1), kmax = min(k0 + 63, p.Sk - 1);
  if (p.causal && k0 > qmax) return false;
  if (p.window > 0 && kmax <= q0 - p.window) return false;
  return true;
}

// Some pair of the 64 x 64 tile is not: it has to be masked.
__device__ __forceinline__ bool tile_masked(const Params& p, int q0, int k0) {
  return k0 + 64 > p.Sk || (p.causal && k0 + 63 > q0)
      || (p.window > 0 && k0 <= q0 + 63 - p.window);
}

// The keys a 128-query tile sees, as 64-key tiles from lo.
__device__ __forceinline__ void dq_key_tiles(const Params& p, int q0, int& lo,
                                             int& n) {
  int hi = p.Sk;
  if (p.causal) hi = min(hi, min(q0 + kDqRows, p.Sq));
  int first = 0;
  if (p.window > 0) first = max(0, q0 - p.window + 1);
  lo = first / kDqKeys * kDqKeys;
  n = hi > lo ? (hi - lo + kDqKeys - 1) / kDqKeys : 0;
}

// The queries a 128-key tile is seen by, as 64-query tiles [lo, hi).
__device__ __forceinline__ void kv_query_tiles(const Params& p, int k0,
                                               int& lo, int& hi) {
  int first = p.causal ? k0 : 0;
  int last = p.Sq;                              // exclusive
  if (p.window > 0) last = min(last, min(k0 + kKvKeys, p.Sk) - 1 + p.window);
  lo = first / kKvRows;
  hi = last > first ? (last + kKvRows - 1) / kKvRows : lo;
}

// ============================================================ dq kernel ==
template <int HD>
struct DqSmem {
  static constexpr int kPanels = HD / kPanel;
  static constexpr int kQBytes = kDqRows * HD * 2;   // Q, and dO
  static constexpr int kTileBytes = kDqKeys * HD * 2;  // K, or V
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQBytes;
  static constexpr int kK = kDO + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
};

// S (64 x 64) = A B^T over hd: A 64 rows of an A_ROWS-row tile (panel
// stride A_ROWS x 128 bytes), B a 64-row tile (panel stride 64 x 128
// bytes), both K-major, hd / 16 steps of k16, 32 bytes a step inside a
// panel.
template <int HD, int A_ROWS>
__device__ __forceinline__ void issue_s(float (&s)[32], uint32_t a_addr,
                                        uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da = sw128_desc(a_addr + (kk / 4) * A_ROWS * 128 + off, 16,
                                   1024);
    const uint64_t db = sw128_desc(b_addr + (kk / 4) * 64 * 128 + off, 16,
                                   1024);
    wgmma_m64n64k16_ss(s, da, db, kk > 0);
  }
}

// acc (64 x hd) += A B: A (64 x 64) as 4 register k-steps, B a 64-row tile
// read as the transposed (MN-major) operand: 8 rows to the next are 1024
// bytes apart, one 64-column panel to the next 64 x 128.
template <int HD>
__device__ __forceinline__ void issue_grad(float (&acc)[HD / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b_addr) {
#pragma unroll
  for (int kj = 0; kj < 4; ++kj) {
    const uint64_t db = sw128_desc(b_addr + kj * 16 * 128, 64 * 128, 1024);
    if constexpr (HD == 128) wgmma_m64n128k16_rs(acc, a[kj], db);
    else wgmma_m64n64k16_rs(acc, a[kj], db);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = DqSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle pattern repeats every 8 rows of 128 B
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  // the work item, heaviest first: the last query tiles see the most keys
  const int w = blockIdx.x;
  const int hb = p.H * p.B;
  const int q0 = (p.n_qtiles - 1 - w / hb) * kDqRows;
  const int h = (w % hb) % p.H, b = (w % hb) / p.H;
  const int kvh = h / p.rep;
  int lo, n_tiles;
  dq_key_tiles(p, q0, lo, n_tiles);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);      // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------ producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::kQBytes);
      for (int c = 0; c < L::kPanels; ++c) {
        tma_load_4d(smem + L::kQ + c * kDqRows * 128, &tq, q_full, c * kPanel,
                    h, q0, b);
        tma_load_4d(smem + L::kDO + c * kDqRows * 128, &tdo, q_full,
                    c * kPanel, h, q0, b);
      }
      // both passes read K and V of every visible key tile
      for (int it = 0; it < 2 * n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) + 1) & 1);
        const int k0 = lo + (it % n_tiles) * kDqKeys;
        mbar_expect_tx(&full[s], 2 * L::kTileBytes);
        for (int c = 0; c < L::kPanels; ++c) {
          tma_load_4d(smem + L::kK + s * L::kTileBytes + c * kDqKeys * 128,
                      &tk, &full[s], c * kPanel, kvh, k0, b);
          tma_load_4d(smem + L::kV + s * L::kTileBytes + c * kDqKeys * 128,
                      &tv, &full[s], c * kPanel, kvh, k0, b);
        }
      }
    }
    return;
  }
  // ------------------------------------------------------- consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int cw = wg - 1;                        // 64-row half of the tile
  const int tid = threadIdx.x - wg * 128;
  const int warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tc = lane % 4;
  const int row0 = cw * 64 + warp * 16 + gr;    // and row0 + 8
  const int qpos0 = q0 + row0, qpos1 = qpos0 + 8;
  const int qw0 = q0 + cw * 64;                 // this warpgroup's rows
  const uint32_t q_addr = smem_u32(smem + L::kQ) + cw * 64 * 128;
  const uint32_t do_addr = smem_u32(smem + L::kDO) + cw * 64 * 128;

  mbar_wait(q_full, 0);

  // pass 1: the rows' log-sum-exp, as the forward's online softmax, in
  // log2 units, and D = sum_j P dP with the same running rescale
  float s[32], dp[32];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f, a0 = 0.0f,
        a1 = 0.0f;
  int it = 0;
  for (int t = 0; t < n_tiles; ++t, ++it) {
    const int st = it % kStages;
    const int k0 = lo + t * kDqKeys;
    mbar_wait(&full[st], (it / kStages) & 1);
    if (tile_visible(p, qw0, k0)) {
      wgmma_fence();
      issue_s<HD, kDqRows>(s, q_addr,
                           smem_u32(smem + L::kK + st * L::kTileBytes));
      issue_s<HD, kDqRows>(dp, do_addr,
                           smem_u32(smem + L::kV + st * L::kTileBytes));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      const bool masked = tile_masked(p, qw0, k0);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
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
      const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
      l0 *= c0;
      a0 *= c0;
      l1 *= c1;
      a1 *= c1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const float e0 = exp2f(s[4 * n8 + 0] - mn0);
        const float e1 = exp2f(s[4 * n8 + 1] - mn0);
        const float e2 = exp2f(s[4 * n8 + 2] - mn1);
        const float e3 = exp2f(s[4 * n8 + 3] - mn1);
        l0 += e0 + e1;
        l1 += e2 + e3;
        a0 = fmaf(e0, dp[4 * n8 + 0], fmaf(e1, dp[4 * n8 + 1], a0));
        a1 = fmaf(e2, dp[4 * n8 + 2], fmaf(e3, dp[4 * n8 + 3], a1));
      }
    }
    if (lane == 0) mbar_arrive(&empty[st]);
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
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.0f;
  for (int t = 0; t < n_tiles; ++t, ++it) {
    const int st = it % kStages;
    const int k0 = lo + t * kDqKeys;
    mbar_wait(&full[st], (it / kStages) & 1);
    if (tile_visible(p, qw0, k0)) {
      const uint32_t k_addr = smem_u32(smem + L::kK + st * L::kTileBytes);
      wgmma_fence();
      issue_s<HD, kDqRows>(s, q_addr, k_addr);
      issue_s<HD, kDqRows>(dp, do_addr,
                           smem_u32(smem + L::kV + st * L::kTileBytes));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      const bool masked = tile_masked(p, qw0, k0);
      uint32_t da[4][4], dl[4][4];
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pr = exp2f(s[4 * n8 + e] * p.scale_log2
                           - (e < 2 ? lse0 : lse1));
          if (masked && !pair_ok(p, e < 2 ? qpos0 : qpos1,
                                 k0 + 8 * n8 + 2 * tc + (e & 1)))
            pr = 0.0f;
          ds[e] = pr * (dp[4 * n8 + e] - (e < 2 ? d0 : d1));
        }
        split_bf16(ds[0], ds[1], da[n8 / 2][(n8 % 2) * 2 + 0],
                   dl[n8 / 2][(n8 % 2) * 2 + 0]);
        split_bf16(ds[2], ds[3], da[n8 / 2][(n8 % 2) * 2 + 1],
                   dl[n8 / 2][(n8 % 2) * 2 + 1]);
      }
      wgmma_fence();
      issue_grad<HD>(dq, da, k_addr);
      issue_grad<HD>(dq, dl, k_addr);           // the remainder's share
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
#pragma unroll
      for (int kj = 0; kj < 4; ++kj) {
        fence_regs(da[kj]);
        fence_regs(dl[kj]);
      }
    }
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // dq = scale dS K, rows past Sq dropped
  const int64_t row_stride = static_cast<int64_t>(p.H) * HD;
  bf16* out = p.dq + (static_cast<int64_t>(b) * p.Sq) * row_stride
              + static_cast<int64_t>(h) * HD;
#pragma unroll
  for (int n8 = 0; n8 < HD / 8; ++n8) {
    const int col = 8 * n8 + 2 * tc;
    if (qpos0 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(out + qpos0 * row_stride + col) =
          __floats2bfloat162_rn(dq[4 * n8 + 0] * p.scale,
                                dq[4 * n8 + 1] * p.scale);
    if (qpos1 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(out + qpos1 * row_stride + col) =
          __floats2bfloat162_rn(dq[4 * n8 + 2] * p.scale,
                                dq[4 * n8 + 3] * p.scale);
  }
}

// ========================================================= dk/dv kernel ==
template <int HD>
struct KvSmem {
  static constexpr int kPanels = HD / kPanel;
  static constexpr int kKBytes = kKvKeys * HD * 2;     // K, and V
  static constexpr int kTileBytes = kKvRows * HD * 2;  // Q, or dO
  static constexpr int kStatBytes = 2 * kKvRows * 4;   // lse, then D
  static constexpr int kPBytes = kKvKeys * kKvRows * 4;  // P^T, fp32
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKBytes;
  static constexpr int kQ = kV + kKBytes;
  static constexpr int kDO = kQ + kStages * kTileBytes;
  static constexpr int kStats = kDO + kStages * kTileBytes;
  static constexpr int kP = kStats + kStages * kStatBytes;
  static constexpr int kBars = kP + kPBufs * kPBytes;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
};

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

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = KvSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  // the work item: the first key tiles are seen by the most queries
  const int w = blockIdx.x;
  const int kb = p.KV * p.B;
  const int k0 = (w / kb) * kKvKeys;
  const int kvh = (w % kb) % p.KV, b = (w % kb) / p.KV;
  int qt_lo, qt_hi;
  kv_query_tiles(p, k0, qt_lo, qt_hi);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------ producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKBytes);
      for (int c = 0; c < L::kPanels; ++c) {
        tma_load_4d(smem + L::kK + c * kKvKeys * 128, &tk, kv_full,
                    c * kPanel, kvh, k0, b);
        tma_load_4d(smem + L::kV + c * kKvKeys * 128, &tv, kv_full,
                    c * kPanel, kvh, k0, b);
      }
      const int64_t plane = static_cast<int64_t>(p.B) * p.H * p.sq_pad;
      int it = 0;
      for (int hh = 0; hh < p.rep; ++hh) {
        const int h = kvh * p.rep + hh;
        const float* lse = p.stats
            + (static_cast<int64_t>(b) * p.H + h) * p.sq_pad;
        for (int qt = qt_lo; qt < qt_hi; ++qt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) + 1) & 1);
          const int q0 = qt * kKvRows;
          mbar_expect_tx(&full[s], 2 * L::kTileBytes + L::kStatBytes);
          for (int c = 0; c < L::kPanels; ++c) {
            tma_load_4d(smem + L::kQ + s * L::kTileBytes + c * kKvRows * 128,
                        &tq, &full[s], c * kPanel, h, q0, b);
            tma_load_4d(smem + L::kDO + s * L::kTileBytes
                        + c * kKvRows * 128, &tdo, &full[s], c * kPanel, h,
                        q0, b);
          }
          uint8_t* st_dst = smem + L::kStats + s * L::kStatBytes;
          bulk_load(st_dst, lse + q0, kKvRows * 4, &full[s]);
          bulk_load(st_dst + kKvRows * 4, lse + plane + q0, kKvRows * 4,
                    &full[s]);
        }
      }
    }
    return;
  }
  // ------------------------------------------------------- consumers --
  // Warpgroup 1 owns dV: S^T = K Q^T, P^T, dV += P^T dO.  Warpgroup 2 owns
  // dK: dP^T = V dO^T, dS^T = P^T (dP^T - D) with P^T from warpgroup 1
  // through shared memory, dK += dS^T Q.  Both accumulate the block's 64
  // keys; the two products a tile each keep the wgmma operands of a
  // warpgroup within its registers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const bool owns_dv = wg == 1;
  const int tid = threadIdx.x - wg * 128;
  const int warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tc = lane % 4;
  const int kpos0 = k0 + warp * 16 + gr, kpos1 = kpos0 + 8;
  const uint32_t k_addr = smem_u32(smem + L::kK);
  const uint32_t v_addr = smem_u32(smem + L::kV);
  float* p_exchange = reinterpret_cast<float*>(smem + L::kP);

  // the accumulator, dV or dK: element 4 n8 + e is key kpos0 + 8 (e / 2),
  // column (a query of the tile, or of hd) 8 n8 + 2 tc + e % 2
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  mbar_wait(kv_full, 0);
  int it = 0, pt = 0;                           // tiles; visible tiles
  for (int hh = 0; hh < p.rep; ++hh) {
    for (int qt = qt_lo; qt < qt_hi; ++qt, ++it) {
      const int st = it % kStages;
      const int q0 = qt * kKvRows;
      mbar_wait(&full[st], (it / kStages) & 1);
      if (tile_visible(p, q0, k0)) {
        const uint32_t q_addr = smem_u32(smem + L::kQ + st * L::kTileBytes);
        const uint32_t do_addr = smem_u32(smem + L::kDO
                                          + st * L::kTileBytes);
        const float* lse_s = reinterpret_cast<const float*>(
            smem + L::kStats + st * L::kStatBytes);
        const float* d_s = lse_s + kKvRows;
        // P^T of this tile, element e of thread tid at [e][tid]
        float* pbuf = p_exchange + (pt % kPBufs) * (kKvKeys * kKvRows);
        float s[32];
        uint32_t a[4][4], al[4][4];
        wgmma_fence();
        // S^T = K Q^T or dP^T = V dO^T: A the 64-key tile, B the 64-query
        // tile, both K-major
        issue_s<HD, kKvKeys>(s, owns_dv ? k_addr : v_addr,
                             owns_dv ? q_addr : do_addr);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        if (owns_dv) {
          const bool masked = tile_masked(p, q0, k0);
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * n8 + 2 * tc + (e & 1);
              float x = exp2f(s[4 * n8 + e] * p.scale_log2 - lse_s[col]);
              if (masked && !pair_ok(p, q0 + col, e < 2 ? kpos0 : kpos1))
                x = 0.0f;
              s[4 * n8 + e] = x;
            }
          }
          if (pt >= kPBufs) named_sync(kPEmpty + pt % kPBufs);
#pragma unroll
          for (int i = 0; i < 32; ++i) pbuf[i * 128 + tid] = s[i];
          named_arrive(kPFull + pt % kPBufs);
        } else {
          named_sync(kPFull + pt % kPBufs);
#pragma unroll
          for (int i = 0; i < 32; ++i)
            s[i] = pbuf[i * 128 + tid]
                   * (s[i] - d_s[8 * (i / 4) + 2 * tc + (i & 1)]);
          named_arrive(kPEmpty + pt % kPBufs);
        }
        // P^T or dS^T as the A operand of dV += P^T dO or dK += dS^T Q
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          split_bf16(s[4 * n8], s[4 * n8 + 1], a[n8 / 2][(n8 % 2) * 2 + 0],
                     al[n8 / 2][(n8 % 2) * 2 + 0]);
          split_bf16(s[4 * n8 + 2], s[4 * n8 + 3],
                     a[n8 / 2][(n8 % 2) * 2 + 1],
                     al[n8 / 2][(n8 % 2) * 2 + 1]);
        }
        const uint32_t b_addr = owns_dv ? do_addr : q_addr;
        wgmma_fence();
        issue_grad<HD>(acc, a, b_addr);
        issue_grad<HD>(acc, al, b_addr);        // the remainder's share
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int kj = 0; kj < 4; ++kj) {
          fence_regs(a[kj]);
          fence_regs(al[kj]);
        }
        ++pt;
      }
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }
  // the reads of the last buffers have no next write to wait for them
  if (owns_dv)
    for (int t = pt > kPBufs ? pt - kPBufs : 0; t < pt; ++t)
      named_sync(kPEmpty + t % kPBufs);

  // dv = P^T dO, dk = scale dS^T Q; keys past Sk dropped
  const int64_t row_stride = static_cast<int64_t>(p.KV) * HD;
  bf16* out = (owns_dv ? p.dv : p.dk) + static_cast<int64_t>(b) * p.Sk
              * row_stride + static_cast<int64_t>(kvh) * HD;
  const float f = owns_dv ? 1.0f : p.scale;
#pragma unroll
  for (int n8 = 0; n8 < HD / 8; ++n8) {
    const int col = 8 * n8 + 2 * tc;
    if (kpos0 < p.Sk)
      *reinterpret_cast<__nv_bfloat162*>(out + kpos0 * row_stride + col) =
          __floats2bfloat162_rn(acc[4 * n8 + 0] * f, acc[4 * n8 + 1] * f);
    if (kpos1 < p.Sk)
      *reinterpret_cast<__nv_bfloat162*>(out + kpos1 * row_stride + col) =
          __floats2bfloat162_rn(acc[4 * n8 + 2] * f, acc[4 * n8 + 3] * f);
  }
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

// A 4-d map over a contiguous (B, S, heads, hd) bf16 array: boxes of
// `rows` positions x 64 columns of one head of one batch row, 128-byte
// swizzled; out-of-range positions read as zeros.
int make_map(CUtensorMap* map, const void* base, int B, int S, int heads,
             int hd, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t s_h = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {s_h, s_h * heads, s_h * heads * S};
  const cuuint32_t box[4] = {kPanel, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
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

template <int HD>
int launch(const void* q, const void* k, const void* v, const Params& p,
           cudaStream_t stream) {
  CUtensorMap tq128, tdo128, tk64, tv64, tq64, tdo64;
  int err = make_map(&tq128, q, p.B, p.Sq, p.H, HD, kDqRows);
  if (err == 0) err = make_map(&tdo128, p.dout, p.B, p.Sq, p.H, HD, kDqRows);
  if (err == 0) err = make_map(&tk64, k, p.B, p.Sk, p.KV, HD, kDqKeys);
  if (err == 0) err = make_map(&tv64, v, p.B, p.Sk, p.KV, HD, kDqKeys);
  if (err == 0) err = make_map(&tq64, q, p.B, p.Sq, p.H, HD, kKvRows);
  if (err == 0) err = make_map(&tdo64, p.dout, p.B, p.Sq, p.H, HD, kKvRows);
  if (err != 0) return err;

  static int dq_set = -1, kv_set = -1;
  auto dq = fa_bwd_dq_kernel<HD>;
  auto dkdv = fa_bwd_dkdv_kernel<HD>;
  cudaError_t e = allow_smem(dq, DqSmem<HD>::kBytes, dq_set);
  if (e == cudaSuccess) e = allow_smem(dkdv, KvSmem<HD>::kBytes, kv_set);
  if (e != cudaSuccess) return e;
  // the dq kernel writes the statistics the dk/dv kernel reads
  dq<<<p.n_qtiles * p.H * p.B, kThreads, DqSmem<HD>::kBytes, stream>>>(
      tq128, tdo128, tk64, tv64, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkdv<<<p.n_ktiles * p.KV * p.B, kThreads, KvSmem<HD>::kBytes, stream>>>(
      tq64, tdo64, tk64, tv64, p);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes.  Pointers are device pointers to
// contiguous bf16 arrays with 16-byte-aligned bases: q, dout and dq (B, Sq,
// H, hd); k, v, dk and dv (B, Sk, KV, hd); stats a float32 (2, B, H,
// sq_pad) scratch with sq_pad = Sq rounded up to a multiple of 128.  hd 64
// or 128; window <= 0 means none.  Returns 0 or the error that kept its
// kernels from running.
extern "C" int flash_attention_tc_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    void* dq, void* dk, void* dv, void* stats, int B,
    int Sq, int Sk, int H, int KV, int hd, int causal, int window,
    float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || Sk <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || (hd != 64 && hd != 128))
    return cudaErrorInvalidValue;
  Params p;
  p.dout = static_cast<const bf16*>(dout);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd == 64 ? launch<64>(q, k, v, p, s) : launch<128>(q, k, v, p, s);
}
