// Flash attention forward on Hopper's own hardware (sm_90a): a prefill on
// the bf16 tensor cores (wgmma, TMA, mbarriers) and a split-K decode.
//
// Replaces, with flash_attention.cu (which keeps the float32 and hd 32 / 80
// calls on the CUDA cores), the Pallas TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas.
// Both routes compute what it computes: for batch row b, query head h and
// query i at absolute position q_offset + i, with KV head h / rep,
//
//   s_j = (q_i . k_j) * scale    for keys j < min(Sk, kv_len[b]), j <= the
//                                query's position if causal, and j > the
//                                position - window if a window is given
//   o_i = sum_j softmax(s)_j v_j
//
// with masked scores at the reference's finite -1e30, kv_len read on the
// device (no host sync), and o in q's type (bf16 here).  A query row with no
// valid key at all (never on the serving path) is left undefined, but finite.
//
// 1. Prefill (bf16, Sq > 16, hd 64 or 128): flash_attention_tc_fwd.
//    Bound, H100 SXM at 700 W, by the larger of bytes and bf16 tensor-core
//    operations.  OLMo-1B (B 4, S 1024, 16 heads on 16, hd 128, causal):
//    4*B*H*hd*S(S+1)/2 = 17.2 GFLOP, 17.4 us at 989 TFLOP/s, against 67.1 MB
//    of q, k, v and o, 20.0 us at 3.35 TB/s.  Jamba (32 heads on 8): 34.4
//    GFLOP, 34.8 us, over 83.9 MB, 25.0 us.  Both products must run on the
//    tensor cores to come near either: fp32 FMAs alone take 0.26 ms a layer.
//    Design:
//    - one block per SM walks the work items, (128-query tile, head, batch
//      row), numbered heaviest first (under a causal mask the last query
//      tiles have the most key tiles) and dealt out in rounds that run
//      forward and backward over the blocks in turn, so each item's loads
//      overlap the last one's softmax and stores and the blocks end close
//      together (13-15 % faster than one block per item at OLMo-1B's and
//      Jamba's prefill on an H100 80GB HBM3 at 700 W, in chip_smoke.py's
//      phase 7);
//    - three warpgroups: a producer whose one thread issues TMA loads, and
//      two consumers that each own 64 query rows (setmaxnreg moves the
//      producer's registers to them);
//    - Q (128 x hd, two buffers) and a ring of 2 stages of K and V tiles
//      (128 keys x hd) come in by TMA through 4-d tensor maps over the
//      (B, S, heads, hd) strides, in 128-byte-swizzled 64-column panels,
//      with mbarriers for "full" (transaction bytes) and "empty" (the 8
//      consumer warps); rows past Sq or Sk arrive as zeros;
//    - S = Q K^T by wgmma m64n128k16 (both operands from shared memory,
//      K-major), fp32 in registers; the online softmax runs there with
//      exp2f on scores prescaled by scale * log2(e); P is rounded to bf16 in
//      registers, whose layout is wgmma's A fragment, and O += P V by wgmma
//      m64n(hd)k16 with A from registers and V from shared memory as the
//      transposed (MN-major) B operand, one instruction across all hd
//      columns (two swizzle atoms at hd 128; one instruction per 64
//      columns ran slower on the H100);
//    - key tiles that no query of the block can see (past kv_len, past the
//      causal diagonal, before the window) are never loaded; only tiles
//      that cross one of those boundaries are masked.
//
// 2. Decode (bf16, Sq <= 16, hd 64 or 128): flash_attention_split_k_fwd.
//    Bound by bytes: the valid prefix of K and V, 34.1 MB a layer for OLMo's
//    decode (B 4, cache 1056, kv_len 1040), 10.2 us at 3.35 TB/s; 17.0 MB for
//    Jamba's (8 KV heads), 5.1 us.  One block per (batch row, KV head) would
//    leave most SMs idle and most of the card's memory rate unused, and
//    fp32 FMAs at ~1 flop a byte plus their loads and conversions would
//    bound a block before its bytes do.  Design:
//    - one block per (chunk of the cache, KV head and group of 16 query
//      rows, batch row); a block serves all rep query heads of its KV head
//      (and every query), so K and V are read once;
//    - the chunk length is chosen on the host from Sk, B * KV and the SM
//      count (split_k_chunk in kernels/flash_attention/flash_attention.py):
//      at least 3 tiles, and ~3 blocks per SM, with no host sync; a block
//      whose chunk no query can see (past kv_len, past the causal
//      diagonal, before the window) writes an empty partial (m -1e30, l 0)
//      and exits;
//    - 64-key tiles of K and V come in by 16-byte cp.async (element loads
//      where a stride rules 16 bytes out) into a ring of 2 stages;
//    - each of the 4 warps takes 16 keys of every tile with its own online
//      softmax: S = Q K^T and O += P V by mma.sync m16n8k16 (bf16 in, fp32
//      out; the 16 query rows are the M of one mma, K and V reach the
//      tensor cores through ldmatrix, V transposed), and the warps' (m, l,
//      O) are combined at the end of the chunk;
//    - each block writes (m, l, acc) in fp32 to scratch the wrapper
//      allocates; a second kernel merges the chunks in the reference's
//      arithmetic, o = sum_c 2^(m_c - M) acc_c / max(sum_c 2^(m_c - M) l_c,
//      1e-30), skipping empty partials; it is launched as a programmatic
//      dependent of the first, so its launch overlaps the first's tail.
//
// Nothing here allocates or synchronises; every entry point returns the
// CUDA error of its launch (or of the tensor map's encoding, as 1000 +
// CUresult).  A wait on an mbarrier that lasts seconds traps, so a fault in
// the pipeline ends the kernel with an error instead of hanging the card.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's finite mask value
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

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

// d (64 x 128, fp32) = (scale_d ? d : 0) + A (64 x 16) B (16 x 128); A and B
// from shared memory, both K-major.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}"
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

// ============================================== 1. tensor-core prefill ==
constexpr int kBQ = 128;            // query rows per work item (2 x 64)
constexpr int kBK = 128;            // keys per tile
constexpr int kStages = 2;          // K/V ring
constexpr int kQBufs = 2;           // the next item's Q loads during this one
constexpr int kPanel = 64;          // bf16 columns in a 128-byte swizzle row
constexpr int kTcThreads = 384;     // producer + 2 consumer warpgroups

struct TcParams {
  bf16* o;                          // (B, Sq, H, hd), contiguous
  const int* kv_len;                // (B,) on the device, or null
  int kv_len_all;
  int Sq, Sk, H, B, rep, n_qtiles, n_items;
  int causal, window;               // window <= 0: none
  long long q_offset;
  float scale_log2;                 // scale * log2(e)
};

template <int HD>
struct TcSmem {
  static constexpr int kPanels = HD / kPanel;
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kTileBytes = kBK * HD * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBufs * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBars + (2 * kQBufs + 2 * kStages) * 8 + 1024;
};

// One work item: a 128-query tile of one head of one batch row, and the
// key tiles its queries can see, [lo, lo + n_tiles * kBK).  Items are
// numbered heaviest first: under a causal mask the last query tiles have
// the most key tiles.
struct TcItem {
  int h, b, q0, nq, n_tiles;
  int64_t lo, kv_valid, qpos_min, qpos_max;
};

__device__ __forceinline__ TcItem tc_item(const TcParams& p, int w) {
  TcItem it;
  const int hb = p.H * p.B;
  const int qt = p.n_qtiles - 1 - w / hb;
  const int rem = w - (w / hb) * hb;
  it.h = rem % p.H;
  it.b = rem / p.H;
  it.q0 = qt * kBQ;
  it.nq = min(kBQ, p.Sq - it.q0);
  it.kv_valid = min64(p.Sk, p.kv_len != nullptr ? p.kv_len[it.b]
                                                : p.kv_len_all);
  it.qpos_min = p.q_offset + it.q0;
  it.qpos_max = it.qpos_min + it.nq - 1;
  int64_t hi = it.kv_valid;
  if (p.causal) hi = min64(hi, it.qpos_max + 1);
  int64_t lo = 0;
  if (p.window > 0) lo = max64(lo, it.qpos_min - p.window + 1);
  it.lo = lo / kBK * kBK;
  it.n_tiles = hi > it.lo ? static_cast<int>((hi - it.lo + kBK - 1) / kBK)
                          : 0;
  return it;
}

// Round r's item for this block: the rounds run forward and backward over
// the blocks in turn, so a block that took a heavy item in one round takes
// a light one in the next.
__device__ __forceinline__ int tc_item_of(int r) {
  const int g = static_cast<int>(gridDim.x), i = static_cast<int>(blockIdx.x);
  return r * g + ((r & 1) ? g - 1 - i : i);
}

// S (64 x 128) = Q K^T: hd / 16 steps of k16, 32 bytes a step inside a
// 64-column panel
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da = sw128_desc(q_addr + (kk / 4) * kBQ * 128 + off, 16,
                                   1024);
    const uint64_t db = sw128_desc(k_addr + (kk / 4) * kBK * 128 + off, 16,
                                   1024);
    wgmma_m64n128k16_ss(s, da, db, kk > 0);
  }
}

// O (64 x hd) += P V: kBK / 16 steps of k16, 16 keys (2048 bytes of each
// panel) a step, one instruction across all hd columns.  V is the
// transposed (MN-major) operand: 8 keys to the next are 1024 bytes apart,
// and one 64-column panel to the next kBK * 128.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pa)[kBK / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kj = 0; kj < kBK / 16; ++kj) {
    const uint64_t db = sw128_desc(v_addr + kj * 16 * 128, kBK * 128, 1024);
    if constexpr (HD == 128) wgmma_m64n128k16_rs(o, pa[kj], db);
    else wgmma_m64n64k16_rs(o, pa[kj], db);
  }
}

// The online softmax of one tile in the accumulator's registers: masks
// (only a tile that crosses a boundary), scales to log2 units, updates the
// rows' max m and sum l, and packs P = exp2(s - m) in bf16 as wgmma's A
// fragments (k-step n8 / 2 takes rows (g, g + 8) x columns (2t, 2t + 1) of
// its first 8 keys, then of its second 8).  c0, c1: the rows' correction
// factors exp2(m_old - m_new).
__device__ __forceinline__ void tile_softmax(
    float (&s)[64], const TcParams& p, const TcItem& item, int64_t k0,
    int64_t qpos0, int64_t qpos1, int tc, float& m0, float& m1, float& l0,
    float& l1, float& c0, float& c1, uint32_t (&pa)[kBK / 16][4]) {
  const bool masked = k0 + kBK > item.kv_valid
      || (p.causal && k0 + kBK - 1 > item.qpos_min)
      || (p.window > 0 && k0 <= item.qpos_max - p.window);
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int n8 = 0; n8 < 16; ++n8) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * n8 + e] * p.scale_log2;
      if (masked) {
        const int64_t kpos = k0 + 8 * n8 + 2 * tc + (e & 1);
        const int64_t qpos = e < 2 ? qpos0 : qpos1;
        bool ok = kpos < item.kv_valid;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        if (!ok) x = kNegInf;
      }
      s[4 * n8 + e] = x;
      if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  c0 = exp2f(m0 - mn0);
  c1 = exp2f(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  l0 *= c0;
  l1 *= c1;
#pragma unroll
  for (int n8 = 0; n8 < 16; ++n8) {
    const float p0 = exp2f(s[4 * n8 + 0] - mn0);
    const float p1 = exp2f(s[4 * n8 + 1] - mn0);
    const float p2 = exp2f(s[4 * n8 + 2] - mn1);
    const float p3 = exp2f(s[4 * n8 + 3] - mn1);
    l0 += p0 + p1;
    l1 += p2 + p3;
    pa[n8 / 2][(n8 % 2) * 2 + 0] = pack_bf16(p0, p1);
    pa[n8 / 2][(n8 % 2) * 2 + 1] = pack_bf16(p2, p3);
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
fa_tc_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const TcParams p) {
  using L = TcSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle pattern repeats every 8 rows of 128 B
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // mbarriers: q_full and q_empty per Q buffer, full and empty per stage
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_empty = q_full + kQBufs;
  uint64_t* full = q_empty + kQBufs;
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);    // the consumers' 8 warps
    }
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
      int it = 0;                   // K/V tiles issued by this block
      int j = 0;                    // items of this block
      for (int r = 0; r * static_cast<int>(gridDim.x) < p.n_items; ++r) {
        const int w = tc_item_of(r);
        if (w >= p.n_items) continue;
        const TcItem item = tc_item(p, w);
        const int qb = j % kQBufs;
        if (j >= kQBufs) mbar_wait(&q_empty[qb], ((j / kQBufs) + 1) & 1);
        mbar_expect_tx(&q_full[qb], L::kQBytes);
        for (int c = 0; c < L::kPanels; ++c)
          tma_load_4d(smem + L::kQ + qb * L::kQBytes + c * kBQ * 128, &tq,
                      &q_full[qb], c * kPanel, item.h, item.q0, item.b);
        const int kvh = item.h / p.rep;
        for (int t = 0; t < item.n_tiles; ++t, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) + 1) & 1);
          const int k0 = static_cast<int>(item.lo) + t * kBK;
          mbar_expect_tx(&full[s], 2 * L::kTileBytes);
          for (int c = 0; c < L::kPanels; ++c) {
            tma_load_4d(smem + L::kK + s * L::kTileBytes + c * kBK * 128, &tk,
                        &full[s], c * kPanel, kvh, k0, item.b);
            tma_load_4d(smem + L::kV + s * L::kTileBytes + c * kBK * 128, &tv,
                        &full[s], c * kPanel, kvh, k0, item.b);
          }
        }
        ++j;
      }
    }
  } else {
    // ----------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = wg - 1;                      // 64-row half of the tile
    const int tid = threadIdx.x - wg * 128;
    const int warp = tid / 32, lane = tid % 32;
    const int gr = lane / 4, tc = lane % 4;
    const int row0 = cw * 64 + warp * 16 + gr;  // and row0 + 8
    const int64_t row_stride = static_cast<int64_t>(p.H) * HD;

    // accumulators: element 4 n8 + e is row row0 + 8 (e / 2), column
    // 8 n8 + 2 tc + e % 2
    float s[64], o[HD / 2];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.0f;
    int it = 0, j = 0;
    for (int r = 0; r * static_cast<int>(gridDim.x) < p.n_items; ++r) {
      const int w = tc_item_of(r);
      if (w >= p.n_items) continue;
      const TcItem item = tc_item(p, w);
      const int64_t qpos0 = item.qpos_min + row0, qpos1 = qpos0 + 8;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

      const int qb = j % kQBufs;
      const uint32_t q_addr =
          smem_u32(smem + L::kQ + qb * L::kQBytes) + cw * 64 * 128;
      mbar_wait(&q_full[qb], (j / kQBufs) & 1);

      for (int t = 0; t < item.n_tiles; ++t, ++it) {
        const int st = it % kStages;
        const int64_t k0 = item.lo + static_cast<int64_t>(t) * kBK;
        mbar_wait(&full[st], (it / kStages) & 1);

        wgmma_fence();
        issue_qk<HD>(s, q_addr, smem_u32(smem + L::kK + st * L::kTileBytes));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        float c0, c1;
        uint32_t pa[kBK / 16][4];
        tile_softmax(s, p, item, k0, qpos0, qpos1, tc, m0, m1, l0, l1, c0,
                     c1, pa);
#pragma unroll
        for (int n8 = 0; n8 < HD / 8; ++n8) {
          o[4 * n8 + 0] *= c0;
          o[4 * n8 + 1] *= c0;
          o[4 * n8 + 2] *= c1;
          o[4 * n8 + 3] *= c1;
        }

        wgmma_fence();
        issue_pv<HD>(o, pa, smem_u32(smem + L::kV + st * L::kTileBytes));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
#pragma unroll
        for (int kj = 0; kj < kBK / 16; ++kj) fence_regs(pa[kj]);
        if (lane == 0) mbar_arrive(&empty[st]);
      }
      if (lane == 0) mbar_arrive(&q_empty[qb]);  // its last read is done

      // o = acc / l, rows past Sq dropped; the stores overlap the next
      // item's loads
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
      bf16* out = p.o + (static_cast<int64_t>(item.b) * p.Sq + item.q0)
                  * row_stride + static_cast<int64_t>(item.h) * HD;
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        const int col = 8 * n8 + 2 * tc;
        if (row0 < item.nq)
          *reinterpret_cast<__nv_bfloat162*>(out + row0 * row_stride + col) =
              __floats2bfloat162_rn(o[4 * n8 + 0] * inv0,
                                    o[4 * n8 + 1] * inv0);
        if (row0 + 8 < item.nq)
          *reinterpret_cast<__nv_bfloat162*>(out + (row0 + 8) * row_stride
                                             + col) =
              __floats2bfloat162_rn(o[4 * n8 + 2] * inv1,
                                    o[4 * n8 + 3] * inv1);
      }
      ++j;
    }
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

// A 4-d map over (B, S, heads, hd) bf16 with element strides s_b, s_s, s_h
// (multiples of 8): boxes of `rows` positions x 64 columns of one head of
// one batch row, 128-byte swizzled; out-of-range positions read as zeros.
int make_map(CUtensorMap* map, const void* base, int B, int S, int heads,
             int hd, long long s_b, long long s_s, long long s_h, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_h) * 2,
                                 static_cast<cuuint64_t>(s_s) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {kPanel, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

template <int HD>
int launch_tc(const CUtensorMap& tq, const CUtensorMap& tk,
              const CUtensorMap& tv, const TcParams& p, int n_sms,
              cudaStream_t stream) {
  constexpr int smem = TcSmem<HD>::kBytes;
  auto kernel = fa_tc_kernel<HD>;
  // the shared-memory attribute, once for each card in turn
  static int set_for = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != set_for) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set_for = dev;
  }
  // one block per SM walks the items: each item's loads overlap the last
  // one's softmax and stores
  kernel<<<min(p.n_items, n_sms), kTcThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// ================================================== 2. split-K decode ==
constexpr int kTK = 64;             // keys per tile: 16 for each warp
constexpr int kSkStages = 2;        // the most tiles in flight: a third
                                    // stage costs a block per SM
constexpr int kRB = 16;             // query rows per block: one mma's M
constexpr int kSkThreads = 128;

struct SplitParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  float* part;                      // acc (.., n_rows, hd), then (m, l)
  long long ml_offset;              // floats from part to the (m, l) pairs
  const int* kv_len;
  int kv_len_all;
  int Sq, Sk, KV, rep, n_rows, n_groups, chunk, n_chunks, stages;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, window;
  long long q_offset;
  float scale_log2;
  int k_vec, v_vec;                 // 16-byte loads allowed
};

template <int HD>
struct SkSmem {
  static constexpr int kLD = HD + 8;    // +16 B: conflict-free ldmatrix rows
  static constexpr int kTileBytes = kTK * kLD * 2;
  // stages x (K tile, V tile), then the warps' (m, l); the 4 warps' O
  // reuse the tiles at the end
  static constexpr int bytes(int stages) {
    return stages * 2 * kTileBytes + 4 * kRB * 2 * 4;
  }
  static_assert(4 * kRB * HD * 4 <= 2 * kTileBytes, "O overlay");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

// d (16 x 8, fp32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Keys k_first .. k_first + 63 into a (kTK, ld) bf16 tile: keys at or past
// kend become zeros (their probabilities are 0, and 0 x garbage could be
// NaN).
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int64_t k_first,
                                          int64_t kend, bool vec) {
  constexpr int CH = HD / 8;
  for (int idx = threadIdx.x; idx < kTK * CH; idx += kSkThreads) {
    const int j = idx / CH;
    const int c = (idx - j * CH) * 8;
    bf16* d = dst + j * SkSmem<HD>::kLD + c;
    const int64_t kpos = k_first + j;
    if (kpos >= kend) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    } else if (vec) {
      cp_async16(d, src + kpos * stride + c);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = src[kpos * stride + c + e];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kSkThreads)
fa_split_k_kernel(const SplitParams p) {
  using L = SkSmem<HD>;
  constexpr int RS = kSkThreads / HD;     // row sets in the combine
  constexpr int RPT = kRB / RS;           // combined rows per thread
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);   // [stage][K, V][kTK][kLD]
  float* wml = reinterpret_cast<float*>(smem + p.stages * 2 * L::kTileBytes);

  const int chunk = blockIdx.x;
  const int g = blockIdx.y / p.n_groups;
  const int r0 = (blockIdx.y - g * p.n_groups) * kRB;
  const int b = blockIdx.z;
  const int nr = min(kRB, p.n_rows - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tc = lane % 4;

  // the keys of this chunk some query can see: [kbeg, kend)
  const int64_t kv_valid = min64(
      p.Sk, p.kv_len != nullptr ? p.kv_len[b] : p.kv_len_all);
  const int64_t qpos_min = p.q_offset, qpos_max = p.q_offset + p.Sq - 1;
  int64_t kbeg = static_cast<int64_t>(chunk) * p.chunk;
  int64_t kend = min64(kbeg + p.chunk, kv_valid);
  if (p.causal) kend = min64(kend, qpos_max + 1);
  if (p.window > 0) kbeg = max64(kbeg, qpos_min - p.window + 1);

  const int64_t slot = ((static_cast<int64_t>(b) * p.KV + g) * p.n_chunks
                        + chunk) * p.n_rows + r0;
  float* acc_out = p.part + slot * HD;
  float* ml_out = p.part + p.ml_offset + slot * 2;
  // the merge may launch now: it waits for this grid's end and its writes
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if (kend <= kbeg) {                    // an empty partial
    if (tid < nr) {
      ml_out[2 * tid] = kNegInf;
      ml_out[2 * tid + 1] = 0.0f;
    }
    return;
  }

  const bf16* kb = p.k + b * p.k_sb + g * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + g * p.v_sh;
  const int nt = static_cast<int>((kend - kbeg + kTK - 1) / kTK);
  const int stages = p.stages;
  auto k_tile = [&](int s) { return tiles + (2 * s) * kTK * L::kLD; };
  auto v_tile = [&](int s) { return tiles + (2 * s + 1) * kTK * L::kLD; };
  for (int s = 0; s < stages && s < nt; ++s) {
    load_rows<HD>(k_tile(s), kb, p.k_ss, kbeg + s * kTK, kend, p.k_vec);
    load_rows<HD>(v_tile(s), vb, p.v_ss, kbeg + s * kTK, kend, p.v_vec);
    cp_async_commit();
  }

  // Q rows r0 .. r0 + 15 (zeros past nr) as mma A fragments: row r is query
  // r / rep of head g * rep + r % rep
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = gr + 8 * (e & 1);
      const int col = 16 * ks + 8 * (e >> 1) + 2 * tc;
      float lo = 0.0f, hi = 0.0f;
      if (r < nr) {
        const int row = r0 + r;
        const bf16* qr = p.q + b * p.q_sb + (row / p.rep) * p.q_ss
                         + (g * p.rep + row % p.rep) * p.q_sh + col;
        lo = __bfloat162float(qr[0]);
        hi = __bfloat162float(qr[1]);
      }
      qa[ks][e] = pack_bf16(lo, hi);
    }
  const int64_t qpos0 = p.q_offset + (r0 + gr) / p.rep;
  const int64_t qpos1 = p.q_offset + (r0 + gr + 8) / p.rep;

  // this warp's online softmax over keys 16 warp .. 16 warp + 15 of each
  // tile: rows gr and gr + 8, columns 2 tc, 2 tc + 1 of every 8
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  for (int t = 0; t < nt; ++t) {
    // tile t + 1 may still be in flight
    if (stages == 2 && t + 1 < nt) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    const int st = t % stages;
    const int64_t kt0 = kbeg + static_cast<int64_t>(t) * kTK;
    const uint32_t kaddr = smem_u32(k_tile(st));
    const uint32_t vaddr = smem_u32(v_tile(st));
    const int mi = lane / 8, mr = lane % 8;

    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t kf[4];
      const int key = 16 * warp + (mi >> 1) * 8 + mr;
      ldmatrix_x4(kf, kaddr + (key * L::kLD + 16 * ks + (mi & 1) * 8) * 2);
      mma_16816(s[0], qa[ks], kf[0], kf[1]);
      mma_16816(s[1], qa[ks], kf[2], kf[3]);
    }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t kpos = kt0 + 16 * warp + 8 * n + 2 * tc + (e & 1);
        const int64_t qpos = e < 2 ? qpos0 : qpos1;
        bool ok = kpos < kend;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        const float x = ok ? s[n][e] * p.scale_log2 : kNegInf;
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
    uint32_t pa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      // keys past kend (the tile's padding) weigh exactly 0
      const int64_t kpos = kt0 + 16 * warp + 8 * n + 2 * tc;
      const float p0 = kpos < kend ? exp2f(s[n][0] - mn0) : 0.0f;
      const float p1 = kpos + 1 < kend ? exp2f(s[n][1] - mn0) : 0.0f;
      const float p2 = kpos < kend ? exp2f(s[n][2] - mn1) : 0.0f;
      const float p3 = kpos + 1 < kend ? exp2f(s[n][3] - mn1) : 0.0f;
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[2 * n] = pack_bf16(p0, p1);
      pa[2 * n + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t vf[4];
      const int key = 16 * warp + (mi & 1) * 8 + mr;
      ldmatrix_x4_trans(vf, vaddr + (key * L::kLD + 8 * (n + (mi >> 1))) * 2);
      mma_16816(o[n], pa, vf[0], vf[1]);
      mma_16816(o[n + 1], pa, vf[2], vf[3]);
    }
    __syncthreads();                     // stage st is free again
    if (t + stages < nt) {
      load_rows<HD>(k_tile(st), kb, p.k_ss, kt0 + stages * kTK, kend,
                    p.k_vec);
      load_rows<HD>(v_tile(st), vb, p.v_ss, kt0 + stages * kTK, kend,
                    p.v_vec);
      cp_async_commit();
    }
  }

  // combine the 4 warps: O in the tiles' space, (m, l) beside it
  float* red = reinterpret_cast<float*>(smem);       // [warp][kRB][HD]
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    float* w0 = red + (warp * kRB + gr) * HD + 8 * n + 2 * tc;
    w0[0] = o[n][0];
    w0[1] = o[n][1];
    w0[8 * HD] = o[n][2];
    w0[8 * HD + 1] = o[n][3];
  }
  if (tc == 0) {
    wml[(warp * kRB + gr) * 2] = m0;
    wml[(warp * kRB + gr) * 2 + 1] = l0;
    wml[(warp * kRB + gr + 8) * 2] = m1;
    wml[(warp * kRB + gr + 8) * 2 + 1] = l1;
  }
  __syncthreads();
  {
    const int d = tid % HD, rs = tid / HD;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rs + RS * i;
      if (r < nr) {
        float M = kNegInf;
#pragma unroll
        for (int w = 0; w < 4; ++w) M = fmaxf(M, wml[(w * kRB + r) * 2]);
        float den = 0.0f, num = 0.0f;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float f = exp2f(wml[(w * kRB + r) * 2] - M);
          den += f * wml[(w * kRB + r) * 2 + 1];
          num += f * red[(w * kRB + r) * HD + d];
        }
        acc_out[r * HD + d] = num;
        if (d == 0) {
          ml_out[2 * r] = M;
          ml_out[2 * r + 1] = den;
        }
      }
    }
  }
}

// One block per (query row, KV head, batch row), one thread per column:
// the chunks' weights 2^(m_c - M) in shared memory, then a sum over chunks.
template <int HD>
__global__ void __launch_bounds__(HD)
fa_merge_kernel(const SplitParams p, bf16* o, int H) {
  extern __shared__ float wts[];                    // [n_chunks]
  __shared__ float red[HD / 32];
  const int r = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int d = threadIdx.x, lane = d % 32, warp = d / 32;
  const int64_t first = (static_cast<int64_t>(b) * p.KV + g) * p.n_chunks
                        * p.n_rows + r;
  const float* ml = p.part + p.ml_offset;
  // launched early (programmatic dependent launch): wait for the split-K
  // grid to finish and its partials to be visible
  asm volatile("griddepcontrol.wait;" ::: "memory");

  float M = kNegInf;
  for (int c = d; c < p.n_chunks; c += HD) {
    const int64_t slot = first + static_cast<int64_t>(c) * p.n_rows;
    const float m = ml[2 * slot], l = ml[2 * slot + 1];
    wts[c] = m;
    if (l > 0.0f) M = fmaxf(M, m);      // empty partials are skipped
    else wts[c] = -INFINITY;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  if (lane == 0) red[warp] = M;
  __syncthreads();
  M = red[0];
#pragma unroll
  for (int w = 1; w < HD / 32; ++w) M = fmaxf(M, red[w]);
  __syncthreads();

  float den = 0.0f;
  for (int c = d; c < p.n_chunks; c += HD) {
    const int64_t slot = first + static_cast<int64_t>(c) * p.n_rows;
    const float w = wts[c] == -INFINITY ? 0.0f : exp2f(wts[c] - M);
    wts[c] = w;
    den += w * ml[2 * slot + 1];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    den += __shfl_xor_sync(0xffffffffu, den, off);
  if (lane == 0) red[warp] = den;
  __syncthreads();
  den = 0.0f;
#pragma unroll
  for (int w = 0; w < HD / 32; ++w) den += red[w];

  float num = 0.0f;
#pragma unroll 4
  for (int c = 0; c < p.n_chunks; ++c) {
    const float w = wts[c];
    if (w != 0.0f)
      num += w * p.part[(first + static_cast<int64_t>(c) * p.n_rows) * HD + d];
  }
  const int qi = r / p.rep, head = g * p.rep + r % p.rep;
  o[((static_cast<int64_t>(b) * p.Sq + qi) * H + head) * HD + d] =
      __float2bfloat16_rn(num / fmaxf(den, 1e-30f));
}

template <int HD>
int launch_split_k(const SplitParams& p, bf16* o, int B, int H,
                   cudaStream_t stream) {
  const int smem = SkSmem<HD>::bytes(p.stages);
  auto kernel = fa_split_k_kernel<HD>;
  // the shared-memory attribute for both stage counts, once for each card
  static int set_for = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != set_for) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SkSmem<HD>::bytes(kSkStages));
    if (err != cudaSuccess) return err;
    set_for = dev;
  }
  kernel<<<dim3(p.n_chunks, p.KV * p.n_groups, B), kSkThreads, smem,
           stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // split_k_chunk keeps n_chunks near 400 at most: ~1.6 KB of weights
  const int merge_smem = p.n_chunks * static_cast<int>(sizeof(float));
  auto merge = fa_merge_kernel<HD>;
  // programmatic dependent launch: the merge's launch overlaps the split
  // grid's last blocks
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_rows, p.KV, B);
  cfg.blockDim = dim3(HD);
  cfg.dynamicSmemBytes = merge_smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, merge, p, o, H);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// C entry points, loaded with ctypes.  Pointers are device pointers to bf16
// (B, Sq, H, hd) q and (B, Sk, KV, hd) k and v, read through their strides
// (in elements, last dimension contiguous); o is (B, Sq, H, hd), contiguous
// bf16; kv_len a (B,) int32 array on the device or null (kv_len_all for
// every row); window <= 0 means none.  Each returns 0 or the error that kept
// its kernels from running.

// The tensor-core route.  Base pointers 16-byte aligned and strides
// multiples of 8 elements (TMA); hd 64 or 128; n_sms: the card's SM count.
extern "C" int flash_attention_tc_fwd(
    const void* q, const void* k, const void* v, void* o, const void* kv_len,
    int kv_len_all, int B, int Sq, int Sk, int H, int KV, int hd,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, int window, long long q_offset, float scale,
    int n_sms, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk <= 0 || KV <= 0 || H % KV != 0 || (hd != 64 && hd != 128)
      || n_sms <= 0)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, Sq, H, hd, q_sb, q_ss, q_sh, kBQ);
  if (err == 0) err = make_map(&tk, k, B, Sk, KV, hd, k_sb, k_ss, k_sh, kBK);
  if (err == 0) err = make_map(&tv, v, B, Sk, KV, hd, v_sb, v_ss, v_sh, kBK);
  if (err != 0) return err;
  TcParams p;
  p.o = static_cast<bf16*>(o);
  p.kv_len = static_cast<const int*>(kv_len);
  p.kv_len_all = kv_len_all;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.B = B;
  p.rep = H / KV;
  p.n_qtiles = (Sq + kBQ - 1) / kBQ;
  p.n_items = p.n_qtiles * H * B;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd == 64 ? launch_tc<64>(tq, tk, tv, p, n_sms, s)
                  : launch_tc<128>(tq, tk, tv, p, n_sms, s);
}

// The split-K route.  `part` holds B * KV * n_chunks * Sq * (H / KV) *
// (hd + 2) floats; chunk is a multiple of 64 and n_chunks = ceil(Sk /
// chunk); k_vec / v_vec allow 16-byte loads of k / v.  hd 64 or 128.
extern "C" int flash_attention_split_k_fwd(
    const void* q, const void* k, const void* v, void* o, void* part,
    const void* kv_len, int kv_len_all, int B, int Sq, int Sk, int H, int KV,
    int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, int window, long long q_offset, float scale,
    int chunk, int k_vec, int v_vec, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk <= 0 || KV <= 0 || H % KV != 0 || (hd != 64 && hd != 128)
      || chunk <= 0 || chunk % kTK != 0)
    return cudaErrorInvalidValue;
  SplitParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.part = static_cast<float*>(part);
  p.kv_len = static_cast<const int*>(kv_len);
  p.kv_len_all = kv_len_all;
  p.Sq = Sq;
  p.Sk = Sk;
  p.KV = KV;
  p.rep = H / KV;
  p.n_rows = Sq * p.rep;
  p.n_groups = (p.n_rows + kRB - 1) / kRB;
  p.chunk = chunk;
  p.n_chunks = (Sk + chunk - 1) / chunk;
  p.stages = min(kSkStages, chunk / kTK);
  p.ml_offset = static_cast<long long>(B) * KV * p.n_chunks * p.n_rows * hd;
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
  p.scale_log2 = scale * kLog2e;
  p.k_vec = k_vec;
  p.v_vec = v_vec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* out = static_cast<bf16*>(o);
  return hd == 64 ? launch_split_k<64>(p, out, B, H, s)
                  : launch_split_k<128>(p, out, B, H, s);
}
