// Flash attention forward in float32 on Hopper's tensor cores (sm_90a):
// 3xTF32 products by wgmma, TMA loads and mbarriers, at hd 64.
//
// Replaces, for float32 q, k and v at hd 64 with more than 16 queries, the
// Pallas TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (:99), which flash_attention.cu computes on the CUDA cores for the other
// float32 calls.  It computes what that kernel computes: for batch row b,
// query head h and query i at absolute position q_offset + i, with KV head
// h / rep,
//
//   s_j = (q_i . k_j) * scale    for keys j < min(Sk, kv_len[b]), j <= the
//                                query's position if causal, and j > the
//                                position - window if a window is given
//   o_i = sum_j softmax(s)_j v_j
//
// with masked scores at the reference's finite -1e30 and kv_len read on the
// device (no host sync).  A query row with no valid key at all is left
// undefined, but finite.
//
// Precision.  TF32 keeps 10 bits of a float32's 23, which puts a product's
// error near 1e-3 on scores of size ~1: far outside the float32 limits the
// port's results are held to (2e-5 on the output).  So each operand x is
// split into hi = tf32(x) and lo = tf32(x - hi), and every product a b is
// taken as hi_a hi_b + hi_a lo_b + lo_a hi_b, three tensor-core products
// into one fp32 accumulator.  The tensor cores read a float32 operand's top
// 19 bits and ignore the rest, so x itself serves as hi (cut toward zero)
// and lo = x - hi is exact; what is dropped, lo_a lo_b and lo's own cut
// bits, is ~2^-20 of a b (tests/test_torch_tf32x3.py emulates it on the
// CPU, beside the round-to-nearest split).  The tensor cores' own sums also
// cut toward zero, and over Whisper's 1500 keys that bias put the encoder's
// output 30 times further from the CPU route's than the CUDA cores' kernel
// (PERF.md); so each tile's P V goes into a fresh accumulator that the
// CUDA cores add to O in fp32.
//
// Bound, on the H100 SXM at 700 W.  Whisper-medium's encoder (B 4, 1500 x
// 1500, 16 heads on 16, hd 64, bidirectional): 4*B*H*hd*Sq*Sk = 36.9 GFLOP,
// 0.550 ms at the CUDA cores' 67 TFLOP/s (flash_attention.cu's own floor);
// as 3xTF32 that is 110.6 GFLOP of tensor-core work, 0.224 ms at 495
// TFLOP/s, against 0.0147 ms for its 49.2 MB of q, k, v and o at 3.35 TB/s.
// So the products bound it.  Its cross-attention at prefill (32 queries on
// the 1500 frames) is bound by bytes: 0.0150 ms.  Design:
// - one block per SM walks the work items, (128-query tile, head, batch
//   row), in rounds that run forward and backward over the blocks
//   (flash_attention_hopper.cu's prefill schedule), numbered head by head
//   (below);
// - three warpgroups.  The first: one thread issues TMA loads and three
//   warps split the tiles into tf32 hi and lo; setmaxnreg moves the
//   registers it does not need to the other two, the consumers, which each
//   own 64 query rows;
// - Q (128 x 64) and a ring of 2 stages of K and V tiles (64 keys x 64)
//   come in by TMA through 4-d tensor maps over the (B, S, heads, hd)
//   strides, in 128-byte-swizzled 32-column panels, with mbarriers for
//   "full" (transaction bytes) and "empty"; rows past Sq or Sk arrive as
//   zeros;
// - the split warps turn each arrived K and V tile into hi and lo tiles in
//   a second ring of 2 stages: K's at the same swizzled offsets (wgmma's
//   K-major B operand of S = Q K^T, as TMA wrote it), V's transposed to
//   (hd, keys), since wgmma takes tf32 operands K-major only, with the keys
//   of each group of 8 permuted to the order in which the consumers hold P
//   (below).  A warp's unit is 4 columns of 32 rows, a row a lane, the
//   loads of two units in flight together; fence.proxy.async makes the
//   stores visible to wgmma.  The split runs one tile ahead of the
//   consumers; its ring adds 128 KB to the raw ring's 64 KB and Q's 32 KB
//   (224 KB of the 227 KB);
// - each consumer reads its 64 Q rows once an item from the raw tile into
//   registers as wgmma A fragments, hi and lo (64 registers), and frees the
//   Q buffer at once, so the next item's Q loads during this one;
// - S = Q K^T by wgmma m64n64k8 (A from registers, B the K tiles), 3
//   instructions a k-step of 8; the online softmax runs in fp32 registers
//   with ex2.approx on scores prescaled by scale * log2(e); P, split into
//   hi and lo in registers, is the A operand of P V (m64n64k8, B the V^T
//   tiles).  The accumulator holds columns 2t and 2t + 1 of each 8 where
//   tf32's A fragment wants t and t + 4; the permuted V^T rows make the two
//   agree, so P never leaves the registers;
// - key tiles that no query of the block can see (past kv_len, past the
//   causal diagonal, before the window) are never loaded, and a consumer
//   whose 64 rows all lie past Sq (a 32-query prefill) skips the products;
//   only tiles that cross a boundary are masked.
// The kernel is bound by issue slots more than by either unit: the split
// and the products each take most of its time alone, and every instruction
// the split and the softmax save shows (tools/flash_attention_tf32_ablation.py
// times each part; cvt.rna for the split takes longer).
// Nothing here allocates or synchronises; the entry point returns the CUDA
// error of its launch (or of a tensor map's encoding, as 1000 + CUresult).
// A wait on an mbarrier that lasts seconds traps, so a fault in the
// pipeline ends the kernel with an error instead of hanging the card.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's finite mask value
constexpr float kLog2e = 1.4426950408889634f;

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
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

// d (64 x 64, fp32) = (scale_d ? d : 0) + A (64 x 8, tf32 in registers)
// B (8 x 64); B from shared memory, K-major (tf32 has no other layout).
__device__ __forceinline__ void wgmma_m64n64k8_rs(float (&d)[32],
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

// ================================================================ layout ==
constexpr int kHD = 64;             // the head dim this route takes
constexpr int kBQ = 128;            // query rows per work item (2 x 64)
constexpr int kBK = 64;             // keys per tile
constexpr int kStages = 2;          // the raw ring and the split ring
constexpr int kPanel = 32;          // float32 columns in a 128-byte row
constexpr int kThreads = 384;       // loader/splitter + 2 consumer warpgroups
constexpr int kSplitWarps = 3;      // warps 1-3 of the first warpgroup

struct Smem {
  static constexpr int kQBytes = kBQ * kHD * 4;        // 2 panels of 128 rows
  static constexpr int kTileBytes = kBK * kHD * 4;     // 2 panels of 64 rows
  static constexpr int kPanelBytes = kBK * 128;        // one panel of a tile
  static constexpr int kQ = 0;
  static constexpr int kRaw = kQ + kQBytes;            // [stage][K, V]
  static constexpr int kSplit = kRaw + kStages * 2 * kTileBytes;
  // [stage][K hi, K lo, V^T hi, V^T lo]
  static constexpr int kBars = kSplit + kStages * 4 * kTileBytes;
  static constexpr int kNumBars = 2 + 4 * kStages;
  static constexpr int kBytes = kBars + kNumBars * 8 + 1024;
};
static_assert(Smem::kBytes <= 232448, "shared memory");

struct Params {
  float* o;                         // (B, Sq, H, 64), contiguous
  const int* kv_len;                // (B,) on the device, or null
  int kv_len_all;
  int Sq, Sk, H, B, rep, n_qtiles, n_items;
  int causal, window;               // window <= 0: none
  long long q_offset;
  float scale_log2;                 // scale * log2(e)
};

// One work item: a 128-query tile of one head of one batch row, and the
// key tiles its queries can see, [lo, lo + n_tiles * kBK).  Items are
// numbered head by head (the heads of a KV group next to each other), and
// within a head heaviest first: under a causal mask the last query tiles
// have the most key tiles.  The blocks at work at one time then share the
// K and V of a few heads through L2: numbered query tile by query tile,
// they stream every head's K and V at once, which at Whisper's encoder
// (49 MB of K and V) reads them from device memory again for each query
// tile.
struct Item {
  int h, b, q0, nq, n_tiles;
  int64_t lo, kv_valid, qpos_min, qpos_max;
};

__device__ __forceinline__ Item item_at(const Params& p, int w) {
  Item it;
  const int hb = w / p.n_qtiles;
  const int qt = p.n_qtiles - 1 - (w - hb * p.n_qtiles);
  it.h = hb % p.H;
  it.b = hb / p.H;
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
__device__ __forceinline__ int item_of(int r) {
  const int g = static_cast<int>(gridDim.x), i = static_cast<int>(blockIdx.x);
  return r * g + ((r & 1) ? g - 1 - i : i);
}

// Byte offset of element (row, col) in a tile of 32-column panels, 128-byte
// swizzled as TMA writes it and wgmma reads it; `panel_bytes` apart.
__device__ __forceinline__ uint32_t swz(int row, int col, int panel_bytes) {
  return (col / kPanel) * panel_bytes + row * 128
         + ((((col % kPanel) >> 2) ^ (row & 7)) << 4) + ((col & 3) << 2);
}

// The V^T column (within its group of 8) that holds key m of the group:
// the consumers hold P's keys 2t and 2t + 1 where tf32's A fragment has
// its columns t and t + 4.
__device__ __forceinline__ int vt_col(int m) {
  return (m >> 1) + 4 * (m & 1);
}

// One pass of the split warps over a raw (ROWS x 64) tile as TMA wrote it
// (32-column panels of ROWS x 128 bytes).  A warp's unit is 4 columns of
// the 32 rows of one panel, a row a lane; the loads of 4 units go out
// before their stores, so their latencies overlap.  SAME: hi and lo at the
// raw offsets; TRANS: hi and lo transposed into (64, ROWS) tiles (panels of
// 64 x 128 bytes), rows permuted by vt_col within each group of 8, 32
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
        const int col = (row & ~7) + vt_col(row & 7);
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

// S (64 x 64) = Q K^T: 8 k-steps of 8 columns of hd (32 bytes inside a
// panel), each as lo_q hi_k + hi_q lo_k + hi_q hi_k.
__device__ __forceinline__ void issue_qk(float (&s)[32],
                                         const uint32_t (&qh)[8][4],
                                         const uint32_t (&ql)[8][4],
                                         uint32_t k_hi, uint32_t k_lo) {
  const uint64_t h0 = sw128_desc(k_hi, 16, 1024);
  const uint64_t l0 = sw128_desc(k_lo, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < kHD / 8; ++kk) {
    // the start address is the descriptor's low field, in 16-byte units
    const uint32_t off = ((kk / 4) * Smem::kPanelBytes + (kk % 4) * 32) >> 4;
    const uint64_t dh = h0 + off, dl = l0 + off;
    wgmma_m64n64k8_rs(s, ql[kk], dh, kk > 0);
    wgmma_m64n64k8_rs(s, qh[kk], dl, 1);
    wgmma_m64n64k8_rs(s, qh[kk], dh, 1);
  }
}

// O_tile (64 x 64) = P V: 8 k-steps of 8 keys, B the V^T tiles (hd rows,
// keys K-major).
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const uint32_t (&ph)[8][4],
                                         const uint32_t (&pl)[8][4],
                                         uint32_t v_hi, uint32_t v_lo) {
  const uint64_t h0 = sw128_desc(v_hi, 16, 1024);
  const uint64_t l0 = sw128_desc(v_lo, 16, 1024);
#pragma unroll
  for (int kj = 0; kj < kBK / 8; ++kj) {
    const uint32_t off = ((kj / 4) * Smem::kPanelBytes + (kj % 4) * 32) >> 4;
    const uint64_t dh = h0 + off, dl = l0 + off;
    wgmma_m64n64k8_rs(o, pl[kj], dh, kj > 0);
    wgmma_m64n64k8_rs(o, ph[kj], dl, 1);
    wgmma_m64n64k8_rs(o, ph[kj], dh, 1);
  }
}

// The online softmax of one tile in the accumulator's registers: masks
// (only a tile that crosses a boundary), scales to log2 units, updates the
// rows' max m and sum l, and splits P = exp2(s - m) into tf32 hi and lo A
// fragments: k-step n8 takes keys 8 n8 .. 8 n8 + 7, registers (row g, key
// 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1).  c0, c1: the rows'
// correction factors exp2(m_old - m_new).
__device__ __forceinline__ void tile_softmax(
    float (&s)[32], const Params& p, const Item& item, int64_t k0,
    int64_t qpos0, int64_t qpos1, int tc, float& m0, float& m1, float& l0,
    float& l1, float& c0, float& c1, uint32_t (&ph)[8][4],
    uint32_t (&pl)[8][4]) {
  const bool masked = k0 + kBK > item.kv_valid
      || (p.causal && k0 + kBK - 1 > item.qpos_min)
      || (p.window > 0 && k0 <= item.qpos_max - p.window);
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int n8 = 0; n8 < kBK / 8; ++n8) {
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
  c0 = ex2(m0 - mn0);
  c1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  l0 *= c0;
  l1 *= c1;
#pragma unroll
  for (int n8 = 0; n8 < kBK / 8; ++n8) {
    const float p0 = ex2(s[4 * n8 + 0] - mn0);
    const float p1 = ex2(s[4 * n8 + 1] - mn0);
    const float p2 = ex2(s[4 * n8 + 2] - mn1);
    const float p3 = ex2(s[4 * n8 + 3] - mn1);
    l0 += p0 + p1;
    l1 += p2 + p3;
    split_tf32(p0, ph[n8][0], pl[n8][0]);
    split_tf32(p2, ph[n8][1], pl[n8][1]);
    split_tf32(p1, ph[n8][2], pl[n8][2]);
    split_tf32(p3, ph[n8][3], pl[n8][3]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fa_tf32_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle pattern repeats every 8 rows of 128 B
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Smem::kBars);
  uint64_t* q_empty = q_full + 1;
  uint64_t* raw_full = q_empty + 1;
  uint64_t* raw_empty = raw_full + kStages;
  uint64_t* split_full = raw_empty + kStages;
  uint64_t* split_empty = split_full + kStages;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);          // the consumers' 8 warps
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&raw_full[s], 1);
      mbar_init(&raw_empty[s], kSplitWarps);
      mbar_init(&split_full[s], kSplitWarps);
      mbar_init(&split_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int n_rounds = (p.n_items + static_cast<int>(gridDim.x) - 1)
                       / static_cast<int>(gridDim.x);
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int warp = threadIdx.x / 32;
    if (threadIdx.x == 0) {
      // ------------------------------------------------ TMA producer --
      int it = 0, j = 0;            // K/V tiles and items of this block
      for (int r = 0; r < n_rounds; ++r) {
        const int w = item_of(r);
        if (w >= p.n_items) continue;
        const Item item = item_at(p, w);
        if (j >= 1) mbar_wait(q_empty, (j - 1) & 1);
        mbar_expect_tx(q_full, Smem::kQBytes);
        for (int c = 0; c < kHD / kPanel; ++c)
          tma_load_4d(smem + Smem::kQ + c * kBQ * 128, &tq, q_full,
                      c * kPanel, item.h, item.q0, item.b);
        const int kvh = item.h / p.rep;
        for (int t = 0; t < item.n_tiles; ++t, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&raw_empty[s], ((it / kStages) + 1) & 1);
          const int k0 = static_cast<int>(item.lo) + t * kBK;
          uint8_t* raw = smem + Smem::kRaw + s * 2 * Smem::kTileBytes;
          mbar_expect_tx(&raw_full[s], 2 * Smem::kTileBytes);
          for (int c = 0; c < kHD / kPanel; ++c) {
            tma_load_4d(raw + c * Smem::kPanelBytes, &tk, &raw_full[s],
                        c * kPanel, kvh, k0, item.b);
            tma_load_4d(raw + Smem::kTileBytes + c * Smem::kPanelBytes, &tv,
                        &raw_full[s], c * kPanel, kvh, k0, item.b);
          }
        }
        ++j;
      }
    } else if (warp >= 1) {
      // --------------------------------------------- the split warps --
      const int sw = warp - 1, lane = threadIdx.x % 32;
      int it = 0;
      for (int r = 0; r < n_rounds; ++r) {
        const int w = item_of(r);
        if (w >= p.n_items) continue;
        const int n_tiles = item_at(p, w).n_tiles;
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int s = it % kStages;
          mbar_wait(&raw_full[s], (it / kStages) & 1);
          if (it >= kStages)
            mbar_wait(&split_empty[s], ((it / kStages) + 1) & 1);
          const uint8_t* raw = smem + Smem::kRaw + s * 2 * Smem::kTileBytes;
          uint8_t* split = smem + Smem::kSplit + s * 4 * Smem::kTileBytes;
          split_tile<kBK, true, false>(raw, split, split + Smem::kTileBytes,
                                       nullptr, nullptr, sw, lane);
          split_tile<kBK, false, true>(raw + Smem::kTileBytes, nullptr,
                                       nullptr, split + 2 * Smem::kTileBytes,
                                       split + 3 * Smem::kTileBytes, sw, lane);
          fence_async_smem();
          __syncwarp();
          if (threadIdx.x % 32 == 0) {
            mbar_arrive(&raw_empty[s]);
            mbar_arrive(&split_full[s]);
          }
        }
      }
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
  const int64_t row_stride = static_cast<int64_t>(p.H) * kHD;

  // accumulators: element 4 n8 + e is row row0 + 8 (e / 2), column
  // 8 n8 + 2 tc + e % 2
  float s[32], o[32];
  uint32_t qh[8][4], ql[8][4];
  int it = 0, j = 0;
  for (int r = 0; r < n_rounds; ++r) {
    const int w = item_of(r);
    if (w >= p.n_items) continue;
    const Item item = item_at(p, w);
    const bool active = cw * 64 < item.nq;
    const int64_t qpos0 = item.qpos_min + row0, qpos1 = qpos0 + 8;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

    // Q's rows as A fragments: k-step kk holds (row g, column 8 kk + t),
    // (g + 8, 8 kk + t), (g, 8 kk + t + 4), (g + 8, 8 kk + t + 4)
    mbar_wait(q_full, j & 1);
    const uint8_t* qs = smem + Smem::kQ;
#pragma unroll
    for (int kk = 0; kk < kHD / 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e & 1);
        const int col = 8 * kk + tc + 4 * (e >> 1);
        const float x = *reinterpret_cast<const float*>(
            qs + swz(row, col, kBQ * 128));
        split_tf32(x, qh[kk][e], ql[kk][e]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty);        // Q is in registers

    for (int t = 0; t < item.n_tiles; ++t, ++it) {
      const int st = it % kStages;
      const int64_t k0 = item.lo + static_cast<int64_t>(t) * kBK;
      mbar_wait(&split_full[st], (it / kStages) & 1);
      if (active) {
        const uint32_t split = smem_u32(smem + Smem::kSplit
                                        + st * 4 * Smem::kTileBytes);
        wgmma_fence();
        issue_qk(s, qh, ql, split, split + Smem::kTileBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        float c0, c1;
        uint32_t ph[8][4], pl[8][4];
        tile_softmax(s, p, item, k0, qpos0, qpos1, tc, m0, m1, l0, l1, c0,
                     c1, ph, pl);
        // this tile's P V into s (free again), added to O in fp32 by the
        // CUDA cores: the tensor cores' own sums cut toward zero, a bias
        // that would grow over the keys
        wgmma_fence();
        issue_pv(s, ph, pl, split + 2 * Smem::kTileBytes,
                 split + 3 * Smem::kTileBytes);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
#pragma unroll
        for (int n8 = 0; n8 < kHD / 8; ++n8) {
          o[4 * n8 + 0] = fmaf(o[4 * n8 + 0], c0, s[4 * n8 + 0]);
          o[4 * n8 + 1] = fmaf(o[4 * n8 + 1], c0, s[4 * n8 + 1]);
          o[4 * n8 + 2] = fmaf(o[4 * n8 + 2], c1, s[4 * n8 + 2]);
          o[4 * n8 + 3] = fmaf(o[4 * n8 + 3], c1, s[4 * n8 + 3]);
        }
#pragma unroll
        for (int kj = 0; kj < kBK / 8; ++kj) {
          fence_regs(ph[kj]);
          fence_regs(pl[kj]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&split_empty[st]);
    }

    // o = acc / l, rows past Sq dropped; the stores overlap the next
    // item's loads
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
    float* out = p.o + (static_cast<int64_t>(item.b) * p.Sq + item.q0)
                 * row_stride + static_cast<int64_t>(item.h) * kHD;
#pragma unroll
    for (int n8 = 0; n8 < kHD / 8; ++n8) {
      const int col = 8 * n8 + 2 * tc;
      if (row0 < item.nq)
        *reinterpret_cast<float2*>(out + row0 * row_stride + col) =
            make_float2(o[4 * n8 + 0] * inv0, o[4 * n8 + 1] * inv0);
      if (row0 + 8 < item.nq)
        *reinterpret_cast<float2*>(out + (row0 + 8) * row_stride + col) =
            make_float2(o[4 * n8 + 2] * inv1, o[4 * n8 + 3] * inv1);
    }
    ++j;
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

// A 4-d map over (B, S, heads, hd) float32 with element strides s_b, s_s,
// s_h (multiples of 4): boxes of `rows` positions x 32 columns of one head
// of one batch row, 128-byte swizzled; out-of-range positions read as
// zeros.
int make_map(CUtensorMap* map, const void* base, int B, int S, int heads,
             long long s_b, long long s_s, long long s_h, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHD),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_h) * 4,
                                 static_cast<cuuint64_t>(s_s) * 4,
                                 static_cast<cuuint64_t>(s_b) * 4};
  const cuuint32_t box[4] = {kPanel, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(r);
}

// C entry point, loaded with ctypes: the tensor-core route's argument list.
// Pointers are device pointers to float32 (B, Sq, H, 64) q and (B, Sk, KV,
// 64) k and v, read through their strides (in elements, last dimension
// contiguous; base pointers 16-byte aligned and strides multiples of 4
// elements, TMA's rule); o is (B, Sq, H, 64), contiguous float32; kv_len a
// (B,) int32 array on the device or null (kv_len_all for every row);
// window <= 0 means none; n_sms: the card's SM count.  Returns 0 or the
// error that kept the kernel from running.
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

extern "C" int flash_attention_tf32_fwd(
    const void* q, const void* k, const void* v, void* o, const void* kv_len,
    int kv_len_all, int B, int Sq, int Sk, int H, int KV, int hd,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, int window, long long q_offset, float scale,
    int n_sms, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk <= 0 || KV <= 0 || H % KV != 0 || hd != kHD || n_sms <= 0)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = make_current(q);
  if (err == 0) err = make_map(&tq, q, B, Sq, H, q_sb, q_ss, q_sh, kBQ);
  if (err == 0) err = make_map(&tk, k, B, Sk, KV, k_sb, k_ss, k_sh, kBK);
  if (err == 0) err = make_map(&tv, v, B, Sk, KV, v_sb, v_ss, v_sh, kBK);
  if (err != 0) return err;
  Params p;
  p.o = static_cast<float*>(o);
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
  // the shared-memory attribute, once for each card in turn
  static int set_for = -1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != set_for) {
    e = cudaFuncSetAttribute(fa_tf32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem::kBytes);
    if (e != cudaSuccess) return e;
    set_for = dev;
  }
  fa_tf32_kernel<<<min(p.n_items, n_sms), kThreads, Smem::kBytes,
                   static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, p);
  return cudaGetLastError();
}
