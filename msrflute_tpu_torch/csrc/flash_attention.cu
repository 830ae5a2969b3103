// Flash attention for Hopper (sm_90a): the forward (B4), the dq pass (B5)
// and the dk/dv pass (B6), in one library: f32 on CUDA cores, and all three
// in bfloat16 / float16 storage on the tensor cores (the last section of
// this note).
//
// Replaces the TPU kernels of msrflute_tpu/ops/pallas_attention.py:
// - B4 _fwd (pl.pallas_call at pallas_attention.py:336, body _fwd_kernel
//   at :96): FlashAttention-2 forward with an online softmax, writing `out`
//   and the per-row logsumexp `lse`;
// - B5 _bwd's dq pass (pl.pallas_call at pallas_attention.py:385, body
//   _dq_kernel at :161): dq with p recomputed from the saved lse and the lse
//   cotangent glse added into ds;
// - B6 _bwd's dk/dv pass (pl.pallas_call at pallas_attention.py:411, body
//   _dkv_kernel at :212): dk and dv, key tiles outer, query tiles streamed.
//
// Semantics kept from the TPU kernels: scale 1/sqrt(D) is given by the
// caller; the causal mask compares GLOBAL positions (q_off + q_loc >=
// k_off + k_loc); key tiles wholly above the diagonal are skipped with the
// TPU kernels' own tile conditions (:139, :201, :260); padded keys, and in
// B6 padded query rows, are masked; masked probabilities are zeroed
// explicitly, so a row whose keys are all masked gives out = 0 and
// lse = -1e30 exactly; ds = p * (dp - delta + glse) * scale with
// delta = rowsum(dO * O) computed by the caller (pallas_attention.py:374).
//
// Layouts: q, k, v, out, dO, dq, dk, dv are contiguous [B, L, H, D] (the JAX
// public layout; no transpose to [B, H, L, D] is made); lse, delta and glse
// are contiguous [B, H, Lq] float32.
//
// Storage types.  The TPU kernels take any float storage: they upcast each
// tile to f32, compute in f32, and store out, dq, dk and dv in the input's
// type, lse in f32 (pallas_attention.py:109-111, :150, :172-175, :209,
// :224-227, :268-269).  So q, k, v, dO and the outputs are float,
// __nv_bfloat16 or __half here, one type for all of them (the launchers
// with the _bf16 and _f16 suffix).  In 16-bit storage all three passes run
// the tensor-core kernels of the last section; the kernels of the sections
// before it take float32 storage only.
//
// Bound on the H100: at the RingLM path's [40, 1023, 4, 32] causal each
// pass reads a few tens of MB and does 1.1e10 (B4), 1.6e10 (B5) and
// 2.1e10 (B6) flops a layer, so all three are bound by operations: about
// 0.16, 0.24 and 0.32 ms at the 67 TFLOP/s f32 CUDA-core rate (0.02-0.04 ms
// at the 495 TFLOP/s TF32 tensor-core rate, which these kernels do not use:
// one TF32 pass cannot hold the port's f32 tolerances).
//
// Common to the three kernels:
// - the TPU kernels' sequential grid axis and its VMEM carry become a loop
//   inside one block: a block of 256 threads owns one (b*h, 64-row query
//   tile) in B4 and B5 and one (b*h, 64-row key tile) in B6, and streams
//   64-row tiles of the other axis through shared memory;
// - no atomics: B4 alone writes its out and lse rows, B5 its dq rows and B6
//   its dk/dv rows, and every sum runs in a fixed order, so two launches
//   are bitwise equal;
// - heavy tiles are scheduled first under the causal mask (the last query
//   tile in B4/B5, the first key tile in B6);
// - D <= 128; any L (the ragged last tile is masked).
//
// Designed for this card.  An SM starts one instruction a clock from each
// of its four schedulers and a warp-wide FMA is one of them, so every
// load, store and index computation takes an FMA's slot; and its shared
// memory serves a 16-byte load one quarter warp at a time, in about 2.5
// clocks a warp when each quarter's 8 lanes touch 64 bytes or fewer and
// 3.7 otherwise, broadcast or not (csrc/probes/lds_throughput.cu).  A
// kernel that reads one shared scalar for each FMA, as the first versions
// of all three did, leaves the FMA pipes a quarter busy.  What the design
// does about it:
// - register tiles.  Warp w owns rows 8w .. 8w + 7 of the block's own tile
//   (Q in B4; Q, dO in B5; K, V in B6).  For each 64 x 64 score product
//   (S = Q K^T in all three, dP = dO V^T in B5 and B6) a thread owns a
//   4 x 4 block (own rows o + 2x against streamed rows t + 16y) and reads
//   4 values along d of each of its 8 rows with 16-byte loads: 8 loads
//   feed 64 FMAs.  For the accumulations (out += P V; dq += dS K;
//   dv += P^T dO; dk += dS^T Q) a lane owns 4 rows x 4 columns of the
//   warp's [8][D] piece of the output and reads p or ds as 16-byte vectors
//   along the axis it sums over: again 8 loads for 64 FMAs.  In B4 and B5
//   the two halves of a warp each sum over 32 of the tile's 64 keys and
//   add up once, by shuffle, when the block ends; in B6 one half sums dv
//   and the other dk.  Per 64 x 64 tile pair at D = 32 a thread makes 128
//   (B4), 192 (B5) or 256 (B6) 16-byte loads for 1,024, 1,536 or 2,048
//   FMAs, where the first versions made one scalar load for each;
// - quarter warps and banks.  Tiles stay row-major [64][DT + 4] (DT = D
//   padded to 8, 16, 32, 64 or 128, the columns at or past D zero), the
//   layout cp.async delivers.  The lanes are placed so that a quarter warp
//   covers 2 own rows x 4 streamed rows (or 2 rows x 4 column groups of an
//   output): each 16-byte load touches at most 4 distinct pieces a quarter,
//   and with a row stride of DT + 4 floats (4 mod 32) consecutive rows fall
//   in distinct groups of 4 banks.  p and ds tiles are [own][streamed] with
//   a row stride of 80 floats (16 mod 32): a warp's scalar stores (2 rows x
//   16 columns) hit 32 distinct banks;
// - barriers.  The p and ds rows a warp writes are the rows its own
//   accumulation reads, so between the two only the warp synchronises; the
//   block meets once a tile, when the next streamed tile has landed;
// - masking.  The tile loop tells tiles that the mask cannot touch (wholly
//   below the diagonal, away from the ragged edges) from diagonal and edge
//   tiles; only the latter run the body that tests every element.  The
//   skip conditions are the TPU kernels';
// - copies.  Tiles arrive by cp.async, 16 bytes a copy where D % 4 == 0
//   and the tensors are 16-byte aligned (4 bytes a copy otherwise), rows
//   past L zero-filled by the copy itself; the two tensors that travel
//   together (K and V, Q and dO) share one address.  The streamed tiles
//   (K, V in B4 and B5; Q, dO and the three row statistics in B6) are
//   double-buffered up to D = 64: tile j + 1 is in flight while tile j is
//   computed.  Above, one stage (two would not fit B5 and B6);
// - the element-wise part.  2^x by ex2.approx, 2 instructions a score
//   instead of expf's dozen.  B4's online softmax runs in the log2 domain:
//   the row max m2 is kept pre-scaled by scale * log2(e), a tile's max of
//   the raw scores is taken over the 16 lanes that share a row with four
//   shuffles, p = 2^(s * scale * log2(e) - m2) is one FMA and one ex2, and
//   each lane keeps its own partial row sum, rescaled by
//   corr = 2^(m2_old - m2_new) each tile and added across the 16 lanes once,
//   when the block ends.  The backward recomputes p = 2^(s * scale *
//   log2(e) - lse * log2(e)) (relative error about 1e-6 from the rounding
//   of the two products at |lse| <= 20); ds is kept as p * (dp + (glse -
//   delta)) and the scale multiplies dq and dk once, when the block ends;
// - B4's row statistics.  A row's corr goes from the lane that computed it
//   to the lanes that own the row's output through a per-warp shared slot,
//   again between the warp's own lanes, with __syncwarp; the final row sum
//   goes the same way.  While a row has seen no visible key its max is
//   still about -1e30 and corr is 2^0 or 2^(-huge); masked entries are set
//   to 0 explicitly, so a fully masked row keeps acc = l = 0 and gives
//   out = 0 and lse = -1e30 exactly;
// - registers.  __launch_bounds__(256, 2) up to D = 32: at most 128
//   registers a thread, two blocks (16 warps) an SM, no spill;
// - shared memory a block at DT = 32 / 128, in bytes: B4 4 * ((1 + 2 *
//   stages) * 64 * (DT + 4) + 64 * 80 + 64) = 66,816 / 122,112; B5 4 *
//   ((2 + 2 * stages) * 64 * (DT + 4) + 64 * 80 + 3 * 64) = 76,544 /
//   156,416; B6 4 * ((2 + 2 * stages) * 64 * (DT + 4) + 2 * 64 * 80 +
//   stages * 3 * 64) = 97,792 / 176,896: above 48 KB it is opted in with
//   cudaFuncSetAttribute.
// What still holds them (PERF.md has the numbers, from an NVIDIA H100
// 80GB HBM3 at 700 W): with the loads taken out of the products B5 and B6
// run no faster, so it is the rate at which 16 warps an SM get their FMAs
// started, with the element-wise part, the copies' index arithmetic and
// the loop taking a fifth of the slots; they reach 48-49 % of their f32
// bound.  B4 reaches 41 %: next to its two products the online softmax,
// the rescale and the copies take a larger share of the slots than B5's
// element-wise part does next to three.  Three blocks an SM (80 registers)
// spill and run slower, and rescaling only when a row max grows by 2^8
// gains nothing (csrc/probes/fwd_variants.py).
//
// The tensor-core arms: flash_fwd_tc_kernel (B4, replacing _fwd at
// pallas_attention.py:336, body :96-150), flash_dq_tc_kernel (B5,
// replacing _bwd's dq pass at :385, body _dq_kernel at :161-209) and
// flash_dkv_tc_kernel (B6, replacing _dkv_kernel at :411, body :212-269)
// for bfloat16 and float16 storage.  Bound on the H100: at [40, 1023, 4,
// 32] causal B4 does 1.1e10 flops and moves 42.6 MB, B5 1.6e10 flops and
// 54.3 MB, B6 2.1e10 flops and 64.8 MB; at the dense 16-bit tensor-core
// rate (989 TFLOP/s) and 3.35 TB/s B4 is bound by bytes (0.0127 ms,
// against 0.0108 of operations), B5 by operations by a hair (0.0163 ms,
// against 0.0162 of bytes) and B6 by operations (0.0217 ms, against
// 0.0193 of bytes).  A CUDA-core FMA loop would hold them at the 67
// TFLOP/s f32 rate (0.16, 0.24 and 0.32 ms); the design puts the products
// on the tensor cores instead:
// - products.  mma.sync.m16n8k16 with 16-bit operands and f32
//   accumulators, fed by ldmatrix from shared memory: B4 runs S = Q K^T
//   and O += P V, B5 S = Q K^T, dP = dO V^T and dQ += dS K, B6 S^T =
//   K Q^T, dP^T = V dO^T, dV += P^T dO and dK += dS^T Q.  A block of 4
//   warps owns 64 rows of its own tile (Q in B4, Q and dO in B5, K and V
//   in B6), a warp 16 of them, and streams 64-row tiles of the other axis;
//   B6 takes a streamed tile 32 queries at a time, which keeps its D = 32
//   instance within 128 registers; B5 takes it whole up to DT = 32 and 32
//   keys at a time above.  B5's
//   dQ += dS K is B4's O += P V with K in V's place: K, stored [key][d],
//   is read by the transposed ldmatrix with keys as the reduction axis.
//   B5 owns its query rows, so a lane reads its two rows' lse, delta and
//   glse once, into registers, where B6 stages them with each query tile,
//   and a warp holds its Q and dO rows as A fragments in registers (32 at
//   DT = 32) instead of reading them by ldmatrix every pass.  Both the
//   held fragments and the whole-tile pass were measured faster, with no
//   spill; 64 keys a pass spill at DT = 64, and 3 blocks an SM are no
//   faster (csrc/probes/tc_variants.py; PERF.md has the numbers).  The head width is padded with zero columns
//   to DT = 16, 32, 64 or 128 (D = 5, 8 -> 16, D = 20 -> 32); D <= 128.
//   An accumulator of S (or S^T, dP^T) is already laid out as the A
//   operand of the next product, so P and dS never leave the registers;
// - the element-wise work in f32 on the accumulators: B4's online softmax
//   in the log2 domain with ex2.approx (the row max over the 4 lanes of a
//   quad, by two shuffles), the global-position causal mask, the TPU
//   kernels' tile-skip conditions (pallas_attention.py:139, :260),
//   explicit zeros for masked entries (a fully masked row gives out = 0
//   and lse = -1e30 exactly), B6's mask on padded query rows (B5's padded
//   query rows come from zero Q and dO rows and are stored nowhere), and
//   ds / scale = p (dp - delta + glse) with the scale on dq and dk once, at
//   the end.  The row sum l, and so the lse, comes from the f32 p before
//   any rounding;
// - P and dS into the products.  The TPU kernel multiplies them in f32
//   (pallas_attention.py:133-134, :191-198, :246-257); here each is rounded
//   once, to nearest even, to the storage type, in bfloat16 and in float16
//   alike.  The error that adds is a relative 2^-9 (bf16) or 2^-12 (f16)
//   per term of sums whose terms have random signs, well inside the one
//   ulp of the type at the largest magnitude (2^-7, 2^-10) that the
//   kernels are held to against their plain versions, and in float16 no
//   value of P (<= 1) or of the test's dS comes near the type's range;
//   tests/test_torch_flash_tc16.py holds this rounding to the JAX kernels
//   and the plain versions on the CPU, in both types, so no hi + lo split
//   is needed.  Accumulation stays f32;
// - copies.  Tiles stay 16-bit in shared memory, [64][DT + 8] (a row 16
//   bytes longer than its values, so each 8 x 8 ldmatrix reads 8 distinct
//   16-byte bank groups); they arrive by 16-byte cp.async copies where
//   D % 8 == 0 and the tensors are 16-byte aligned (element by element
//   otherwise), rows past L zero-filled by the copy, and the streamed tiles
//   are double-buffered at every width: one barrier a tile, no widening;
// - determinism: no atomics, a block writes its own rows, every sum runs
//   in a fixed order, so two launches are bitwise equal;
// - shared memory a block: B4 5 tiles (Q, two stages of K and V), B5 6
//   (Q, dO, two stages of K and V), B6 6 and two stages of 3 x 64
//   statistics, 64 * (DT + 8) * 2 bytes a tile: 25,600 / 30,720 / 32,256
//   bytes at DT = 32 (4 blocks an SM at <= 128 registers), 87,040 / 104,448
//   / 105,984 at DT = 128 (2 blocks).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// The build may compile this file once a storage type, in parallel, and
// link the three objects into one library: KERNEL_PART 0, 1 or 2 keeps the
// float32, bfloat16 or float16 launchers (and their kernels' instances)
// alone, part 0 the entry points common to all three.  Undefined (-1),
// one object holds everything.
#ifndef KERNEL_PART
#define KERNEL_PART -1
#endif
// whether this object serves storage s (0 float32, 1 bfloat16, 2 float16)
#define SERVES(s) (KERNEL_PART < 0 || KERNEL_PART == (s))

namespace {

constexpr int kTile = 64;        // rows of a tile, both axes
constexpr int kThreads = 256;    // 8 warps, 8 rows of the own tile each
constexpr float kNeg = -1e30f;   // the TPU kernels' "minus infinity"

struct Dims {
  int B, Lq, Lk, H, D, causal, q_off, k_off;
  float scale;
};

// element (b, row, h, d) of a contiguous [B, L, H, D] tensor
__device__ __forceinline__ int64_t elem(const Dims& p, int b, int L, int row,
                                        int h, int d) {
  return ((static_cast<int64_t>(b) * L + row) * p.H + h) * p.D + d;
}

__device__ __forceinline__ int64_t stat(const Dims& p, int b, int h,
                                        int row) {
  return (static_cast<int64_t>(b) * p.H + h) * p.Lq + row;
}

// the causal mask at global positions, with padded keys masked
__device__ __forceinline__ bool visible(const Dims& p, int q_loc,
                                        int k_loc) {
  return k_loc < p.Lk &&
         (!p.causal || static_cast<int64_t>(p.q_off) + q_loc >=
                           static_cast<int64_t>(p.k_off) + k_loc);
}

// ---------------------------------------------------------------------
// the register tiles, copies and lane places of the three kernels (see
// the header)
// ---------------------------------------------------------------------
constexpr int kScoreStride = kTile + 16;  // row stride of a p or ds tile
constexpr int kWarpRows = kTile / (kThreads / 32);  // own rows of a warp: 8
constexpr float kLog2e = 1.4426950408889634f;

// The tiles at head width DT: D padded to 8, 16, 32, 64 or 128.
template <int DT>
struct Layout {
  static constexpr int kStride = DT + 4;  // row stride of a tile, floats
  static constexpr int kTileFloats = kTile * kStride;
  static constexpr int kStages = DT <= 64 ? 2 : 1;
  static constexpr int kMinBlocks = DT <= 32 ? 2 : 1;
  // the accumulations: 16 lanes cover a warp's [8][DT] piece of an output,
  // a lane kRows rows x kCols groups of 4 columns
  static constexpr int kColLanes = DT / 4 < 16 ? DT / 4 : 16;
  static constexpr int kRowLanes = 16 / kColLanes;
  static constexpr int kRows = kWarpRows / kRowLanes;
  static constexpr int kCols = DT / 4 / kColLanes;
};

// kBytes (4 or 16) from global to shared memory, asynchronously; zeros
// when the source row is padding
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool real) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = real ? kBytes : 0;
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 2^x: one MUFU instruction (2 ulp)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the storage types: narrow rounding to nearest even
template <typename S>
__device__ __forceinline__ S narrow(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}

template <typename S>
constexpr bool kWide = sizeof(S) == 4;  // f32 storage: CUDA-core kernels

// rows [row0, row0 + 64) of one head of kTensors (1 or 2) tensors of one
// shape (the head starts `head` floats into each, rows are `row_stride`
// floats apart) into consecutive [64][kStride] shared tiles, `per_row`
// copies of kBytes a row; rows at or past L arrive as zeros.  One address
// serves both.
template <int kStride, int kBytes, int kTensors>
__device__ __forceinline__ void copy_rows(float* dst, const float* src_a,
                                          const float* src_b, int64_t head,
                                          int64_t row_stride, int row0,
                                          int L, int per_row) {
  for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
    const int rr = i / per_row, c = (i - rr * per_row) * (kBytes / 4);
    const bool real = row0 + rr < L;
    const int64_t from = head + (real ? (row0 + rr) * row_stride : 0) + c;
    cp_async<kBytes>(dst + rr * kStride + c, src_a + from, real);
    if (kTensors == 2)
      cp_async<kBytes>(dst + kTile * kStride + rr * kStride + c, src_b + from,
                       real);
  }
}

// the asynchronous tile load, for the two tensors that always travel
// together (K and V, Q and dO; kTensors 2) or for Q alone (B4; kTensors 1,
// src_b unused): 16-byte copies when `vec`
template <int DT, typename S, int kTensors = 2>
__device__ __forceinline__ void load_pair_async(float* dst, const S* src_a,
                                                const S* src_b, int b,
                                                int h, int row0, int L,
                                                const Dims& p, bool vec) {
  constexpr int kStride = Layout<DT>::kStride;
  const int64_t head = elem(p, b, L, 0, h, 0);
  const int64_t row_stride = static_cast<int64_t>(p.H) * p.D;
  if (vec && p.D == DT) {  // the division by a constant folds
    copy_rows<kStride, 16, kTensors>(dst, src_a, src_b, head, row_stride,
                                     row0, L, DT / 4);
  } else if (vec) {
    copy_rows<kStride, 16, kTensors>(dst, src_a, src_b, head, row_stride,
                                     row0, L, p.D / 4);
  } else {
    copy_rows<kStride, 4, kTensors>(dst, src_a, src_b, head, row_stride,
                                    row0, L, p.D);
  }
}

// lse, delta and glse of query rows [row0, row0 + 64) into dst[3][64]
__device__ __forceinline__ void load_stats_async(float* dst, const float* lse,
                                                 const float* delta,
                                                 const float* glse, int b,
                                                 int h, int row0,
                                                 const Dims& p) {
  if (threadIdx.x >= 3 * kTile) return;
  const int which = threadIdx.x / kTile, row = row0 + threadIdx.x % kTile;
  const bool real = row < p.Lq;
  const float* src = which == 0 ? lse : which == 1 ? delta : glse;
  cp_async<4>(dst + threadIdx.x, src + (real ? stat(p, b, h, row) : 0), real);
}

// zero the columns at or past D of `tiles` consecutive shared tiles: no
// copy writes them and the products run over all DT columns
template <int DT>
__device__ __forceinline__ void zero_pad_columns(float* tiles_base, int tiles,
                                                 int D) {
  const int extra = DT - D;
  for (int i = threadIdx.x; i < tiles * kTile * extra; i += kThreads) {
    const int row = i / extra;
    tiles_base[row * Layout<DT>::kStride + D + (i - row * extra)] = 0.0f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A thread's place in the two 64 x 64 score products.  Warp w owns rows
// 8w .. 8w + 7 of the block's own tile against all 64 rows of the streamed
// tile; a thread owns the 4 x 4 block of own rows `own + 2x` and streamed
// rows `streamed + 16y`.  The card serves a 16-byte shared load one quarter
// warp at a time, at about 2.5 clocks when the quarter's 8 lanes touch 64
// bytes or fewer and 3.7 otherwise: a quarter warp covers 2 own rows and 4
// streamed rows.
struct Place {
  int own, streamed;
  __device__ Place() {
    const int lane = threadIdx.x & 31;
    own = kWarpRows * (threadIdx.x >> 5) + ((lane >> 2) & 1);
    streamed = (lane & 3) | ((lane >> 3) << 2);
  }
};

// s[x][y] += sum over d of A[2 x][d] * B[16 y][d]: A and B point at the
// thread's first row of two [64][DT + 4] shared tiles
template <int DT>
__device__ __forceinline__ void tile_product(float (&s)[4][4], const float* A,
                                             const float* B) {
  constexpr int kStride = Layout<DT>::kStride;
#pragma unroll 8
  for (int d = 0; d < DT; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      a[x] = ld4(A + 2 * x * kStride + d);
      b[x] = ld4(B + 16 * x * kStride + d);
    }
    // one d at a time over all 16 sums: neighbouring FMAs are independent
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) s[x][y] = fmaf(a[x].x, b[y].x, s[x][y]);
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) s[x][y] = fmaf(a[x].y, b[y].y, s[x][y]);
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) s[x][y] = fmaf(a[x].z, b[y].z, s[x][y]);
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) s[x][y] = fmaf(a[x].w, b[y].w, s[x][y]);
  }
}

// A lane's place in an accumulation.  The p and ds rows a warp wrote are
// the rows it sums over, so only the warp synchronises between the two.
// Each half of the warp (16 lanes) covers the warp's [8][DT] piece of an
// output: lane rows `row + kRowLanes i`, columns `col + 4 kColLanes j`
// .. + 3.  At DT = 32 a quarter warp covers 2 rows x 4 column groups.
template <int DT>
struct Owned {
  int half, row, col;
  __device__ Owned() {
    using T = Layout<DT>;
    const int u = threadIdx.x & 15;
    half = (threadIdx.x >> 4) & 1;
    const int cg = T::kColLanes == 8 ? (u & 3) | ((u >> 1) & 4)
                                     : u % T::kColLanes;
    const int rg = T::kColLanes == 8 ? (u >> 2) & 1 : u / T::kColLanes;
    row = kWarpRows * (threadIdx.x >> 5) + rg;
    col = 4 * cg;
  }
};

// acc[i][j] += sum over c in [c0, c1) of W[kRowLanes i][c] *
// X[c][4 kColLanes j .. + 3]: W points at the lane's first row of a
// [64][80] p or ds tile, X at its first column of row 0 of a [64][DT + 4]
// tile
template <int DT>
__device__ __forceinline__ void accumulate(
    float4 (&acc)[Layout<DT>::kRows][Layout<DT>::kCols], const float* W,
    const float* X, int c0, int c1) {
  using T = Layout<DT>;
#pragma unroll 4
  for (int c = c0; c < c1; c += 4) {
    float w[T::kRows][4];
#pragma unroll
    for (int i = 0; i < T::kRows; ++i) {
      const float4 wi = ld4(W + i * T::kRowLanes * kScoreStride + c);
      w[i][0] = wi.x, w[i][1] = wi.y, w[i][2] = wi.z, w[i][3] = wi.w;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int j = 0; j < T::kCols; ++j) {
        const float4 x = ld4(X + (c + cc) * T::kStride + 4 * T::kColLanes * j);
#pragma unroll
        for (int i = 0; i < T::kRows; ++i) {
          acc[i][j].x = fmaf(w[i][cc], x.x, acc[i][j].x);
          acc[i][j].y = fmaf(w[i][cc], x.y, acc[i][j].y);
          acc[i][j].z = fmaf(w[i][cc], x.z, acc[i][j].z);
          acc[i][j].w = fmaf(w[i][cc], x.w, acc[i][j].w);
        }
      }
    }
  }
}

// the lane's piece of a [64][DT] result into rows [row0, row0 + 64) of head
// h of a [B, L, H, D] tensor
template <int DT, typename S>
__device__ __forceinline__ void store_rows(
    S* dst, const float4 (&acc)[Layout<DT>::kRows][Layout<DT>::kCols],
    const Owned<DT>& own, int b, int h, int row0, int L, const Dims& p,
    bool vec) {
  using T = Layout<DT>;
#pragma unroll
  for (int i = 0; i < T::kRows; ++i) {
#pragma unroll
    for (int j = 0; j < T::kCols; ++j) {
      const int row = row0 + own.row + i * T::kRowLanes;
      const int col = own.col + 4 * T::kColLanes * j;
      if (row >= L || col >= p.D) continue;
      S* o = dst + elem(p, b, L, row, h, col);
      const float a[4] = {acc[i][j].x, acc[i][j].y, acc[i][j].z,
                          acc[i][j].w};
      if (vec) {
        *reinterpret_cast<float4*>(o) = acc[i][j];
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < p.D) o[c] = a[c];
      }
    }
  }
}

// One 64 x 64 tile pair's p and ds / scale = p * (dp - delta + glse),
// [own][streamed], into the warp's rows of Ps (B6 only; B5 passes nullptr)
// and Ss: the scale multiplies the sums of ds once, at the end.  A and Ad
// are the own tile of the scores and of dp (B5: Q, dO; B6: K, V), B and Bd
// the streamed one (B5: K, V; B6: Q, dO), all at the thread's first row.
// `stats` is [3][64] lse, delta, glse of the query rows, which are the own
// rows in B5 (kQueryOwn) and the streamed rows in B6; it points at the
// thread's first query.  q_first and k_first are the thread's first local
// positions.
template <int DT, bool kMasked, bool kQueryOwn>
__device__ __forceinline__ void scores(const float* A, const float* Ad,
                                       const float* B, const float* Bd,
                                       float* Ps, float* Ss,
                                       const float* stats, const Dims& p,
                                       int q_first, int k_first) {
  float s[4][4] = {}, dp[4][4] = {};
  tile_product<DT>(s, A, B);
  tile_product<DT>(dp, Ad, Bd);
  const float scale2 = p.scale * kLog2e;
  constexpr int kQueryStep = kQueryOwn ? 2 : 16;
  constexpr int kKeyStep = kQueryOwn ? 16 : 2;
#pragma unroll
  for (int iq = 0; iq < 4; ++iq) {
    const float lse2 = stats[kQueryStep * iq] * kLog2e;
    // d lse / d s = p: the lse cotangent adds straight into ds
    const float shift = stats[2 * kTile + kQueryStep * iq] -
                        stats[kTile + kQueryStep * iq];  // glse - delta
    const int q_loc = q_first + kQueryStep * iq;
#pragma unroll
    for (int ik = 0; ik < 4; ++ik) {
      const int x = kQueryOwn ? iq : ik, y = kQueryOwn ? ik : iq;
      float pr = fast_exp2(fmaf(s[x][y], scale2, -lse2));
      // padded query rows carry no lse: mask them too
      if (kMasked &&
          !(q_loc < p.Lq && visible(p, q_loc, k_first + kKeyStep * ik)))
        pr = 0.0f;
      if (!kQueryOwn) Ps[2 * x * kScoreStride + 16 * y] = pr;
      Ss[2 * x * kScoreStride + 16 * y] = pr * (dp[x][y] + shift);
    }
  }
}

// query tile q0's key tiles: pallas_attention.py:139 and :201, key tile kj
// adds nothing unless k_off + 64 kj <= q_off + q0 + 63, so tiles 0 .. n - 1
// are visited
__device__ __forceinline__ int key_tiles(const Dims& p, int q0) {
  int n = (p.Lk + kTile - 1) / kTile;
  if (p.causal) {
    const int64_t last = static_cast<int64_t>(p.q_off) + q0 + kTile - 1 -
                         static_cast<int64_t>(p.k_off);
    if (last < 0) n = 0;
    else if (last / kTile + 1 < n) n = static_cast<int>(last / kTile) + 1;
  }
  return n;
}

// the mask can touch the tile of queries q0.. and keys k0..: it holds
// padded keys, or its last key lies past its first query
__device__ __forceinline__ bool key_edge(const Dims& p, int q0, int k0) {
  return k0 + kTile > p.Lk ||
         (p.causal && static_cast<int64_t>(p.k_off) + k0 + kTile - 1 >
                          static_cast<int64_t>(p.q_off) + q0);
}

// the lanes of a warp that hold streamed rows 16y (lanes 0 and 4): they
// hand each own row's statistics to the lanes that own its output
__device__ __forceinline__ bool row_writer() {
  return (threadIdx.x & 0x1b) == 0;
}

// ---------------------------------------------------------------------
// B4: forward
// ---------------------------------------------------------------------
// One 64 x 64 tile of the online softmax in the log2 domain: s[x][y] are
// the raw scores of own row `q_first + 2x` against key `k_first + 16y`; m2
// and l are the thread's 4 rows' running max (times scale * log2 e) and its
// own partial row sums; p goes to P [query][key] at the thread's first
// place and each row's corr to slot[2x] (the row writers only).
template <bool kMasked>
__device__ __forceinline__ void online_softmax(float (&s)[4][4],
                                               float (&m2)[4], float (&l)[4],
                                               float* P, float* slot,
                                               const Dims& p, float scale2,
                                               int q_first, int k_first) {
  const bool writer = row_writer();
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    unsigned seen = 0xfu;
    float mt = kNeg;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      if (kMasked && !visible(p, q_first + 2 * x, k_first + 16 * y)) {
        s[x][y] = kNeg;
        seen &= ~(1u << y);
      }
      mt = fmaxf(mt, s[x][y]);
    }
    // the 16 lanes that share the row differ in lane bits 0, 1, 3 and 4
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
    const float m_new = fmaxf(m2[x], mt * scale2);
    const float corr = fast_exp2(m2[x] - m_new);
    m2[x] = m_new;
    float sum = 0.0f;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      float pr = fast_exp2(fmaf(s[x][y], scale2, -m_new));
      // masked entries are zeroed explicitly: in a row that has seen no
      // visible key s * scale2 == m2 and 2^0 would resurrect them
      if (kMasked && !((seen >> y) & 1u)) pr = 0.0f;
      P[2 * x * kScoreStride + 16 * y] = pr;
      sum += pr;
    }
    l[x] = fmaf(l[x], corr, sum);
    if (writer) slot[2 * x] = corr;
  }
}

template <int DT, typename S>
__global__ void __launch_bounds__(kThreads, Layout<DT>::kMinBlocks)
flash_fwd_kernel(const S* __restrict__ q, const S* __restrict__ k,
                 const S* __restrict__ v, S* __restrict__ out,
                 float* __restrict__ lse, Dims p, int vec) {
  static_assert(kWide<S>, "16-bit B4 is flash_fwd_tc_kernel");
  using T = Layout<DT>;
  extern __shared__ float4 smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* KVs = Qs + T::kTileFloats;                   // a stage: K, then V
  float* Ps = KVs + T::kStages * 2 * T::kTileFloats;  // p [query][key]
  float* slot = Ps + kTile * kScoreStride;            // a value a query row

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heavy tiles first
  const int n = key_tiles(p, q0);

  if (p.D < DT) zero_pad_columns<DT>(Qs, 1 + 2 * T::kStages, p.D);
  if (n > 0) {
    load_pair_async<DT, S, 1>(Qs, q, nullptr, b, h, q0, p.Lq, p, vec);
    load_pair_async<DT>(KVs, k, v, b, h, 0, p.Lk, p, vec);
    cp_async_commit();
  }
  const Place at;
  // out += P V: each half of a warp sums over 32 of the tile's 64 keys
  const Owned<DT> own;
  const float scale2 = p.scale * kLog2e;
  float m2[4], l[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) m2[x] = kNeg, l[x] = 0.0f;
  float4 acc[T::kRows][T::kCols];
#pragma unroll
  for (int i = 0; i < T::kRows; ++i)
#pragma unroll
    for (int j = 0; j < T::kCols; ++j) acc[i][j] = make_float4(0, 0, 0, 0);

  for (int kj = 0; kj < n; ++kj) {
    const int stage = T::kStages == 2 ? kj & 1 : 0;
    float* Ks = KVs + stage * 2 * T::kTileFloats;
    float* Vs = Ks + T::kTileFloats;
    cp_async_wait_all();
    __syncthreads();  // tile kj is here; tile kj - 1's readers are done
    if (T::kStages == 2 && kj + 1 < n) {
      load_pair_async<DT>(KVs + (stage ^ 1) * 2 * T::kTileFloats, k, v, b, h,
                          (kj + 1) * kTile, p.Lk, p, vec);
      cp_async_commit();
    }
    const int k0 = kj * kTile;
    float s[4][4] = {};
    tile_product<DT>(s, Qs + at.own * T::kStride,
                     Ks + at.streamed * T::kStride);
    float* Pt = Ps + at.own * kScoreStride + at.streamed;
    if (key_edge(p, q0, k0))
      online_softmax<true>(s, m2, l, Pt, slot + at.own, p, scale2,
                           q0 + at.own, k0 + at.streamed);
    else
      online_softmax<false>(s, m2, l, Pt, slot + at.own, p, scale2,
                            q0 + at.own, k0 + at.streamed);
    __syncwarp();  // the warp reads only the p rows and corr it wrote
#pragma unroll
    for (int i = 0; i < T::kRows; ++i) {
      const float c = slot[own.row + i * T::kRowLanes];
#pragma unroll
      for (int j = 0; j < T::kCols; ++j) {
        float4& a = acc[i][j];
        a.x *= c, a.y *= c, a.z *= c, a.w *= c;
      }
    }
    accumulate<DT>(acc, Ps + own.row * kScoreStride, Vs + own.col,
                   32 * own.half, 32 * own.half + 32);
    if (T::kStages == 1 && kj + 1 < n) {
      __syncthreads();
      load_pair_async<DT>(Ks, k, v, b, h, (kj + 1) * kTile, p.Lk, p, vec);
      cp_async_commit();
    }
  }
  // each row's sum over its 16 lanes (a butterfly: every lane gets the same
  // bits), and the two halves' outputs meet in the lower half, in a fixed
  // order
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 8);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 16);
  }
#pragma unroll
  for (int i = 0; i < T::kRows; ++i) {
#pragma unroll
    for (int j = 0; j < T::kCols; ++j) {
      float4& a = acc[i][j];
      a.x += __shfl_down_sync(0xffffffffu, a.x, 16);
      a.y += __shfl_down_sync(0xffffffffu, a.y, 16);
      a.z += __shfl_down_sync(0xffffffffu, a.z, 16);
      a.w += __shfl_down_sync(0xffffffffu, a.w, 16);
    }
  }
  __syncwarp();  // the last tile's corr is read
  if (row_writer()) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float lc = fmaxf(l[x], 1e-30f);
      slot[at.own + 2 * x] = lc;
      const int row = q0 + at.own + 2 * x;
      if (row < p.Lq)
        lse[stat(p, b, h, row)] =
            l[x] > 0.0f ? m2[x] * 0.6931471805599453f + logf(lc) : kNeg;
    }
  }
  __syncwarp();
  if (own.half == 0) {
#pragma unroll
    for (int i = 0; i < T::kRows; ++i) {
      const float lc = slot[own.row + i * T::kRowLanes];
#pragma unroll
      for (int j = 0; j < T::kCols; ++j) {
        float4& a = acc[i][j];
        a.x /= lc, a.y /= lc, a.z /= lc, a.w /= lc;
      }
    }
    store_rows<DT, S>(out, acc, own, b, h, q0, p.Lq, p, vec);
  }
}

// ---------------------------------------------------------------------
// B5: dq
// ---------------------------------------------------------------------
template <int DT, typename S>
__global__ void __launch_bounds__(kThreads, Layout<DT>::kMinBlocks)
flash_dq_kernel(const S* __restrict__ q, const S* __restrict__ k,
                const S* __restrict__ v, const S* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const float* __restrict__ glse, S* __restrict__ dq,
                Dims p, int vec) {
  static_assert(kWide<S>, "16-bit B5 is flash_dq_tc_kernel");
  using T = Layout<DT>;
  extern __shared__ float4 smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Gs = Qs + T::kTileFloats;                     // dO
  float* KVs = Gs + T::kTileFloats;                    // a stage: K, then V
  float* Ss = KVs + T::kStages * 2 * T::kTileFloats;   // ds [query][key]
  float* stats = Ss + kTile * kScoreStride;            // lse, delta, glse

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heavy tiles first
  const int n = key_tiles(p, q0);

  if (p.D < DT) zero_pad_columns<DT>(Qs, 2 + 2 * T::kStages, p.D);
  if (n > 0) {
    load_pair_async<DT>(Qs, q, dout, b, h, q0, p.Lq, p, vec);
    load_stats_async(stats, lse, delta, glse, b, h, q0, p);
    load_pair_async<DT>(KVs, k, v, b, h, 0, p.Lk, p, vec);
    cp_async_commit();
  }
  const Place at;
  // dq += dS K: each half of a warp sums over 32 of the tile's 64 keys
  const Owned<DT> own;
  float4 acc[T::kRows][T::kCols];
#pragma unroll
  for (int i = 0; i < T::kRows; ++i)
#pragma unroll
    for (int j = 0; j < T::kCols; ++j) acc[i][j] = make_float4(0, 0, 0, 0);

  for (int kj = 0; kj < n; ++kj) {
    const int stage = T::kStages == 2 ? kj & 1 : 0;
    float* Ks = KVs + stage * 2 * T::kTileFloats;
    float* Vs = Ks + T::kTileFloats;
    cp_async_wait_all();
    __syncthreads();  // tile kj is here; tile kj - 1's readers are done
    if (T::kStages == 2 && kj + 1 < n) {
      load_pair_async<DT>(KVs + (stage ^ 1) * 2 * T::kTileFloats, k, v, b, h,
                          (kj + 1) * kTile, p.Lk, p, vec);
      cp_async_commit();
    }
    const int k0 = kj * kTile;
    const bool edge = key_edge(p, q0, k0);
    const float* Qt = Qs + at.own * T::kStride;
    const float* Gt = Gs + at.own * T::kStride;
    const float* Kt = Ks + at.streamed * T::kStride;
    const float* Vt = Vs + at.streamed * T::kStride;
    float* St = Ss + at.own * kScoreStride + at.streamed;
    if (edge)
      scores<DT, true, true>(Qt, Gt, Kt, Vt, nullptr, St, stats + at.own, p,
                             q0 + at.own, k0 + at.streamed);
    else
      scores<DT, false, true>(Qt, Gt, Kt, Vt, nullptr, St, stats + at.own, p,
                              q0 + at.own, k0 + at.streamed);
    __syncwarp();  // the warp reads only the ds rows it wrote
    accumulate<DT>(acc, Ss + own.row * kScoreStride, Ks + own.col,
                   32 * own.half, 32 * own.half + 32);
    if (T::kStages == 1 && kj + 1 < n) {
      __syncthreads();
      load_pair_async<DT>(Ks, k, v, b, h, (kj + 1) * kTile, p.Lk, p, vec);
      cp_async_commit();
    }
  }
  // the two halves' sums meet in the lower half, in a fixed order, and take
  // the scale that ds left out
#pragma unroll
  for (int i = 0; i < T::kRows; ++i) {
#pragma unroll
    for (int j = 0; j < T::kCols; ++j) {
      float4& a = acc[i][j];
      a.x = (a.x + __shfl_down_sync(0xffffffffu, a.x, 16)) * p.scale;
      a.y = (a.y + __shfl_down_sync(0xffffffffu, a.y, 16)) * p.scale;
      a.z = (a.z + __shfl_down_sync(0xffffffffu, a.z, 16)) * p.scale;
      a.w = (a.w + __shfl_down_sync(0xffffffffu, a.w, 16)) * p.scale;
    }
  }
  if (own.half == 0) store_rows<DT, S>(dq, acc, own, b, h, q0, p.Lq, p, vec);
}

// ---------------------------------------------------------------------
// B6: dk, dv
// ---------------------------------------------------------------------
template <int DT, typename S>
__global__ void __launch_bounds__(kThreads, Layout<DT>::kMinBlocks)
flash_dkv_kernel(const S* __restrict__ q, const S* __restrict__ k,
                 const S* __restrict__ v, const S* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ glse, S* __restrict__ dk,
                 S* __restrict__ dv, Dims p, int vec) {
  static_assert(kWide<S>, "16-bit B6 is flash_dkv_tc_kernel");
  using T = Layout<DT>;
  extern __shared__ float4 smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + T::kTileFloats;
  float* QGs = Vs + T::kTileFloats;                    // a stage: Q, then dO
  float* Ps = QGs + T::kStages * 2 * T::kTileFloats;   // p [key][query]
  float* Ss = Ps + kTile * kScoreStride;               // ds [key][query]
  float* stats = Ss + kTile * kScoreStride;  // a stage: lse, delta, glse

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int k0 = blockIdx.y * kTile;  // key tile 0 sees the most query tiles
  // pallas_attention.py:260: query tile qj sees nothing unless
  // q_off + 64 (qj + 1) - 1 >= k_off + k0, so tiles first .. nq - 1 are
  // visited
  const int nq = (p.Lq + kTile - 1) / kTile;
  int first = 0;
  if (p.causal) {
    const int64_t need = static_cast<int64_t>(p.k_off) + k0 + 1 -
                         static_cast<int64_t>(p.q_off);
    if (need > 0) {
      const int64_t f = (need + kTile - 1) / kTile - 1;
      first = f < nq ? static_cast<int>(f) : nq;
    }
  }

  // tile qj's Q, dO and row statistics into `stage`
  auto load_stage = [&](int stage, int qj) {
    load_pair_async<DT>(QGs + stage * 2 * T::kTileFloats, q, dout, b, h,
                        qj * kTile, p.Lq, p, vec);
    load_stats_async(stats + stage * 3 * kTile, lse, delta, glse, b, h,
                     qj * kTile, p);
  };

  if (p.D < DT) zero_pad_columns<DT>(Ks, 2 + 2 * T::kStages, p.D);
  if (first < nq) {
    load_pair_async<DT>(Ks, k, v, b, h, k0, p.Lk, p, vec);
    load_stage(0, first);
    cp_async_commit();
  }
  const Place at;
  // one half of a warp sums dv += P^T dO, the other dk += dS^T Q
  const Owned<DT> own;
  const float* W = (own.half == 0 ? Ps : Ss) + own.row * kScoreStride;
  float4 acc[T::kRows][T::kCols];
#pragma unroll
  for (int i = 0; i < T::kRows; ++i)
#pragma unroll
    for (int j = 0; j < T::kCols; ++j) acc[i][j] = make_float4(0, 0, 0, 0);

  for (int qj = first; qj < nq; ++qj) {
    const int stage = T::kStages == 2 ? (qj - first) & 1 : 0;
    float* Qs = QGs + stage * 2 * T::kTileFloats;
    float* Gs = Qs + T::kTileFloats;
    cp_async_wait_all();
    __syncthreads();  // tile qj is here; tile qj - 1's readers are done
    if (T::kStages == 2 && qj + 1 < nq) {
      load_stage(stage ^ 1, qj + 1);
      cp_async_commit();
    }
    const int q0 = qj * kTile;
    // the mask can touch this tile: it holds padded keys or padded
    // queries, or its last key lies past its first query
    const bool edge =
        k0 + kTile > p.Lk || q0 + kTile > p.Lq ||
        (p.causal && static_cast<int64_t>(p.k_off) + k0 + kTile - 1 >
                         static_cast<int64_t>(p.q_off) + q0);
    const float* Kt = Ks + at.own * T::kStride;
    const float* Vt = Vs + at.own * T::kStride;
    const float* Qt = Qs + at.streamed * T::kStride;
    const float* Gt = Gs + at.streamed * T::kStride;
    const int place = at.own * kScoreStride + at.streamed;
    const float* st = stats + stage * 3 * kTile + at.streamed;
    if (edge)
      scores<DT, true, false>(Kt, Vt, Qt, Gt, Ps + place, Ss + place, st, p,
                              q0 + at.streamed, k0 + at.own);
    else
      scores<DT, false, false>(Kt, Vt, Qt, Gt, Ps + place, Ss + place, st, p,
                               q0 + at.streamed, k0 + at.own);
    __syncwarp();  // the warp reads only the p and ds rows it wrote
    accumulate<DT>(acc, W, (own.half == 0 ? Gs : Qs) + own.col, 0, kTile);
    if (T::kStages == 1 && qj + 1 < nq) {
      __syncthreads();
      load_stage(0, qj + 1);
      cp_async_commit();
    }
  }
  if (own.half == 1) {  // dk takes the scale that ds left out
#pragma unroll
    for (int i = 0; i < T::kRows; ++i)
#pragma unroll
      for (int j = 0; j < T::kCols; ++j) {
        float4& a = acc[i][j];
        a.x *= p.scale, a.y *= p.scale, a.z *= p.scale, a.w *= p.scale;
      }
  }
  store_rows<DT, S>(own.half == 0 ? dv : dk, acc, own, b, h, k0, p.Lk, p,
                    vec);
}

// ---------------------------------------------------------------------
// B4, B5 and B6 in 16-bit storage: the tensor-core arms (see the header)
// ---------------------------------------------------------------------
// 4 warps a block, 16 rows of the block's 64 each
constexpr int kTcThreads = 128;
// B6's streamed queries a pass: S^T, dP^T and the sums of a warp cover
// 16 keys x 32 queries at a time, which keeps the D = 32 instance under
// 128 registers
constexpr int kTcChunk = 32;

// 16-bit tiles [64][DT + 8] at head width DT (D padded to 16, 32, 64 or
// 128): a row is 16 bytes longer than its DT values, so the 8 rows of an
// ldmatrix 8 x 8 matrix start in 8 distinct 16-byte groups of the 32
// banks; columns at or past D are zeros
template <int DT>
struct TcLayout {
  static constexpr int kStride = DT + 8;  // elements
  static constexpr int kTileElems = kTile * kStride;
  // blocks an SM the register budget is set for: a B4 warp holds
  // 16 x (64 + DT) sums, a B5 warp 16 x (2 kDqChunk + DT) and its Q and dO
  // rows, a B6 warp 16 x (32 + 2 DT)
  static constexpr int kFwdBlocks = DT <= 64 ? 4 : 2;
  static constexpr int kDqBlocks = DT <= 64 ? 4 : 2;
  static constexpr int kDkvBlocks = DT <= 32 ? 4 : 2;
  // B5's streamed keys a pass: S, dP and dS of a warp cover 16 queries x
  // 64 keys at a time up to DT = 32, and 32 keys above, where 64 would
  // spill at 128 registers
  static constexpr int kDqChunk = DT <= 32 ? 64 : 32;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool real) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(real ? 16 : 0)
               : "memory");
}

// four 8 x 8 matrices of 16-bit values from shared memory; lane i gives
// the address of row i % 8 of matrix i / 8 and gets, of matrix j, the
// elements (lane / 4, 2 (lane % 4) .. + 1) in r[j], or with .trans those
// of the transposed matrix
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += A B on the tensor cores: A 16 x 16 (row-major fragment a), B 16 x 8
// (fragment b0, b1), c 16 x 8 float32 (rows lane / 4 and + 8, columns
// 2 (lane % 4) .. + 1)
template <typename S>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 values rounded to nearest even into one 16-bit pair, lo in
// the low half
template <typename S>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of a 16 x 16 piece from two neighbouring 16 x 8
// accumulators (columns 0-7 and 8-15), rounded to the storage type
template <typename S>
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&lo)[4],
                                     const float (&hi)[4]) {
  a[0] = pack2<S>(lo[0], lo[1]);
  a[1] = pack2<S>(lo[2], lo[3]);
  a[2] = pack2<S>(hi[0], hi[1]);
  a[3] = pack2<S>(hi[2], hi[3]);
}

// 16-byte copies of `per_row` pieces a row (8 values each) into a
// [64][DT + 8] tile, rows at or past L zero-filled by the copy
template <int DT, typename S>
__device__ __forceinline__ void tc_copy_rows(S* dst, const S* src,
                                             int64_t row_stride, int row0,
                                             int L, int per_row) {
  for (int i = threadIdx.x; i < kTile * per_row; i += kTcThreads) {
    const int rr = i / per_row, c = (i - rr * per_row) * 8;
    const bool real = row0 + rr < L;
    cp_async16(dst + rr * TcLayout<DT>::kStride + c,
               src + (real ? (row0 + rr) * row_stride : 0) + c, real);
  }
}

// rows [row0, row0 + 64) of one head of a [B, L, H, D] tensor into a
// [64][DT + 8] tile: 16-byte cp.async copies when `vec`; otherwise element
// by element, here and now.  Columns at or past D are not written.
template <int DT, typename S>
__device__ __forceinline__ void tc_load_tile(S* dst, const S* src, int b,
                                             int h, int row0, int L,
                                             const Dims& p, bool vec) {
  const S* head = src + elem(p, b, L, 0, h, 0);
  const int64_t row_stride = static_cast<int64_t>(p.H) * p.D;
  if (vec && p.D == DT) {  // the division by a constant folds
    tc_copy_rows<DT>(dst, head, row_stride, row0, L, DT / 8);
  } else if (vec) {
    tc_copy_rows<DT>(dst, head, row_stride, row0, L, p.D / 8);
  } else {
    for (int i = threadIdx.x; i < kTile * p.D; i += kTcThreads) {
      const int rr = i / p.D, c = i - rr * p.D;
      dst[rr * TcLayout<DT>::kStride + c] =
          row0 + rr < L ? head[(row0 + rr) * row_stride + c]
                        : narrow<S>(0.0f);
    }
  }
}

// zeros in the columns at or past D of `tiles` consecutive tiles: no copy
// writes them and the products run over all DT columns
template <int DT, typename S>
__device__ __forceinline__ void tc_zero_pad(S* tiles_base, int tiles, int D) {
  const int extra = DT - D;
  for (int i = threadIdx.x; i < tiles * kTile * extra; i += kTcThreads) {
    const int row = i / extra;
    tiles_base[row * TcLayout<DT>::kStride + D + (i - row * extra)] =
        narrow<S>(0.0f);
  }
}

// lse, delta and glse of query rows [row0, row0 + 64) into dst[3][64]
__device__ __forceinline__ void tc_load_stats(float* dst, const float* lse,
                                              const float* delta,
                                              const float* glse, int b,
                                              int h, int row0,
                                              const Dims& p) {
  for (int i = threadIdx.x; i < 3 * kTile; i += kTcThreads) {
    const int which = i / kTile, row = row0 + i % kTile;
    const bool real = row < p.Lq;
    const float* src = which == 0 ? lse : which == 1 ? delta : glse;
    cp_async<4>(dst + i, src + (real ? stat(p, b, h, row) : 0), real);
  }
}

// A lane's place: its ldmatrix address in a 16 x 16 piece, (a_row, a_col)
// for an A operand stored [row][k] and for a B operand stored [k][n] (by
// .trans), (b_row, b_col) for a pair of B operands (n 0-7 and 8-15) stored
// [n][k]; and its accumulator rows g, g + 8 and columns 2 t, 2 t + 1
struct TcLane {
  int a_row, a_col, b_row, b_col, g, t;
  __device__ TcLane() {
    const int lane = threadIdx.x & 31;
    a_row = lane & 15;
    a_col = (lane >> 4) * 8;
    b_row = (lane & 7) + ((lane >> 4) << 3);
    b_col = ((lane >> 3) & 1) * 8;
    g = lane >> 2;
    t = lane & 3;
  }
};

// acc[n] (16 x kN * 8, float32) += A B over k in [0, DT): A the 16 rows of
// a tile at `a` (the lane's ldmatrix address), B the rows n0 .. n0 + 8 kN
// of a tile `b` stored [n][k] (the lane's ldmatrix address of row n0)
template <int DT, int kN, typename S>
__device__ __forceinline__ void tc_product_nk(float (&acc)[kN][4], const S* a,
                                              const S* b) {
  constexpr int kStride = TcLayout<DT>::kStride;
#pragma unroll
  for (int kk = 0; kk < DT; kk += 16) {
    uint32_t fa[4];
    ldsm_x4(fa, a + kk);
#pragma unroll
    for (int np = 0; np < kN / 2; ++np) {
      uint32_t fb[4];
      ldsm_x4(fb, b + np * 16 * kStride + kk);
      mma16816<S>(acc[2 * np], fa, fb[0], fb[1]);
      mma16816<S>(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc[DT / 8] (16 x DT, float32) += W X: W the 16 x 8 kN accumulators
// `w`, rounded to the storage type, X the kN * 8 rows of a tile stored
// [k][n] (the lane's .trans ldmatrix address of its first row)
template <int DT, int kN, typename S>
__device__ __forceinline__ void tc_product_kn(float (&acc)[DT / 8][4],
                                              const float (&w)[kN][4],
                                              const S* x) {
  constexpr int kStride = TcLayout<DT>::kStride;
#pragma unroll
  for (int kk = 0; kk < kN / 2; ++kk) {
    uint32_t fa[4];
    to_a<S>(fa, w[2 * kk], w[2 * kk + 1]);
#pragma unroll
    for (int dp = 0; dp < DT / 16; ++dp) {
      uint32_t fb[4];
      ldsm_x4_t(fb, x + kk * 16 * kStride + dp * 16);
      mma16816<S>(acc[2 * dp], fa, fb[0], fb[1]);
      mma16816<S>(acc[2 * dp + 1], fa, fb[2], fb[3]);
    }
  }
}

// One 16 x 64 tile of B4's online softmax in the log2 domain, on the
// accumulator layout: the lane holds query rows `row` and `row + 8`
// (s[.][0..1] and s[.][2..3]) against keys `key + 8 n` and + 1.  Scores
// become p = 2^(s * scale * log2 e - m2) in place, masked ones exactly 0;
// m2 and the lane's partial row sums l move on; the output rows take corr.
template <bool kMasked, int kDn>
__device__ __forceinline__ void tc_online_softmax(float (&s)[kTile / 8][4],
                                                  float (&o)[kDn][4],
                                                  float (&m2)[2],
                                                  float (&l)[2],
                                                  const Dims& p,
                                                  float scale2, int row,
                                                  int key) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mt = kNeg;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[n][2 * r + c];
        // kNeg marks a masked score below: no real score is -1e30
        if (kMasked && !visible(p, row + 8 * r, key + 8 * n + c)) x = kNeg;
        mt = fmaxf(mt, x);
      }
    // the 4 lanes of a quad share the row
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m2[r], mt * scale2);
    const float corr = fast_exp2(m2[r] - m_new);
    m2[r] = m_new;
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[n][2 * r + c];
        // masked entries are zeroed explicitly: in a row that has seen no
        // visible key s * scale2 == m2 and 2^0 would resurrect them
        const float pr =
            kMasked && x == kNeg ? 0.0f : fast_exp2(fmaf(x, scale2, -m_new));
        x = pr;
        sum += pr;
      }
    l[r] = fmaf(l[r], corr, sum);
#pragma unroll
    for (int d = 0; d < kDn; ++d) {
      o[d][2 * r] *= corr;
      o[d][2 * r + 1] *= corr;
    }
  }
}

template <int DT, typename S>
__global__ void __launch_bounds__(kTcThreads, TcLayout<DT>::kFwdBlocks)
flash_fwd_tc_kernel(const S* __restrict__ q, const S* __restrict__ k,
                    const S* __restrict__ v, S* __restrict__ out,
                    float* __restrict__ lse, Dims p, int vec) {
  using T = TcLayout<DT>;
  constexpr int kN = kTile / 8;  // 8-key pieces of a tile
  constexpr int kDn = DT / 8;    // 8-column pieces of an output row
  extern __shared__ float4 smem[];
  S* Qs = reinterpret_cast<S*>(smem);
  S* KVs = Qs + T::kTileElems;  // a stage: K, then V

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heavy tiles first
  const int n = key_tiles(p, q0);
  const int warp = threadIdx.x >> 5;
  const TcLane ln;

  if (p.D < DT) tc_zero_pad<DT>(Qs, 5, p.D);
  if (n > 0) {
    tc_load_tile<DT>(Qs, q, b, h, q0, p.Lq, p, vec);
    tc_load_tile<DT>(KVs, k, b, h, 0, p.Lk, p, vec);
    tc_load_tile<DT>(KVs + T::kTileElems, v, b, h, 0, p.Lk, p, vec);
    cp_async_commit();
  }
  const S* Qa = Qs + (16 * warp + ln.a_row) * T::kStride + ln.a_col;
  const int row = q0 + 16 * warp + ln.g;  // the lane's rows: row, row + 8
  const float scale2 = p.scale * kLog2e;
  float o[kDn][4] = {};
  float m2[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};

  for (int kj = 0; kj < n; ++kj) {
    S* Ks = KVs + (kj & 1) * 2 * T::kTileElems;
    S* Vs = Ks + T::kTileElems;
    cp_async_wait_all();
    __syncthreads();  // tile kj is here; tile kj - 1's readers are done
    if (kj + 1 < n) {
      S* next = KVs + ((kj + 1) & 1) * 2 * T::kTileElems;
      tc_load_tile<DT>(next, k, b, h, (kj + 1) * kTile, p.Lk, p, vec);
      tc_load_tile<DT>(next + T::kTileElems, v, b, h, (kj + 1) * kTile,
                       p.Lk, p, vec);
      cp_async_commit();
    }
    const int k0 = kj * kTile;
    float s[kN][4] = {};
    tc_product_nk<DT, kN>(s, Qa, Ks + ln.b_row * T::kStride + ln.b_col);
    if (key_edge(p, q0, k0))
      tc_online_softmax<true>(s, o, m2, l, p, scale2, row, k0 + 2 * ln.t);
    else
      tc_online_softmax<false>(s, o, m2, l, p, scale2, row, k0 + 2 * ln.t);
    tc_product_kn<DT, kN>(o, s, Vs + ln.a_row * T::kStride + ln.a_col);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the quad's partial sums, a butterfly: every lane gets the same bits
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int rr = row + 8 * r;
    if (rr >= p.Lq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    if (ln.t == 0)
      lse[stat(p, b, h, rr)] =
          l[r] > 0.0f ? m2[r] * 0.6931471805599453f + logf(lc) : kNeg;
    S* o_row = out + elem(p, b, p.Lq, rr, h, 0);
#pragma unroll
    for (int d = 0; d < kDn; ++d) {
      const int col = 8 * d + 2 * ln.t;
      const float x0 = o[d][2 * r] / lc, x1 = o[d][2 * r + 1] / lc;
      if (vec) {
        if (col < p.D)
          *reinterpret_cast<uint32_t*>(o_row + col) = pack2<S>(x0, x1);
      } else {
        if (col < p.D) o_row[col] = narrow<S>(x0);
        if (col + 1 < p.D) o_row[col + 1] = narrow<S>(x1);
      }
    }
  }
}

// acc[n] (16 x kN * 8, float32) += A B over k in [0, DT): A the 16 x DT
// fragments `fa` the warp holds, B as in tc_product_nk
template <int DT, int kN, typename S>
__device__ __forceinline__ void tc_product_held(
    float (&acc)[kN][4], const uint32_t (&fa)[DT / 16][4], const S* b) {
#pragma unroll
  for (int kk = 0; kk < DT / 16; ++kk)
#pragma unroll
    for (int np = 0; np < kN / 2; ++np) {
      uint32_t fb[4];
      ldsm_x4(fb, b + np * 16 * TcLayout<DT>::kStride + kk * 16);
      mma16816<S>(acc[2 * np], fa[kk], fb[0], fb[1]);
      mma16816<S>(acc[2 * np + 1], fa[kk], fb[2], fb[3]);
    }
}

// B5's p and ds / scale = p * (dp - delta + glse) in place of dp, on the
// accumulator layout of a 16-query x 8 kN-key piece: the lane holds query
// rows `row` and `row + 8` (dp[.][0..1] and dp[.][2..3]) against keys
// `key + 8 n` and + 1; lse2 is each row's lse times log2 e, shift its
// glse - delta
template <bool kMasked, int kN>
__device__ __forceinline__ void tc_probs_q(const float (&s)[kN][4],
                                           float (&dp)[kN][4],
                                           const float (&lse2)[2],
                                           const float (&shift)[2],
                                           const Dims& p, float scale2,
                                           int row, int key) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = c >> 1;
      float pr = fast_exp2(fmaf(s[n][c], scale2, -lse2[r]));
      if (kMasked && !visible(p, row + 8 * r, key + 8 * n + (c & 1)))
        pr = 0.0f;
      dp[n][c] = pr * (dp[n][c] + shift[r]);
    }
}

template <int DT, typename S>
__global__ void __launch_bounds__(kTcThreads, TcLayout<DT>::kDqBlocks)
flash_dq_tc_kernel(const S* __restrict__ q, const S* __restrict__ k,
                   const S* __restrict__ v, const S* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const float* __restrict__ glse, S* __restrict__ dq,
                   Dims p, int vec) {
  using T = TcLayout<DT>;
  constexpr int kN = T::kDqChunk / 8;  // 8-key pieces of a pass
  constexpr int kDn = DT / 8;
  extern __shared__ float4 smem[];
  S* Qs = reinterpret_cast<S*>(smem);
  S* Gs = Qs + T::kTileElems;   // dO
  S* KVs = Gs + T::kTileElems;  // a stage: K, then V

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heavy tiles first
  const int n = key_tiles(p, q0);
  const int warp = threadIdx.x >> 5;
  const TcLane ln;

  if (p.D < DT) tc_zero_pad<DT>(Qs, 6, p.D);
  if (n > 0) {
    tc_load_tile<DT>(Qs, q, b, h, q0, p.Lq, p, vec);
    tc_load_tile<DT>(Gs, dout, b, h, q0, p.Lq, p, vec);
    tc_load_tile<DT>(KVs, k, b, h, 0, p.Lk, p, vec);
    tc_load_tile<DT>(KVs + T::kTileElems, v, b, h, 0, p.Lk, p, vec);
    cp_async_commit();
  }
  const int own = (16 * warp + ln.a_row) * T::kStride + ln.a_col;
  const int row = q0 + 16 * warp + ln.g;  // the lane's rows: row, row + 8
  // the rows' statistics, once: the block owns its query rows
  float lse2[2], shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool real = row + 8 * r < p.Lq;
    const int64_t at = real ? stat(p, b, h, row + 8 * r) : 0;
    lse2[r] = real ? lse[at] * kLog2e : 0.0f;
    // d lse / d s = p: the lse cotangent adds straight into ds
    shift[r] = real ? glse[at] - delta[at] : 0.0f;
  }
  const float scale2 = p.scale * kLog2e;
  float dq_acc[kDn][4] = {};
  // the warp's Q and dO rows as A fragments, read once when they land
  uint32_t qa[DT / 16][4], ga[DT / 16][4];

  for (int kj = 0; kj < n; ++kj) {
    const S* Ks = KVs + (kj & 1) * 2 * T::kTileElems;
    const S* Vs = Ks + T::kTileElems;
    cp_async_wait_all();
    __syncthreads();  // tile kj is here; tile kj - 1's readers are done
    if (kj + 1 < n) {
      S* next = KVs + ((kj + 1) & 1) * 2 * T::kTileElems;
      tc_load_tile<DT>(next, k, b, h, (kj + 1) * kTile, p.Lk, p, vec);
      tc_load_tile<DT>(next + T::kTileElems, v, b, h, (kj + 1) * kTile,
                       p.Lk, p, vec);
      cp_async_commit();
    }
    const int k0 = kj * kTile;
    const bool edge = key_edge(p, q0, k0);
    if (kj == 0) {
#pragma unroll
      for (int kk = 0; kk < DT / 16; ++kk) {
        ldsm_x4(qa[kk], Qs + own + 16 * kk);
        ldsm_x4(ga[kk], Gs + own + 16 * kk);
      }
    }
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += T::kDqChunk) {
      // S = Q K^T and dP = dO V^T over the pass's keys
      float s[kN][4] = {}, dp[kN][4] = {};
      const int nk = (c0 + ln.b_row) * T::kStride + ln.b_col;
      tc_product_held<DT, kN>(s, qa, Ks + nk);
      tc_product_held<DT, kN>(dp, ga, Vs + nk);
      if (edge)
        tc_probs_q<true>(s, dp, lse2, shift, p, scale2, row,
                         k0 + c0 + 2 * ln.t);
      else
        tc_probs_q<false>(s, dp, lse2, shift, p, scale2, row,
                          k0 + c0 + 2 * ln.t);
      // dQ += dS K, K read with keys as the reduction axis
      tc_product_kn<DT, kN>(dq_acc, dp,
                            Ks + (c0 + ln.a_row) * T::kStride + ln.a_col);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr >= p.Lq) continue;
    S* q_row = dq + elem(p, b, p.Lq, rr, h, 0);
#pragma unroll
    for (int d = 0; d < kDn; ++d) {
      const int col = 8 * d + 2 * ln.t;
      // dq takes the scale that ds left out
      const float x0 = dq_acc[d][2 * r] * p.scale;
      const float x1 = dq_acc[d][2 * r + 1] * p.scale;
      if (vec) {
        if (col < p.D)
          *reinterpret_cast<uint32_t*>(q_row + col) = pack2<S>(x0, x1);
      } else {
        if (col < p.D) q_row[col] = narrow<S>(x0);
        if (col + 1 < p.D) q_row[col + 1] = narrow<S>(x1);
      }
    }
  }
}

// B6's p and ds / scale = p * (dp - delta + glse) in place of s and dp, on
// the accumulator layout of a 16-key x kTcChunk-query piece: the lane
// holds key rows `key` and `key + 8` against local queries `ql + 8 n` and
// + 1 of the tile at q0; `st` is the tile's [3][64] lse, delta, glse
template <bool kMasked>
__device__ __forceinline__ void tc_probs(float (&s)[kTcChunk / 8][4],
                                         float (&dp)[kTcChunk / 8][4],
                                         const float* st, const Dims& p,
                                         float scale2, int q0, int ql,
                                         int key) {
#pragma unroll
  for (int n = 0; n < kTcChunk / 8; ++n) {
    const int qn = ql + 8 * n;
    const float2 ls = *reinterpret_cast<const float2*>(st + qn);
    const float2 de = *reinterpret_cast<const float2*>(st + kTile + qn);
    const float2 gl = *reinterpret_cast<const float2*>(st + 2 * kTile + qn);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = c & 1;
      const float lse2 = (j ? ls.y : ls.x) * kLog2e;
      // d lse / d s = p: the lse cotangent adds straight into ds
      const float shift = (j ? gl.y : gl.x) - (j ? de.y : de.x);
      float pr = fast_exp2(fmaf(s[n][c], scale2, -lse2));
      // padded query rows carry no lse: mask them too
      const int q_loc = q0 + qn + j;
      if (kMasked &&
          !(q_loc < p.Lq && visible(p, q_loc, key + 8 * (c >> 1))))
        pr = 0.0f;
      s[n][c] = pr;
      dp[n][c] = pr * (dp[n][c] + shift);
    }
  }
}

template <int DT, typename S>
__global__ void __launch_bounds__(kTcThreads, TcLayout<DT>::kDkvBlocks)
flash_dkv_tc_kernel(const S* __restrict__ q, const S* __restrict__ k,
                    const S* __restrict__ v, const S* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ glse, S* __restrict__ dk,
                    S* __restrict__ dv, Dims p, int vec) {
  using T = TcLayout<DT>;
  constexpr int kN = kTcChunk / 8;  // 8-query pieces of a pass
  constexpr int kDn = DT / 8;
  extern __shared__ float4 smem[];
  S* Ks = reinterpret_cast<S*>(smem);
  S* Vs = Ks + T::kTileElems;
  S* QGs = Vs + T::kTileElems;  // a stage: Q, then dO
  float* stats = reinterpret_cast<float*>(QGs + 4 * T::kTileElems);

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int k0 = blockIdx.y * kTile;  // key tile 0 sees the most query tiles
  // pallas_attention.py:260, as in flash_dkv_kernel
  const int nq = (p.Lq + kTile - 1) / kTile;
  int first = 0;
  if (p.causal) {
    const int64_t need = static_cast<int64_t>(p.k_off) + k0 + 1 -
                         static_cast<int64_t>(p.q_off);
    if (need > 0) {
      const int64_t f = (need + kTile - 1) / kTile - 1;
      first = f < nq ? static_cast<int>(f) : nq;
    }
  }
  const int warp = threadIdx.x >> 5;
  const TcLane ln;

  // tile qj's Q, dO and row statistics into `stage`
  auto load_stage = [&](int stage, int qj) {
    S* dst = QGs + stage * 2 * T::kTileElems;
    tc_load_tile<DT>(dst, q, b, h, qj * kTile, p.Lq, p, vec);
    tc_load_tile<DT>(dst + T::kTileElems, dout, b, h, qj * kTile, p.Lq, p,
                     vec);
    tc_load_stats(stats + stage * 3 * kTile, lse, delta, glse, b, h,
                  qj * kTile, p);
  };

  if (p.D < DT) tc_zero_pad<DT>(Ks, 6, p.D);
  if (first < nq) {
    tc_load_tile<DT>(Ks, k, b, h, k0, p.Lk, p, vec);
    tc_load_tile<DT>(Vs, v, b, h, k0, p.Lk, p, vec);
    load_stage(0, first);
    cp_async_commit();
  }
  const int own = (16 * warp + ln.a_row) * T::kStride + ln.a_col;
  const int key = k0 + 16 * warp + ln.g;  // the lane's keys: key, key + 8
  const float scale2 = p.scale * kLog2e;
  float dk_acc[kDn][4] = {}, dv_acc[kDn][4] = {};

  for (int qj = first; qj < nq; ++qj) {
    const int stage = (qj - first) & 1;
    const S* Qs = QGs + stage * 2 * T::kTileElems;
    const S* Gs = Qs + T::kTileElems;
    const float* st = stats + stage * 3 * kTile;
    cp_async_wait_all();
    __syncthreads();  // tile qj is here; tile qj - 1's readers are done
    if (qj + 1 < nq) {
      load_stage(stage ^ 1, qj + 1);
      cp_async_commit();
    }
    const int q0 = qj * kTile;
    // the mask can touch this tile: it holds padded keys or padded
    // queries, or its last key lies past its first query
    const bool edge =
        k0 + kTile > p.Lk || q0 + kTile > p.Lq ||
        (p.causal && static_cast<int64_t>(p.k_off) + k0 + kTile - 1 >
                         static_cast<int64_t>(p.q_off) + q0);
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kTcChunk) {
      // S^T = K Q^T and dP^T = V dO^T over the pass's queries
      float s[kN][4] = {}, dp[kN][4] = {};
      const int nk = (c0 + ln.b_row) * T::kStride + ln.b_col;
      tc_product_nk<DT, kN>(s, Ks + own, Qs + nk);
      tc_product_nk<DT, kN>(dp, Vs + own, Gs + nk);
      if (edge)
        tc_probs<true>(s, dp, st, p, scale2, q0, c0 + 2 * ln.t, key);
      else
        tc_probs<false>(s, dp, st, p, scale2, q0, c0 + 2 * ln.t, key);
      // dV += P^T dO and dK += dS^T Q
      const int kn = (c0 + ln.a_row) * T::kStride + ln.a_col;
      tc_product_kn<DT, kN>(dv_acc, s, Gs + kn);
      tc_product_kn<DT, kN>(dk_acc, dp, Qs + kn);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = key + 8 * r;
    if (rr >= p.Lk) continue;
    S* k_row = dk + elem(p, b, p.Lk, rr, h, 0);
    S* v_row = dv + elem(p, b, p.Lk, rr, h, 0);
#pragma unroll
    for (int d = 0; d < kDn; ++d) {
      const int col = 8 * d + 2 * ln.t;
      // dk takes the scale that ds left out
      const float k0v = dk_acc[d][2 * r] * p.scale;
      const float k1v = dk_acc[d][2 * r + 1] * p.scale;
      const float v0 = dv_acc[d][2 * r], v1 = dv_acc[d][2 * r + 1];
      if (vec) {
        if (col < p.D) {
          *reinterpret_cast<uint32_t*>(k_row + col) = pack2<S>(k0v, k1v);
          *reinterpret_cast<uint32_t*>(v_row + col) = pack2<S>(v0, v1);
        }
      } else {
        if (col < p.D) k_row[col] = narrow<S>(k0v), v_row[col] = narrow<S>(v0);
        if (col + 1 < p.D)
          k_row[col + 1] = narrow<S>(k1v), v_row[col + 1] = narrow<S>(v1);
      }
    }
  }
}

// ---------------------------------------------------------------------
// launch plumbing
// ---------------------------------------------------------------------
enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// D padded to the width its kernels are instantiated at
int padded_width(int D) {
  return D <= 8 ? 8 : D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128;
}

// the tensor-core arms' width: D padded to 16, 32, 64 or 128
constexpr int tc_width(int DT) { return DT < 16 ? 16 : DT; }

size_t smem_bytes(int which, int D, int storage) {
  if (storage != 0) {  // the tensor-core kernels
    // B4: Q and two stages of K, V; B5: Q, dO and two stages of K, V; B6:
    // K, V, two stages of Q, dO and of the three row statistics
    const size_t tile = static_cast<size_t>(kTile) *
                        (tc_width(padded_width(D)) + 8) * 2;
    return which == kFwd  ? 5 * tile
           : which == kDq ? 6 * tile
                          : 6 * tile + 2 * 3 * kTile * 4;
  }
  const int DT = padded_width(D), stages = DT <= 64 ? 2 : 1;
  // own tiles: Q in B4; Q, dO in B5; K, V in B6
  const size_t tiles = static_cast<size_t>((which == kFwd ? 1 : 2) +
                                           2 * stages) * kTile * (DT + 4);
  const size_t scores = static_cast<size_t>(kTile) * kScoreStride;
  if (which == kFwd) return 4 * (tiles + scores + kTile);
  return which == kDq ? 4 * (tiles + scores + 3 * kTile)
                      : 4 * (tiles + 2 * scores + stages * 3 * kTile);
}

// opt a kernel in to more than 48 KB of dynamic shared memory, once for
// each size it is launched at or above
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e == cudaSuccess) *granted = bytes;
  return e;
}

// 16-byte copies and stores need every tensor 16-byte aligned and D % 4 ==
// 0 (f32: 4 elements a copy) or D % 8 == 0 (16-bit: 8)
bool vector_path(const void* const* ptr, int n, int D, int elems) {
  if (D % elems != 0) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptr[i]) % 16 != 0) return false;
  return true;
}

template <typename S>
constexpr int storage_of() {
  return kWide<S> ? 0 : std::is_same<S, __half>::value ? 2 : 1;
}

// 16-bit storage: the tensor-core kernels at width DT
template <int DT, typename S>
cudaError_t launch_tc(int which, const void* const* ptr, const Dims& p,
                      cudaStream_t stream) {
  static size_t granted[3] = {0, 0, 0};
  const size_t bytes = smem_bytes(which, p.D, storage_of<S>());
  const int nq = (p.Lq + kTile - 1) / kTile;
  const int nk = (p.Lk + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(p.B * p.H),
                  static_cast<unsigned>(which == kDkv ? nk : nq));
  const S* const* f = reinterpret_cast<const S* const*>(ptr);
  const float* const* st = reinterpret_cast<const float* const*>(ptr);
  cudaError_t e;
  if (which == kFwd) {
    e = allow_smem(flash_fwd_tc_kernel<DT, S>, bytes, &granted[kFwd]);
    if (e != cudaSuccess) return e;
    flash_fwd_tc_kernel<DT, S><<<grid, kTcThreads, bytes, stream>>>(
        f[0], f[1], f[2], const_cast<S*>(f[3]), const_cast<float*>(st[4]),
        p, vector_path(ptr, 4, p.D, 8));
  } else if (which == kDq) {
    e = allow_smem(flash_dq_tc_kernel<DT, S>, bytes, &granted[kDq]);
    if (e != cudaSuccess) return e;
    flash_dq_tc_kernel<DT, S><<<grid, kTcThreads, bytes, stream>>>(
        f[0], f[1], f[2], f[3], st[4], st[5], st[6], const_cast<S*>(f[7]),
        p, vector_path(ptr, 8, p.D, 8));
  } else {
    e = allow_smem(flash_dkv_tc_kernel<DT, S>, bytes, &granted[kDkv]);
    if (e != cudaSuccess) return e;
    flash_dkv_tc_kernel<DT, S><<<grid, kTcThreads, bytes, stream>>>(
        f[0], f[1], f[2], f[3], st[4], st[5], st[6], const_cast<S*>(f[7]),
        const_cast<S*>(f[8]), p, vector_path(ptr, 9, p.D, 8));
  }
  return cudaGetLastError();
}

template <int DT, typename S>
cudaError_t launch(int which, const void* const* ptr, const Dims& p,
                   cudaStream_t stream) {
  if constexpr (!kWide<S>) {
    return launch_tc<tc_width(DT), S>(which, ptr, p, stream);
  } else {
    static size_t granted[3] = {0, 0, 0};
    const size_t bytes = smem_bytes(which, p.D, 0);
    const int nq = (p.Lq + kTile - 1) / kTile;
    const int nk = (p.Lk + kTile - 1) / kTile;
    const dim3 grid(static_cast<unsigned>(p.B * p.H),
                    static_cast<unsigned>(which == kDkv ? nk : nq));
    const float* const* f = reinterpret_cast<const float* const*>(ptr);
    float* const* out = const_cast<float* const*>(f);
    cudaError_t e;
    switch (which) {
      case kFwd:
        e = allow_smem(flash_fwd_kernel<DT, S>, bytes, &granted[kFwd]);
        if (e != cudaSuccess) return e;
        flash_fwd_kernel<DT, S><<<grid, kThreads, bytes, stream>>>(
            f[0], f[1], f[2], out[3], out[4], p, vector_path(ptr, 4, p.D, 4));
        break;
      case kDq:
        e = allow_smem(flash_dq_kernel<DT, S>, bytes, &granted[kDq]);
        if (e != cudaSuccess) return e;
        flash_dq_kernel<DT, S><<<grid, kThreads, bytes, stream>>>(
            f[0], f[1], f[2], f[3], f[4], f[5], f[6], out[7], p,
            vector_path(ptr, 8, p.D, 4));
        break;
      default:
        e = allow_smem(flash_dkv_kernel<DT, S>, bytes, &granted[kDkv]);
        if (e != cudaSuccess) return e;
        flash_dkv_kernel<DT, S><<<grid, kThreads, bytes, stream>>>(
            f[0], f[1], f[2], f[3], f[4], f[5], f[6], out[7], out[8], p,
            vector_path(ptr, 9, p.D, 4));
        break;
    }
    return cudaGetLastError();
  }
}

// what the compiler and the card give pass `which` at this width:
// registers a thread, local memory a thread (stack and spills) and the
// blocks an SM holds at the pass's shared memory
template <int DT, typename S>
cudaError_t info(int which, int D, int* regs, int* local_bytes,
                 int* blocks_per_sm) {
  const void* kernel;
  if constexpr (kWide<S>) {
    kernel = which == kFwd
                 ? reinterpret_cast<const void*>(flash_fwd_kernel<DT, S>)
             : which == kDq
                 ? reinterpret_cast<const void*>(flash_dq_kernel<DT, S>)
                 : reinterpret_cast<const void*>(flash_dkv_kernel<DT, S>);
  } else {
    constexpr int kDTc = tc_width(DT);
    kernel =
        which == kFwd
            ? reinterpret_cast<const void*>(flash_fwd_tc_kernel<kDTc, S>)
        : which == kDq
            ? reinterpret_cast<const void*>(flash_dq_tc_kernel<kDTc, S>)
            : reinterpret_cast<const void*>(flash_dkv_tc_kernel<kDTc, S>);
  }
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  const size_t bytes = smem_bytes(which, D, storage_of<S>());
  if (bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, kWide<S> ? kThreads : kTcThreads, bytes);
}

// call fn<DT, S> at the instantiation that serves head width D (DT is
// padded_width(D))
#define FLASH_BY_WIDTH(D, fn, S, ...)                \
  ((D) <= 8    ? fn<8, S>(__VA_ARGS__)               \
   : (D) <= 16 ? fn<16, S>(__VA_ARGS__)              \
   : (D) <= 32 ? fn<32, S>(__VA_ARGS__)              \
   : (D) <= 64 ? fn<64, S>(__VA_ARGS__)              \
               : fn<128, S>(__VA_ARGS__))

enum Storage { kF32 = 0, kBf16 = 1, kF16 = 2 };

int dispatch(int which, const void* const* ptr, int B, int Lq, int Lk,
             int H, int D, int causal, int q_off, int k_off, float scale,
             int storage, void* stream) {
  if (D < 1 || D > 128 || B < 0 || H < 0 || Lq < 0 || Lk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((which == kDkv ? Lk : Lq) + kTile - 1) / kTile;
  if (static_cast<int64_t>(B) * H > 0x7fffffff || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || tiles == 0) return 0;
  const Dims p{B, Lq, Lk, H, D, causal != 0, q_off, k_off, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (storage) {
#if SERVES(0)
    case kF32:
      return static_cast<int>(
          FLASH_BY_WIDTH(D, launch, float, which, ptr, p, s));
#endif
#if SERVES(1)
    case kBf16:
      return static_cast<int>(
          FLASH_BY_WIDTH(D, launch, __nv_bfloat16, which, ptr, p, s));
#endif
#if SERVES(2)
    case kF16:
      return static_cast<int>(
          FLASH_BY_WIDTH(D, launch, __half, which, ptr, p, s));
#endif
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// info<DT, S> of pass `which` % 3 at storage `which` / 3, for the storages
// this object serves
int kernel_info(int which, int D, int* regs, int* local_bytes,
                int* blocks_per_sm) {
  const int pass = which % 3;
  switch (which / 3) {
#if SERVES(0)
    case kF32:
      return static_cast<int>(FLASH_BY_WIDTH(D, info, float, pass, D, regs,
                                             local_bytes, blocks_per_sm));
#endif
#if SERVES(1)
    case kBf16:
      return static_cast<int>(FLASH_BY_WIDTH(D, info, __nv_bfloat16, pass, D,
                                             regs, local_bytes,
                                             blocks_per_sm));
#endif
#if SERVES(2)
    case kF16:
      return static_cast<int>(FLASH_BY_WIDTH(D, info, __half, pass, D, regs,
                                             local_bytes, blocks_per_sm));
#endif
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// the objects' bridges: flash_kernel_info (part 0) reaches the 16-bit
// storages' kernel_info through these
namespace flash_parts {
int info_bf16(int which, int D, int* regs, int* local_bytes,
              int* blocks_per_sm);
int info_f16(int which, int D, int* regs, int* local_bytes,
             int* blocks_per_sm);
#if KERNEL_PART == 1
int info_bf16(int which, int D, int* regs, int* local_bytes,
              int* blocks_per_sm) {
  return kernel_info(which, D, regs, local_bytes, blocks_per_sm);
}
#elif KERNEL_PART == 2
int info_f16(int which, int D, int* regs, int* local_bytes,
             int* blocks_per_sm) {
  return kernel_info(which, D, regs, local_bytes, blocks_per_sm);
}
#endif
}  // namespace flash_parts

// Each launcher runs on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).  Offsets are global positions.  The
// unsuffixed launchers take float32 q, k, v, dO and outputs; the _bf16 and
// _f16 ones take them in bfloat16 or float16 (lse, delta and glse are
// float32 in every case).

#if SERVES(0)
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int B, int Lq, int Lk,
                                int H, int D, int causal, int q_off, int k_off,
                                float scale, void* stream) {
  const void* ptr[] = {q, k, v, out, lse};
  return dispatch(kFwd, ptr, B, Lq, Lk, H, D, causal, q_off, k_off, scale,
                  kF32, stream);
}

extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* glse, void* dq,
                               int B, int Lq, int Lk, int H, int D, int causal,
                               int q_off, int k_off, float scale,
                               void* stream) {
  const void* ptr[] = {q, k, v, dout, lse, delta, glse, dq};
  return dispatch(kDq, ptr, B, Lq, Lk, H, D, causal, q_off, k_off, scale,
                  kF32, stream);
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* glse, void* dk,
                                void* dv, int B, int Lq, int Lk, int H, int D,
                                int causal, int q_off, int k_off, float scale,
                                void* stream) {
  const void* ptr[] = {q, k, v, dout, lse, delta, glse, dk, dv};
  return dispatch(kDkv, ptr, B, Lq, Lk, H, D, causal, q_off, k_off, scale,
                  kF32, stream);
}
#endif

#if SERVES(1)
extern "C" int flash_fwd_launch_bf16(const void* q, const void* k,
                                     const void* v, void* out, void* lse, int B,
                                     int Lq, int Lk, int H, int D, int causal,
                                     int q_off, int k_off, float scale,
                                     void* stream) {
  const void* ptr[] = {q, k, v, out, lse};
  return dispatch(kFwd, ptr, B, Lq, Lk, H, D, causal, q_off, k_off, scale,
                  kBf16, stream);
}

extern "C" int flash_dq_launch_bf16(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* delta, const void* glse,
                                    void* dq, int B, int Lq, int Lk, int H,
                                    int D, int causal, int q_off, int k_off,
                                    float scale, void* stream) {
  const void* ptr[] = {q, k, v, dout, lse, delta, glse, dq};
  return dispatch(kDq, ptr, B, Lq, Lk, H, D, causal, q_off, k_off, scale,
                  kBf16, stream);
}

extern "C" int flash_dkv_launch_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     const void* glse, void* dk, void* dv,
                                     int B, int Lq, int Lk, int H, int D,
                                     int causal, int q_off, int k_off,
                                     float scale, void* stream) {
  const void* ptr[] = {q, k, v, dout, lse, delta, glse, dk, dv};
  return dispatch(kDkv, ptr, B, Lq, Lk, H, D, causal, q_off, k_off, scale,
                  kBf16, stream);
}
#endif

#if SERVES(2)
extern "C" int flash_fwd_launch_f16(const void* q, const void* k, const void* v,
                                    void* out, void* lse, int B, int Lq, int Lk,
                                    int H, int D, int causal, int q_off,
                                    int k_off, float scale, void* stream) {
  const void* ptr[] = {q, k, v, out, lse};
  return dispatch(kFwd, ptr, B, Lq, Lk, H, D, causal, q_off, k_off, scale,
                  kF16, stream);
}

extern "C" int flash_dq_launch_f16(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, const void* glse,
                                   void* dq, int B, int Lq, int Lk, int H,
                                   int D, int causal, int q_off, int k_off,
                                   float scale, void* stream) {
  const void* ptr[] = {q, k, v, dout, lse, delta, glse, dq};
  return dispatch(kDq, ptr, B, Lq, Lk, H, D, causal, q_off, k_off, scale,
                  kF16, stream);
}

extern "C" int flash_dkv_launch_f16(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* delta, const void* glse,
                                    void* dk, void* dv, int B, int Lq, int Lk,
                                    int H, int D, int causal, int q_off,
                                    int k_off, float scale, void* stream) {
  const void* ptr[] = {q, k, v, dout, lse, delta, glse, dk, dv};
  return dispatch(kDkv, ptr, B, Lq, Lk, H, D, causal, q_off, k_off, scale,
                  kF16, stream);
}
#endif

// shared memory a block of pass `which` uses at D: `which` is the pass (0
// B4, 1 B5, 2 B6) plus 3 times the storage (0 float32, 1 bfloat16, 2
// float16), as for flash_kernel_info; -1 for a `which` or D out of range
#if SERVES(0)
extern "C" long long flash_smem_bytes(int which, int D) {
  if (which < 0 || which > 8 || D < 1 || D > 128) return -1;
  return static_cast<long long>(smem_bytes(which % 3, D, which / 3));
}

// registers a thread, local memory a thread in bytes (0 means no spill)
// and resident blocks an SM of pass `which` at D; returns a CUDA error
// code.  `which` is the pass (0 B4, 1 B5, 2 B6) plus 3 times the storage
// (0 float32, 1 bfloat16, 2 float16)
extern "C" int flash_kernel_info(int which, int D, int* regs,
                                 int* local_bytes, int* blocks_per_sm) {
  if (which < 0 || which > 8 || D < 1 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
#if KERNEL_PART == 0
  if (which / 3 == kBf16)
    return flash_parts::info_bf16(which, D, regs, local_bytes, blocks_per_sm);
  if (which / 3 == kF16)
    return flash_parts::info_f16(which, D, regs, local_bytes, blocks_per_sm);
#endif
  return kernel_info(which, D, regs, local_bytes, blocks_per_sm);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
