// Histogram binning plus sub-threshold zeroing over K clients' flat
// pseudo-gradient rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel msrflute_tpu/ops/pallas_kernels.py::
// quant_bin_sparsify (body _quant_kernel, pl.pallas_call at
// pallas_kernels.py:164), which the JAX package's DGA quantization
// (ops/quantization.py::quantize_array) launches once per parameter leaf per
// client under the round's vmap.  For element x of client row k in leaf l,
// with lo, hi, thresh the per-(client, leaf) tables and n = n_bins:
//
//     width = (hi - lo) / (n - 1)                       once per (k, l)
//     idx   = clip(rint((x - lo) / max(width, 1e-30)), 0, n - 1)
//     out   = lo + idx * width    if |x| > thresh, else 0
//
// This is the JAX package's jnp arithmetic (ops/quantization.py:72-76): the
// Pallas body clamps width before the product too, which differs only for
// 0 < width < 1e-30.  min, max and the quantile threshold are reductions;
// the wrapper computes them with PyTorch, as the JAX package leaves them to
// XLA.
//
// Bound: one pass that reads x and writes out, 8 bytes per element, and does
// about 10 flops on it (one of them a division), so it is bound by device
// memory.  At K = 10 clients a launch moves 218,174,720 bytes for the
// nlg_gru GRU LM (P = 2,727,184 in 7 leaves), about 65 us at the H100 SXM's
// 3.35 TB/s, and 8.76 GB for BERT-base (P = 109,514,298 in 202 leaves),
// about 2.6 ms.
//
// Design, for the card rather than the TPU:
// - one launch per round over the whole [K, P] payload instead of K * L
//   launches: blockIdx.y is the client, blockIdx.x a tile of kTile elements
//   inside ONE leaf.  A block finds its leaf with one load from a tile
//   table the wrapper builds once a layout on the device
//   (ops/quant_bin.py::schedule): entry t holds the leaf of tile t and the
//   tile's number inside that leaf.  No block searches the offsets: a scan
//   of them up to the block's leaf, two dependent loads a leaf, was most of
//   the time at BERT-base, whose leaf order puts the encoder's large
//   kernels behind up to 200 small leaves;
// - tiles are cut at 16-byte addresses, not at leaf offsets: tile j of a
//   (row, leaf) segment covers [A + j * kTile, A + (j + 1) * kTile) clipped
//   to the segment, where A is the segment's first element rounded down to
//   a 16-byte address.  Leaf offsets are not multiples of 4, and when P is
//   not one either every leaf of an odd row starts off a 16-byte boundary,
//   so alignment is taken from the address itself; x and out share theirs
//   (the wrapper allocates out so).  Only a segment's first tile has a head
//   of up to 3 scalars and only its last a tail of up to 3: the rest moves
//   as float4.  A leaf of len elements gets ceil((len + 3) / kTile) tile
//   numbers, enough for any alignment of its start; a block whose range is
//   empty returns at once;
// - each thread issues all of its kVecs independent 16-byte loads before
//   its first store: 16 KB in flight a block of 256 threads, and at 38
//   registers 6 blocks an SM, 96 KB.  A scalar load per thread at a time
//   (8 KB an SM) is too little to cover device memory's latency at
//   3.35 TB/s;
// - indices inside a tile are 32-bit, over one 64-bit base a block;
// - every element is binned and the threshold selects, with no branch: a
//   thread of a full tile issues about 30 instructions an element (the
//   IEEE division's fast path most of them, set-up included), about 1 ms
//   at BERT-base against 2.6 ms of bytes (chip_smoke.py counts them in the
//   SASS);
// - no TMA, wgmma, clusters or shared memory: every byte is read once and
//   written once and nothing is reused, so staging through shared memory
//   would only add a copy.  What bounds the kernel is device memory, and
//   what the design does about it is keep enough loads in flight;
// - IEEE arithmetic spelled with __fsub_rn / __fdiv_rn / __fmul_rn /
//   __fadd_rn, which nvcc never contracts into an FMA, and rintf (round half
//   to even, as jnp.round and torch.round): bitwise equal to the plain
//   PyTorch version.  Clamps are comparisons, so a NaN stays a NaN as in
//   torch.clamp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                     // 16-byte loads in flight a thread
constexpr int kTile = kThreads * kVecs * 4;  // 4,096; ops/quant_bin.py TILE

// one (client, leaf) cell's binning.  Every element is binned and the
// threshold selects: a warp's lanes fall on both sides of the threshold
// (70 % below it at the paths' 0.7 quantile), so a branch would issue both
// sides anyway
struct Bins {
  float lo, width, wdiv, th, last;

  __device__ float operator()(float v) const {
    float idx = rintf(__fdiv_rn(__fsub_rn(v, lo), wdiv));
    idx = idx < 0.0f ? 0.0f : idx;
    idx = idx > last ? last : idx;
    const float r = __fadd_rn(lo, __fmul_rn(idx, width));
    return fabsf(v) > th ? r : 0.0f;
  }
};

__device__ __forceinline__ int misalignment(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__global__ void __launch_bounds__(kThreads)
quant_bin_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const int64_t* __restrict__ offsets,
                 const int2* __restrict__ tiles,
                 const float* __restrict__ lo_tab,
                 const float* __restrict__ hi_tab,
                 const float* __restrict__ th_tab, int64_t P, int L,
                 int n_bins) {
  const int2 tile = tiles[blockIdx.x];  // {leaf, tile inside the leaf}
  if (tile.x >= L) return;              // past the layout's last tile
  const int64_t row = static_cast<int64_t>(blockIdx.y) * P;
  const int64_t seg = row + offsets[tile.x];
  const int64_t seg_end = row + offsets[tile.x + 1];
  const int64_t base = seg - misalignment(x + seg) +
                       static_cast<int64_t>(tile.y) * kTile;
  const int64_t start = base > seg ? base : seg;
  const int64_t stop = base + kTile < seg_end ? base + kTile : seg_end;
  if (start >= stop) return;

  const int64_t cell = static_cast<int64_t>(blockIdx.y) * L + tile.x;
  Bins q;
  q.lo = lo_tab[cell];
  q.th = th_tab[cell];
  const float top = static_cast<float>(n_bins > 1 ? n_bins - 1 : 1);
  q.width = __fdiv_rn(__fsub_rn(hi_tab[cell], q.lo), top);
  q.wdiv = q.width < 1e-30f ? 1e-30f : q.width;
  q.last = static_cast<float>(n_bins - 1);

  const float* xs = x + start;
  float* os = out + start;
  const int n = static_cast<int>(stop - start);  // 1 .. kTile
  const int head = min((4 - misalignment(xs)) & 3, n);
  const int nvec = (n - head) >> 2;
  const int tail = head + 4 * nvec;
  const float4* xv = reinterpret_cast<const float4*>(xs + head);
  float4* ov = reinterpret_cast<float4*>(os + head);

  float4 v[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < nvec) v[u] = xv[i];
  }
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < nvec) ov[i] = make_float4(q(v[u].x), q(v[u].y), q(v[u].z),
                                      q(v[u].w));
  }
  // the head's and the tail's scalars, one a thread
  const int t = threadIdx.x;
  if (t < head + (n - tail)) {
    const int j = t < head ? t : tail + (t - head);
    os[j] = q(xs[j]);
  }
}

}  // namespace

// Elements one block covers; the wrapper's tile table counts in these.
extern "C" int quant_bin_tile() { return kTile; }

// x, out: [K, P] float32 whose addresses agree mod 16; offsets: [L + 1]
// int64 leaf boundaries (0 = o_0 <= ... <= o_L = P); tiles: [grid, 2]
// int32, entry t the leaf of tile t and its number inside the leaf (a leaf
// >= L past the last tile); lo, hi, thresh: [K, L] float32; all contiguous
// on the current device.  Launches (grid, K) blocks on `stream` and returns
// cudaGetLastError() (0 on success).  Does not synchronise.
extern "C" int quant_bin_launch(const void* x, void* out, const void* offsets,
                                const void* tiles, const void* lo,
                                const void* hi, const void* thresh,
                                long long K, long long P, int L,
                                long long grid, int n_bins, void* stream) {
  if (K <= 0 || P <= 0 || L <= 0 || grid <= 0) return 0;
  if (K > 65535 || grid > 2147483647LL) return cudaErrorInvalidConfiguration;
  if ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(out)) &
      15)
    return cudaErrorMisalignedAddress;
  const dim3 blocks(static_cast<unsigned>(grid), static_cast<unsigned>(K));
  quant_bin_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<const int64_t*>(offsets), static_cast<const int2*>(tiles),
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<const float*>(thresh), static_cast<int64_t>(P), L, n_bins);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quant_bin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
