// The earlier design of kernel B3 (csrc/quant_bin.cu before its redesign),
// kept as the baseline of csrc/probes/quant_variants.py; nothing else
// builds it.  Each block of 2,048 elements finds its leaf by a scan of the
// offsets table and each thread moves one scalar at a time.
//
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
// memory.  The nlg_gru GRU LM has P = 2,727,184 parameters in 7 leaves; at
// K = 10 clients a launch moves 218,174,720 bytes, about 65 us at the H100
// SXM's 3.35 TB/s.
//
// Design, for the card rather than the TPU:
// - one launch per round over the whole [K, P] payload instead of K * L
//   launches: blockIdx.y is the client, blockIdx.x a tile of kTile elements
//   inside ONE leaf (each leaf's tiles are numbered after the previous
//   leaf's), so a block finds its leaf once, by a scan of the L + 1 offsets,
//   and computes width once; leaves of 1.6M and of 10k elements get blocks
//   in proportion to their size, and no thread searches per element;
// - no (256, 128) block padding: the last tile of a leaf is masked, all
//   offsets are 64-bit;
// - neighbouring threads read neighbouring words, so every warp access is
//   coalesced; leaf starts are not 16-byte aligned (w_hh.bias has 1536
//   elements but unembedding_bias 10,000 after an odd offset), so loads are
//   scalar;
// - IEEE arithmetic spelled with __fsub_rn / __fdiv_rn / __fmul_rn /
//   __fadd_rn, which nvcc never contracts into an FMA, and rintf (round half
//   to even, as jnp.round and torch.round): bitwise equal to the plain
//   PyTorch version.  Clamps are comparisons, so a NaN stays a NaN as in
//   torch.clamp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // elements per block; QuantBinSparsify.TILE

__global__ void __launch_bounds__(kThreads)
quant_bin_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const int64_t* __restrict__ offsets,
                 const float* __restrict__ lo_tab,
                 const float* __restrict__ hi_tab,
                 const float* __restrict__ th_tab, int64_t P, int L,
                 int n_bins) {
  const int64_t k = blockIdx.y;
  const int64_t t = blockIdx.x;
  // this block's leaf and element range
  int leaf = -1;
  int64_t start = 0, end = 0, seen = 0;
  for (int l = 0; l < L; ++l) {
    const int64_t a = offsets[l], b = offsets[l + 1];
    const int64_t tiles = (b - a + kTile - 1) / kTile;
    if (t < seen + tiles) {
      leaf = l;
      start = a + (t - seen) * kTile;
      end = start + kTile < b ? start + kTile : b;
      break;
    }
    seen += tiles;
  }
  if (leaf < 0) return;

  const int64_t cell = k * L + leaf;
  const float lo = lo_tab[cell];
  const float th = th_tab[cell];
  const float top = static_cast<float>(n_bins > 1 ? n_bins - 1 : 1);
  const float width = __fdiv_rn(__fsub_rn(hi_tab[cell], lo), top);
  const float wdiv = width < 1e-30f ? 1e-30f : width;
  const float last = static_cast<float>(n_bins - 1);

  const int64_t row = k * P;
  for (int64_t j = start + threadIdx.x; j < end; j += kThreads) {
    const float v = x[row + j];
    float r = 0.0f;
    if (fabsf(v) > th) {
      float idx = rintf(__fdiv_rn(__fsub_rn(v, lo), wdiv));
      idx = idx < 0.0f ? 0.0f : idx;
      idx = idx > last ? last : idx;
      r = __fadd_rn(lo, __fmul_rn(idx, width));
    }
    out[row + j] = r;
  }
}

}  // namespace

// x, out: [K, P] float32; offsets: [L + 1] int64 leaf boundaries
// (0 = o_0 <= ... <= o_L = P); lo, hi, thresh: [K, L] float32; all
// contiguous on the current device.  tiles >= the leaves' tile count (extra
// blocks return at once).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).  Does not synchronise.
extern "C" int quant_bin_launch(const void* x, void* out, const void* offsets,
                                const void* lo, const void* hi,
                                const void* thresh, long long K, long long P,
                                int L, long long tiles, int n_bins,
                                void* stream) {
  if (K <= 0 || P <= 0 || L <= 0) return 0;
  if (K > 65535 || tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(K));
  quant_bin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<const int64_t*>(offsets), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<const float*>(thresh),
      static_cast<int64_t>(P), L, n_bins);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quant_bin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
