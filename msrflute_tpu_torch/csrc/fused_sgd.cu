// Fused momentum-SGD apply over K clients' flat parameter rows, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel msrflute_tpu/ops/pallas_kernels.py::fused_sgd_apply
// (body _sgd_kernel, pl.pallas_call at pallas_kernels.py:212), which the JAX
// client update runs once per local step under its client vmap when
// server_config.megakernel.pallas_apply is set.  Per element of row k:
//
//     m' = g + (mu * m)          p' = p - (lr * m')
//
// and a row whose gate[k] <= 0 (an all-padding step of client k) keeps p and
// m unchanged.  The update is IN PLACE: p and m are read and overwritten;
// pinned rows are neither read nor written.
//
// Bound: one pass that moves 20 bytes per live parameter (read p, g, m;
// write p, m; 4 bytes each) and does 4 flops on them, so it is bound by
// device memory.  CNN_FEMNIST has P = 1,206,590 parameters
// (Conv_0 3*3*1*32+32, Conv_1 3*3*32*64+64, Dense_0 9216*128+128,
// Dense_1 128*62+62); at K = 10 clients a launch moves 241,318,000 bytes,
// about 72 us at the H100 SXM's 3.35 TB/s.
//
// Design, for the card rather than the TPU:
// - no (256, 128) block padding: a 2-D grid, blockIdx.y over client rows and
//   a grid-stride loop over the row in x, all offsets 64-bit (K * P passes
//   2^31 at fleet cohort sizes);
// - one wave: the launcher asks the runtime how many blocks fit on an SM and
//   launches no more than fit on the card at once, so no block waits for a
//   second wave;
// - scalar loads: P = 1,206,590 is 2 (mod 4), so float4 loads would be
//   misaligned at every other row start.  Neighbouring threads still read
//   neighbouring words, so every warp access is coalesced.  (On the H100
//   this pass reaches about 55 % of the byte bound and PyTorch's vectorized
//   torch._fused_sgd_ about 78 %, chip_smoke.py.  Vector loads need an
//   aligned head per row or a padded row stride; unrolling the scalar loop
//   did not close the gap.)
// - the gate is uniform over a row, so a pinned row is skipped by the whole
//   block with no divergence and no traffic;
// - no fused multiply-add: nvcc would contract p - lr*m' into an FMA, which
//   rounds once where the JAX kernel and the plain PyTorch version round
//   twice.  The __fmul_rn / __fadd_rn / __fsub_rn intrinsics are never
//   contracted, so the kernel is bitwise equal to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_sgd_kernel(float* __restrict__ p, const float* __restrict__ g,
                 float* __restrict__ m, const float* __restrict__ gate,
                 int64_t K, int64_t P, float lr, float mu) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t k = blockIdx.y; k < K; k += gridDim.y) {
    if (!(gate[k] > 0.0f)) continue;  // NaN gates pin too, as in JAX
    const int64_t row = k * P;
    for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
         j < P; j += stride) {
      const int64_t i = row + j;
      const float m_new = __fadd_rn(g[i], __fmul_rn(mu, m[i]));
      p[i] = __fsub_rn(p[i], __fmul_rn(lr, m_new));
      m[i] = m_new;
    }
  }
}

// Blocks of fused_sgd_kernel that the card holds at once.
long long resident_blocks() {
  static long long cached = 0;
  if (cached == 0) {
    int device = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fused_sgd_kernel, kThreads, 0) != cudaSuccess ||
        sms <= 0 || per_sm <= 0) {
      return 132;  // one block per SM of an H100 SXM; not cached
    }
    cached = static_cast<long long>(sms) * per_sm;
  }
  return cached;
}

}  // namespace

// p, m: [K, P] float32, updated in place; g: [K, P] float32; gate: [K]
// float32; all contiguous on the current device.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).  Does not synchronise.
extern "C" int fused_sgd_launch(void* p, const void* g, void* m,
                                const void* gate, long long K, long long P,
                                float lr, float mu, void* stream) {
  if (K <= 0 || P <= 0) return 0;
  const long long gy = K < 65535 ? K : 65535;
  long long gx = resident_blocks() / gy;
  const long long need = (P + kThreads - 1) / kThreads;
  if (gx > need) gx = need;
  if (gx < 1) gx = 1;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  fused_sgd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<const float*>(gate),
      static_cast<int64_t>(K), static_cast<int64_t>(P), lr, mu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_sgd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
