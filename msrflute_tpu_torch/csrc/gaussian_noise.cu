// x * scale + sigma * N(0, 1) over a flat float32 vector, the normals made
// in the kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel msrflute_tpu/ops/pallas_kernels.py::
// fused_gaussian_noise (body _noise_kernel, pl.pallas_call at
// pallas_kernels.py:127), which the JAX package's server runs once per round
// for global DP (privacy.apply_global_dp, called from DGA's combine).  The
// noise never touches device memory: the kernel reads x and writes out.
//
// Random bits: the TPU kernel seeds the TPU's own generator per block; here
// Philox-4x32-10 (Salmon et al., SC'11; the generator of cuRAND's
// curand_Philox4x32_10, against which chip_smoke.py checks the plain
// version that this kernel's normals are held to), keyed by the
// 64-bit seed (k0 = low word, k1 = high word), with pair index j as the
// counter (j mod 2^32, j >> 32, 0, 0).  The four output words are
// (b1, b2) of element 2j and (b1, b2) of element 2j + 1.  The same bits come
// from the plain PyTorch version (ops/gaussian_noise.py::philox4x32_10), so
// kernel and plain version are compared element for element.
//
// Box-Muller exactly as the JAX package writes it (bits_to_normal,
// pallas_kernels.py:77-95):
//     u1 = (b1 >> 8) * 2^-24 + 1e-12      u2 = (b2 >> 8) * 2^-24
//     z  = sqrt(-2 log u1) * cos(2 pi u2)
// with IEEE sqrtf and libdevice's logf / cosf (no --use_fast_math, no
// __logf / __cosf: a wrong sigma silently under-noises every global-DP
// update).  Every product and sum is spelled with __fmul_rn / __fadd_rn,
// which nvcc never contracts into an FMA, as the plain version rounds each
// operation on its own.
//
// Bound: the kernel moves 8 bytes per element (read x, write out): 21.8 MB
// for the nlg_gru GRU LM's P = 2,727,184, about 6.5 us at the H100 SXM's
// 3.35 TB/s.  Its integer work per element is half a Philox call: 10 rounds
// of two 32 x 32 -> 64 bit products (mul.lo and mul.hi each) and four xors,
// 40 int32 operations (the round keys depend on the seed alone, not on the
// element).  At 64 int32 lanes per SM per clock (16.75 Tops/s on the H100
// SXM) that is also about 6.5 us, before the log, square root and cosine,
// which make the instructions a thread issues the largest term
// (chip_smoke.py counts them in this kernel's SASS).
//
// Design, for the card rather than the TPU:
// - one thread per element PAIR, so each Philox call feeds two normals and
//   no word is wasted; a grid-stride loop;
// - no work in the loop that is not an element's: the 20 round keys are
//   made once a launch on the host and read from the kernel's parameters
//   (operands of the xors, not instructions), and indices are 32-bit, the
//   launcher splitting a vector of 2^31 elements or more into launches of
//   2^31, each told its first pair's counter;
// - one wave: no more blocks than the card holds at once (as B1);
// - Philox needs no state: any block can start anywhere in the stream, so
//   blocks run in any order and the result does not depend on the grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

// Elements one launch covers: 32-bit element and pair indices
constexpr long long kChunk = 1LL << 31;

struct Words4 {
  uint32_t x, y, z, w;
};

// The round keys of Philox-4x32-10, (k0 + r W0, k1 + r W1) for r = 0..9.
struct RoundKeys {
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ Words4 philox4x32_10(Words4 c,
                                                const RoundKeys& keys) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = Words4{hi1 ^ c.y ^ keys.k0[r], lo1, hi0 ^ c.w ^ keys.k1[r], lo0};
  }
  return c;
}

__device__ __forceinline__ float bits_to_normal(uint32_t b1, uint32_t b2) {
  const float inv24 = 5.9604644775390625e-08f;  // 2^-24, exact
  const float u1 = __fadd_rn(__fmul_rn(static_cast<float>(b1 >> 8), inv24),
                             1e-12f);
  const float u2 = __fmul_rn(static_cast<float>(b2 >> 8), inv24);
  const float two_pi = 6.283185307179586f;  // float32(2 * pi), as in JAX
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                   cosf(__fmul_rn(two_pi, u2)));
}

// n <= kChunk elements from x to out; pair j draws counter
// (j0 + j, j_hi, 0, 0), where (j_hi, j0) is the first pair's 64-bit index
// in the whole vector (j0 a multiple of 2^30, so j0 + j never carries).
__global__ void __launch_bounds__(kThreads)
gaussian_noise_kernel(const float* __restrict__ x, float* __restrict__ out,
                      uint32_t n, float scale, float sigma,
                      const RoundKeys keys, uint32_t j0, uint32_t j_hi) {
  const uint32_t pairs = n / 2 + (n & 1u);
  const uint32_t stride = gridDim.x * kThreads;
  for (uint32_t j = blockIdx.x * kThreads + threadIdx.x; j < pairs;
       j += stride) {
    // the pair's addresses once, its loads in flight during the rounds
    const float* xp = x + 2 * j;
    float* op = out + 2 * j;
    const bool both = 2 * j + 1 < n;
    const float x0 = xp[0];
    const float x1 = both ? xp[1] : 0.0f;
    const Words4 r = philox4x32_10(Words4{j0 + j, j_hi, 0u, 0u}, keys);
    op[0] = __fadd_rn(__fmul_rn(x0, scale),
                      __fmul_rn(sigma, bits_to_normal(r.x, r.y)));
    if (both) {
      op[1] = __fadd_rn(__fmul_rn(x1, scale),
                        __fmul_rn(sigma, bits_to_normal(r.z, r.w)));
    }
  }
}

// Blocks of gaussian_noise_kernel that the card holds at once.
long long resident_blocks() {
  static long long cached = 0;
  if (cached == 0) {
    int device = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, gaussian_noise_kernel, kThreads, 0) != cudaSuccess ||
        sms <= 0 || per_sm <= 0) {
      return 132;  // one block per SM of an H100 SXM; not cached
    }
    cached = static_cast<long long>(sms) * per_sm;
  }
  return cached;
}

}  // namespace

// x, out: [n] float32, contiguous on the current device; (k0, k1) the
// Philox key.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).  Does not synchronise.
extern "C" int gaussian_noise_launch(const void* x, void* out, long long n,
                                     float scale, float sigma, uint32_t k0,
                                     uint32_t k1, void* stream) {
  RoundKeys keys;
  for (uint32_t r = 0; r < 10; ++r) {
    keys.k0[r] = k0 + r * kW0;
    keys.k1[r] = k1 + r * kW1;
  }
  for (long long start = 0; start < n; start += kChunk) {
    const long long len = n - start < kChunk ? n - start : kChunk;
    const unsigned long long pair0 =
        static_cast<unsigned long long>(start) / 2;
    const long long need = ((len + 1) / 2 + kThreads - 1) / kThreads;
    long long blocks = resident_blocks();
    if (blocks > need) blocks = need;
    gaussian_noise_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x) + start, static_cast<float*>(out) + start,
        static_cast<uint32_t>(len), scale, sigma, keys,
        static_cast<uint32_t>(pair0), static_cast<uint32_t>(pair0 >> 32));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* gaussian_noise_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
