// cuRAND's Philox-4x32-10 on given (counter, key) pairs: the reference that
// chip_smoke.py holds kernel B2's own Philox (gaussian_noise.cu) and the
// plain PyTorch Philox (ops/gaussian_noise.py) to.  Not on any training path.
//
// Bound: none worth stating; it runs once on a few thousand pairs.

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void curand_philox_kernel(const uint32_t* __restrict__ ctr,
                                     const uint32_t* __restrict__ key,
                                     uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4 r = curand_Philox4x32_10(
      make_uint4(ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2], ctr[4 * i + 3]),
      make_uint2(key[2 * i], key[2 * i + 1]));
  out[4 * i] = r.x;
  out[4 * i + 1] = r.y;
  out[4 * i + 2] = r.z;
  out[4 * i + 3] = r.w;
}

}  // namespace

// ctr [n, 4], key [n, 2], out [n, 4] uint32 on the current device.  Returns
// cudaGetLastError() (0 on success).  Does not synchronise.
extern "C" int curand_philox_launch(const void* ctr, const void* key,
                                    void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  curand_philox_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ctr), static_cast<const uint32_t*>(key),
      static_cast<uint32_t*>(out), static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}
