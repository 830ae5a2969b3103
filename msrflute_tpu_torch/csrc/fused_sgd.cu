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
// What bounds it, and what the design does about it.  A pass at the byte
// bound needs the card's memory busy all the time: many 16-byte requests in
// flight on every SM, few instructions for each byte, and no SM idle at the
// end.  Aligned rows alone are not enough: one scalar 4-byte access a
// tensor an element reaches 65 % of the bound at P = 2,727,184 (0 mod 4,
// every row aligned).  So:
// - a vector body.  Each row runs a scalar head up to the first 16-byte
//   boundary of its p row, computed from the row's actual address (the base
//   pointer itself may be misaligned, and with P = 2 (mod 4), as for CNN
//   and RingLM, odd rows start 8 bytes off), then float4 loads and stores,
//   then a scalar tail of at most 3 elements.  The body needs p, g and m to
//   share the address's residue mod 16; a row where they do not runs the
//   scalar loop instead, in the same launch;
// - 4 independent float4 loads a tensor a thread in flight (12 requests of
//   16 bytes), with the streaming cache hints (__ldcs / __stcs): no byte is
//   used twice in a launch.  Index arithmetic is done once a vector;
// - a 2-D grid, blockIdx.y over client rows, and in x enough blocks of 256
//   threads to cover a row's vectors with one pass of 4 each (295 blocks a
//   row at the CNN shape); a grid-stride loop takes rows or vectors beyond
//   the grid's limits.  The gate is uniform over a row, so a pinned row is
//   skipped by whole blocks with no divergence and no traffic;
// - no fused multiply-add: nvcc would contract p - lr*m' into an FMA, which
//   rounds once where the JAX kernel and the plain PyTorch version round
//   twice.  The __fmul_rn / __fadd_rn / __fsub_rn intrinsics are never
//   contracted, so the kernel is bitwise equal to the plain version.
// On an NVIDIA H100 80GB HBM3 at 700 W it moves 86-88 % of the byte bound
// at the CNN and DGA shapes, where torch._fused_sgd_ moves 78-79 %
// (chip_smoke.py; PERF.md has the numbers).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // float4 loads a tensor a thread in flight
constexpr int64_t kSpan = static_cast<int64_t>(kThreads) * kUnroll;

__device__ __forceinline__ void sgd(float& p, float g, float& m, float lr,
                                    float mu) {
  m = __fadd_rn(g, __fmul_rn(mu, m));
  p = __fsub_rn(p, __fmul_rn(lr, m));
}

__device__ __forceinline__ void sgd_at(float* p, const float* g, float* m,
                                       int64_t i, float lr, float mu) {
  float pi = p[i], mi = m[i];
  sgd(pi, g[i], mi, lr, mu);
  p[i] = pi;
  m[i] = mi;
}

__global__ void __launch_bounds__(kThreads)
fused_sgd_kernel(float* __restrict__ p, const float* __restrict__ g,
                 float* __restrict__ m, const float* __restrict__ gate,
                 int64_t K, int64_t P, float lr, float mu) {
  const int t = threadIdx.x;
  for (int64_t k = blockIdx.y; k < K; k += gridDim.y) {
    if (!(gate[k] > 0.0f)) continue;  // NaN gates pin too, as in JAX
    float* pr = p + k * P;
    const float* gr = g + k * P;
    float* mr = m + k * P;
    const uintptr_t a = reinterpret_cast<uintptr_t>(pr);
    if (((a ^ reinterpret_cast<uintptr_t>(gr)) |
         (a ^ reinterpret_cast<uintptr_t>(mr))) & 15) {
      // the three rows cannot share 16-byte boundaries: scalar
      for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + t;
           i < P; i += static_cast<int64_t>(gridDim.x) * kThreads)
        sgd_at(pr, gr, mr, i, lr, mu);
      continue;
    }
    int64_t head = static_cast<int64_t>((16 - (a & 15)) & 15) / 4;
    if (head > P) head = P;
    const int64_t nv = (P - head) / 4;
    const int64_t tail = head + 4 * nv;  // at most 3 elements from here
    if (blockIdx.x == 0) {
      if (t < head) sgd_at(pr, gr, mr, t, lr, mu);
      else if (t >= 4 && t - 4 < P - tail) sgd_at(pr, gr, mr, tail + t - 4,
                                                  lr, mu);
    }
    float4* pv = reinterpret_cast<float4*>(pr + head);
    const float4* gv = reinterpret_cast<const float4*>(gr + head);
    float4* mv = reinterpret_cast<float4*>(mr + head);
    for (int64_t v = static_cast<int64_t>(blockIdx.x) * kSpan + t; v < nv;
         v += static_cast<int64_t>(gridDim.x) * kSpan) {
      float4 pp[kUnroll], gg[kUnroll], mm[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = v + u * kThreads;
        if (i < nv) {
          pp[u] = __ldcs(pv + i);
          gg[u] = __ldcs(gv + i);
          mm[u] = __ldcs(mv + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = v + u * kThreads;
        if (i < nv) {
          sgd(pp[u].x, gg[u].x, mm[u].x, lr, mu);
          sgd(pp[u].y, gg[u].y, mm[u].y, lr, mu);
          sgd(pp[u].z, gg[u].z, mm[u].z, lr, mu);
          sgd(pp[u].w, gg[u].w, mm[u].w, lr, mu);
          __stcs(pv + i, pp[u]);
          __stcs(mv + i, mm[u]);
        }
      }
    }
  }
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
  // blocks that cover a row's vectors, kUnroll each a thread
  long long gx = (P / 4 + kSpan - 1) / kSpan;
  if (gx > 65535) gx = 65535;
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
