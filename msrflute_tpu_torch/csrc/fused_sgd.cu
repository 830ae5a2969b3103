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
// Storage types.  The JAX kernel takes any float storage: it upcasts p, g
// and m to f32, computes in f32 and stores in the input's type
// (pallas_kernels.py:204-227); the precision policy's `params: bfloat16`
// with pallas_apply feeds it bf16.  So p, g and m are float, __nv_bfloat16
// or __half here (one type for all three; lr, mu and the gate stay f32):
// each element is widened to f32 on load, m' and p' are computed in f32
// exactly as in the f32 arm (p' from the f32 m', not from its rounding),
// and both are rounded to nearest even on store (__float2bfloat16_rn,
// __float2half_rn).  A 16-byte vector then carries 8 elements, not 4.
//
// Bound: one pass that moves 20 bytes per live parameter (read p, g, m;
// write p, m; 4 bytes each; 10 bytes in a 16-bit type) and does 4 flops
// on them, so it is bound by device memory.  CNN_FEMNIST has P =
// 1,206,590 parameters (Conv_0 3*3*1*32+32, Conv_1 3*3*32*64+64, Dense_0
// 9216*128+128, Dense_1 128*62+62); at K = 10 clients a float32 launch
// moves 241,318,000 bytes, about 72 us at the H100 SXM's 3.35 TB/s.
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
//   and RingLM, odd rows start 8 bytes off), then 16-byte loads and stores
//   (4 floats or 8 16-bit values), then a scalar tail of at most 3 (7)
//   elements.  The body needs p, g and m to
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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte loads a tensor a thread in flight
constexpr int64_t kSpan = static_cast<int64_t>(kThreads) * kUnroll;

// the storage types: widen to f32 exactly, narrow rounding to nearest even
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename S>
__device__ __forceinline__ S narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ void sgd(float& p, float g, float& m, float lr,
                                    float mu) {
  m = __fadd_rn(g, __fmul_rn(mu, m));
  p = __fsub_rn(p, __fmul_rn(lr, m));
}

template <typename S>
__device__ __forceinline__ void sgd_at(S* p, const S* g, S* m, int64_t i,
                                       float lr, float mu) {
  float pi = widen(p[i]), mi = widen(m[i]);
  sgd(pi, widen(g[i]), mi, lr, mu);
  p[i] = narrow<S>(pi);
  m[i] = narrow<S>(mi);
}

// one 16-byte vector of each tensor: 4 floats, or 8 16-bit values
__device__ __forceinline__ void sgd_vec(float4& p, const float4& g, float4& m,
                                        float lr, float mu) {
  sgd(p.x, g.x, m.x, lr, mu);
  sgd(p.y, g.y, m.y, lr, mu);
  sgd(p.z, g.z, m.z, lr, mu);
  sgd(p.w, g.w, m.w, lr, mu);
}

template <typename S>
__device__ __forceinline__ void sgd_vec(uint4& p, const uint4& g, uint4& m,
                                        float lr, float mu) {
  S* ps = reinterpret_cast<S*>(&p);
  const S* gs = reinterpret_cast<const S*>(&g);
  S* ms = reinterpret_cast<S*>(&m);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float pe = widen(ps[e]), me = widen(ms[e]);
    sgd(pe, widen(gs[e]), me, lr, mu);
    ps[e] = narrow<S>(pe);
    ms[e] = narrow<S>(me);
  }
}

template <typename S>
struct VecOf {
  using T = uint4;  // 8 16-bit values
  static constexpr int kElems = 8;
};
template <>
struct VecOf<float> {
  using T = float4;
  static constexpr int kElems = 4;
};

template <typename S>
__global__ void __launch_bounds__(kThreads)
fused_sgd_kernel(S* __restrict__ p, const S* __restrict__ g,
                 S* __restrict__ m, const float* __restrict__ gate,
                 int64_t K, int64_t P, float lr, float mu) {
  using V = typename VecOf<S>::T;
  constexpr int kElems = VecOf<S>::kElems;
  const int t = threadIdx.x;
  for (int64_t k = blockIdx.y; k < K; k += gridDim.y) {
    if (!(gate[k] > 0.0f)) continue;  // NaN gates pin too, as in JAX
    S* pr = p + k * P;
    const S* gr = g + k * P;
    S* mr = m + k * P;
    const uintptr_t a = reinterpret_cast<uintptr_t>(pr);
    if (((a ^ reinterpret_cast<uintptr_t>(gr)) |
         (a ^ reinterpret_cast<uintptr_t>(mr))) & 15) {
      // the three rows cannot share 16-byte boundaries: scalar
      for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + t;
           i < P; i += static_cast<int64_t>(gridDim.x) * kThreads)
        sgd_at(pr, gr, mr, i, lr, mu);
      continue;
    }
    int64_t head = static_cast<int64_t>((16 - (a & 15)) & 15) /
                   static_cast<int64_t>(sizeof(S));
    if (head > P) head = P;
    const int64_t nv = (P - head) / kElems;
    const int64_t tail = head + kElems * nv;  // < kElems elements from here
    if (blockIdx.x == 0) {
      if (t < head) sgd_at(pr, gr, mr, t, lr, mu);
      else if (t >= kElems && t - kElems < P - tail)
        sgd_at(pr, gr, mr, tail + t - kElems, lr, mu);
    }
    V* pv = reinterpret_cast<V*>(pr + head);
    const V* gv = reinterpret_cast<const V*>(gr + head);
    V* mv = reinterpret_cast<V*>(mr + head);
    for (int64_t v = static_cast<int64_t>(blockIdx.x) * kSpan + t; v < nv;
         v += static_cast<int64_t>(gridDim.x) * kSpan) {
      V pp[kUnroll], gg[kUnroll], mm[kUnroll];
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
          if constexpr (kElems == 4)
            sgd_vec(pp[u], gg[u], mm[u], lr, mu);
          else
            sgd_vec<S>(pp[u], gg[u], mm[u], lr, mu);
          __stcs(pv + i, pp[u]);
          __stcs(mv + i, mm[u]);
        }
      }
    }
  }
}

template <typename S>
int launch(void* p, const void* g, void* m, const void* gate, long long K,
           long long P, float lr, float mu, cudaStream_t stream) {
  const long long gy = K < 65535 ? K : 65535;
  // blocks that cover a row's vectors, kUnroll each a thread
  long long gx = (P / VecOf<S>::kElems + kSpan - 1) / kSpan;
  if (gx > 65535) gx = 65535;
  if (gx < 1) gx = 1;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  fused_sgd_kernel<S><<<grid, kThreads, 0, stream>>>(
      static_cast<S*>(p), static_cast<const S*>(g), static_cast<S*>(m),
      static_cast<const float*>(gate), static_cast<int64_t>(K),
      static_cast<int64_t>(P), lr, mu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p, m: [K, P], updated in place; g: [K, P]; all three of one storage type
// (`storage`: 0 float, 1 bfloat16, 2 float16); gate: [K] float32; all
// contiguous on the current device.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).  Does not synchronise.
extern "C" int fused_sgd_launch(void* p, const void* g, void* m,
                                const void* gate, long long K, long long P,
                                float lr, float mu, int storage,
                                void* stream) {
  if (K <= 0 || P <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0:
      return launch<float>(p, g, m, gate, K, P, lr, mu, s);
    case 1:
      return launch<__nv_bfloat16>(p, g, m, gate, K, P, lr, mu, s);
    case 2:
      return launch<__half>(p, g, m, gate, K, P, lr, mu, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fused_sgd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
