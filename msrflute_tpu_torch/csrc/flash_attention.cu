// Flash attention for Hopper (sm_90a): the forward (B4), the dq pass (B5)
// and the dk/dv pass (B6), f32 on CUDA cores, in one library.
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
// Layouts: q, k, v, out, dO, dq, dk, dv are contiguous [B, L, H, D] float32
// (the JAX public layout; no transpose to [B, H, L, D] is made); lse,
// delta and glse are contiguous [B, H, Lq] float32.
//
// Bound on the H100: at the RingLM path's [40, 1023, 4, 32] causal each
// pass reads a few tens of MB and does 1.1e10 (B4), 1.6e10 (B5) and
// 2.1e10 (B6) flops a layer, so all three are bound by operations: about
// 0.16, 0.24 and 0.32 ms at the 67 TFLOP/s f32 CUDA-core rate (0.02-0.04 ms
// at the 495 TFLOP/s TF32 tensor-core rate, which these kernels do not use).
//
// Design, simple and right first (tensor cores, TMA and a producer warp are
// later work):
// - the TPU kernels' sequential grid axis and its VMEM carry become a loop
//   inside one block: a block of 256 threads owns one (b*h, 64-row query
//   tile) in B4 and B5 and one (b*h, 64-row key tile) in B6, and streams
//   64-row tiles of the other axis through shared memory;
// - 4 threads share a tile row; a thread keeps 16 scores of its row and
//   its quarter of the output row (d = quad + 4j) in registers; row max and
//   row sum are reduced over the 4 lanes with shuffles;
// - shared rows are padded to D + 1 floats (and score tiles to 65) so the
//   warp's reads fall in distinct banks;
// - no atomics: B5 alone writes its dq rows and B6 alone its dk/dv rows,
//   and every sum runs in a fixed order, so two launches are bitwise equal;
// - heavy tiles are scheduled first under the causal mask (the last query
//   tile in B4/B5, the first key tile in B6);
// - shared memory a block: B4 4 * (3 * 64 * (D + 1) + 64 * 65) bytes
//   (41,984 at D = 32; 115,712 at D = 128), B5 4 * (4 * 64 * (D + 1) +
//   64 * 65) (50,432; 148,736), B6 4 * (4 * 64 * (D + 1) + 2 * 64 * 65 +
//   3 * 64) (67,840; 166,144): above 48 KB it is opted in with
//   cudaFuncSetAttribute.  D <= 128; any L (the ragged last tile is masked).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // rows of a tile, both axes
constexpr int kThreads = 256;    // 4 threads per tile row
constexpr int kPerThread = kTile / 4;  // scores a thread keeps
constexpr int kScoreStride = kTile + 1;
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

// rows [row0, row0 + 64) of head h of batch b of a [B, L, H, D] tensor into
// a [64][D + 1] shared tile; rows at or past L are zero (never garbage: a
// masked score multiplies them by 0, and 0 * NaN would poison the sums)
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int b, int h, int row0, int L,
                                          const Dims& p) {
  const int Dp = p.D + 1;
  for (int i = threadIdx.x; i < kTile * p.D; i += kThreads) {
    const int rr = i / p.D, d = i - rr * p.D, row = row0 + rr;
    dst[rr * Dp + d] = row < L ? src[elem(p, b, L, row, h, d)] : 0.0f;
  }
}

__device__ __forceinline__ int64_t stat(const Dims& p, int b, int h,
                                        int row) {
  return (static_cast<int64_t>(b) * p.H + h) * p.Lq + row;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the causal mask at global positions, with padded keys masked
__device__ __forceinline__ bool visible(const Dims& p, int q_loc,
                                        int k_loc) {
  return k_loc < p.Lk &&
         (!p.causal || static_cast<int64_t>(p.q_off) + q_loc >=
                           static_cast<int64_t>(p.k_off) + k_loc);
}

// ---------------------------------------------------------------------
// B4: forward
// ---------------------------------------------------------------------
template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, Dims p) {
  extern __shared__ float smem[];
  const int Dp = p.D + 1;
  float* Qs = smem;
  float* Ks = Qs + kTile * Dp;
  float* Vs = Ks + kTile * Dp;
  float* Ps = Vs + kTile * Dp;  // [64][65]

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int qi = gridDim.y - 1 - blockIdx.y;  // heavy causal tiles first
  const int q0 = qi * kTile;
  const int r = threadIdx.x >> 2, quad = threadIdx.x & 3;
  const int nk = (p.Lk + kTile - 1) / kTile;

  load_tile(Qs, q, b, h, q0, p.Lq, p);
  float m = kNeg, l = 0.0f, acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.0f;

  for (int kj = 0; kj < nk; ++kj) {
    // pallas_attention.py:139: whole key tiles above the diagonal add
    // nothing (block-uniform, so the barriers below stay uniform)
    if (p.causal && !(static_cast<int64_t>(p.k_off) + kj * kTile <=
                      static_cast<int64_t>(p.q_off) + q0 + kTile - 1))
      continue;
    __syncthreads();  // the last tile's readers are done
    load_tile(Ks, k, b, h, kj * kTile, p.Lk, p);
    load_tile(Vs, v, b, h, kj * kTile, p.Lk, p);
    __syncthreads();

    float s[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) s[j] = 0.0f;
    for (int d = 0; d < p.D; ++d) {
      const float qd = Qs[r * Dp + d];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        s[j] += qd * Ks[(quad + 4 * j) * Dp + d];
    }
    float mt = kNeg;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const bool ok = visible(p, q0 + r, kj * kTile + quad + 4 * j);
      s[j] = ok ? s[j] * p.scale : kNeg;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, quad_max(mt));
    float st = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      // masked entries are zeroed explicitly: in a fully masked row
      // s == m_new == -1e30 and exp(0) would resurrect them
      const bool ok = visible(p, q0 + r, kj * kTile + quad + 4 * j);
      const float pj = ok ? expf(s[j] - m_new) : 0.0f;
      Ps[r * kScoreStride + quad + 4 * j] = pj;
      st += pj;
    }
    const float corr = expf(m - m_new);
    l = l * corr + quad_sum(st);
    m = m_new;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] *= corr;
    for (int c = 0; c < kTile; ++c) {
      const float pc = Ps[r * kScoreStride + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = quad + 4 * j;
        if (d < p.D) acc[j] += pc * Vs[c * Dp + d];
      }
    }
  }

  const int row = q0 + r;
  if (row < p.Lq) {
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = quad + 4 * j;
      if (d < p.D) out[elem(p, b, p.Lq, row, h, d)] = acc[j] / lc;
    }
    if (quad == 0) lse[stat(p, b, h, row)] = l > 0.0f ? m + logf(lc) : kNeg;
  }
}

// ---------------------------------------------------------------------
// B5: dq
// ---------------------------------------------------------------------
template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const float* __restrict__ glse, float* __restrict__ dq,
                Dims p) {
  extern __shared__ float smem[];
  const int Dp = p.D + 1;
  float* Qs = smem;
  float* Gs = Qs + kTile * Dp;   // dO
  float* Ks = Gs + kTile * Dp;
  float* Vs = Ks + kTile * Dp;
  float* Ss = Vs + kTile * Dp;   // ds, [64][65]

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int q0 = qi * kTile;
  const int r = threadIdx.x >> 2, quad = threadIdx.x & 3;
  const int row = q0 + r;
  const int nk = (p.Lk + kTile - 1) / kTile;

  load_tile(Qs, q, b, h, q0, p.Lq, p);
  load_tile(Gs, dout, b, h, q0, p.Lq, p);
  float row_lse = 0.0f, row_delta = 0.0f, row_glse = 0.0f;
  if (row < p.Lq) {
    const int64_t i = stat(p, b, h, row);
    row_lse = lse[i];
    row_delta = delta[i];
    row_glse = glse[i];
  }
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.0f;

  for (int kj = 0; kj < nk; ++kj) {
    // pallas_attention.py:201
    if (p.causal && !(static_cast<int64_t>(p.k_off) + kj * kTile <=
                      static_cast<int64_t>(p.q_off) + q0 + kTile - 1))
      continue;
    __syncthreads();
    load_tile(Ks, k, b, h, kj * kTile, p.Lk, p);
    load_tile(Vs, v, b, h, kj * kTile, p.Lk, p);
    __syncthreads();

    float s[kPerThread], dp[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) s[j] = dp[j] = 0.0f;
    for (int d = 0; d < p.D; ++d) {
      const float qd = Qs[r * Dp + d], gd = Gs[r * Dp + d];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int c = (quad + 4 * j) * Dp + d;
        s[j] += qd * Ks[c];
        dp[j] += gd * Vs[c];
      }
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const bool ok = visible(p, row, kj * kTile + quad + 4 * j);
      const float pj = ok ? expf(s[j] * p.scale - row_lse) : 0.0f;
      // d lse / d s = p: the lse cotangent adds straight into ds
      Ss[r * kScoreStride + quad + 4 * j] =
          pj * (dp[j] - row_delta + row_glse) * p.scale;
    }
    __syncthreads();
    for (int c = 0; c < kTile; ++c) {
      const float dsc = Ss[r * kScoreStride + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = quad + 4 * j;
        if (d < p.D) acc[j] += dsc * Ks[c * Dp + d];
      }
    }
  }

  if (row < p.Lq) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = quad + 4 * j;
      if (d < p.D) dq[elem(p, b, p.Lq, row, h, d)] = acc[j];
    }
  }
}

// ---------------------------------------------------------------------
// B6: dk, dv
// ---------------------------------------------------------------------
template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ glse, float* __restrict__ dk,
                 float* __restrict__ dv, Dims p) {
  extern __shared__ float smem[];
  const int Dp = p.D + 1;
  float* Ks = smem;
  float* Vs = Ks + kTile * Dp;
  float* Qs = Vs + kTile * Dp;
  float* Gs = Qs + kTile * Dp;              // dO
  float* Ps = Gs + kTile * Dp;              // p, [key][query], 64 x 65
  float* Ss = Ps + kTile * kScoreStride;    // ds, [key][query]
  float* lse_s = Ss + kTile * kScoreStride;
  float* delta_s = lse_s + kTile;
  float* glse_s = delta_s + kTile;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int ki = blockIdx.y;  // key tile 0 sees the most query tiles
  const int k0 = ki * kTile;
  const int c = threadIdx.x >> 2, quad = threadIdx.x & 3;  // key row c
  const int nq = (p.Lq + kTile - 1) / kTile;

  load_tile(Ks, k, b, h, k0, p.Lk, p);
  load_tile(Vs, v, b, h, k0, p.Lk, p);
  float acc_k[NJ], acc_v[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc_k[j] = acc_v[j] = 0.0f;

  for (int qj = 0; qj < nq; ++qj) {
    // pallas_attention.py:260: query tiles wholly above this key tile's
    // diagonal start see nothing
    if (p.causal && !(static_cast<int64_t>(p.q_off) + (qj + 1) * kTile - 1 >=
                      static_cast<int64_t>(p.k_off) + k0))
      continue;
    const int q0 = qj * kTile;
    __syncthreads();
    load_tile(Qs, q, b, h, q0, p.Lq, p);
    load_tile(Gs, dout, b, h, q0, p.Lq, p);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const bool real = row < p.Lq;
      const int64_t i = real ? stat(p, b, h, row) : 0;
      lse_s[threadIdx.x] = real ? lse[i] : 0.0f;
      delta_s[threadIdx.x] = real ? delta[i] : 0.0f;
      glse_s[threadIdx.x] = real ? glse[i] : 0.0f;
    }
    __syncthreads();

    float s[kPerThread], dp[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) s[i] = dp[i] = 0.0f;
    for (int d = 0; d < p.D; ++d) {
      const float kd = Ks[c * Dp + d], vd = Vs[c * Dp + d];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int qr = (quad + 4 * i) * Dp + d;
        s[i] += Qs[qr] * kd;
        dp[i] += Gs[qr] * vd;
      }
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int rr = quad + 4 * i, q_loc = q0 + rr;
      // padded query rows carry no lse: mask them too
      const bool ok = q_loc < p.Lq && visible(p, q_loc, k0 + c);
      const float pi = ok ? expf(s[i] * p.scale - lse_s[rr]) : 0.0f;
      Ps[c * kScoreStride + rr] = pi;
      Ss[c * kScoreStride + rr] =
          pi * (dp[i] - delta_s[rr] + glse_s[rr]) * p.scale;
    }
    __syncthreads();
    for (int rr = 0; rr < kTile; ++rr) {
      const float pr = Ps[c * kScoreStride + rr];
      const float sr = Ss[c * kScoreStride + rr];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = quad + 4 * j;
        if (d < p.D) {
          acc_v[j] += pr * Gs[rr * Dp + d];
          acc_k[j] += sr * Qs[rr * Dp + d];
        }
      }
    }
  }

  const int row = k0 + c;
  if (row < p.Lk) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = quad + 4 * j;
      if (d < p.D) {
        dk[elem(p, b, p.Lk, row, h, d)] = acc_k[j];
        dv[elem(p, b, p.Lk, row, h, d)] = acc_v[j];
      }
    }
  }
}

// ---------------------------------------------------------------------
// launch plumbing
// ---------------------------------------------------------------------
enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

size_t smem_bytes(int which, int D) {
  const size_t tile = static_cast<size_t>(kTile) * (D + 1);
  const size_t scores = static_cast<size_t>(kTile) * kScoreStride;
  switch (which) {
    case kFwd: return 4 * (3 * tile + scores);
    case kDq: return 4 * (4 * tile + scores);
    default: return 4 * (4 * tile + 2 * scores + 3 * kTile);
  }
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

template <int NJ>
cudaError_t launch(int which, const void* const* ptr, const Dims& p,
                   cudaStream_t stream) {
  static size_t granted[3] = {0, 0, 0};
  const size_t bytes = smem_bytes(which, p.D);
  const int nq = (p.Lq + kTile - 1) / kTile;
  const int nk = (p.Lk + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(p.B * p.H),
                  static_cast<unsigned>(which == kDkv ? nk : nq));
  const float* const* f = reinterpret_cast<const float* const*>(ptr);
  cudaError_t e;
  switch (which) {
    case kFwd:
      e = allow_smem(flash_fwd_kernel<NJ>, bytes, &granted[kFwd]);
      if (e != cudaSuccess) return e;
      flash_fwd_kernel<NJ><<<grid, kThreads, bytes, stream>>>(
          f[0], f[1], f[2], const_cast<float*>(f[3]),
          const_cast<float*>(f[4]), p);
      break;
    case kDq:
      e = allow_smem(flash_dq_kernel<NJ>, bytes, &granted[kDq]);
      if (e != cudaSuccess) return e;
      flash_dq_kernel<NJ><<<grid, kThreads, bytes, stream>>>(
          f[0], f[1], f[2], f[3], f[4], f[5], f[6],
          const_cast<float*>(f[7]), p);
      break;
    default:
      e = allow_smem(flash_dkv_kernel<NJ>, bytes, &granted[kDkv]);
      if (e != cudaSuccess) return e;
      flash_dkv_kernel<NJ><<<grid, kThreads, bytes, stream>>>(
          f[0], f[1], f[2], f[3], f[4], f[5], f[6],
          const_cast<float*>(f[7]), const_cast<float*>(f[8]), p);
      break;
  }
  return cudaGetLastError();
}

int dispatch(int which, const void* const* ptr, int B, int Lq, int Lk,
             int H, int D, int causal, int q_off, int k_off, float scale,
             void* stream) {
  if (D < 1 || D > 128 || B < 0 || H < 0 || Lq < 0 || Lk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = ((which == kDkv ? Lk : Lq) + kTile - 1) / kTile;
  if (static_cast<int64_t>(B) * H > 0x7fffffff || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || tiles == 0) return 0;
  const Dims p{B, Lq, Lk, H, D, causal != 0, q_off, k_off, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D <= 8) e = launch<2>(which, ptr, p, s);
  else if (D <= 16) e = launch<4>(which, ptr, p, s);
  else if (D <= 32) e = launch<8>(which, ptr, p, s);
  else if (D <= 64) e = launch<16>(which, ptr, p, s);
  else e = launch<32>(which, ptr, p, s);
  return static_cast<int>(e);
}

}  // namespace

// Each launcher runs on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).  Offsets are global positions.

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int B, int Lq, int Lk,
                                int H, int D, int causal, int q_off,
                                int k_off, float scale, void* stream) {
  const void* ptr[] = {q, k, v, out, lse};
  return dispatch(kFwd, ptr, B, Lq, Lk, H, D, causal, q_off, k_off, scale,
                  stream);
}

extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* glse, void* dq,
                               int B, int Lq, int Lk, int H, int D,
                               int causal, int q_off, int k_off, float scale,
                               void* stream) {
  const void* ptr[] = {q, k, v, dout, lse, delta, glse, dq};
  return dispatch(kDq, ptr, B, Lq, Lk, H, D, causal, q_off, k_off, scale,
                  stream);
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* glse,
                                void* dk, void* dv, int B, int Lq, int Lk,
                                int H, int D, int causal, int q_off,
                                int k_off, float scale, void* stream) {
  const void* ptr[] = {q, k, v, dout, lse, delta, glse, dk, dv};
  return dispatch(kDkv, ptr, B, Lq, Lk, H, D, causal, q_off, k_off, scale,
                  stream);
}

// shared memory a block of pass `which` (0 B4, 1 B5, 2 B6) uses at D
extern "C" long long flash_smem_bytes(int which, int D) {
  return static_cast<long long>(smem_bytes(which, D));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
