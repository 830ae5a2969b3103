// Probe: what a warp-wide shared-memory load costs an SM of this card, by
// width and by address pattern.  The backward of flash_attention.cu is
// designed on these figures.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o lds_probe \
//       lds_throughput.cu && ./lds_probe
//
// Every block (256 threads, two blocks an SM) makes kLoads loads a thread
// from addresses that depend on the lane as the pattern says, and reads
// the SM's clock before and after.  Printed: SM clocks for each warp-wide
// load instruction, all warps of the SM counted (1.0 means the SM retires
// one such instruction a clock).  The loop's own address arithmetic and
// adds share the schedulers' slots, so a figure is an upper bound of the
// load's cost; it is the differences between patterns that the kernels
// use.  Measured on an NVIDIA H100 80GB HBM3 at 700 W: a 16-byte load costs
// about 2.5 clocks when each quarter warp touches 64 bytes or fewer
// (patterns 0, 1, 4) and 3.7 otherwise (2, 3, 5, 6), whether or not the
// quarters read the same addresses.
#include <cuda_runtime.h>
#include <stdio.h>

constexpr int kThreads = 256, kLoads = 4096, kBlocksPerSm = 2;
constexpr int kRowBytes = 144;  // 36 floats, a row of the kernels' tiles

// byte offset of the lane's address under pattern `pat`
__device__ int lane_offset(int pat, int lane) {
  switch (pat) {
    case 0: return 0;                           // all lanes one address
    case 1: return (lane >> 3) * kRowBytes;     // a quarter warp one address
    case 2: return (lane & 7) * kRowBytes;      // 8 rows in every quarter
    case 3: return lane * 16;                   // 32 pieces, contiguous
    case 4: return ((lane >> 1) & 7) * 16;      // 8 pieces, 4 a quarter
    case 5: return (lane & 7) * 16;             // 8 pieces in every quarter
    default: return (lane & 15) * kRowBytes;    // 16 rows
  }
}

template <int kWidth>  // floats a load: 1, 2 or 4
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
probe(int pat, float* sink, long long* clocks) {
  extern __shared__ float4 smem[];
  for (int i = threadIdx.x; i < 4096; i += kThreads)
    smem[i] = make_float4(i, 1, 2, 3);
  __syncthreads();
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(smem)) +
      lane_offset(pat, threadIdx.x & 31);
  float acc = 0.0f;
  const long long start = clock64();
#pragma unroll 1
  for (int i = 0; i < kLoads; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned a = base + ((i + j) & 63) * 4 * kRowBytes;
      float x, y = 0, z = 0, w = 0;
      if (kWidth == 4)
        asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];"
                     : "=f"(x), "=f"(y), "=f"(z), "=f"(w)
                     : "r"(a));
      else if (kWidth == 2)
        asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];"
                     : "=f"(x), "=f"(y)
                     : "r"(a));
      else
        asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(a));
      acc += x + y + z + w;
    }
  }
  const long long stop = clock64();
  if (threadIdx.x == 0) clocks[blockIdx.x] = stop - start;
  if (acc == 12345.678f) *sink = acc;  // keeps the loads alive
}

template <int kWidth>
void launch(int blocks, size_t bytes, int pat, float* sink,
            long long* clocks) {
  cudaFuncSetAttribute(probe<kWidth>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  for (int rep = 0; rep < 2; ++rep)
    probe<kWidth><<<blocks, kThreads, bytes>>>(pat, sink, clocks);
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  const int blocks = prop.multiProcessorCount * kBlocksPerSm;
  float* sink;
  long long *clocks, *host = new long long[blocks];
  cudaMalloc(&sink, 4);
  cudaMalloc(&clocks, blocks * sizeof(long long));
  const size_t bytes = 4096 * 16 + 64 * 4 * kRowBytes + 4096;
  printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  for (int width : {1, 2, 4})
    for (int pat = 0; pat < 7; ++pat) {
      if (width == 1) launch<1>(blocks, bytes, pat, sink, clocks);
      if (width == 2) launch<2>(blocks, bytes, pat, sink, clocks);
      if (width == 4) launch<4>(blocks, bytes, pat, sink, clocks);
      if (cudaDeviceSynchronize() != cudaSuccess) {
        printf("launch failed\n");
        return 1;
      }
      cudaMemcpy(host, clocks, blocks * sizeof(long long),
                 cudaMemcpyDeviceToHost);
      double mean = 0;
      for (int i = 0; i < blocks; ++i) mean += host[i];
      mean /= blocks;
      // the SM ran kBlocksPerSm blocks of 8 warps side by side
      printf("{\"floats_a_load\": %d, \"pattern\": %d, "
             "\"sm_clocks_a_warp_load\": %.3f}\n",
             width, pat,
             mean / (double(kLoads) * (kThreads / 32) * kBlocksPerSm));
    }
  return 0;
}
