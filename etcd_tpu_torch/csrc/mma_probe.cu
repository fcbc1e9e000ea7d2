// Rate probe of the warp-level integer tensor-core instructions the
// raw-CRC kernels can be built on, on NVIDIA Hopper (sm_90a):
//   kind 0: mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
//           (1-bit AND + popcount, 65,536 operations an instruction);
//   kind 1: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
//           (int8, 8,192 operations an instruction).
// Each warp issues `iters` rounds of CHAINS independent products, so the
// rate is set by the instruction's issue rate, not by its latency.  The
// sums go to `out` so that nothing is dropped.  Used by
// etcd_tpu_torch/scripts/mma_rate.py to choose the route of raw_crc.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHAINS = 8;

__device__ __forceinline__ void mma_b1(uint32_t (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(uint32_t (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int KIND>
__global__ void __launch_bounds__(128) probe_kernel(int iters,
                                                    long long* out) {
  const uint32_t s = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  const uint32_t a0 = s, a1 = s ^ 0x5555u, a2 = s * 3u, a3 = ~s;
  const uint32_t b0 = s >> 3, b1 = s ^ 0xF0F0F0F0u;
  uint32_t c[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      if (KIND == 0)
        mma_b1(c[j], a0 + j, a1, a2, a3, b0, b1);
      else
        mma_s8(c[j], a0 + j, a1, a2, a3, b0, b1);
    }
  }
  long long sum = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j)
    sum += (long long)c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

// kind: 0 (1-bit) or 1 (int8); blocks of 128 threads; each warp issues
// iters * CHAINS products.  out: int64 [blocks * 128].  Returns the
// cudaError_t of the launch.
extern "C" int mma_probe_launch(int kind, int blocks, int iters, void* out,
                                void* stream) {
  long long* o = static_cast<long long*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0)
    probe_kernel<0><<<blocks, 128, 0, st>>>(iters, o);
  else if (kind == 1)
    probe_kernel<1><<<blocks, 128, 0, st>>>(iters, o);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Products each warp issues per loop iteration.
extern "C" int mma_probe_chains() { return CHAINS; }
