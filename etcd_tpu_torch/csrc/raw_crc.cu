// Raw CRC32-Castagnoli state of every right-aligned row of a uint8
// [N, L] buffer, on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel etcd_tpu/ops/crc_pallas.py:_kernel, which
// unpacked 8 bit planes in VMEM and contracted them with the [8L, 32]
// contribution matrix C in one int8 MXU matmul.  The function is the
// same: raw(row) = XOR over the set bits (8i + k) of row of C[8i + k],
// with each row of C packed into one 32-bit word.  All-zero rows give 0.
//
// Design.  One thread folds one row; a block of ROWS threads walks its
// rows' columns in passes of CW bytes.  Each pass stages the rows'
// bytes in shared memory (16-byte coalesced loads when the row width
// and base allow it, byte loads otherwise) and the matching slice of a
// nibble table: for each nibble q of the row (q = 2i + h, h = 0 low,
// 1 high) and each value v in [0, 16), tab[q][v] = XOR of the packed C
// words of the set bits of v.  A byte then costs two table reads and
// two XORs instead of eight bit tests.
//   - Bank conflicts: a smem row is CW + 4 bytes (17 words, odd), so
//     the 32 threads of a warp reading the same column of their rows
//     hit 32 different banks.  The table reads of one column all fall
//     in one 16-word run (one run per nibble), so they are conflict
//     free or broadcast whatever the data.
//   - The tables (128 L bytes, 48 KB at L = 384) are uploaded once per
//     (L, device) and read from L2 by every block; shared memory per
//     block is 25 KB whatever L is, so L = 4096 snapshot chunks run in
//     the same kernel.
//
// Bound on one H100 SXM (3.35 TB/s, 1,979 int8 TOP/s).  At the slice's
// shape, N = 1,048,576 and L = 384, the function must read 403 MB of
// rows and 12 KB of packed C and write 4 MB of uint32 states: 0.121 ms
// at the memory rate.  The int8 tensor-core form of the same contraction
// (2 N 8L 32 = 2.1e11 ops) would take 0.10 ms, so the function is bound
// by bytes.  This kernel writes its states as int64 (8 MB, the port's
// carrier for uint32) and reads 48 KB of nibble tables: about 1% more
// traffic than the bound counts, a known cost.  This kernel does not
// use the tensor cores: its fold costs about 8 integer instructions a
// byte, some 3e9 in all, which at Hopper's integer rate (132 SMs x 64
// lanes x ~1.7 GHz, ~1.4e13/s) is ~0.2 ms, so it is likely bound by the
// integer ALUs and not by memory.  The int8 tensor-core form of the same
// contraction is csrc/planes_crc.cu.
//
// Rows per block.  raw_crc_launch_rows takes 128, 256 or 512; the main
// path runs 256.  The choice is the port's counterpart of the tile swept
// by scripts/pallas_sweep.py:make_pallas_concat (TPU kernel 5).  Shared memory is static: ROWS * 68 B of staged rows plus
// 8 KB of nibble tables, 43,008 B at 512 rows, under the 48 KB static
// limit.  The TPU's tiles of 1024-2048 rows do not carry over: here a
// tile is a block of one thread a row, and 1024 threads of 68-byte rows
// would pass that limit and leave a few blocks on each SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CW = 64;           // bytes of each row staged per pass
constexpr int STRIDE = CW + 4;   // padded shared-memory row, in bytes

// ROWS: rows per block, one thread per row.
template <int ROWS>
__global__ void __launch_bounds__(ROWS)
raw_crc_kernel(const uint8_t* __restrict__ buf,
               const uint32_t* __restrict__ tab,
               long long* __restrict__ out, long long n, int length,
               int vec) {
  __shared__ __align__(16) uint8_t tile[ROWS * STRIDE];
  __shared__ uint32_t ntab[CW * 32];  // 2 nibbles x 16 values a byte

  const int t = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * ROWS;
  const int rows = (int)min((long long)ROWS, n - r0);
  const uint8_t* base = buf + r0 * length;
  uint32_t acc = 0;

  for (int c0 = 0; c0 < length; c0 += CW) {
    const int cw = min(CW, length - c0);
    const int cw4 = (cw + 3) & ~3;  // whole words; the rest is zeros
    __syncthreads();  // the previous pass is done with tile and ntab

    const uint32_t* tsrc = tab + (size_t)c0 * 32;
    for (int i = t; i < cw4 * 32; i += ROWS)
      ntab[i] = i < cw * 32 ? tsrc[i] : 0u;

    if (vec) {  // length % 16 == 0 and a 16-byte aligned base
      const int per_row = cw / 16;
      for (int p = t; p < rows * per_row; p += ROWS) {
        const int r = p / per_row, q = p - r * per_row;
        const uint4 v = *reinterpret_cast<const uint4*>(
            base + (long long)r * length + c0 + q * 16);
        uint32_t* dst =
            reinterpret_cast<uint32_t*>(tile + r * STRIDE + q * 16);
        dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
      }
    } else {
      for (int p = t; p < rows * cw4; p += ROWS) {
        const int r = p / cw4, q = p - r * cw4;
        tile[r * STRIDE + q] =
            q < cw ? base[(long long)r * length + c0 + q] : (uint8_t)0;
      }
    }
    __syncthreads();

    if (t < rows) {
      const uint8_t* row = tile + t * STRIDE;
      for (int j = 0; j < cw4; j += 4) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(row + j);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t b = (w >> (8 * k)) & 0xFFu;
          const uint32_t* nt = ntab + (j + k) * 32;
          acc ^= nt[b & 15u] ^ nt[16 + (b >> 4)];
        }
      }
    }
  }
  if (t < rows) out[r0 + t] = (long long)acc;
}

template <int ROWS>
int launch(const void* buf, const void* tab, void* out, long long n,
           int length, void* stream) {
  const int vec =
      (length % 16 == 0) && ((uintptr_t)buf % 16 == 0) ? 1 : 0;
  const long long blocks = (n + ROWS - 1) / ROWS;
  raw_crc_kernel<ROWS><<<(unsigned)blocks, ROWS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(buf), static_cast<const uint32_t*>(tab),
      static_cast<long long*>(out), n, length, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// buf: uint8 [n, length] contiguous; tab: uint32 [2 * length * 16]
// nibble tables; out: int64 [n]; rows: rows per block, 128, 256 or 512.
// Launches on `stream` and returns the cudaError_t of the launch (0 on
// success; cudaErrorInvalidValue for another `rows`).  n >= 1,
// length >= 1.
extern "C" int raw_crc_launch_rows(const void* buf, const void* tab,
                                   void* out, long long n, int length,
                                   int rows, void* stream) {
  switch (rows) {
    case 128: return launch<128>(buf, tab, out, n, length, stream);
    case 256: return launch<256>(buf, tab, out, n, length, stream);
    case 512: return launch<512>(buf, tab, out, n, length, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
