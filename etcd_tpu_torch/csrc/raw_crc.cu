// Raw CRC32-Castagnoli state of every right-aligned row of a uint8
// [N, L] buffer, on the 1-bit tensor cores of NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel etcd_tpu/ops/crc_pallas.py:_kernel (via
// raw_crc_pallas), which unpacked 8 bit planes in VMEM and contracted
// them with the [8L, 32] contribution matrix C in one int8 MXU matmul,
// and its swept-tile form scripts/pallas_sweep.py:make_pallas_concat
// (here the `rows` argument).  The function: raw(row) = parity of
// bits(row) . C[:, j] for each output bit j, packed LSB first.  All-zero
// rows give 0.
//
// Bound on one H100 SXM (3.35 TB/s; NVIDIA H100 80GB HBM3 at 700 W).  At
// N = 1,048,576 and L = 384 the function must read 402,653,184 B of rows
// and 12 KB of packed C and write 4 MB of uint32 states: 406,859,776 B,
// 0.1215 ms at the memory rate.  It is bound by bytes.
//
// The earlier design (one thread a row, two nibble-table lookups a byte)
// took 0.337-0.381 ms, 32-36% of the bound: about 8-9 integer
// instructions a byte, some 3.2e9 in all, so it was bound by instruction
// issue; and every 64-byte pass restaged the rows and an 8 KB slice of
// the tables through shared memory behind two barriers.
//
// This design takes the per-byte instructions away.  The GF(2)
// contraction is a popcount of AND over bits, which one warp instruction
// does for a 16 x 8 x 256-bit tile:
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc.
// scripts/mma_rate.py measured it on an NVIDIA H100 80GB HBM3 (700.00 W)
// at 134 instructions a ns, the same instruction rate as the int8
// m16n8k32 form (8,777 against 1,100 TOP/s), compiled to a native
// BMMA.168256.AND.POPC.  A 1M x 384 contraction is 3.1e6 of them, about
// 24 us of the card, so the kernel is left bound by bytes.
//   - A operand: the row's bytes as they lie in memory.  A little-endian
//     32-bit word holds bit k of byte i at bit 8(i mod 4) + k, which is
//     contraction index 8i + k, row 8i + k of C.  Nothing is unpacked.
//   - B operand: C transposed and packed to bits, column j's byte i
//     holding C[8i + k, j] at bit k: [32, Lp] bytes, Lp = L rounded up to
//     128 with zero bytes past L (12 KB at L = 384, 128 KB at 4096).  Built
//     on the host, uploaded once per (L, device), copied into shared
//     memory once per block and kept there; never restaged.  Bytes past L
//     meet zero B bits, so whatever A holds there adds nothing.
//   - Fragments: a thread (group g = lane / 4, t = lane % 4) reads 16
//     contiguous bytes of its row at c0 + 16t and at c0 + 64 + 16t of a
//     128-byte chunk and feeds them, word by word, to four k-steps; B is
//     read with the same byte mapping, so the contraction index means the
//     same bytes for every row and column of each product.
//   - Epilogue: parity is acc & 1; a thread holds 8 of a row's 32 bits,
//     the four lanes of a quad OR theirs together with __shfl_xor, and
//     one int64 is written a row.
//   - Loop: a persistent grid of 4-warp blocks.  Each warp walks tiles of
//     `rows` rows (16, 32 or 64) with its own ring of 2-4 stages in shared
//     memory: a tile of R rows is R*L contiguous bytes, so one
//     cp.async.bulk with an mbarrier brings it in while the tiles before it
//     are multiplied.  No block-wide barrier after the start.
//   - Bank conflicts: B's smem column stride is Lp + 64, so a
//     quarter-warp's two columns fall on distinct banks.  A quarter-warp
//     also reads rows g and g + 1 of a stage, L bytes apart, which share
//     banks when L mod 128 is near 0 (L = 384).  Reading odd rows' two
//     pieces in the other order removes that 2-way conflict, but it
//     moved no rows value by more than 1.3% (scripts/kernel_probe.py,
//     both versions in one call; NVIDIA H100 80GB HBM3 at 700.00 W), so
//     the kernel does not do it.
//   - Edge cases: a base that is not 16-byte aligned, L % 16 != 0, or an L
//     whose stages do not fit beside B (L > ~1 KB) take the direct path:
//     the same products with the fragments read straight from device
//     memory (16-byte loads where aligned, byte loads otherwise, zeros
//     past L and past N).  It is not the plain version.
//
// Prediction (before the first run on the card): 0.14-0.20 ms at
// 1M x 384 (60-85% of the bound), at every rows value within 15%.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W: chip_smoke.py (one
// launch at a time, the launch's host cost included) 0.163-0.179 ms at
// 32 rows a tile (68-74% of the bound), 0.169-0.180 and 0.174-0.184 ms
// at 16 and 64; scripts/kernel_probe.py (10 launches back to back)
// 0.148-0.150 ms at 32 rows (81-82%, 2.7 TB/s of rows).  The
// nibble-table fold took 0.337 ms.  SASS (kernel_probe.py sass): a
// native BMMA.168256.AND.POPC, 85 integer instructions to 32 BMMA in the
// bulk path's tile loop at 32 rows, no local memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 128;                 // bytes of a row a step
constexpr int SMEM_MAX = 232448;           // a block's dynamic smem, sm_90
constexpr int MAX_STAGES = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes of a row at column `col`, read straight from device memory:
// zeros at and past `length`; 16-byte loads when `vec` (length % 16 == 0
// and an aligned base), byte loads otherwise.
__device__ __forceinline__ uint4 piece_direct(const uint8_t* row, int col,
                                              int length, int vec) {
  if (col >= length) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + col));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (col + j < length) w[j >> 2] |= (uint32_t)row[col + j] << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The products of one tile of T rows against the resident B, and its
// states written to out[r0 ..].  BULK: `rows` points at the tile in
// shared memory (row r at r * length, always readable to the chunk's
// end); else at the tile in device memory, rows past `valid` read as 0.
template <int T, bool BULK>
__device__ __forceinline__ void tile_crc(const uint8_t* rows, int valid,
                                         const uint8_t* bs, int sb, int lp,
                                         int length, int vec,
                                         long long* out, long long r0) {
  constexpr int M = T / 16;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int acc[M][4][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][nt][i] = 0;

#pragma unroll 1
  for (int c0 = 0; c0 < lp; c0 += CHUNK) {
    uint4 q0[4], q1[4];
    const uint8_t* bp = bs + g * sb + c0 + 16 * t;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      q0[nt] = *reinterpret_cast<const uint4*>(bp + nt * 8 * sb);
      q1[nt] = *reinterpret_cast<const uint4*>(bp + nt * 8 * sb + 64);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      uint4 p0, p1, x0, x1;  // rows g and g + 8: bytes 16t.., 64 + 16t..
      const int ra = m * 16 + g, rb = ra + 8;
      if constexpr (BULK) {
        const uint8_t* a = rows + (long long)ra * length + c0 + 16 * t;
        const uint8_t* b = rows + (long long)rb * length + c0 + 16 * t;
        p0 = *reinterpret_cast<const uint4*>(a);
        p1 = *reinterpret_cast<const uint4*>(a + 64);
        x0 = *reinterpret_cast<const uint4*>(b);
        x1 = *reinterpret_cast<const uint4*>(b + 64);
      } else {
        const uint4 z = make_uint4(0u, 0u, 0u, 0u);
        const uint8_t* a = rows + (long long)ra * length;
        const uint8_t* b = rows + (long long)rb * length;
        const int col = c0 + 16 * t;
        p0 = ra < valid ? piece_direct(a, col, length, vec) : z;
        p1 = ra < valid ? piece_direct(a, col + 64, length, vec) : z;
        x0 = rb < valid ? piece_direct(b, col, length, vec) : z;
        x1 = rb < valid ? piece_direct(b, col + 64, length, vec) : z;
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_b1(acc[m][nt], p0.x, x0.x, p0.y, x0.y, q0[nt].x, q0[nt].y);
        mma_b1(acc[m][nt], p0.z, x0.z, p0.w, x0.w, q0[nt].z, q0[nt].w);
        mma_b1(acc[m][nt], p1.x, x1.x, p1.y, x1.y, q1[nt].x, q1[nt].y);
        mma_b1(acc[m][nt], p1.z, x1.z, p1.w, x1.w, q1[nt].z, q1[nt].w);
      }
    }
  }

  // acc[m][nt]: {row g, row g, row g + 8, row g + 8} x columns
  // nt * 8 + 2t + {0, 1}
#pragma unroll
  for (int m = 0; m < M; ++m) {
    uint32_t lo = 0u, hi = 0u;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int j = nt * 8 + 2 * t;
      lo |= ((uint32_t)acc[m][nt][0] & 1u) << j;
      lo |= ((uint32_t)acc[m][nt][1] & 1u) << (j + 1);
      hi |= ((uint32_t)acc[m][nt][2] & 1u) << j;
      hi |= ((uint32_t)acc[m][nt][3] & 1u) << (j + 1);
    }
    lo |= __shfl_xor_sync(0xFFFFFFFFu, lo, 1);
    lo |= __shfl_xor_sync(0xFFFFFFFFu, lo, 2);
    hi |= __shfl_xor_sync(0xFFFFFFFFu, hi, 1);
    hi |= __shfl_xor_sync(0xFFFFFFFFu, hi, 2);
    const int r = m * 16 + g + (t == 1 ? 8 : 0);
    if (t < 2 && r < valid) out[r0 + r] = (long long)(t == 0 ? lo : hi);
  }
}

template <int T, bool BULK>
__global__ void __launch_bounds__(THREADS)
raw_crc_kernel(const uint8_t* __restrict__ buf,
               const uint8_t* __restrict__ bcols, long long* __restrict__ out,
               long long n, int length, int lp, int stages, int vec) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int sb = lp + 64;  // B's smem column stride
  uint8_t* bs = smem;
  const int stage_bytes = ((T * length + 127) & ~127) + CHUNK;
  uint8_t* ring = smem + 32 * sb;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      ring + (BULK ? WARPS * stages * stage_bytes : 0));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // B, once a block
  const int per_col = lp / 16;
  for (int i = threadIdx.x; i < 32 * per_col; i += THREADS) {
    const int col = i / per_col, q = i - col * per_col;
    *reinterpret_cast<uint4*>(bs + col * sb + q * 16) =
        __ldg(reinterpret_cast<const uint4*>(bcols + (size_t)col * lp) + q);
  }
  if (BULK && threadIdx.x == 0) {
    for (int i = 0; i < WARPS * stages; ++i) bar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long ntiles = (n + T - 1) / T;
  const long long first = (long long)blockIdx.x * WARPS + warp;
  const long long step = (long long)gridDim.x * WARPS;

  if constexpr (BULK) {
    uint8_t* mine = ring + warp * stages * stage_bytes;
    uint64_t* mbar = bars + warp * stages;
    auto issue = [&](long long tile, int s) {
      const long long r0 = tile * T;
      const long long cnt = min((long long)T, n - r0);
      bulk_load(mine + s * stage_bytes, buf + r0 * length,
                (uint32_t)(cnt * length), mbar + s);
    };
    if (lane == 0)
      for (int s = 0; s < stages; ++s)
        if (first + s * step < ntiles) issue(first + s * step, s);
    int it = 0;
    for (long long tile = first; tile < ntiles; tile += step, ++it) {
      const int s = it % stages;
      bar_wait(mbar + s, (uint32_t)((it / stages) & 1));
      const long long r0 = tile * T;
      tile_crc<T, true>(mine + s * stage_bytes,
                        (int)min((long long)T, n - r0), bs, sb, lp, length,
                        vec, out, r0);
      __syncwarp();
      const long long next = tile + (long long)stages * step;
      if (lane == 0 && next < ntiles) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(next, s);
      }
    }
  } else {
    for (long long tile = first; tile < ntiles; tile += step) {
      const long long r0 = tile * T;
      tile_crc<T, false>(buf + r0 * length, (int)min((long long)T, n - r0),
                         bs, sb, lp, length, vec, out, r0);
    }
  }
}

template <int T, bool BULK>
int launch(const uint8_t* buf, const uint8_t* bcols, long long* out,
           long long n, int length, int lp, int stages, int smem, int vec,
           cudaStream_t stream) {
  auto kernel = raw_crc_kernel<T, BULK>;
  int resident = 0;
  const cudaError_t e = resident_blocks(kernel, THREADS, smem, &resident);
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = (n + T - 1) / T;
  const long long want = (ntiles + WARPS - 1) / WARPS;
  const int blocks = (int)min(want, (long long)resident);
  kernel<<<blocks, THREADS, smem, stream>>>(buf, bcols, out, n, length, lp,
                                            stages, vec);
  return (int)cudaGetLastError();
}

template <int T>
int launch_rows(const void* buf, const void* bcols, void* out, long long n,
                int length, cudaStream_t stream) {
  const int lp = (length + CHUNK - 1) / CHUNK * CHUNK;
  const int bbytes = 32 * (lp + 64);
  const int vec = (length % 16 == 0) && ((uintptr_t)buf % 16 == 0) ? 1 : 0;
  const int stage_bytes = ((T * length + 127) & ~127) + CHUNK;
  const int room = SMEM_MAX - bbytes - WARPS * MAX_STAGES * 8;
  const int stages = min(MAX_STAGES, room / (WARPS * stage_bytes));
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  const uint8_t* c = static_cast<const uint8_t*>(bcols);
  long long* o = static_cast<long long*>(out);
  if (vec && stages >= 2) {
    const int smem = bbytes + WARPS * stages * stage_bytes + WARPS * stages * 8;
    return launch<T, true>(b, c, o, n, length, lp, stages, smem, vec, stream);
  }
  return launch<T, false>(b, c, o, n, length, lp, 0, bbytes, vec, stream);
}

}  // namespace

// buf: uint8 [n, length] contiguous; bcols: uint8 [32, Lp], Lp = length
// rounded up to 128, column j's byte i holding bit k of C[8i + k, j] and
// zeros past length, 16-byte aligned; out: int64 [n]; rows: rows per
// warp tile, 16, 32 or 64.  Launches on `stream` and returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for
// another `rows`).  n >= 1, 1 <= length <= 4096.
extern "C" int raw_crc_launch_rows(const void* buf, const void* bcols,
                                   void* out, long long n, int length,
                                   int rows, void* stream) {
  if (length < 1 || length > 4096) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
    case 16: return launch_rows<16>(buf, bcols, out, n, length, s);
    case 32: return launch_rows<32>(buf, bcols, out, n, length, s);
    case 64: return launch_rows<64>(buf, bcols, out, n, length, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
