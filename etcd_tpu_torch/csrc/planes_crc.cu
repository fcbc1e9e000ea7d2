// Raw CRC32-Castagnoli state of every right-aligned row of a uint8
// [N, L] buffer, as eight bit-plane matrix products on the tensor cores
// of NVIDIA Hopper (sm_90a).
//
// Replaces three TPU kernels, which compute one function:
//   - etcd_tpu/ops/crc_variants.py:_pallas_planes_kernel (via
//     _pallas_planes_jit, raw_crc_pallas_planes, pallas_planes_perturbed):
//     out[T, 32] = sum over k of bits_k(buf ^ perturb)[T, L] @ C_k[L, 32],
//     8 accumulating int8 MXU products, parity `& 1`;
//   - crc_variants.py:_pallas_planes_t_kernel, the same in the [32, T]
//     orientation (C_k^T @ bits_k^T): here the `transposed` argument;
//   - scripts/pallas_sweep.py:make_pallas_planes.kernel, the same with a
//     swept tile and an int8 or bf16 operand type: here `tile` and
//     `operand`.
// C_k [L, 32] is plane k's slice of the contribution matrix (row i = the
// raw-CRC contribution of bit k of byte i), so raw(row ^ p) = parity of
// sum_k bits_k(row ^ p) @ C_k, packed LSB first into 32 bits.  All-zero
// rows give 0.
//
// Design (simple and right first; not tuned).
//   - A block of WARPS = 4 warps owns `tile` rows (a multiple of 64) and
//     walks them in passes of 64 rows, 16 rows a warp.  Each warp keeps
//     its 16 x 32 sums in two 16 x 16 WMMA accumulators.
//   - The contraction dimension is streamed in chunks of KC = 64 bytes of
//     each row: for each chunk the block stages, in shared memory, the 8
//     bit planes of its 64 rows and the 8 planes' 64 x 32 slices of C_k.
//     C_k at L = 4096 is 1 MiB and could never be resident; streaming it
//     makes any L work.  Columns at or past L stage zero C rows, so what
//     sits in the planes there adds nothing.
//   - Bit planes straight from packed bytes: four bytes of a row in one
//     register give plane k as ((w ^ perturb * 0x01010101) >> k) &
//     0x01010101, one XOR, one shift and one AND for four 0/1 int8
//     operands; for bf16 the same bits widen to 0x3F80 (1.0).
//   - Tensor cores through nvcuda::wmma m16n16k16: s8 operands with int32
//     accumulators, or bf16 operands with float32 accumulators.  Every
//     16-wide K slice is its own run of 16-element rows in shared memory
//     (ldm = 16 elements = 16 or 32 bytes), so every fragment pointer
//     lies on a 256-bit boundary as WMMA requires.
//   - Orientation: transposed == 0 runs A = planes [rows x K] row-major,
//     B = C_k [K x 32] row-major, acc [rows x 32].  transposed == 1 runs
//     A = C_k^T [32 x K] (the same staged C read column-major), B = the
//     planes read column-major as [K x rows], acc [32 x rows], stored
//     column-major so that the epilogue reads the same [rows x 32] tile.
//   - Epilogue: accumulators to shared memory, `& 1`, and one lane a row
//     packs its 32 bits (columns read rotated by lane: no bank conflict).
//     States are written as int64, the port's carrier of uint32; the
//     ragged last pass is masked.
//   - Exactness: a sum is a count of at most 8L <= 32,768 ones, exact in
//     int32 and in float32.
//
// Bound on one H100 SXM (3.35 TB/s; 1,979 int8 TOP/s; 989 bf16 TFLOP/s).
// The function is kernel 1's (csrc/raw_crc.cu): at N = 1,048,576 and
// L = 384 it must read 402,653,184 B of rows and 12 KB of packed C and
// write 4 MB of uint32 states, 406,859,776 B, 0.1215 ms at the memory
// rate; its contraction, 2 N 8L 32 = 2.06e11 operations, takes 0.104 ms
// at the int8 rate and 0.208 ms at the bf16 rate.  So the int8 form is
// bound by bytes and the bf16 form by operations.
//
// What bounds this kernel, predicted before its first run on the card:
// not HBM.  Each 64-row pass restages every 64-byte chunk of C (16 KB
// int8, 32 KB bf16, read from L2) for 4 KB of row bytes, 1.6 GB of L2
// reads at 1M x 384 in int8; and each WMMA product reads its fragments
// from shared memory, about 10 GB in all.  Warp-level mma.sync also
// reaches only part of the tensor cores' rate (wgmma is needed for all
// of it).  Prediction at 1M x 384: int8 0.5-1.0 ms, bf16 1.0-2.0 ms,
// both slower than raw_crc.cu (0.34 ms), the transposed orientation
// within 10% of the other, tiles within 20% of each other.
//
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W, tile 1024:
// int8 2.72 ms (4.5% of the bound), bf16 4.84 ms, the transposed forms
// within 1% (int8) and 3% (bf16) of them, tiles 512-2048 within 1.5% of
// each other; raw_crc.cu took 0.34 ms in the same run.  Far slower than
// predicted, and the tile hardly matters, so neither the tensor cores
// nor HBM set the time.  What the redesign should look at: each chunk's
// staging loads wait behind two barriers, with few warps to hide them
// (shared memory allows 3 blocks of 4 warps an SM in int8, 2 in bf16);
// C is restaged from L2 for every 64-row pass; and integer mma.sync
// takes A row-major and B column-major only, so in either orientation
// one int8 operand is gathered from shared memory byte by byte (the
// SASS shows LDS.U8 and PRMT feeding the IMMA instructions).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int PASS = 16 * WARPS;  // rows per pass, 16 a warp
constexpr int KC = 64;            // bytes of each row per K-chunk
constexpr int KS = KC / 16;       // 16-wide K slices per chunk
constexpr int WORDS = KC / 4;     // 4-byte words of a row per chunk

template <typename T> struct Acc;
template <> struct Acc<signed char> { using type = int; };
template <> struct Acc<__nv_bfloat16> { using type = float; };

// Shared memory: planes [8][KS][PASS][16], C chunk [8][2][KC][16] (plane
// k, 16-column half nb, byte i, column), sums [PASS][32].
template <typename T>
constexpr int smem_bytes() {
  return (8 * KS * PASS * 16 + 8 * 2 * KC * 16) * (int)sizeof(T) +
         PASS * 32 * 4;
}

// Four 0/1 operands (one per byte of p) into the staged plane.
__device__ __forceinline__ void put_plane(signed char* dst, uint32_t p) {
  *reinterpret_cast<uint32_t*>(dst) = p;
}
__device__ __forceinline__ void put_plane(__nv_bfloat16* dst, uint32_t p) {
  uint2 v;  // bf16 1.0 is 0x3F80
  v.x = (p & 1u) * 0x3F80u | ((p >> 8) & 1u) * 0x3F800000u;
  v.y = ((p >> 16) & 1u) * 0x3F80u | ((p >> 24) & 1u) * 0x3F800000u;
  *reinterpret_cast<uint2*>(dst) = v;
}

template <bool TRANS, typename T>
__global__ void __launch_bounds__(THREADS)
planes_crc_kernel(const uint8_t* __restrict__ buf, const T* __restrict__ ck,
                  long long* __restrict__ out, long long n, int length,
                  int tile, uint32_t pmask, int vec) {
  using A = typename Acc<T>::type;
  using LA = typename std::conditional<TRANS, wmma::col_major,
                                       wmma::row_major>::type;
  using LB = LA;
  extern __shared__ __align__(128) unsigned char smem[];
  T* planes = reinterpret_cast<T*>(smem);
  T* cs = planes + 8 * KS * PASS * 16;
  A* sums = reinterpret_cast<A*>(cs + 8 * 2 * KC * 16);

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long b0 = (long long)blockIdx.x * tile;
  const long long b1 = min(b0 + (long long)tile, n);

  for (long long r0 = b0; r0 < b1; r0 += PASS) {
    const int rows = (int)min((long long)PASS, b1 - r0);
    wmma::fragment<wmma::accumulator, 16, 16, 16, A> acc[2];
    wmma::fill_fragment(acc[0], (A)0);
    wmma::fill_fragment(acc[1], (A)0);

    for (int c0 = 0; c0 < length; c0 += KC) {
      __syncthreads();  // the previous chunk's products are done

      // the rows' bytes -> 8 bit planes
      for (int p = t; p < PASS * WORDS; p += THREADS) {
        const int r = p / WORDS, q = p - r * WORDS;
        const int col = c0 + 4 * q;
        uint32_t w = 0;
        if (r < rows && col < length) {
          const uint8_t* src = buf + (r0 + r) * (long long)length + col;
          if (vec && col + 4 <= length) {
            w = *reinterpret_cast<const uint32_t*>(src);
          } else {
            for (int j = 0; j < 4 && col + j < length; ++j)
              w |= (uint32_t)src[j] << (8 * j);
          }
        }
        w ^= pmask;  // bytes past L or n meet zero C rows or are dropped
        T* dst = planes + ((q >> 2) * PASS + r) * 16 + (q & 3) * 4;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          put_plane(dst + k * KS * PASS * 16, (w >> k) & 0x01010101u);
      }

      // the chunk of C_k, 16 elements (one or two uint4) at a time
      constexpr int U = (int)sizeof(T);
      for (int p = t; p < 8 * 2 * KC * U; p += THREADS) {
        const int u = p % U;
        const int i = (p / U) % KC;
        const int nb = (p / (U * KC)) & 1;
        const int k = p / (U * KC * 2);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (c0 + i < length)
          v = reinterpret_cast<const uint4*>(
              ck + ((size_t)k * length + c0 + i) * 32 + nb * 16)[u];
        reinterpret_cast<uint4*>(cs + ((k * 2 + nb) * KC + i) * 16)[u] = v;
      }
      __syncthreads();

      const int ks = min(KS, (length - c0 + 15) / 16);
#pragma unroll 1
      for (int k = 0; k < 8; ++k) {
        for (int s = 0; s < ks; ++s) {
          const T* pl = planes + ((k * KS + s) * PASS + warp * 16) * 16;
          const T* c = cs + (k * 2 * KC + s * 16) * 16;
          if constexpr (!TRANS) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> a;
            wmma::load_matrix_sync(a, pl, 16);
#pragma unroll
            for (int nb = 0; nb < 2; ++nb) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> b;
              wmma::load_matrix_sync(b, c + nb * KC * 16, 16);
              wmma::mma_sync(acc[nb], a, b, acc[nb]);
            }
          } else {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> b;
            wmma::load_matrix_sync(b, pl, 16);
#pragma unroll
            for (int mb = 0; mb < 2; ++mb) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> a;
              wmma::load_matrix_sync(a, c + mb * KC * 16, 16);
              wmma::mma_sync(acc[mb], a, b, acc[mb]);
            }
          }
        }
      }
    }

    // sums -> [rows x 32] in shared memory; this warp's 16 rows only
    A* mine = sums + warp * 16 * 32;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      wmma::store_matrix_sync(mine + h * 16, acc[h], 32,
                              TRANS ? wmma::mem_col_major
                                    : wmma::mem_row_major);
    __syncwarp();
    if (lane < 16 && warp * 16 + lane < rows) {
      const A* a = mine + lane * 32;
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int jj = (j + lane) & 31;
        word |= ((uint32_t)(int)a[jj] & 1u) << jj;
      }
      out[r0 + warp * 16 + lane] = (long long)word;
    }
    __syncwarp();
  }
}

template <bool TRANS, typename T>
int launch(const void* buf, const void* ck, void* out, long long n,
           int length, int tile, uint32_t pmask, int vec,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      planes_crc_kernel<TRANS, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (n + tile - 1) / tile;
  planes_crc_kernel<TRANS, T><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      static_cast<const uint8_t*>(buf), static_cast<const T*>(ck),
      static_cast<long long*>(out), n, length, tile, pmask, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// buf: uint8 [n, length] contiguous; ck: the plane matrices [8, length,
// 32], int8 (operand 0) or bf16 (operand 1), contiguous and 16-byte
// aligned; out: int64 [n].  tile: rows per block, a multiple of 64;
// transposed: 0 or 1; perturb: a byte XORed into every byte of buf.
// Launches on `stream` and returns the cudaError_t of the launch (0 on
// success; cudaErrorInvalidValue for an argument it does not take).
// n >= 1, length >= 1.
extern "C" int planes_crc_launch(const void* buf, const void* ck, void* out,
                                 long long n, int length, int tile,
                                 int transposed, int operand, int perturb,
                                 void* stream) {
  if (tile <= 0 || tile % PASS != 0 || perturb < 0 || perturb > 255)
    return (int)cudaErrorInvalidValue;
  const uint32_t pmask = (uint32_t)perturb * 0x01010101u;
  const int vec = (length % 4 == 0) && ((uintptr_t)buf % 4 == 0) ? 1 : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (operand == 0)
    return transposed
               ? launch<true, signed char>(buf, ck, out, n, length, tile,
                                           pmask, vec, s)
               : launch<false, signed char>(buf, ck, out, n, length, tile,
                                            pmask, vec, s);
  if (operand == 1)
    return transposed
               ? launch<true, __nv_bfloat16>(buf, ck, out, n, length, tile,
                                             pmask, vec, s)
               : launch<false, __nv_bfloat16>(buf, ck, out, n, length,
                                              tile, pmask, vec, s);
  return (int)cudaErrorInvalidValue;
}
