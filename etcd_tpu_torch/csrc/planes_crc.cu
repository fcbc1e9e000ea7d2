// Raw CRC32-Castagnoli state of every right-aligned row of a uint8
// [N, L] buffer, as eight bit-plane matrix products on the tensor cores
// of NVIDIA Hopper (sm_90a), with the plane matrices kept on chip.
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
// raw-CRC contribution of bit k of byte i).  All-zero rows give 0.
//
// Bound on one H100 SXM (3.35 TB/s; 1,979 int8 TOP/s; 989 bf16 TFLOP/s;
// NVIDIA H100 80GB HBM3 at 700 W).  At N = 1,048,576 and L = 384 the
// function must move 406,859,776 B (0.1215 ms); its contraction,
// 2 N 8L 32 = 2.06e11 operations, takes 0.104 ms at the int8 rate and
// 0.208 ms at the bf16 rate.  The int8 form is bound by bytes, the bf16
// form by operations.
//
// The earlier design (WMMA m16n16k16 on 64-row passes) took 2.72 ms in
// int8 and 4.84 ms in bf16, 4.5% and 4.3% of the bound: every 64-row
// pass restaged a 64-byte chunk of all eight C_k from L2 (16 KB of C for
// 4 KB of rows), the planes went through shared memory before WMMA read
// them back, s8 WMMA takes B column-major so one operand was gathered
// byte by byte (LDS.U8 + PRMT), and each chunk waited behind two barriers
// with few warps resident.
//
// This design:
//   - A block is two warpgroups; a pass is 512 rows, 256 a warpgroup.
//   - C on chip.  The host gives C_k^T, K contiguous: int8 [8, 32, Lc],
//     Lc = L rounded up to 64, zeros past L.  Where all of it fits beside
//     the staging buffers (int8 up to L = 384, 96 KB there; bf16 up to
//     L = 192) a persistent block copies it into shared memory once and
//     keeps it.  Otherwise (bf16 at L = 384, any type at L = 4096) it
//     streams 64-byte K-chunks of it with the rows, each chunk serving a
//     pass of 512 rows (a tile that is not a multiple of 512 ends with a
//     shorter pass), so C bytes staged from memory are half the row
//     bytes instead of 4 times them.  bf16 operands are widened from
//     int8 in shared memory.
//   - Planes in registers.  The contraction index K is ordered so that a
//     thread's operand register is one 4-byte word of its row shifted and
//     masked: in int8, k-step (G, P) of a 16-byte group G covers plane P
//     of the group's 16 bytes (K 0..15) and plane P + 4 (K 16..31), so
//     thread t's registers are (w_t >> P) & 0x01010101 and
//     (w_t >> (P + 4)) & 0x01010101; in bf16 k-step (G, P) covers plane P
//     of the group's even bytes (K 0..7) and odd bytes (K 8..15), each
//     register ((w_t >> P) & 0x00010001) * 0x3F80 or the same of
//     w_t >> (P + 8).  C is laid out in shared memory with the same
//     order, as 8-row x 16-byte core matrices.  The perturb byte is XORed
//     into the words in registers.  The planes never touch shared memory.
//   - Rows reach shared memory by cp.async (16-byte pieces, zero-filled
//     past L and N) into a ring of 3 buffers, two chunks' copies in flight
//     while one is multiplied; a base that is not 16-byte aligned or
//     L % 16 != 0 takes byte loads instead.  Staged rows are 80 bytes
//     apart, so a warp's word reads of 8 rows hit 32 distinct banks.
//   - transposed == 0: wgmma.mma_async m64n32k32 s8 (m64n32k16 bf16), a
//     warpgroup's 64 rows as A from registers and C_k^T from shared
//     memory through a descriptor (no swizzle; LBO the K-direction
//     core-matrix stride, SBO = 128 B).  The only route to the full
//     tensor-core rate, which the bf16 form needs.  The products go in
//     batches of 8 (2 planes x 4 sub-passes) behind one fence; the
//     planes of the next batch are made while this one runs
//     (wgmma.wait_group 1, two register sets).  No branch surrounds a
//     product: ptxas serializes wgmma in a divergent path (warning
//     C7520), so sub-passes past N are multiplied too (their rows are
//     zeros and their states are not stored).
//   - transposed == 1: a real second orientation, D[32, rows] = C^T @
//     planes^T, as TPU kernel 3.  wgmma needs M = 64 rows of A, and here
//     A is C^T with 32 rows, so it takes warp-level mma.sync m16n8k32 s8
//     (m16n8k16 bf16): A = C^T as two m16 tiles through ldmatrix.x4 (one
//     core matrix each), B = the planes of 8 data rows from registers.
//   - Epilogue: `& 1` of the sums, a row's 32 bits gathered across the
//     lanes that hold them with __shfl_xor, one int64 a row.  Sums are
//     counts of at most 8L <= 32,768 ones: exact in int32 and float32.
//
// Targets at 1M x 384 (half the bound): int8 <= 0.243 ms, bf16 <= 0.417
// ms.  Prediction before the first run on the card: int8 0.20-0.40 ms,
// bf16 0.35-0.70 ms, the transposed forms within 30% of the others.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W,
// tile 1024: int8 0.309-0.328 ms (37-39% of the bound), bf16 0.636-0.645
// ms (32-33% of its operation bound), transposed 0.417-0.454 and
// 0.80-0.81 ms; 8.3x and 7.6x faster than the WMMA design, short of the
// targets.  Where the time goes (scripts/kernel_probe.py parts: the
// kernel built without a part, 10 launches back to back; same card), ms
// for int8 / bf16 / int8 transposed / bf16 transposed:
//   the kernel        0.282 / 0.591 / 0.385 / 0.743
//   no products       0.212 / 0.256 / 0.210 / 0.244
//   no row copies     0.211 / 0.534 / 0.293 / 0.675
//   neither           0.030 / 0.150 / 0.018 / 0.130
//   no plane making   0.221 / 0.442 / 0.336 / 0.593
// (1) The staging pipeline alone streams the rows at 57% of the memory
// rate: one block an SM (the ring and C fill shared memory; 223-250
// registers a thread in the wgmma forms) keeps two 32 KB chunks in
// flight behind a block-wide barrier a chunk.  (2) The products alone
// take as long in int8, twice the int8 peak's time; in bf16 making the
// planes costs 0.15 ms (SASS: 11 integer instructions a HGMMA in the
// product loop, 7 a IGMMA in int8) and streaming and widening C 0.13-
// 0.15 ms.  (3) The two overlap only in part.  Reaching half the bound
// takes all three changed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "grid.cuh"

// Diagnostic builds for scripts/kernel_probe.py, which times what each
// part of the kernel costs: PLANES_PROBE is a bit mask, 1 = issue no
// products, 2 = copy no rows into shared memory, 4 = make no planes (the
// row words go to the products as they are).  Their results are wrong by
// design.  The kernel is the default build, 0.
#ifndef PLANES_PROBE
#define PLANES_PROBE 0
#endif

namespace {

constexpr bool kProducts = !(PLANES_PROBE & 1);
constexpr bool kRowCopies = !(PLANES_PROBE & 2);
constexpr bool kPlanes = !(PLANES_PROBE & 4);

constexpr int WGS = 2;                // warpgroups a block
constexpr int THREADS = 128 * WGS;
constexpr int PASS = 256 * WGS;       // rows a pass, 256 a warpgroup
constexpr int SUB = 4;                // 64-row sub-passes a warpgroup
constexpr int KC = 64;                // row bytes a chunk
constexpr int GPC = KC / 16;          // 16-byte groups a chunk
constexpr int RSTRIDE = KC + 16;      // staged row stride, bytes
constexpr int ROWBUF = PASS * RSTRIDE;
constexpr int CCHUNK = 8 * 32 * KC;   // int8 C bytes of one chunk
constexpr int STAGES = 3;             // chunks staged: 2 in flight
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// bf16 pairs (1.0 = 0x3F80) of the 0/1 bytes 0 and 2 of x
__device__ __forceinline__ uint32_t widen(uint32_t x) {
  return (x & 0x00010001u) * 0x3F80u;
}

// -- tensor-core instructions ------------------------------------------------

__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo) {
  // no swizzle; SBO = 128 B between 8-row groups
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma(int (&d)[16], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4],
                                      uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
      : "memory");
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix4(uint32_t (&a)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)));
}

// -- operand layouts -----------------------------------------------------------
//
// C in shared memory, for a K-width of ng 16-byte groups:
//   int8: core (plane k, group G, column n) of 16 bytes at
//         ((k * ng + G) * 32 + n) * 16;
//   bf16: core (k, G, half h, n) of 8 values at
//         (((k * ng + G) * 2 + h) * 32 + n) * 16, h = 0 the even bytes of
//         the group, 1 the odd ones.

template <typename T> struct Op;
template <> struct Op<int8_t> {
  using acc = int;
  static constexpr int planes_per_group = 4;  // k-steps a 16-byte group
  static constexpr int core_bytes = 16 * 32;  // one (k, G) of C
  __device__ static void regs(uint32_t (&r)[4], uint32_t wa, uint32_t wb,
                              int p) {
    const uint32_t m = 0x01010101u;
    if (!kPlanes) {
      r[0] = r[2] = wa;
      r[1] = r[3] = wb;
      return;
    }
    r[0] = (wa >> p) & m;        // row g, plane p
    r[1] = (wb >> p) & m;        // row g + 8
    r[2] = (wa >> (p + 4)) & m;  // row g, plane p + 4
    r[3] = (wb >> (p + 4)) & m;
  }
  // wgmma B descriptor of k-step (G, P); lbo: plane P to P + 4
  __device__ static uint64_t bdesc(const uint8_t* cs, int ng, int g, int p) {
    return desc(cs + (p * ng + g) * core_bytes, 4 * ng * core_bytes);
  }
  // ldmatrix row address of lane l for m-tile mt of k-step (G, P)
  __device__ static const uint8_t* arow(const uint8_t* cs, int ng, int g,
                                        int p, int mt, int l) {
    const int q = l >> 3;
    const int k = p + 4 * (q >> 1), n = mt * 16 + 8 * (q & 1) + (l & 7);
    return cs + ((k * ng + g) * 32 + n) * 16;
  }
};
template <> struct Op<__nv_bfloat16> {
  using acc = float;
  static constexpr int planes_per_group = 8;
  static constexpr int core_bytes = 2 * 32 * 16;  // two halves
  __device__ static void regs(uint32_t (&r)[4], uint32_t wa, uint32_t wb,
                              int p) {
    if (!kPlanes) {
      r[0] = r[2] = wa;
      r[1] = r[3] = wb;
      return;
    }
    r[0] = widen(wa >> p);        // row g, even bytes
    r[1] = widen(wb >> p);        // row g + 8
    r[2] = widen(wa >> (p + 8));  // row g, odd bytes
    r[3] = widen(wb >> (p + 8));
  }
  __device__ static uint64_t bdesc(const uint8_t* cs, int ng, int g, int p) {
    return desc(cs + (p * ng + g) * core_bytes, 512);
  }
  __device__ static const uint8_t* arow(const uint8_t* cs, int ng, int g,
                                        int p, int mt, int l) {
    const int q = l >> 3;
    const int h = q >> 1, n = mt * 16 + 8 * (q & 1) + (l & 7);
    return cs + (((p * ng + g) * 2 + h) * 32 + n) * 16;
  }
};

// One int8 core of C (16 bytes of column n of plane k) into the operand
// layout: as it is for int8, split into even and odd bytes for bf16.
template <typename T>
__device__ __forceinline__ void put_core(uint8_t* cs, int ng, int k, int g,
                                         int n, uint4 v) {
  if constexpr (std::is_same<T, int8_t>::value) {
    *reinterpret_cast<uint4*>(cs + ((k * ng + g) * 32 + n) * 16) = v;
  } else {
    uint8_t* base = cs + ((k * ng + g) * 2 * 32 + n) * 16;
    *reinterpret_cast<uint4*>(base) =
        make_uint4(widen(v.x), widen(v.y), widen(v.z), widen(v.w));
    *reinterpret_cast<uint4*>(base + 32 * 16) = make_uint4(
        widen(v.x >> 8), widen(v.y >> 8), widen(v.z >> 8), widen(v.w >> 8));
  }
}

// -- the kernel ----------------------------------------------------------------

struct Work {  // one chunk of one pass
  long long tile, r0;  // tile index, the pass's first row
  int c0;              // the chunk's first byte
};

template <bool TRANS, typename T, bool RESIDENT>
__global__ void __launch_bounds__(THREADS)
planes_crc_kernel(const uint8_t* __restrict__ buf,
                  const uint8_t* __restrict__ ckt, long long* __restrict__ out,
                  long long n, int length, int lc, int tile, uint32_t pmask,
                  int vec) {
  using A = typename Op<T>::acc;
  constexpr int NP = Op<T>::planes_per_group;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* rowbuf = smem;                   // [STAGES][PASS][RSTRIDE]
  uint8_t* land = smem + STAGES * ROWBUF;   // [STAGES][CCHUNK] (streamed)
  uint8_t* cres = land;                     // C resident, or widened
  if (!RESIDENT) cres = land + STAGES * CCHUNK;  // bf16 chunk
  const int ng = RESIDENT ? lc / 16 : GPC;       // groups of C on chip

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = tid >> 7, warp = (tid >> 5) & 3;  // warp in warpgroup
  const int base = wg * 256;  // this warpgroup's first row of a pass
  const long long ntiles = (n + tile - 1) / tile;

  if (RESIDENT) {  // all of C, once a block
    for (int p = tid; p < 8 * 32 * (lc / 16); p += THREADS) {
      const int k = p / (32 * ng), rest = p - k * 32 * ng;
      const int nn = rest / ng, gg = rest - nn * ng;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          ckt + ((size_t)k * 32 + nn) * lc + 16 * gg));
      put_core<T>(cres, ng, k, gg, nn, v);
    }
  }

  auto tile_end = [&](long long tl) { return min((tl + 1) * tile, n); };
  auto advance = [&](Work w) {
    w.c0 += KC;
    if (w.c0 >= lc) {
      w.c0 = 0;
      w.r0 += PASS;
      if (w.r0 >= tile_end(w.tile)) {
        w.tile += gridDim.x;
        w.r0 = w.tile * tile;
      }
    }
    return w;
  };
  // rows [r0, r0 + PASS) of the tile, bytes [c0, c0 + KC), into rowbuf b;
  // streamed C's chunk into land b
  auto stage = [&](Work w, int b) {
    const long long end = min(w.r0 + PASS, tile_end(w.tile));
    uint8_t* dst = rowbuf + b * ROWBUF;
    for (int p = tid; kRowCopies && p < PASS * GPC; p += THREADS) {
      const int r = p / GPC, gg = p - r * GPC;
      const int col = w.c0 + 16 * gg;
      const bool in = w.r0 + r < end && col < length;
      const uint8_t* src = buf + (w.r0 + r) * (long long)length + col;
      uint8_t* d = dst + r * RSTRIDE + 16 * gg;
      if (vec) {
        cp_async16(d, in ? src : buf, in ? 16 : 0);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (in)
          for (int j = 0; j < 16 && col + j < length; ++j)
            v[j >> 2] |= (uint32_t)src[j] << (8 * (j & 3));
        *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    if (!RESIDENT) {
      uint8_t* cd = land + b * CCHUNK;
      for (int p = tid; p < 8 * 32 * GPC; p += THREADS) {
        const int k = p / (32 * GPC), nn = (p / GPC) & 31, gg = p % GPC;
        cp_async16(cd + ((k * GPC + gg) * 32 + nn) * 16,
                   ckt + ((size_t)k * 32 + nn) * lc + w.c0 + 16 * gg, 16);
      }
    }
  };

  A acc[SUB][16];
  Work cur{(long long)blockIdx.x, (long long)blockIdx.x * tile, 0};
  Work pf = cur;  // the next chunk to stage
  for (int i = 0; i < STAGES - 1; ++i) {
    if (pf.tile < ntiles) {
      stage(pf, i);
      pf = advance(pf);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  int b = 0;
  while (cur.tile < ntiles) {
    if (pf.tile < ntiles) {
      stage(pf, (b + STAGES - 1) % STAGES);
      pf = advance(pf);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const uint8_t* cs = cres;
    int g0 = cur.c0 / 16;  // this chunk's first group within C on chip
    if (!RESIDENT) {
      g0 = 0;
      if constexpr (std::is_same<T, int8_t>::value) {
        cs = land + b * CCHUNK;
      } else {  // widen the chunk to bf16
        const uint8_t* src = land + b * CCHUNK;
        for (int p = tid; p < 8 * GPC * 32; p += THREADS) {
          const int k = p / (GPC * 32), gg = (p / 32) % GPC, nn = p & 31;
          put_core<T>(cres, GPC, k, gg, nn,
                      *reinterpret_cast<const uint4*>(src + p * 16));
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
      }
    }

    if (cur.c0 == 0) {
#pragma unroll
      for (int s = 0; s < SUB; ++s)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[s][i] = (A)0;
    }
    const int live = (int)(min(cur.r0 + PASS, tile_end(cur.tile)) - cur.r0);
    const uint8_t* rows = rowbuf + b * ROWBUF;
    // word t of each group of rows g and g + 8 of every sub-pass
    auto word = [&](int gg, int s, int half) {
      const uint8_t* r = rows + (base + s * 64 + 16 * warp + g + 8 * half) *
                                    RSTRIDE + 16 * gg + 4 * t;
      return *reinterpret_cast<const uint32_t*>(r) ^ pmask;
    };
    if constexpr (!TRANS) {
      // batches of PB planes x SUB sub-passes; the planes of batch i + 1
      // are made while batch i runs (wgmma.wait_group 1)
      constexpr int PB = 2, NB = GPC * NP / PB;
      uint32_t w[GPC][SUB][2];
#pragma unroll
      for (int gg = 0; gg < GPC; ++gg)
#pragma unroll
        for (int s = 0; s < SUB; ++s) {
          w[gg][s][0] = word(gg, s, 0);
          w[gg][s][1] = word(gg, s, 1);
        }
      uint32_t r[2][PB][SUB][4];
      auto make = [&](uint32_t (&dst)[PB][SUB][4], int bi) {
#pragma unroll
        for (int p = 0; p < PB; ++p)
#pragma unroll
          for (int s = 0; s < SUB; ++s)
            Op<T>::regs(dst[p][s], w[bi / (NP / PB)][s][0],
                        w[bi / (NP / PB)][s][1], (bi % (NP / PB)) * PB + p);
      };
      make(r[0], 0);
#pragma unroll
      for (int bi = 0; bi < NB; ++bi) {
        const int gg = bi / (NP / PB), p0 = (bi % (NP / PB)) * PB;
        wg_fence();
#pragma unroll
        for (int p = 0; p < PB; ++p) {
          const uint64_t bd = Op<T>::bdesc(cs, ng, g0 + gg, p0 + p);
#pragma unroll
          for (int s = 0; s < SUB; ++s)  // no branch: a guard serializes
            if constexpr (kProducts) wgmma(acc[s], r[bi & 1][p][s], bd);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (bi + 1 < NB) {
          // batch bi - 1 is done, so its registers take batch bi + 1
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          make(r[(bi + 1) & 1], bi + 1);
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    } else {
#pragma unroll 1
      for (int gg = 0; gg < GPC; ++gg) {
        uint32_t wa[SUB], wb[SUB];
#pragma unroll
        for (int s = 0; s < SUB; ++s) {
          wa[s] = word(gg, s, 0);
          wb[s] = word(gg, s, 1);
        }
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          uint32_t ca[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldmatrix4(ca[mt], Op<T>::arow(cs, ng, g0 + gg, p, mt, lane));
#pragma unroll
          for (int s = 0; s < SUB; ++s) {
            uint32_t r[4];
            Op<T>::regs(r, wa[s], wb[s], p);
#pragma unroll
            for (int mt = 0; mt < 2 && kProducts; ++mt) {
              A (&d)[16] = acc[s];
              mma(*reinterpret_cast<A(*)[4]>(&d[mt * 8]), ca[mt], r[0],
                  r[2]);  // data rows g: n-tile 0
              mma(*reinterpret_cast<A(*)[4]>(&d[mt * 8 + 4]), ca[mt], r[1],
                  r[3]);  // data rows g + 8: n-tile 1
            }
          }
        }
      }
    }

    if (cur.c0 + KC >= lc) {  // the pass's last chunk: parity, pack, store
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
        if constexpr (!TRANS) {
          // acc[s][4 nt + i]: row g (i < 2) or g + 8, column 8 nt + 2t + i%2
          uint32_t lo = 0u, hi = 0u;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int j = nt * 8 + 2 * t;
            lo |= ((uint32_t)(int)acc[s][4 * nt] & 1u) << j;
            lo |= ((uint32_t)(int)acc[s][4 * nt + 1] & 1u) << (j + 1);
            hi |= ((uint32_t)(int)acc[s][4 * nt + 2] & 1u) << j;
            hi |= ((uint32_t)(int)acc[s][4 * nt + 3] & 1u) << (j + 1);
          }
          lo |= __shfl_xor_sync(0xFFFFFFFFu, lo, 1);
          lo |= __shfl_xor_sync(0xFFFFFFFFu, lo, 2);
          hi |= __shfl_xor_sync(0xFFFFFFFFu, hi, 1);
          hi |= __shfl_xor_sync(0xFFFFFFFFu, hi, 2);
          const int r = base + s * 64 + 16 * warp + g + (t == 1 ? 8 : 0);
          if (t < 2 && r < live) out[cur.r0 + r] = (long long)(t == 0 ? lo : hi);
        } else {
          // acc[s][8 mt + 4 nt + i]: output bit 16 mt + g (+8 for i >= 2)
          // of data row 8 nt + 2t + i%2
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              uint32_t w = 0u;
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                w |= ((uint32_t)(int)acc[s][8 * mt + 4 * nt + j] & 1u)
                     << (16 * mt + g);
                w |= ((uint32_t)(int)acc[s][8 * mt + 4 * nt + 2 + j] & 1u)
                     << (16 * mt + g + 8);
              }
              w |= __shfl_xor_sync(0xFFFFFFFFu, w, 4);
              w |= __shfl_xor_sync(0xFFFFFFFFu, w, 8);
              w |= __shfl_xor_sync(0xFFFFFFFFu, w, 16);
              const int r = base + s * 64 + 16 * warp + 8 * nt + 2 * t + j;
              if (g == 0 && r < live) out[cur.r0 + r] = (long long)w;
            }
          }
        }
      }
    }
    __syncthreads();  // rowbuf b, land b and the widened chunk are free
    cur = advance(cur);
    b = (b + 1) % STAGES;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <bool TRANS, typename T, bool RESIDENT>
int launch(const void* buf, const void* ckt, void* out, long long n,
           int length, int lc, int tile, uint32_t pmask, int vec, int smem,
           cudaStream_t stream) {
  auto kernel = planes_crc_kernel<TRANS, T, RESIDENT>;
  int resident = 0;
  const cudaError_t e = resident_blocks(kernel, THREADS, smem, &resident);
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = (n + tile - 1) / tile;
  const int blocks = (int)min(ntiles, (long long)resident);
  kernel<<<blocks, THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(buf), static_cast<const uint8_t*>(ckt),
      static_cast<long long*>(out), n, length, lc, tile, pmask, vec);
  return (int)cudaGetLastError();
}

template <bool TRANS, typename T>
int launch_type(const void* buf, const void* ckt, void* out, long long n,
                int length, int tile, uint32_t pmask, int vec,
                cudaStream_t stream) {
  const int lc = (length + KC - 1) / KC * KC;
  const int per_byte = std::is_same<T, int8_t>::value ? 1 : 2;
  const int resident = STAGES * ROWBUF + 8 * 32 * lc * per_byte;
  if (resident <= SMEM_MAX)
    return launch<TRANS, T, true>(buf, ckt, out, n, length, lc, tile, pmask,
                                  vec, resident, stream);
  const int streamed =
      STAGES * (ROWBUF + CCHUNK) + (per_byte - 1) * 2 * CCHUNK;
  return launch<TRANS, T, false>(buf, ckt, out, n, length, lc, tile, pmask,
                                 vec, streamed, stream);
}

}  // namespace

// buf: uint8 [n, length] contiguous; ckt: int8 C_k^T [8, 32, Lc], Lc =
// length rounded up to 64, K contiguous, zeros past length, 16-byte
// aligned (for both operand types); out: int64 [n].  tile: rows per
// block tile, a multiple of 64; transposed: 0 or 1; operand: 0 int8, 1
// bf16; perturb: a byte XORed into every byte of buf.  Launches on
// `stream` and returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for an argument it does not take).  n >= 1,
// length >= 1.
extern "C" int planes_crc_launch(const void* buf, const void* ckt, void* out,
                                 long long n, int length, int tile,
                                 int transposed, int operand, int perturb,
                                 void* stream) {
  if (tile <= 0 || tile % 64 != 0 || perturb < 0 || perturb > 255 ||
      length < 1)
    return (int)cudaErrorInvalidValue;
  const uint32_t pmask = (uint32_t)perturb * 0x01010101u;
  const int vec = (length % 16 == 0) && ((uintptr_t)buf % 16 == 0) ? 1 : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (operand == 0)
    return transposed ? launch_type<true, int8_t>(buf, ckt, out, n, length,
                                                  tile, pmask, vec, s)
                      : launch_type<false, int8_t>(buf, ckt, out, n, length,
                                                   tile, pmask, vec, s);
  if (operand == 1)
    return transposed
               ? launch_type<true, __nv_bfloat16>(buf, ckt, out, n, length,
                                                  tile, pmask, vec, s)
               : launch_type<false, __nv_bfloat16>(buf, ckt, out, n, length,
                                                   tile, pmask, vec, s);
  return (int)cudaErrorInvalidValue;
}
