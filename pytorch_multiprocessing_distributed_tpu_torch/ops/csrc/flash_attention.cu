// Flash attention for Hopper (sm_90a): the forward and the two backward
// kernels of FlashAttention-2, f32 accumulation, bf16 or f32 I/O.
//
// Replaces the TPU kernels of
//   pytorch_multiprocessing_distributed_tpu/ops/pallas/flash_attention.py
//   `_fwd_kernel`     (launched by `_flash_fwd`)        -> flash_fwd_*
//   `_bwd_dq_kernel`  (launched by `_flash_pair_grads`) -> flash_bwd_dq_*
//   `_bwd_dkv_kernel` (launched by `_flash_pair_grads`) -> flash_bwd_dkv_*
// in bf16 as the `flash_*_wgmma_kernel`s; in f32 as the
// `flash_*_tf32x3_kernel`s.
//
//   out = softmax(Q K^T * scale + mask) V,  lse = log-sum-exp of each row
//   dq  = sum_k dS K * scale,  dk = sum_q dS^T Q * scale,  dv = sum_q P^T dO
//   with P = exp(Q K^T * scale - lse) rebuilt from the saved (or an
//   external) lse, and dS = P o (dO V^T - D), D = rowsum(dO o O).
//
// Masks are the Pallas kernels' (`_bwd_mask`): a column counts when it
// is < Skv and, under `causal`, <= its row; rows >= Sq and columns >=
// Skv contribute nothing (their tiles are zero-filled in shared memory,
// so a masked entry never multiplies garbage).
//
// What bounds it on the card: operations. A (q-tile, k-tile) pair does
// 2 * 64 * 64 * Dh flops per product on 2 * 64 * Dh elements: far above
// the H100's flop/byte ridge once tiles are in shared memory. Every
// pass, in both dtypes, is warp-specialised: one producer warp brings
// every tile by TMA through mbarrier rings, and consumer warpgroups run
// every product as `wgmma`:
//   - bf16: two (forward, dk/dv) or one (dq) consumer warpgroups a CTA;
//     described above the `flash_*_wgmma_kernel`s below;
//   - f32 (`train_lm`'s default dtype): every product as 3xTF32 `wgmma`
//     (three TF32 products on hi/lo splits of the f32 operands,
//     f32-accurate), two consumer warpgroups a CTA, each splitting half
//     of every streamed tile into those hi/lo operands; described above
//     the `flash_*_tf32x3_kernel`s below.
// All:
//   - the Pallas grid's sequential innermost axis (k for the forward and
//     dq, q for dk/dv) becomes a loop inside one CTA, so the running
//     max, denominator and accumulators stay in registers for the whole
//     row of tiles and nothing is carried between CTAs (no atomics: dq
//     and dk/dv are FlashAttention-2's two separate passes, and two calls
//     give equal bits);
//   - causal tiles wholly above the diagonal are never loaded (a tile is
//     live iff its first column < the tile's last row + 1, the Pallas
//     `k_start < q_end` test), and the q-tile passes launch their longest
//     (last) tiles first;
//   - inputs are read through element strides (the TMA descriptors
//     carry them), so the [B, S, H, Dh] views of the fused
//     QKV projection are never copied.

#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {  // element strides of a [B, S, H, Dh] tensor (Dh: 1)
  long long b, s, h;
  int cols;  // Dh: columns past it (zeros in the tiles) are never stored
};

// ---- bf16 on Hopper: wgmma fed by TMA through mbarrier rings ----
//
// All three bf16 passes are warp-specialised. One producer warp issues
// every tile copy as a TMA load (one thread) that completes on an
// mbarrier; the consumer warpgroups each own 64 rows of the CTA's
// resident tile and run every product as `wgmma`. The producer runs up
// to kStages tiles ahead of the consumers, so the next tiles' loads
// overlap the current products. TMA writes each tile in the 128-byte
// swizzle (64-byte for Dh 32) that the wgmma descriptors name, in
// 64-column panels (two for Dh 128), and zero-fills rows past the
// sequence. Products read both operands from shared memory where the
// contraction runs along the stored rows (K-major); an operand that is
// itself a product (P, dS) is the A operand from registers (an f32
// accumulator's layout is the bf16 A fragment's), rounded to bf16 there
// as the Pallas kernels round it; a B operand the product needs
// transposed is read through the descriptor's transpose, so no
// transposed copy of any tile exists. Every exponential is one FMA into
// the SFU's exp2. Masks are applied only on the diagonal tile and the
// ragged last tile. The epilogue stages the bf16 result in the
// warpgroup's own rows of a resident tile and writes it out in 16-byte
// stores. No atomics: each output element is summed by one thread in
// one order, so two calls give equal bits.

constexpr int kWg = 128;       // threads of a warpgroup
constexpr int kWgRows = 64;    // wgmma M: the rows a consumer warpgroup
                               // owns, and the rows of a streamed tile
constexpr float kLog2e = 1.4426950408889634f;
// a wait that outlives this traps (a CUDA error) instead of hanging
constexpr unsigned long long kSpinTrapNs = 4000000000ull;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait for the phase of `bar` with this parity to complete
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > kSpinTrapNs) __trap();
}

// TMA: the box at (col, row, h, b) of a [B, S, H, Dh] view; completes on
// bar
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(h), "r"(b)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers a wgmma in flight reads or writes: the compiler must neither
// read them early nor reuse them before the wgmma_wait that precedes this.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M>
__device__ __forceinline__ void hold(uint32_t (&r)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// named barrier of one warpgroup (id 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory,
// both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 32] += A[64 x 16] B[16 x 32], A from registers (the m16n8k16
// A fragment of each warp), B from shared memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers (the m16n8k16
// A fragment of each warp), B from shared memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A from registers (the m16n8k16
// A fragment of each warp), B from shared memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 32)
    wgmma_rs_n32(d, a, b);
  else if constexpr (D == 64)
    wgmma_rs_n64(d, a, b);
  else
    wgmma_rs_n128(d, a, b);
}

// A [rows][COLS] tile of E-byte elements (bf16: 2, f32: 4) in shared
// memory as TMA writes it: panels of at most 128 bytes a row (64 bf16 or
// 32 f32 columns; one narrower panel for a narrower tile), each row of a
// panel one swizzle span (128, 64 or 32 bytes), its 16-byte chunks
// XOR-permuted by the row; tiles start on 1024-byte boundaries, so the
// pattern is the one the wgmma descriptors' layout type names.
template <int COLS, int E = 2>
struct Tile {
  static constexpr int kPanelCols = COLS * E < 128 ? COLS : 128 / E;
  static constexpr int kRowBytes = E * kPanelCols;  // the swizzle span
  static constexpr int kPanels = COLS / kPanelCols;
  static constexpr uint64_t kLayout =
      kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;  // B128/B64/B32

  __host__ __device__ static constexpr int bytes(int rows) {
    return rows * COLS * E;
  }

  // byte offset of 16-byte chunk ch (columns ch * 16 / E onwards) of row r
  __device__ static int chunk(int rows, int r, int ch) {
    constexpr int per = kRowBytes / 16;
    const int off = r * kRowBytes + (ch % per) * 16;
    return (ch / per) * rows * kRowBytes +
           (off ^ (((off >> 7) & (kRowBytes / 16 - 1)) << 4));
  }
  // byte offset of element (r, c)
  __device__ static int elem(int rows, int r, int c) {
    return chunk(rows, r, c * E / 16) + c * E % 16;
  }

  __device__ static uint64_t desc(uint32_t addr, uint32_t lbo,
                                  uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
           (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
           (kLayout << 62);
  }

  // rows [r0, r0 + n) x the 32 bytes of columns of k-step kk (16 bf16 or
  // 8 tf32: one wgmma's K) as a K-major operand (the product's K runs
  // along the columns, as stored); r0 a multiple of 8
  __device__ static uint64_t kmajor(uint32_t tile, int rows, int r0,
                                    int kk) {
    const int col = kk * 32 / E;
    return desc(tile + (col / kPanelCols) * rows * kRowBytes +
                    r0 * kRowBytes + (col % kPanelCols) * E,
                16, 8 * kRowBytes);
  }

  // bf16: rows [16 kk, 16 kk + 16) as the product's K and all COLS
  // columns as its N: the MN-major (transposed) B operand; LBO steps
  // between panels
  __device__ static uint64_t mnmajor(uint32_t tile, int rows, int kk) {
    return desc(tile + 16 * kk * kRowBytes, rows * kRowBytes,
                8 * kRowBytes);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// reduce over the 4 lanes of a quad (the lanes that share an accumulator
// row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the bf16 A fragments of a 64 x 64 f32 accumulator, one per k-step of
// 16 columns (the accumulator's layout is the A fragment's, per warp)
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4],
                                         const float (&c)[32]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    a[kc][0] = pack_bf16(c[8 * kc], c[8 * kc + 1]);
    a[kc][1] = pack_bf16(c[8 * kc + 2], c[8 * kc + 3]);
    a[kc][2] = pack_bf16(c[8 * kc + 4], c[8 * kc + 5]);
    a[kc][3] = pack_bf16(c[8 * kc + 6], c[8 * kc + 7]);
  }
}

// a warpgroup's 64 x D f32 result, times `mul`, as bf16 into its rows
// [r0, r0 + 64) of a resident tile (which only it reads), then 16-byte
// stores of the rows < n_rows and the columns < cols to out[row *
// row_stride]
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float mul, unsigned char* tile,
                                           int rows, int r0, int wg,
                                           __nv_bfloat16* out,
                                           long long row_stride, int row0,
                                           int n_rows, int cols) {
  const int lane = threadIdx.x % 32;
  const int r = r0 + (threadIdx.x / 32) % 4 * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(tile + Tile<D>::chunk(rows, r + 8 * i, j) +
                                   4 * (lane % 4)) =
          pack_bf16(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
  wg_sync(1 + wg);
  for (int idx = threadIdx.x % kWg; idx < kWgRows * D / 8; idx += kWg) {
    const int rr = idx / (D / 8);
    const int ch = idx - rr * (D / 8);
    const int row = row0 + rr;
    if (row < n_rows && ch * 8 < cols)
      *reinterpret_cast<uint4*>(out + row * row_stride + ch * 8) =
          *reinterpret_cast<const uint4*>(
              tile + Tile<D>::chunk(rows, r0 + rr, ch));
  }
}

// ---- the bf16 forward (row 5) ----
//
// A CTA of two consumer warpgroups holds 128 query rows of Q, 64 each;
// K and V stream through a 3-stage ring of 64-key tiles, each tile
// loaded once for both warpgroups. Up to two CTAs share an SM (one at Dh
// 128). For each live k-tile a warpgroup computes S = Q K^T with both
// operands from shared memory; runs the online softmax on the
// accumulator's registers (a row spans the 4 lanes of a quad, so two
// shuffles give its max; the row sums stay per thread until the
// epilogue); rescales O by the correction; and adds P V, with P rounded
// to bf16 as the A operand from registers (where the Pallas kernel rounds
// it, `p.astype(v.dtype)`) and V read through the descriptor's transpose.
// Under `causal` a warpgroup skips the k-tiles past its diagonal (the
// first warpgroup skips the CTA's last tile), and the grid runs the
// longest rows first. The epilogue divides O by the row sums, writes the
// natural-log lse of the scaled logits (m / log2 e + ln l: the contract
// the backward and ring attention read), and stores O through the Q
// tile.
//
// What bounds it: at gpt_small's training shape (B 8, H 12, S 1024, Dh
// 64, causal) the least time is about even between bytes and operations
// (0.0151 and 0.0131 ms on an H100 SXM). The loop is latency-bound: a
// tile's two products wait on each other and on the softmax between
// them, and a tile's 4,096 exponentials keep the SFU about as long as its
// 8 `wgmma` keep the tensor cores; the four warpgroups of an SM
// interleave one's products with another's softmax. Measured at that
// shape on an NVIDIA H100 80GB HBM3 at 700 W by `ab_flash_fwd.py`
// (builds that differ only in FwdSmem's constants, timed in turns in one
// process): two warpgroups on 128 rows 0.047 ms; one warpgroup on 64 rows
// with three CTAs an SM (dq's shape) 0.050, or with two stages and four
// CTAs 0.049; three warpgroups on 192 rows 0.063; rings of 2 or 4 stages
// 0.050. At Dh 32 one warpgroup is 6% faster; the shape is chosen for
// gpt_small's Dh 64. Also slower, in a build not kept: issuing tile
// j + 1's S before tile j's softmax (FlashAttention-3's overlap inside a
// warpgroup): its second logit tile costs 32 registers a thread, and
// ptxas serialises the `wgmma` where they do not fit.

// shared memory of the forward (byte offsets from a 1024-aligned base)
template <int D>
struct FwdSmem {
  static constexpr int kWgs = 2;
  static constexpr int kMinBlocks = D == 128 ? 1 : 2;  // CTAs an SM
  static constexpr int kRows = kWgs * kWgRows;  // query rows a CTA
  static constexpr int kStages = 3;
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + Tile<D>::bytes(kRows);
  static constexpr int kStage = 2 * Tile<D>::bytes(kWgRows);  // K, V
  static constexpr int kBar = kRing + kStages * kStage;  // resident,
                                                         // full[], empty[]
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

// the online softmax of one 64 x N logit tile in place, in the
// accumulator layout (this thread: rows g and g + 8 of its warp's 16,
// element 4 j + 2 i + e at column 8 j + 2 t + e of row g + 8 i): masks
// the tile when `masked`, raises the running max m (log2 domain, of s *
// c; c > 0), turns s into P = 2^(s c - m), adds P's row sums to this
// thread's share of l, and returns each row's correction 2^(m_old -
// m_new) in corr
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float c, bool masked, int row0,
                                             int col0, int Skv, int causal) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  if (masked) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + 8 * (e >> 1);
        const int col = col0 + 8 * j + 2 * t + (e & 1);
        if (!(col < Skv && (!causal || col <= row)))
          s[4 * j + e] = -INFINITY;
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    const float m_new = fmaxf(m[i], quad_max(mx) * c);
    // a row with no live column yet keeps P = 0 (not exp2(-inf + inf))
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    corr[i] = ex2(m[i] - m_use);
    m[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * i + e];
        x = ex2(fmaf(x, c, -m_use));
        sum += x;
      }
    l[i] = l[i] * corr[i] + sum;
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
}

template <int D>
__global__ void __launch_bounds__(FwdSmem<D>::kWgs* kWg + 32,
                                  FwdSmem<D>::kMinBlocks)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int H, int Sq, int Skv,
                           Strides os, float scale, int causal) {
  using T = Tile<D>;
  using L = FwdSmem<D>;
  constexpr int R = L::kRows;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t base = smem_addr(smem);
  const uint32_t resident = base + L::kBar;
  const uint32_t full0 = resident + 8, empty0 = full0 + 8 * S;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qi = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qi * R;
  int n_k = (Skv + kWgRows - 1) / kWgRows;
  if (causal) n_k = min(n_k, (q0 + R) / kWgRows);  // live iff k0 < q_end

  if (threadIdx.x == 0) {
    mbar_init(resident, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * L::kWgs);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == L::kWgs) {  // the producer warp
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(resident, T::bytes(R));
      for (int p = 0; p < T::kPanels; ++p)
        tma_rows(base + L::kQ + p * R * T::kRowBytes, &tq, resident,
                 p * T::kPanelCols, q0, h, b);
      for (int kb = 0; kb < n_k; ++kb) {
        const int s = kb % S;
        mbar_wait(empty0 + 8 * s, ((kb / S) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, L::kStage);
        const uint32_t kt = base + L::kRing + s * L::kStage;
        for (int p = 0; p < T::kPanels; ++p) {
          const int off = p * kWgRows * T::kRowBytes;
          tma_rows(kt + off, &tk, full0 + 8 * s, p * T::kPanelCols,
                   kb * kWgRows, h, b);
          tma_rows(kt + T::bytes(kWgRows) + off, &tv, full0 + 8 * s,
                   p * T::kPanelCols, kb * kWgRows, h, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: query rows [q0 + r0, q0 + r0 + 64)
  const int r0 = wg * kWgRows;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + r0 + warp * 16;  // this warp's first row
  // the row max is taken on the raw logits, so a negative scale flips
  // them first and goes to the exponent as |scale| (at least 1e-30: a
  // zero scale must not turn a masked -inf into 0 * -inf = NaN)
  const bool flip = scale < 0.f;
  const float c = fmaxf(fabsf(scale) * kLog2e, 1e-30f);
  const int diag = q0 / kWgRows + wg;  // this warpgroup's diagonal k-tile
  float o[D / 2], sc[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  mbar_wait(resident, 0);
  __syncwarp();  // reconverge before the .aligned wgmma ops

  for (int kb = 0; kb < n_k; ++kb) {
    const int s = kb % S;
    mbar_wait(full0 + 8 * s, (kb / S) & 1);
    __syncwarp();
    const uint32_t kt = base + L::kRing + s * L::kStage;
    const uint32_t vt = kt + T::bytes(kWgRows);
    if (!causal || kb <= diag) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, T::kmajor(base + L::kQ, R, r0, kk),
                     T::kmajor(kt, kWgRows, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      hold(sc);
      if (flip) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = -sc[i];
      }
      float corr[2];
      softmax_tile<64>(sc, m, l, corr, c,
                   (causal && kb == diag) || (kb + 1) * kWgRows > Skv, row0,
                   kb * kWgRows, Skv, causal);
      rescale<D>(o, corr);
      uint32_t a[4][4];
      acc_to_a(a, sc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs<D>(o, a[kc], T::mnmajor(vt, kWgRows, kc));
      wgmma_commit();
      wgmma_wait<0>();
      hold(o);
      hold(a);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // O / l, and lse = m / log2 e + ln l (the natural-log lse of the
  // scaled logits)
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_safe = fmaxf(quad_sum(l[i]), 1e-30f);
    inv[i] = 1.f / l_safe;
    const int row = row0 + lane / 4 + 8 * i;
    if (lane % 4 == 0 && row < Sq)
      lse[static_cast<long long>(bh) * Sq + row] =
          m[i] / kLog2e + logf(l_safe);
  }
  rescale<D>(o, inv);
  store_rows<D>(o, 1.f, smem + L::kQ, R, r0, wg, out + b * os.b + h * os.h,
                os.s, q0 + r0, Sq, os.cols);
}

// ---- the bf16 backward (rows 6 and 7) ----
//
//   - dq (row 6): a CTA of one consumer warpgroup holds 64 query rows of
//     Q and dO, and each thread the lse and dterm of its two rows; K and
//     V stream through a ring of 64-key tiles. Up to three such CTAs
//     share an SM. S = Q K^T and dP = dO V^T read both operands from
//     shared memory; dS is formed in registers and dQ += dS K takes K
//     through the descriptor's transpose.
//   - dk/dv (row 7): a CTA of two consumer warpgroups holds 128 keys of K
//     and V (one warpgroup and 64 keys for Dh 128, where the registers of
//     dK and dV leave room for no second); Q and dO stream through the
//     ring in 64-query tiles, starting at the diagonal under `causal`,
//     and the producer warp's lanes store each tile's lse and dterm
//     beside them (a TMA box must start 16-byte aligned; row bh * Sq + q0
//     of those flat arrays need not). S^T = K Q^T, dP^T = V dO^T from
//     shared memory; dV += P^T dO and dK += dS^T Q with P^T and dS^T from
//     registers and dO, Q transposed by descriptor.
// P = exp2(S * scale * log2 e - lse * log2 e). The warpgroups of an SM
// interleave their products with each other's exponentials. (Measured
// slower and dropped: keeping a tile's dQ, or dV and dK, products in
// flight into the next tile's; ping-pong turns between dk/dv's two
// warpgroups.)

// shared memory of the dq pass (byte offsets from a 1024-aligned base)
template <int D>
struct DqSmem {
  // one consumer warpgroup a CTA and up to three CTAs an SM (Dh <= 64):
  // independent CTAs hide each other's waits better than two warpgroups
  // that share one CTA's ring (measured; dk/dv showed no such gain)
  static constexpr int kWgs = 1;
  static constexpr int kMinBlocks = D == 128 ? 1 : 3;  // CTAs an SM
  static constexpr int kRows = kWgs * kWgRows;  // query rows a CTA
  static constexpr int kStages = 3;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + Tile<D>::bytes(kRows);
  static constexpr int kRing = kDO + Tile<D>::bytes(kRows);
  static constexpr int kStage = 2 * Tile<D>::bytes(kWgRows);  // K, V
  static constexpr int kBar = kRing + kStages * kStage;  // resident,
                                                         // full[], empty[]
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(DqSmem<D>::kWgs* kWg + 32,
                                  DqSmem<D>::kMinBlocks)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ dterm,
                              __nv_bfloat16* __restrict__ dq, int H, int Sq,
                              int Skv, Strides dqs, float scale, int causal) {
  using T = Tile<D>;
  using L = DqSmem<D>;
  constexpr int R = L::kRows;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t base = smem_addr(smem);
  const uint32_t resident = base + L::kBar;
  const uint32_t full0 = resident + 8, empty0 = full0 + 8 * S;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qi = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qi * R;
  int n_k = (Skv + kWgRows - 1) / kWgRows;
  if (causal) n_k = min(n_k, (q0 + R) / kWgRows);  // live iff k0 < q_end

  if (threadIdx.x == 0) {
    mbar_init(resident, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * L::kWgs);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == L::kWgs) {  // the producer warp
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(resident, 2 * T::bytes(R));
      for (int p = 0; p < T::kPanels; ++p) {
        const int off = p * R * T::kRowBytes;
        tma_rows(base + L::kQ + off, &tq, resident, p * T::kPanelCols, q0, h,
                 b);
        tma_rows(base + L::kDO + off, &tdo, resident, p * T::kPanelCols, q0,
                 h, b);
      }
      for (int kb = 0; kb < n_k; ++kb) {
        const int s = kb % S;
        mbar_wait(empty0 + 8 * s, ((kb / S) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, L::kStage);
        const uint32_t kt = base + L::kRing + s * L::kStage;
        for (int p = 0; p < T::kPanels; ++p) {
          const int off = p * kWgRows * T::kRowBytes;
          tma_rows(kt + off, &tk, full0 + 8 * s, p * T::kPanelCols,
                   kb * kWgRows, h, b);
          tma_rows(kt + T::bytes(kWgRows) + off, &tv, full0 + 8 * s,
                   p * T::kPanelCols, kb * kWgRows, h, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: query rows [q0 + r0, q0 + r0 + 64)
  const int r0 = wg * kWgRows;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float c = scale * kLog2e;
  float lse2[2], dt[2];  // this thread's two rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + warp * 16 + g + 8 * i;
    const long long at = static_cast<long long>(bh) * Sq + row;
    lse2[i] = row < Sq ? lse[at] * kLog2e : 0.f;
    dt[i] = row < Sq ? dterm[at] : 0.f;
  }
  mbar_wait(resident, 0);
  __syncwarp();  // reconverge before the .aligned wgmma ops
  float acc[D / 2], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  const int diag = q0 / kWgRows + wg;  // this warpgroup's diagonal k-tile

  for (int kb = 0; kb < n_k; ++kb) {
    const int s = kb % S;
    mbar_wait(full0 + 8 * s, (kb / S) & 1);
    __syncwarp();
    const uint32_t kt = base + L::kRing + s * L::kStage;
    const uint32_t vt = kt + T::bytes(kWgRows);
    if (!causal || kb <= diag) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, T::kmajor(base + L::kQ, R, r0, kk),
                     T::kmajor(kt, kWgRows, 0, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, T::kmajor(base + L::kDO, R, r0, kk),
                     T::kmajor(vt, kWgRows, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<1>();  // S is in; dP still running
      hold(sc);
      const bool masked = (causal && kb == diag) || (kb + 1) * kWgRows > Skv;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(sc[4 * j + e], c, -lse2[e >> 1]));
          if (masked) {
            const int row = q0 + r0 + warp * 16 + g + 8 * (e >> 1);
            const int col = kb * kWgRows + 8 * j + 2 * t + (e & 1);
            if (!(col < Skv && (!causal || col <= row))) p = 0.f;
          }
          sc[4 * j + e] = p;
        }
      wgmma_wait<0>();
      hold(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sc[i] *= dp[i] - dt[(i >> 1) & 1];  // dS, in place
      uint32_t a[4][4];
      acc_to_a(a, sc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs<D>(acc, a[kc], T::mnmajor(kt, kWgRows, kc));
      wgmma_commit();
      wgmma_wait<0>();
      hold(acc);
      hold(a);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  store_rows<D>(acc, scale, smem + L::kQ, R, r0, wg,
                dq + b * dqs.b + h * dqs.h, dqs.s, q0 + r0, Sq, dqs.cols);
}

// shared memory of the dk/dv pass
template <int D>
struct DkvSmem {
  static constexpr int kWgs = D == 128 ? 1 : 2;
  static constexpr int kMinBlocks = 1;  // CTAs an SM
  static constexpr int kRows = kWgs * kWgRows;  // keys a CTA
  static constexpr int kStages = D == 128 ? 3 : 4;
  static constexpr int kK = 0;
  static constexpr int kV = kK + Tile<D>::bytes(kRows);
  static constexpr int kRing = kV + Tile<D>::bytes(kRows);
  // a stage: Q, dO (by TMA), then lse and dterm (256 bytes each, stored
  // by the producer warp; padded so the next stage's tiles stay
  // 1024-aligned)
  static constexpr int kRowVals = 2 * Tile<D>::bytes(kWgRows);
  static constexpr int kStage = kRowVals + 1024;
  static constexpr int kBar = kRing + kStages * kStage;
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(DkvSmem<D>::kWgs* kWg + 32,
                                  DkvSmem<D>::kMinBlocks)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ dterm,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int H, int Sq,
                               int Skv, Strides dks, Strides dvs, float scale,
                               int causal) {
  using T = Tile<D>;
  using L = DkvSmem<D>;
  constexpr int R = L::kRows;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t base = smem_addr(smem);
  const uint32_t resident = base + L::kBar;
  const uint32_t full0 = resident + 8, empty0 = full0 + 8 * S;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * R;  // causal: the first keys see most rows
  const int n_q = (Sq + kWgRows - 1) / kWgRows;
  // causal: q-tile qi is live iff k0 < (qi + 1) * 64
  const int qi0 = causal ? k0 / kWgRows : 0;

  if (threadIdx.x == 0) {
    mbar_init(resident, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty0 + 8 * s, 4 * L::kWgs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == L::kWgs) {  // the producer warp
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(resident, 2 * T::bytes(R));
      for (int p = 0; p < T::kPanels; ++p) {
        const int off = p * R * T::kRowBytes;
        tma_rows(base + L::kK + off, &tk, resident, p * T::kPanelCols, k0, h,
                 b);
        tma_rows(base + L::kV + off, &tv, resident, p * T::kPanelCols, k0, h,
                 b);
      }
    }
    for (int qi = qi0; qi < n_q; ++qi) {
      const int i = qi - qi0;
      const int s = i % S;
      const uint32_t full = full0 + 8 * s;
      if (lane == 0) mbar_wait(empty0 + 8 * s, ((i / S) & 1) ^ 1);
      __syncwarp();
      const uint32_t qt = base + L::kRing + s * L::kStage;
      if (lane == 0) {
        mbar_expect(full, 2 * T::bytes(kWgRows));
        for (int p = 0; p < T::kPanels; ++p) {
          const int off = p * kWgRows * T::kRowBytes;
          tma_rows(qt + off, &tq, full, p * T::kPanelCols, qi * kWgRows, h,
                   b);
          tma_rows(qt + T::bytes(kWgRows) + off, &tdo, full,
                   p * T::kPanelCols, qi * kWgRows, h, b);
        }
      }
      // lse and dterm of the tile's rows as plain loads: a TMA box must
      // start 16-byte aligned, and row bh * Sq + q0 of the flat arrays
      // need not
      float* rowv = reinterpret_cast<float*>(smem + L::kRing +
                                             s * L::kStage + L::kRowVals);
      for (int r = lane; r < kWgRows; r += 32) {
        const int row = qi * kWgRows + r;
        const long long at = static_cast<long long>(bh) * Sq + row;
        rowv[r] = row < Sq ? lse[at] : 0.f;
        rowv[kWgRows + r] = row < Sq ? dterm[at] : 0.f;
      }
      mbar_arrive(full);  // releases this lane's stores with its arrival
    }
    return;
  }

  // a consumer warpgroup: keys [k0 + r0, k0 + r0 + 64)
  const int r0 = wg * kWgRows;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float c = scale * kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
  const int diag = k0 / kWgRows + wg;  // this warpgroup's diagonal q-tile
  mbar_wait(resident, 0);
  __syncwarp();  // reconverge before the .aligned wgmma ops

  for (int qi = qi0; qi < n_q; ++qi) {
    const int i = qi - qi0;
    const int s = i % S;
    mbar_wait(full0 + 8 * s, (i / S) & 1);
    __syncwarp();
    const uint32_t qt = base + L::kRing + s * L::kStage;
    const uint32_t dot = qt + T::bytes(kWgRows);
    const float* rowv = reinterpret_cast<const float*>(
        smem + L::kRing + s * L::kStage + L::kRowVals);  // lse, dterm
    if (!causal || qi >= diag) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(st, T::kmajor(base + L::kK, R, r0, kk),
                     T::kmajor(qt, kWgRows, 0, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dpt, T::kmajor(base + L::kV, R, r0, kk),
                     T::kmajor(dot, kWgRows, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<1>();  // S^T is in; dP^T still running
      hold(st);
      const bool masked = (causal && qi == diag) || (qi + 1) * kWgRows > Sq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(rowv + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p =
              ex2(fmaf(st[4 * j + e], c, -(e & 1 ? l.y : l.x) * kLog2e));
          if (masked) {
            const int key = k0 + r0 + warp * 16 + g + 8 * (e >> 1);
            const int row = qi * kWgRows + 8 * j + 2 * t + (e & 1);
            if (!(row < Sq && (!causal || key <= row))) p = 0.f;
          }
          st[4 * j + e] = p;  // P^T
        }
      }
      wgmma_wait<0>();
      hold(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(
            rowv + kWgRows + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)  // dS^T, in place
          dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] -
                                            (e & 1 ? d.y : d.x));
      }
      uint32_t ap[4][4], ads[4][4];
      acc_to_a(ap, st);
      acc_to_a(ads, dpt);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs<D>(dv_acc, ap[kc], T::mnmajor(dot, kWgRows, kc));
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs<D>(dk_acc, ads[kc], T::mnmajor(qt, kWgRows, kc));
      wgmma_commit();
      wgmma_wait<0>();
      hold(dv_acc);
      hold(dk_acc);
      hold(ap);
      hold(ads);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  store_rows<D>(dk_acc, scale, smem + L::kK, R, r0, wg,
                dk + b * dks.b + h * dks.h, dks.s, k0 + r0, Skv, dks.cols);
  store_rows<D>(dv_acc, 1.f, smem + L::kV, R, r0, wg,
                dv + b * dvs.b + h * dvs.h, dvs.s, k0 + r0, Skv, dvs.cols);
}

// ---- the f32 backward (rows 6 and 7 in f32): 3xTF32 on wgmma ----
//
// The f32 pair keeps the bf16 pair's skeleton: one producer warp issues
// every tile copy as a TMA load onto mbarriers, consumer warpgroups run
// every product as `wgmma`, and nothing is summed by atomics (two calls
// give equal bits). The tensor cores read f32 only as TF32 (10 mantissa
// bits), so every product runs three times on split operands (3xTF32):
// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), and A B = A_hi B_lo
// + A_lo B_hi + A_hi B_hi, summed in the f32 accumulator. hi is rounded
// to nearest (`cvt.rna`), because wgmma truncates the 13 low bits of
// whatever it reads: a truncated hi leaves a lo of up to one TF32 unit of
// x (2^-10), a rounded one at most half of it, and lo's own TF32 rounding
// then costs 2^-22 of x instead of 2^-21. The A_lo B_lo term is dropped:
// it is at most 2^-11 * 2^-11 = 2^-22 of |a b|, so a product term errs by
// about 2^-22 relative (f32 itself rounds at 2^-24), where a single TF32
// product errs by about 2^-11 (tests/test_torch_flash_tf32x3.py emulates
// both on the CPU).
//
// A TF32 wgmma reads both operands K-major: a descriptor cannot transpose
// 32-bit types. S = Q K^T and dP = dO V^T contract over Dh, along the
// stored rows, so both take their operands from shared memory as TMA
// writes them. The accumulating products (dq += dS K, dk += dS^T Q, dv +=
// P^T dO) contract over the streamed rows: their A operand (dS, dS^T,
// P^T) comes from registers, where the f32 accumulator of S or dP already
// holds it (one 8-column k-step in 4 registers), and their B operand is a
// transposed copy of the streamed tile that the consumers write while
// they split it.
//
// A CTA holds one producer warp and two consumer warpgroups. Both
// warpgroups own the CTA's 64 resident rows (dq: Q and dO; dk/dv: K and
// V), split into hi and lo once. Every streamed tile of kN rows (dq: K
// and V; dk/dv: Q and dO) is shared out: each warpgroup splits and
// transposes its own kN / 2 rows and runs the products over them into its
// own accumulators, so neither waits on the other inside a tile and one's
// split and exponentials overlap the other's products. Each split is done
// once per tile (hi overwrites the f32 tile in place; lo and the
// transposed copies sit beside it), never once per product. The two
// partial sums are added in a fixed order at the end.
//
// Shared memory sets the shapes: at Dh 64 the resident hi and lo tiles
// take 64 KB, a ring stage 32 KB, and a streamed tile's lo and transposed
// copies 64 KB (dq) or 96 KB (dk/dv), so the ring holds two stages within
// the 227 KB a CTA may have (one CTA an SM). At Dh 128 the resident tiles
// alone take 128 KB, and the streamed tiles shrink to 16 rows.
//
// What bounds it: operations, at the 3xTF32 rate (495 / 3 = 165 TFLOP/s
// of f32 products on an H100 SXM). At gpt_small's training shape (B 8, H
// 12, S 1024, Dh 64, causal) dq does 19.3 GFLOP (0.117 ms) and dk/dv 25.8
// (0.156 ms), against about 0.01 ms for their bytes. The design keeps the
// tensor cores fed: TMA brings the next tile while the current one is
// split and multiplied, and the two warpgroups interleave their products
// with each other's splits and exponentials. In builds that left parts
// out (timed in turns on an H100), the split of the streamed tiles was
// about a third of a pass, and issuing all of a thread's split loads
// before using any was the one change that cut it. Flat or slower, not
// kept: the two warpgroups taking turns to issue their products, the
// second tile's split beside the first tile's products, both tiles'
// loads in flight at once, a third ring stage for dq.

// the shape of the f32 backward at head dim D: streamed tiles of kN rows,
// kHalf = kN / 2 to each of the kWgs consumer warpgroups, a ring of
// kStages
template <int D>
struct Tf32Shape {
  static constexpr int kN = D == 128 ? 16 : 64;
  static constexpr int kHalf = kN / 2;
  static constexpr int kStages = 2;
  static constexpr int kWgs = 2;
};

// an f32 [rows][COLS] tile (TF32 wgmma operands, their TMA boxes)
template <int COLS>
using F32Tile = Tile<COLS, 4>;

// A TF32 A fragment (wgmma m64nNk8, A from registers) holds, per thread,
// rows g and g + 8 of its warp's 16 at k-columns t and t + 4 (g = lane /
// 4, t = lane % 4; PTX ISA, wgmma register fragments for .tf32), in the
// order (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4). An accumulator
// holds columns 2 t and 2 t + 1 of each 8-column block instead. So
// register r of a k-step's fragment takes accumulator element
// frag_from(r) of that block, and the product's k-column kappa stands for
// streamed row 2 kappa (kappa < 4) or 2 (kappa - 4) + 1 of the block: the
// transposed B tiles store streamed row r at column kpos(r).
__device__ __forceinline__ constexpr int frag_from(int r) {
  return r == 1 ? 2 : r == 2 ? 1 : r;
}
__device__ __forceinline__ int kpos(int r) {
  const int i = r & 7;
  return (r & ~7) | ((i & 1) ? 4 + (i >> 1) : (i >> 1));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (as f32 values)
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = __uint_as_float(tf32_rna(x));
  lo = __uint_as_float(tf32_rna(x - hi));
}

// x -> its hi in place; returns its lo
__device__ __forceinline__ float4 split4(float4& x) {
  float4 lo;
  split_tf32(x.x, x.x, lo.x);
  split_tf32(x.y, x.y, lo.y);
  split_tf32(x.z, x.z, lo.z);
  split_tf32(x.w, x.w, lo.w);
  return lo;
}

// generic-proxy stores to shared memory made visible to wgmma (the async
// proxy); each writing thread fences before the barrier that precedes
// the wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier of the two consumer warpgroups
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// d[64 x 8] (+)= A[64 x 8] B[8 x 8], TF32, both from shared memory
__device__ __forceinline__ void wgmma_tf32_ss_n8(float (&d)[4], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 32] (+)= A[64 x 8] B[8 x 32], TF32, both from shared memory
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t a,
                                                  uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 16] (+)= A[64 x 8] B[8 x 16], TF32, both from shared memory
__device__ __forceinline__ void wgmma_tf32_ss_n16(float (&d)[8], uint64_t a,
                                                  uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], TF32, both from shared memory
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t a,
                                                  uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t a,
                                              uint64_t b, int accumulate) {
  if constexpr (N == 8)
    wgmma_tf32_ss_n8(d, a, b, accumulate);
  else if constexpr (N == 16)
    wgmma_tf32_ss_n16(d, a, b, accumulate);
  else if constexpr (N == 32)
    wgmma_tf32_ss_n32(d, a, b, accumulate);
  else
    wgmma_tf32_ss_n64(d, a, b, accumulate);
}

// d[64 x 32] += A[64 x 8] B[8 x 32], TF32, A from registers
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 8] B[8 x 64], TF32, A from registers
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] += A[64 x 8] B[8 x 128], TF32, A from registers
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[D / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  if constexpr (D == 32)
    wgmma_tf32_rs_n32(d, a, b);
  else if constexpr (D == 64)
    wgmma_tf32_rs_n64(d, a, b);
  else
    wgmma_tf32_rs_n128(d, a, b);
}

// s = A B^T in 3xTF32 over Dh = D: A rows [a_r0, a_r0 + 64) of a
// resident hi/lo pair of a_rows rows, B rows [r0, r0 + N) of a streamed
// hi/lo pair of b_rows rows (both K-major F32Tile<D>); the first product
// overwrites s
template <int D, int N>
__device__ __forceinline__ void product_3x_ss(float (&s)[N / 2],
                                              uint32_t a_hi, uint32_t a_lo,
                                              uint32_t b_hi, uint32_t b_lo,
                                              int b_rows, int r0,
                                              int a_rows = kWgRows,
                                              int a_r0 = 0) {
  using T = F32Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32_ss<N>(s, T::kmajor(a_hi, a_rows, a_r0, kk),
                     T::kmajor(b_lo, b_rows, r0, kk), kk);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32_ss<N>(s, T::kmajor(a_lo, a_rows, a_r0, kk),
                     T::kmajor(b_hi, b_rows, r0, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32_ss<N>(s, T::kmajor(a_hi, a_rows, a_r0, kk),
                     T::kmajor(b_hi, b_rows, r0, kk), 1);
}

// the A fragments (hi and lo) of an f32 accumulator over N columns: one
// k-step of 8 columns each, in the TF32 fragment's order
template <int N>
__device__ __forceinline__ void acc_to_tf32(uint32_t (&hi)[N / 8][4],
                                            uint32_t (&lo)[N / 8][4],
                                            const float (&c)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float h, l;
      split_tf32(c[4 * j + frag_from(r)], h, l);
      hi[j][r] = __float_as_uint(h);
      lo[j][r] = __float_as_uint(l);
    }
}

// acc += A B in 3xTF32 over N streamed rows: A from registers (hi and lo
// fragments), B the transposed [D][N] hi/lo tiles
template <int D, int N>
__device__ __forceinline__ void product_3x_rs(float (&acc)[D / 2],
                                              const uint32_t (&a_hi)[N / 8][4],
                                              const uint32_t (&a_lo)[N / 8][4],
                                              uint32_t b_hi, uint32_t b_lo) {
  using TT = F32Tile<N>;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    wgmma_tf32_rs<D>(acc, a_hi[j], TT::kmajor(b_lo, D, 0, j));
    wgmma_tf32_rs<D>(acc, a_lo[j], TT::kmajor(b_hi, D, 0, j));
    wgmma_tf32_rs<D>(acc, a_hi[j], TT::kmajor(b_hi, D, 0, j));
  }
}

// split a resident f32 tile of `bytes` in place into hi, its lo to the
// same offsets of `lo` (the two consumer warpgroups together)
__device__ __forceinline__ void split_resident(unsigned char* tile,
                                               unsigned char* lo, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += 2 * kWg) {
    float4 x = reinterpret_cast<float4*>(tile)[i];
    const float4 l = split4(x);
    reinterpret_cast<float4*>(tile)[i] = x;
    reinterpret_cast<float4*>(lo)[i] = l;
  }
}

// split rows [r0, r0 + NH) of a landed [N][D] tile (one warpgroup): when
// `lo` is set, hi in place and lo to the same offsets of `lo`; when `t_hi`
// is set, both transposed into [D][NT] tiles (streamed row r0 + r at
// column kpos(r) of a tile of these rows alone, NT = NH, or kpos(r0 + r)
// of one of all N, NT = N); a thread's loads are all issued before any is
// used
template <int D, int N, int NH, int NT = NH>
__device__ __forceinline__ void split_rows(unsigned char* tile,
                                           unsigned char* lo,
                                           unsigned char* t_hi,
                                           unsigned char* t_lo, int r0) {
  using T = F32Tile<D>;
  using TT = F32Tile<NT>;
  static_assert(NT == NH || NT == N, "a tile of these rows or of all");
  constexpr int kIters = NH * D / 4 / kWg;  // 16-byte chunks a thread
  static_assert(NH * D / 4 % kWg == 0, "whole chunks a thread");
  const int tid = threadIdx.x % kWg;
  const int r = tid % NH;  // a warp's lanes take consecutive rows
  float4 x[kIters];
  int off[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    off[it] = T::chunk(N, r0 + r, (tid + it * kWg) / NH);
    x[it] = *reinterpret_cast<const float4*>(tile + off[it]);
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const float4 l = split4(x[it]);
    if (lo != nullptr) {
      *reinterpret_cast<float4*>(tile + off[it]) = x[it];
      *reinterpret_cast<float4*>(lo + off[it]) = l;
    }
    if (t_hi != nullptr) {
      const int ch = (tid + it * kWg) / NH;
      const int c = kpos(NT == NH ? r : r0 + r);
      const float hs[4] = {x[it].x, x[it].y, x[it].z, x[it].w};
      const float ls[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = TT::elem(D, 4 * ch + e, c);
        *reinterpret_cast<float*>(t_hi + at) = hs[e];
        *reinterpret_cast<float*>(t_lo + at) = ls[e];
      }
    }
  }
}

// the two consumer warpgroups' partial sums of a 64 x D f32 result ->
// (part 0 + part 1) * mul in rows [row0, row0 + 64) of out: each
// warpgroup stages its part in its area (resident tiles no product reads
// any more), then each sums 32 rows and stores them in 16-byte pieces
// (the columns < cols)
template <int D>
__device__ __forceinline__ void store_pair(const float (&acc)[D / 2],
                                           float mul, unsigned char* area0,
                                           unsigned char* area1, int wg,
                                           float* out, long long row_stride,
                                           int row0, int n_rows, int cols) {
  using T = F32Tile<D>;
  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x / 32) % 4 * 16 + lane / 4;
  unsigned char* mine = wg == 0 ? area0 : area1;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(
          mine + T::elem(kWgRows, r + 8 * i, 8 * j + 2 * (lane % 4))) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  consumers_sync();
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x % kWg; idx < kWgRows / 2 * kChunks;
       idx += kWg) {
    const int rr = wg * (kWgRows / 2) + idx / kChunks;
    const int ch = idx % kChunks;
    const int row = row0 + rr;
    const float4 a =
        *reinterpret_cast<const float4*>(area0 + T::chunk(kWgRows, rr, ch));
    const float4 b =
        *reinterpret_cast<const float4*>(area1 + T::chunk(kWgRows, rr, ch));
    if (row < n_rows && 4 * ch < cols)
      *reinterpret_cast<float4*>(out + row * row_stride + 4 * ch) =
          make_float4((a.x + b.x) * mul, (a.y + b.y) * mul,
                      (a.z + b.z) * mul, (a.w + b.w) * mul);
  }
}

// shared memory of the f32 dq pass (byte offsets from a 1024-aligned base)
template <int D>
struct DqTf32Smem {
  using T = F32Tile<D>;
  using TT = F32Tile<Tf32Shape<D>::kHalf>;
  static constexpr int kN = Tf32Shape<D>::kN;
  static constexpr int kStages = Tf32Shape<D>::kStages;
  static constexpr int kQ = 0;  // Q hi (in place), lo; dO hi, lo
  static constexpr int kQlo = kQ + T::bytes(kWgRows);
  static constexpr int kDO = kQlo + T::bytes(kWgRows);
  static constexpr int kDOlo = kDO + T::bytes(kWgRows);
  static constexpr int kRing = kDOlo + T::bytes(kWgRows);
  static constexpr int kStage = 2 * T::bytes(kN);  // K, V (hi in place)
  static constexpr int kKlo = kRing + kStages * kStage;
  static constexpr int kVlo = kKlo + T::bytes(kN);
  static constexpr int kKT = kVlo + T::bytes(kN);  // a warpgroup's K^T hi, lo
  static constexpr int kKTWg = 2 * TT::bytes(D);
  static constexpr int kBar = kKT + Tf32Shape<D>::kWgs * kKTWg;
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(Tf32Shape<D>::kWgs* kWg + 32, 1)
    flash_bwd_dq_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ dterm,
                               float* __restrict__ dq, int H, int Sq, int Skv,
                               Strides dqs, float scale, int causal) {
  using T = F32Tile<D>;
  using L = DqTf32Smem<D>;
  constexpr int N = L::kN;
  constexpr int NH = Tf32Shape<D>::kHalf;
  constexpr int S = L::kStages;
  constexpr int W = Tf32Shape<D>::kWgs;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t base = smem_addr(smem);
  const uint32_t resident = base + L::kBar;
  const uint32_t full0 = resident + 8, empty0 = full0 + 8 * S;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qi = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qi * kWgRows;
  int n_k = (Skv + N - 1) / N;
  if (causal) n_k = min(n_k, (q0 + kWgRows) / N);  // live iff k0 < q_end

  if (threadIdx.x == 0) {
    mbar_init(resident, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * W);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == W) {  // the producer warp
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(resident, 2 * T::bytes(kWgRows));
      for (int p = 0; p < T::kPanels; ++p) {
        const int off = p * kWgRows * T::kRowBytes;
        tma_rows(base + L::kQ + off, &tq, resident, p * T::kPanelCols, q0, h,
                 b);
        tma_rows(base + L::kDO + off, &tdo, resident, p * T::kPanelCols, q0,
                 h, b);
      }
      for (int kb = 0; kb < n_k; ++kb) {
        const int s = kb % S;
        mbar_wait(empty0 + 8 * s, ((kb / S) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, L::kStage);
        const uint32_t kt = base + L::kRing + s * L::kStage;
        for (int p = 0; p < T::kPanels; ++p) {
          const int off = p * N * T::kRowBytes;
          tma_rows(kt + off, &tk, full0 + 8 * s, p * T::kPanelCols, kb * N,
                   h, b);
          tma_rows(kt + T::bytes(N) + off, &tv, full0 + 8 * s,
                   p * T::kPanelCols, kb * N, h, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: all 64 query rows, keys [wg NH, wg NH + NH) of
  // every streamed tile
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float c = scale * kLog2e;
  float lse2[2], dt[2];  // this thread's two rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    const long long at = static_cast<long long>(bh) * Sq + row;
    lse2[i] = row < Sq ? lse[at] * kLog2e : 0.f;
    dt[i] = row < Sq ? dterm[at] : 0.f;
  }
  unsigned char* kt_hi = smem + L::kKT + wg * L::kKTWg;
  unsigned char* kt_lo = kt_hi + L::kKTWg / 2;
  mbar_wait(resident, 0);
  __syncwarp();
  split_resident(smem + L::kQ, smem + L::kQlo, T::bytes(kWgRows));
  split_resident(smem + L::kDO, smem + L::kDOlo, T::bytes(kWgRows));
  fence_async_smem();
  consumers_sync();
  float acc[D / 2], sc[NH / 2], dp[NH / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) sc[i] = dp[i] = 0.f;

  for (int kb = 0; kb < n_k; ++kb) {
    const int s = kb % S;
    mbar_wait(full0 + 8 * s, (kb / S) & 1);
    __syncwarp();
    const int st = L::kRing + s * L::kStage;  // K, then V
    split_rows<D, N, NH>(smem + st, smem + L::kKlo, kt_hi, kt_lo, wg * NH);
    split_rows<D, N, NH>(smem + st + T::bytes(N), smem + L::kVlo, nullptr,
                         nullptr, wg * NH);
    fence_async_smem();
    wg_sync(2 + wg);
    wgmma_fence();
    product_3x_ss<D, NH>(sc, base + L::kQ, base + L::kQlo, base + st,
                         base + L::kKlo, N, wg * NH);
    wgmma_commit();
    product_3x_ss<D, NH>(dp, base + L::kDO, base + L::kDOlo,
                         base + st + T::bytes(N), base + L::kVlo, N, wg * NH);
    wgmma_commit();
    wgmma_wait<1>();  // S is in; dP still running
    hold(sc);
    const int kw0 = kb * N + wg * NH;  // this warpgroup's first key
    const bool masked = (causal && kw0 + NH - 1 > q0) || kw0 + NH > Skv;
#pragma unroll
    for (int j = 0; j < NH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(sc[4 * j + e], c, -lse2[e >> 1]));
        if (masked) {
          const int row = q0 + warp * 16 + g + 8 * (e >> 1);
          const int col = kw0 + 8 * j + 2 * t + (e & 1);
          if (!(col < Skv && (!causal || col <= row))) p = 0.f;
        }
        sc[4 * j + e] = p;
      }
    wgmma_wait<0>();
    hold(dp);
#pragma unroll
    for (int i = 0; i < NH / 2; ++i)
      sc[i] *= dp[i] - dt[(i >> 1) & 1];  // dS, in place
    uint32_t a_hi[NH / 8][4], a_lo[NH / 8][4];
    acc_to_tf32<NH>(a_hi, a_lo, sc);
    wgmma_fence();
    product_3x_rs<D, NH>(acc, a_hi, a_lo, smem_addr(kt_hi),
                         smem_addr(kt_lo));
    wgmma_commit();
    wgmma_wait<0>();
    hold(acc);
    hold(a_hi);
    hold(a_lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  consumers_sync();  // every product is done: the resident tiles are free
  store_pair<D>(acc, scale, smem + L::kQ, smem + L::kQlo, wg,
                dq + b * dqs.b + h * dqs.h, dqs.s, q0, Sq, dqs.cols);
}

// shared memory of the f32 dk/dv pass
template <int D>
struct DkvTf32Smem {
  using T = F32Tile<D>;
  using TT = F32Tile<Tf32Shape<D>::kHalf>;
  static constexpr int kN = Tf32Shape<D>::kN;
  static constexpr int kStages = Tf32Shape<D>::kStages;
  static constexpr int kK = 0;  // K hi (in place), lo; V hi, lo
  static constexpr int kKlo = kK + T::bytes(kWgRows);
  static constexpr int kV = kKlo + T::bytes(kWgRows);
  static constexpr int kVlo = kV + T::bytes(kWgRows);
  static constexpr int kRing = kVlo + T::bytes(kWgRows);
  static constexpr int kStage = 2 * T::bytes(kN);  // Q, dO (hi in place)
  static constexpr int kQlo = kRing + kStages * kStage;
  static constexpr int kDOlo = kQlo + T::bytes(kN);
  // a warpgroup's Q^T hi, lo, dO^T hi, lo
  static constexpr int kT = kDOlo + T::bytes(kN);
  static constexpr int kTWg = 4 * TT::bytes(D);
  // each stage's lse and dterm (stored by the producer warp's lanes)
  static constexpr int kRowv = kT + Tf32Shape<D>::kWgs * kTWg;
  static constexpr int kBar = kRowv + kStages * 2 * kN * 4;
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(Tf32Shape<D>::kWgs* kWg + 32, 1)
    flash_bwd_dkv_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const float* __restrict__ lse,
                                const float* __restrict__ dterm,
                                float* __restrict__ dk, float* __restrict__ dv,
                                int H, int Sq, int Skv, Strides dks,
                                Strides dvs, float scale, int causal) {
  using T = F32Tile<D>;
  using TT = F32Tile<Tf32Shape<D>::kHalf>;
  using L = DkvTf32Smem<D>;
  constexpr int N = L::kN;
  constexpr int NH = Tf32Shape<D>::kHalf;
  constexpr int S = L::kStages;
  constexpr int W = Tf32Shape<D>::kWgs;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t base = smem_addr(smem);
  const uint32_t resident = base + L::kBar;
  const uint32_t full0 = resident + 8, empty0 = full0 + 8 * S;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kWgRows;  // causal: the first keys see most rows
  const int n_q = (Sq + N - 1) / N;
  // causal: q-tile qi is live iff k0 < (qi + 1) * N
  const int qi0 = causal ? k0 / N : 0;

  if (threadIdx.x == 0) {
    mbar_init(resident, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty0 + 8 * s, 4 * W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == W) {  // the producer warp
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(resident, 2 * T::bytes(kWgRows));
      for (int p = 0; p < T::kPanels; ++p) {
        const int off = p * kWgRows * T::kRowBytes;
        tma_rows(base + L::kK + off, &tk, resident, p * T::kPanelCols, k0, h,
                 b);
        tma_rows(base + L::kV + off, &tv, resident, p * T::kPanelCols, k0, h,
                 b);
      }
    }
    for (int qi = qi0; qi < n_q; ++qi) {
      const int i = qi - qi0;
      const int s = i % S;
      const uint32_t full = full0 + 8 * s;
      if (lane == 0) mbar_wait(empty0 + 8 * s, ((i / S) & 1) ^ 1);
      __syncwarp();
      const uint32_t qt = base + L::kRing + s * L::kStage;
      if (lane == 0) {
        mbar_expect(full, L::kStage);
        for (int p = 0; p < T::kPanels; ++p) {
          const int off = p * N * T::kRowBytes;
          tma_rows(qt + off, &tq, full, p * T::kPanelCols, qi * N, h, b);
          tma_rows(qt + T::bytes(N) + off, &tdo, full, p * T::kPanelCols,
                   qi * N, h, b);
        }
      }
      // lse and dterm of the tile's rows as plain loads: a TMA box must
      // start 16-byte aligned, and row bh * Sq + q0 of the flat arrays
      // need not
      float* rowv = reinterpret_cast<float*>(smem + L::kRowv) + s * 2 * N;
      for (int r = lane; r < N; r += 32) {
        const int row = qi * N + r;
        const long long at = static_cast<long long>(bh) * Sq + row;
        rowv[r] = row < Sq ? lse[at] : 0.f;
        rowv[N + r] = row < Sq ? dterm[at] : 0.f;
      }
      mbar_arrive(full);  // releases this lane's stores with its arrival
    }
    return;
  }

  // a consumer warpgroup: all 64 keys, query rows [wg NH, wg NH + NH) of
  // every streamed tile
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float c = scale * kLog2e;
  unsigned char* tq_hi = smem + L::kT + wg * L::kTWg;  // Q^T hi, lo
  unsigned char* tq_lo = tq_hi + TT::bytes(D);
  unsigned char* tdo_hi = tq_lo + TT::bytes(D);  // dO^T hi, lo
  unsigned char* tdo_lo = tdo_hi + TT::bytes(D);
  mbar_wait(resident, 0);
  __syncwarp();
  split_resident(smem + L::kK, smem + L::kKlo, T::bytes(kWgRows));
  split_resident(smem + L::kV, smem + L::kVlo, T::bytes(kWgRows));
  fence_async_smem();
  consumers_sync();
  float dk_acc[D / 2], dv_acc[D / 2], st[NH / 2], dpt[NH / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) st[i] = dpt[i] = 0.f;

  for (int qi = qi0; qi < n_q; ++qi) {
    const int i = qi - qi0;
    const int s = i % S;
    mbar_wait(full0 + 8 * s, (i / S) & 1);
    __syncwarp();
    const int sq = L::kRing + s * L::kStage;  // Q, then dO
    split_rows<D, N, NH>(smem + sq, smem + L::kQlo, tq_hi, tq_lo, wg * NH);
    split_rows<D, N, NH>(smem + sq + T::bytes(N), smem + L::kDOlo, tdo_hi,
                         tdo_lo, wg * NH);
    fence_async_smem();
    wg_sync(2 + wg);
    wgmma_fence();
    product_3x_ss<D, NH>(st, base + L::kK, base + L::kKlo, base + sq,
                         base + L::kQlo, N, wg * NH);
    wgmma_commit();
    product_3x_ss<D, NH>(dpt, base + L::kV, base + L::kVlo,
                         base + sq + T::bytes(N), base + L::kDOlo, N,
                         wg * NH);
    wgmma_commit();
    wgmma_wait<1>();  // S^T is in; dP^T still running
    hold(st);
    const float* rowv = reinterpret_cast<const float*>(smem + L::kRowv) +
                        s * 2 * N + wg * NH;  // lse; dterm at + N
    const int qw0 = qi * N + wg * NH;  // this warpgroup's first row
    const bool masked = (causal && k0 + kWgRows - 1 > qw0) || qw0 + NH > Sq;
#pragma unroll
    for (int j = 0; j < NH / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(rowv + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(st[4 * j + e], c, -(e & 1 ? l.y : l.x) * kLog2e));
        if (masked) {
          const int key = k0 + warp * 16 + g + 8 * (e >> 1);
          const int row = qw0 + 8 * j + 2 * t + (e & 1);
          if (!(row < Sq && (!causal || key <= row))) p = 0.f;
        }
        st[4 * j + e] = p;  // P^T
      }
    }
    wgmma_wait<0>();
    hold(dpt);
#pragma unroll
    for (int j = 0; j < NH / 8; ++j) {
      const float2 d =
          *reinterpret_cast<const float2*>(rowv + N + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)  // dS^T, in place
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] -
                                          (e & 1 ? d.y : d.x));
    }
    uint32_t p_hi[NH / 8][4], p_lo[NH / 8][4], ds_hi[NH / 8][4],
        ds_lo[NH / 8][4];
    acc_to_tf32<NH>(p_hi, p_lo, st);
    acc_to_tf32<NH>(ds_hi, ds_lo, dpt);
    wgmma_fence();
    product_3x_rs<D, NH>(dv_acc, p_hi, p_lo, smem_addr(tdo_hi),
                         smem_addr(tdo_lo));
    product_3x_rs<D, NH>(dk_acc, ds_hi, ds_lo, smem_addr(tq_hi),
                         smem_addr(tq_lo));
    wgmma_commit();
    wgmma_wait<0>();
    hold(dv_acc);
    hold(dk_acc);
    hold(p_hi);
    hold(p_lo);
    hold(ds_hi);
    hold(ds_lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  consumers_sync();  // every product is done: the resident tiles are free
  store_pair<D>(dk_acc, scale, smem + L::kK, smem + L::kKlo, wg,
                dk + b * dks.b + h * dks.h, dks.s, k0, Skv, dks.cols);
  store_pair<D>(dv_acc, 1.f, smem + L::kV, smem + L::kVlo, wg,
                dv + b * dvs.b + h * dvs.h, dvs.s, k0, Skv, dvs.cols);
}

// ---- the f32 forward (row 5 in f32): 3xTF32 on wgmma ----
//
// The f32 backward's skeleton with one product fewer and an online
// softmax in place of the lse-based P. The producer warp brings the
// CTA's query rows once (the `resident` barrier) and streams K and V
// through the ring, tiles of kN keys (16 at Dh 128, as the backward);
// causal tiles wholly above the diagonal are never loaded, and the grid
// runs the longest rows first. A CTA takes 128 query rows, 64 a consumer
// warpgroup, and each warpgroup runs every key of every tile. Each
// landed tile is split once for both, half its rows by each warpgroup: K
// rows into hi (in place) and lo, V rows into transposed [D][keys] hi/lo
// tiles (the B operand of P V, which contracts over the keys; a TF32
// wgmma reads only K-major operands). The split goes to one of two split
// buffers, taken in turns, so a warpgroup may split the next tile while
// the other still reads this one; one barrier of both warpgroups a tile.
// Per tile a warpgroup then runs S = Q K^T (3xTF32, both operands from
// shared memory; skipped where the causal tile lies wholly above its 64
// rows), frees the ring stage, runs the online softmax on the
// accumulator's registers in the log2 domain (masks only on the diagonal
// and the ragged last tile; a negative scale flips the logits, a zero
// one keeps c at 1e-30 so a masked -inf never meets a 0), rescales O,
// splits P into hi/lo A fragments and adds P V (3xTF32, A from
// registers). P stays f32, as the Pallas kernel's `p.astype(v.dtype)` is
// a no-op in f32. The epilogue divides O by l, stores each thread's
// column pairs (a quad fills a 32-byte sector) and writes the
// natural-log lse, m / log2 e + ln l, which the backward pair and ring
// attention read. Rows past Sq and keys past Skv come zero-filled from
// TMA and are never written or counted.
//
// What bounds it: operations at the 3xTF32 rate. At gpt_small's training
// shape (B 8, H 12, S 1024, Dh 64, causal) the forward does 12.9 GFLOP
// (0.078 ms at 165 TFLOP/s) against about 0.015 ms for its bytes. A TF32
// wgmma takes 8 columns of K a step, so an m64nNk8 product with both
// operands in shared memory reads 32 (64 + N) bytes for 1024 N flops: at
// N = 64 that is the SM's 16 TF32 flops per byte of shared memory, at N
// = 32 shared memory runs out first. So S runs at N = 64 over a whole
// tile, and a tile is split once per 128 rows. Shared memory at Dh 64: Q
// hi and lo 64 KB, two ring stages of K and V 64 KB, two split buffers of
// K lo and V^T hi/lo 96 KB: 226 KB, one CTA an SM (no room for a third
// stage). Measured on an NVIDIA H100 80GB HBM3 at 700 W at that shape,
// builds timed in turns in one process by `ab_flash_fwd.py --dtype
// float32`: this layout 0.2008 ms. Slower, in builds not kept: 64 rows a
// CTA with both warpgroups on every row, each on half of every tile's
// keys and a merge of their two partials (S at N = 32, a tile split once
// per 64 rows: 0.2682 ms with 2 stages, 0.2721 with 3); Q's hi/lo A
// fragments held in registers for S (ptxas caps 288 threads at 168
// registers a thread: 40-292 bytes of spills and serialised wgmma, 0.2529
// ms); issuing tile j + 1's S beside tile j's P V with a second split
// buffer (64 rows: 0.3465 ms).

// the ring stages of the f32 forward at head dim D (the constant
// ab_flash_fwd.py replaces)
template <int D>
struct FwdTf32Shape {
  static constexpr int kStages = 2;
};

// shared memory of the f32 forward (byte offsets from a 1024-aligned base)
template <int D>
struct FwdTf32Smem {
  using T = F32Tile<D>;
  static constexpr int kRows = 2 * kWgRows;  // query rows a CTA
  static constexpr int kN = Tf32Shape<D>::kN;
  using TT = F32Tile<kN>;
  static constexpr int kStages = FwdTf32Shape<D>::kStages;
  static constexpr int kQ = 0;  // Q hi (in place), lo
  static constexpr int kQlo = kQ + T::bytes(kRows);
  static constexpr int kRing = kQlo + T::bytes(kRows);
  static constexpr int kStage = 2 * T::bytes(kN);  // K (hi in place), V
  // two split buffers, taken in turns: K lo, then V^T hi and lo
  static constexpr int kSplit0 = kRing + kStages * kStage;
  static constexpr int kVt = T::bytes(kN);
  static constexpr int kSplit = kVt + 2 * TT::bytes(D);
  static constexpr int kBar = kSplit0 + 2 * kSplit;
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(2 * kWg + 32, 1)
    flash_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            float* __restrict__ out, float* __restrict__ lse,
                            int H, int Sq, int Skv, Strides os, float scale,
                            int causal) {
  using T = F32Tile<D>;
  using L = FwdTf32Smem<D>;
  constexpr int R = L::kRows;
  constexpr int N = L::kN;
  constexpr int S = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const uint32_t base = smem_addr(smem);
  const uint32_t resident = base + L::kBar;
  const uint32_t full0 = resident + 8, empty0 = full0 + 8 * S;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qi = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qi * R;
  int n_k = (Skv + N - 1) / N;
  if (causal) n_k = min(n_k, (q0 + R) / N);  // live iff k0 < q_end

  if (threadIdx.x == 0) {
    mbar_init(resident, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 2) {  // the producer warp
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(resident, T::bytes(R));
      for (int p = 0; p < T::kPanels; ++p)
        tma_rows(base + L::kQ + p * R * T::kRowBytes, &tq, resident,
                 p * T::kPanelCols, q0, h, b);
      for (int kb = 0; kb < n_k; ++kb) {
        const int s = kb % S;
        mbar_wait(empty0 + 8 * s, ((kb / S) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, L::kStage);
        const uint32_t kt = base + L::kRing + s * L::kStage;
        for (int p = 0; p < T::kPanels; ++p) {
          const int off = p * N * T::kRowBytes;
          tma_rows(kt + off, &tk, full0 + 8 * s, p * T::kPanelCols, kb * N,
                   h, b);
          tma_rows(kt + T::bytes(N) + off, &tv, full0 + 8 * s,
                   p * T::kPanelCols, kb * N, h, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: query rows [q0 + r0, q0 + r0 + 64), every key
  // of every streamed tile; it splits tile rows [wg N / 2, wg N / 2 + N /
  // 2)
  const int r0 = wg * kWgRows;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int row0 = q0 + r0 + warp * 16;  // this warp's first row
  // the row max is taken on the raw logits, so a negative scale flips
  // them first and goes to the exponent as |scale| (at least 1e-30: a
  // zero scale must not turn a masked -inf into 0 * -inf = NaN)
  const bool flip = scale < 0.f;
  const float c = fmaxf(fabsf(scale) * kLog2e, 1e-30f);
  mbar_wait(resident, 0);
  __syncwarp();
  split_resident(smem + L::kQ, smem + L::kQlo, T::bytes(R));
  fence_async_smem();
  consumers_sync();
  float o[D / 2], sc[N / 2], m[2] = {-INFINITY, -INFINITY},
                             l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sc[i] = 0.f;

  for (int kb = 0; kb < n_k; ++kb) {
    const int s = kb % S;
    mbar_wait(full0 + 8 * s, (kb / S) & 1);
    __syncwarp();
    const int st = L::kRing + s * L::kStage;  // K, then V
    unsigned char* klo = smem + L::kSplit0 + (kb % 2) * L::kSplit;
    unsigned char* vt_hi = klo + L::kVt;
    unsigned char* vt_lo = vt_hi + F32Tile<N>::bytes(D);
    split_rows<D, N, N / 2, N>(smem + st, klo, nullptr, nullptr,
                               wg * (N / 2));
    split_rows<D, N, N / 2, N>(smem + st + T::bytes(N), nullptr, vt_hi,
                               vt_lo, wg * (N / 2));
    fence_async_smem();
    consumers_sync();
    const int k0 = kb * N;
    const bool live = !causal || k0 <= q0 + r0 + kWgRows - 1;
    if (live) {
      wgmma_fence();
      product_3x_ss<D, N>(sc, base + L::kQ, base + L::kQlo, base + st,
                          smem_addr(klo), N, 0, R, r0);
      wgmma_commit();
      wgmma_wait<0>();
      hold(sc);
    }
    // the stage is free: S has read K, and V sits split in the buffer
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if (live) {
      if (flip) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) sc[i] = -sc[i];
      }
      float corr[2];
      softmax_tile<N>(sc, m, l, corr, c,
                      (causal && k0 + N - 1 > q0 + r0) || k0 + N > Skv,
                      row0, k0, Skv, causal);
      rescale<D>(o, corr);
      uint32_t p_hi[N / 8][4], p_lo[N / 8][4];
      acc_to_tf32<N>(p_hi, p_lo, sc);
      wgmma_fence();
      product_3x_rs<D, N>(o, p_hi, p_lo, smem_addr(vt_hi),
                          smem_addr(vt_lo));
      wgmma_commit();
      wgmma_wait<0>();
      hold(o);
      hold(p_hi);
      hold(p_lo);
    }
  }

  // O / l and lse = m / log2 e + ln l; each thread stores its own column
  // pairs (a quad's four lanes fill one 32-byte sector a row)
  float* o_base = out + b * os.b + h * os.h;
  float f[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_safe = fmaxf(quad_sum(l[i]), 1e-30f);
    f[i] = 1.f / l_safe;
    const int row = row0 + g + 8 * i;
    if (lane % 4 == 0 && row < Sq)
      lse[static_cast<long long>(bh) * Sq + row] =
          m[i] / kLog2e + logf(l_safe);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row < Sq) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        if (8 * j + 2 * (lane % 4) < os.cols)
          *reinterpret_cast<float2*>(o_base + row * os.s + 8 * j +
                                     2 * (lane % 4)) =
              make_float2(o[4 * j + 2 * i] * f[i],
                          o[4 * j + 2 * i + 1] * f[i]);
    }
  }
}

Strides strides_at(const long long* s, int i, int cols) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2], cols};
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

using bf16 = __nv_bfloat16;

// launch one pass with the dynamic shared memory it needs
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t bytes,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// ---- host: TMA descriptors, encoded per call ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 or f32 [B, S, H, Dh] view (unit Dh stride) over its real
// dimensions (Dh, S, H, B) and byte strides, in boxes of one panel x
// `rows` rows, swizzled as Tile<D, 2> (bf16) or Tile<D, 4> (f32); rows past
// S and columns past Dh (a tile of D >= Dh columns) read as zeros, which
// add nothing to Q K^T and give zero columns of P V. Returns the CUresult.
template <int D, bool F32>
int map_rows(CUtensorMap* map, const void* p, int B, int S, int H,
             Strides st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  constexpr int elt = F32 ? 4 : 2;
  using T = Tile<D, elt>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(st.cols),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * elt,
                                 static_cast<cuuint64_t>(st.h) * elt,
                                 static_cast<cuuint64_t>(st.b) * elt};
  const cuuint32_t box[4] = {T::kPanelCols, static_cast<cuuint32_t>(rows),
                             1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map,
                F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// what an entry returns when cuTensorMapEncodeTiled refuses a descriptor:
// kTmaRefused + the CUresult (the Python wrapper names it)
constexpr int kTmaRefused = 100000;

// the descriptors of one pass: tensor i (its pointer, its length and
// the rows of its box) with the strides at i
template <int D, bool F32, int N>
int make_maps(CUtensorMap (&m)[N], const void* const (&ptrs)[N],
              const int (&lens)[N], const int (&rows)[N], int B, int H,
              const long long* st, int dh) {
  for (int i = 0; i < N; ++i) {
    const int err = map_rows<D, F32>(&m[i], ptrs[i], B, lens[i], H,
                                     strides_at(st, i, dh), rows[i]);
    if (err != CUDA_SUCCESS) return kTmaRefused + err;
  }
  return 0;
}

template <int D>
cudaError_t fwd(int dtype, const void* q, const void* k, const void* v,
                void* out, float* lse, int B, int H, int Sq, int Skv,
                int dh, const long long* st, float scale, int causal,
                cudaStream_t stream) {
  const Strides s3 = strides_at(st, 3, dh);
  if (dtype == 1) {
    using L = FwdSmem<D>;
    CUtensorMap m[3];
    const int err = make_maps<D, false>(m, {q, k, v}, {Sq, Skv, Skv},
                                 {L::kRows, kWgRows, kWgRows}, B, H, st, dh);
    if (err != 0) return static_cast<cudaError_t>(err);
    return launch(flash_fwd_wgmma_kernel<D>,
                  dim3(B * H, (Sq + L::kRows - 1) / L::kRows),
                  L::kWgs * kWg + 32, L::kBytes, stream, m[0], m[1], m[2],
                  static_cast<bf16*>(out), lse, H, Sq, Skv, s3, scale,
                  causal);
  }
  using L = FwdTf32Smem<D>;
  CUtensorMap m[3];
  const int err = make_maps<D, true>(m, {q, k, v}, {Sq, Skv, Skv},
                                     {L::kRows, L::kN, L::kN}, B, H, st, dh);
  if (err != 0) return static_cast<cudaError_t>(err);
  return launch(flash_fwd_tf32x3_kernel<D>,
                dim3(B * H, (Sq + L::kRows - 1) / L::kRows), 2 * kWg + 32,
                L::kBytes, stream, m[0], m[1], m[2], static_cast<float*>(out),
                lse, H, Sq, Skv, s3, scale, causal);
}

template <int D>
cudaError_t bwd_dq(int dtype, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dterm,
                   void* dq, int B, int H, int Sq, int Skv, int dh,
                   const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  const Strides s4 = strides_at(st, 4, dh);
  CUtensorMap m[4];
  if (dtype == 1) {
    constexpr int R = DqSmem<D>::kRows;
    const int err = make_maps<D, false>(m, {q, k, v, dout},
                                        {Sq, Skv, Skv, Sq},
                                        {R, kWgRows, kWgRows, R}, B, H, st, dh);
    if (err != 0) return static_cast<cudaError_t>(err);
    return launch(flash_bwd_dq_wgmma_kernel<D>,
                  dim3(B * H, (Sq + R - 1) / R), DqSmem<D>::kWgs * kWg + 32,
                  DqSmem<D>::kBytes, stream, m[0], m[1], m[2], m[3], lse,
                  dterm, static_cast<bf16*>(dq), H, Sq, Skv, s4, scale,
                  causal);
  }
  using L = DqTf32Smem<D>;
  const int err = make_maps<D, true>(m, {q, k, v, dout}, {Sq, Skv, Skv, Sq},
                                     {kWgRows, L::kN, L::kN, kWgRows}, B, H,
                                     st, dh);
  if (err != 0) return static_cast<cudaError_t>(err);
  return launch(flash_bwd_dq_tf32x3_kernel<D>,
                dim3(B * H, (Sq + kWgRows - 1) / kWgRows),
                Tf32Shape<D>::kWgs * kWg + 32, L::kBytes, stream, m[0], m[1],
                m[2], m[3], lse, dterm, static_cast<float*>(dq), H, Sq, Skv,
                s4, scale, causal);
}

template <int D>
cudaError_t bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* dterm,
                    void* dk, void* dv, int B, int H, int Sq, int Skv,
                    int dh, const long long* st, float scale, int causal,
                    cudaStream_t stream) {
  const Strides s4 = strides_at(st, 4, dh),
                s5 = strides_at(st, 5, dh);
  CUtensorMap m[4];
  if (dtype == 1) {
    constexpr int R = DkvSmem<D>::kRows;
    const int err = make_maps<D, false>(m, {q, k, v, dout},
                                        {Sq, Skv, Skv, Sq},
                                        {kWgRows, R, R, kWgRows}, B, H, st, dh);
    if (err != 0) return static_cast<cudaError_t>(err);
    return launch(flash_bwd_dkv_wgmma_kernel<D>,
                  dim3(B * H, (Skv + R - 1) / R), DkvSmem<D>::kWgs * kWg + 32,
                  DkvSmem<D>::kBytes, stream, m[0], m[1], m[2], m[3], lse,
                  dterm, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H,
                  Sq, Skv, s4, s5, scale, causal);
  }
  using L = DkvTf32Smem<D>;
  const int err = make_maps<D, true>(m, {q, k, v, dout}, {Sq, Skv, Skv, Sq},
                                     {L::kN, kWgRows, kWgRows, L::kN}, B, H,
                                     st, dh);
  if (err != 0) return static_cast<cudaError_t>(err);
  return launch(flash_bwd_dkv_tf32x3_kernel<D>,
                dim3(B * H, (Skv + kWgRows - 1) / kWgRows),
                Tf32Shape<D>::kWgs * kWg + 32, L::kBytes, stream, m[0], m[1],
                m[2], m[3], lse, dterm, static_cast<float*>(dk),
                static_cast<float*>(dv), H, Sq, Skv, s4, s5, scale, causal);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D is the head_dim, 1 <= D <= 128 with
// 16-byte rows (a multiple of 8 in bf16, of 4 in f32), run on the tile of
// 32, 64 or 128 columns that holds it (the TMA maps read zeros past D, the
// stores skip those columns). `strides` holds (b, s, h) element strides per
// tensor, in argument order (the Dh stride must be 1; the Python wrapper
// checks it and pads any other head_dim). lse and dterm are contiguous f32
// [B * H, Sq]. Each entry returns a cudaError_t.
#define PMDT_DISPATCH(CALL)                                        \
  if ((dtype != 0 && dtype != 1) || D < 1 || D > 128 ||            \
      D * (dtype == 0 ? 4 : 2) % 16 != 0)                          \
    return static_cast<int>(cudaErrorInvalidValue);                \
  if (D <= 32) return static_cast<int>(CALL(32));                  \
  if (D <= 64) return static_cast<int>(CALL(64));                  \
  return static_cast<int>(CALL(128));

extern "C" int pmdt_flash_fwd(const void* q, const void* k, const void* v,
                              void* out, float* lse, int B, int H, int Sq,
                              int Skv, int D, int dtype,
                              const long long* strides, float scale,
                              int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PMDT_FWD(DIM) \
  fwd<DIM>(dtype, q, k, v, out, lse, B, H, Sq, Skv, D, strides, scale, \
           causal, s)
  PMDT_DISPATCH(PMDT_FWD)
#undef PMDT_FWD
}

extern "C" int pmdt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* dterm, void* dq, int B, int H,
                                 int Sq, int Skv, int D, int dtype,
                                 const long long* strides, float scale,
                                 int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PMDT_DQ(DIM)                                                  \
  bwd_dq<DIM>(dtype, q, k, v, dout, lse, dterm, dq, B, H, Sq, Skv, D,   \
              strides, scale, causal, s)
  PMDT_DISPATCH(PMDT_DQ)
#undef PMDT_DQ
}

extern "C" int pmdt_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* dterm,
                                  void* dk, void* dv, int B, int H, int Sq,
                                  int Skv, int D, int dtype,
                                  const long long* strides, float scale,
                                  int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PMDT_DKV(DIM)                                                 \
  bwd_dkv<DIM>(dtype, q, k, v, dout, lse, dterm, dk, dv, B, H, Sq, Skv, \
               D, strides, scale, causal, s)
  PMDT_DISPATCH(PMDT_DKV)
#undef PMDT_DKV
}
#undef PMDT_DISPATCH
