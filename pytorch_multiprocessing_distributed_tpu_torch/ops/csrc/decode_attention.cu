// Flash-decode attention for Hopper (sm_90a): one cached query per slot
// over its KV window (rows 1 and 2 of the port's kernel table, at the end
// of the file), and its k-query twin, the speculative verify pass (rows 3
// and 4, whose shared-memory ring the decode kernels reuse). f32 online
// softmax, f32 output.
//
// The decode kernels replace, in pytorch_multiprocessing_distributed_tpu/
// ops/pallas/decode_attention.py:
//
//   dense, model dtype  — `_decode_kernel` (quant=False), `_pallas_decode`
//   dense, int8 + scale — `_decode_kernel` (quant=True)
//   paged, model dtype  — `_paged_decode_kernel` (quant=False),
//                         `_pallas_paged_decode`
//   paged, int8 + scale — `_paged_decode_kernel` (quant=True)
//
//   out[b, 0, h, :] = softmax(q[b,0,h,:] . K[b, 0..n_b-1, h, :]^T * Dh^-1/2)
//                     . V[b, 0..n_b-1, h, :],   n_b = min(pos_b, W-1) + 1
//
// Column c of slot b lives at row (base, c') of the K/V storage:
//   dense: base = b, c' = c            (k[b, c, h, :], any strides)
//   paged: base = table[b, c / ps], c' = c % ps   (pages[P, H, ps, Dh])
// and an int8 row carries one f32 scale per (token, head), read through
// the same (base, c') from its `[.., H]` / `[P, H, ps]` sidecar.
//
// What bounds it on the card: HBM bytes. Each (slot, head) reads its n_b
// keys and values once (2 * n_b * Dh * elt bytes, plus 2 * n_b * 4 bytes
// of scales for int8) and does 4 flops per element read, far below the
// ~295 flop/byte the H100 needs before compute matters. So the design
// moves each byte once, with enough CTAs and enough loads in flight
// (`decode_split_kernel` and `decode_merge_kernel`, at the end of the
// file):
//   - split-K over the window. The grid is (slot x head, key split); a
//     CTA walks `split` keys (a multiple of 64) of its slot's reach
//     min(pos, W-1). The wrapper picks the split from W, B, H and Dh
//     alone, never from the layout or the page size, so a dense window
//     and the same columns in pages walk the same keys in the same order
//     and agree bit for bit. A split that starts past the reach returns
//     before it reads the table or K/V, and the splits are dispatched last
//     first, so those CTAs leave their slots to the live ones early;
//   - loads in flight: the verify kernels' shared-memory ring (`Ring`,
//     `stage_keys`): 64-key K and V tiles (and the int8 scales beside
//     them) staged with cp.async, the whole split at once where it fits,
//     dense rows through their strides (the engine's window view is never
//     copied), paged rows through the slot's table row; every table entry
//     of a tile is read before its first copy, and keys past the reach are
//     zero-filled and never located, so no entry or page past the reach
//     (the scratch page 0) is read;
//   - one query row on the CUDA cores: each of the 4 warps takes 16 keys
//     of every staged tile, two lanes a key for the logit (each half of
//     Dh), and keeps its own online softmax in registers (f32 m, l and
//     its Dh / 32 columns of acc), logits prescaled by scale * log2 e and
//     exponentiated with ex2; P stays f32, as the plain version keeps it
//     (an mma tile would spend 15/16 of its rows on zeros). int8 lanes
//     are dequantized on their way from shared memory exactly as
//     `_kernel_dequant` does (f32 product with the scale, rounded to the
//     query's dtype), off the conversion unit, which runs at a quarter
//     of the ALU's rate and bounded the int8 variants: a byte becomes an
//     f32 by a byte permute and a subtraction, and two products round to
//     bf16 in one cvt.rn.bf16x2.f32. f32 q runs the same body. The warps'
//     states merge in shared memory at the end of the CTA;
//   - a window of one split (W <= split: the serve path's short buckets)
//     is one launch: the CTA writes `out` itself, with no workspace and
//     no merge. Otherwise each live CTA writes its partial (acc[Dh], m, l)
//     to the f32 workspace the wrapper allocates, and `decode_merge_kernel`
//     (the split kernel's programmatic dependent: it starts early and
//     waits for the split grid's end) folds the live splits in split
//     order: deterministic, and both launches can be captured in a CUDA
//     graph. (A fold by the last live CTA of each (slot, head), behind a
//     counter it sets back to zero, gave the same bits in one launch but
//     was slower at every variant: its fence and atomic cost more than
//     the merge kernel's tail);
//   - a row whose position lies beyond the window (a frozen or inactive
//     slot) is clamped to the window, as the XLA reference does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

}  // namespace

// Strides are in elements. Storage row (base, col, head) of K sits at
// k + base * k_s0 + col * k_s1 + head * k_s2 (dense: base = slot, col =
// column; paged: base = page, col = column % page_size); the scales
// likewise with ks_s*/vs_s*. `table` is null for dense windows.
struct PmdtDecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // int8 only
  const float* v_scale;
  const int* positions;
  const int* table;  // paged only: [B, >= ceil(W / page_size)]
  float* out;
  int B, H, W;
  int D;  // head_dim, 1..128 with 16-byte K/V rows; the kernels run on
          // the tile of 32, 64 or 128 columns that holds it
  int dtype;  // 0 = float32, 1 = bfloat16 (q, and K/V unless int8)
  int quant;  // 1: K/V are int8 with f32 scales
  int page_size;
  int table_stride;
  long long q_sb, q_sh;
  long long k_s0, k_s1, k_s2;
  long long v_s0, v_s1, v_s2;
  long long ks_s0, ks_s1, ks_s2;
  long long vs_s0, vs_s1, vs_s2;
  float scale;
};


// ---- k-query verify: rows 3 and 4 ----------------------------------------
//
// Replaces `_verify_kernel` (dense, quant False/True; launched by
// `_pallas_verify`) and `_paged_verify_kernel` (paged, quant False/True;
// `_pallas_paged_verify`) in pytorch_multiprocessing_distributed_tpu/
// ops/pallas/decode_attention.py: the speculative verify pass, K1 = k+1
// queries per slot over the same window one decode step reads,
//
//   out[b, i, h, :] = softmax(q[b,i,h,:] . K[b, 0..n_bi-1, h, :]^T * Dh^-1/2)
//                     . V[b, 0..n_bi-1, h, :],  n_bi = min(pos_b + i, W-1) + 1
//
// What bounds it on the card: HBM bytes. A key's K/V are read once and
// used by all K1 rows, 4 * K1 flops per element read (20 at K1 = 5), far
// below the ~295 flop/byte of the H100's balance. So the design moves each
// byte once, with enough CTAs and enough loads in flight:
//   - split-K over the window. The grid is (slot x head, key split, tile of
//     16 query rows). A CTA walks `split` keys (a multiple of 64) of its
//     slot's reach; the wrapper picks the split from W, K1, B and H alone,
//     never from the layout, so dense and paged windows walk the same keys
//     in the same order and agree bit for bit. A CTA whose split starts
//     past the tile's last reachable column min(pos + r0 + rows - 1, W - 1)
//     returns before it reads the table or K/V; the splits are dispatched
//     last first, so those CTAs leave their slots to the live ones early.
//     Each live CTA writes its rows' partial (m, l, acc[Dh]) to the f32
//     workspace the wrapper allocates, and `verify_merge_kernel` folds the
//     live splits in split order: deterministic (two calls give the same
//     bits). It is launched as the split kernel's programmatic dependent
//     (it starts early and waits for the split grid's end), and both
//     launches can be captured in a CUDA graph;
//   - loads in flight: 4 warps stage 64-key K and V tiles into a
//     shared-memory ring with 16-byte cp.async copies (4-byte ones for the
//     int8 scales), the whole split at once where it fits (up to 4 tiles in
//     80 KB), dense rows through their strides (the engine's window view is
//     never copied), paged rows through the slot's table row, one entry per
//     key; keys past the CTA's last one are zero-filled and never located,
//     so no table entry or page past the reach is read;
//   - bf16 q, on the tensor cores: the tile's query rows (K1 <= 16 rows,
//     zero-padded) are mma.sync m16n8k16 A fragments, loaded once; each warp
//     takes 16 keys of every tile and keeps its own online softmax (m, l in
//     f32, acc[16][Dh] in the f32 accumulators). S = Q K^T reads the K tile
//     with ldmatrix; masked entries are -inf before the row max; p = exp2 of
//     the logits prescaled by scale * log2 e. O += P V reads V with
//     ldmatrix.trans, and P is split into hi = bf16(P) and lo = bf16(P - hi),
//     one mma each: the Pallas kernel rounds P to bf16 once, about 2e-3 off
//     the port's f32-PV plain version against a tolerance of 1e-4, where
//     hi + lo leaves about 2^-18 of each weight. int8 rows are dequantized on
//     their way from shared memory to the fragment exactly as the plain
//     version does (f32 product with the scale, rounded to bf16), so each
//     product is exact in f32. The 4 warps' states merge in shared memory
//     at the end of the CTA;
//   - f32 q: a CUDA-core FMA body on the same ring, grid and merge (TF32
//     would break the 1e-4 tolerance and the f32 engine's token-exactness):
//     logits, softmax and P V in three passes through shared memory.

struct PmdtVerifyArgs {
  PmdtDecodeArgs d;  // d.out is [B, K1, H, Dh] f32, contiguous
  int k1;            // query rows per slot
  long long q_sq;    // q's stride between rows (elements)
  float* partials;   // [B*H, row tiles, n_splits, 16, tile + 4] f32 workspace
  int split;         // keys a CTA walks, a multiple of kVerifyKeys
  int n_splits;      // ceil(W / split)
};

namespace {

constexpr int kVerifyThreads = 128;  // 4 warps
constexpr int kVerifyRows = 16;      // query rows of a CTA: one mma row tile
constexpr int kVerifyKeys = 64;      // keys of a ring tile: 16 a warp
constexpr int kVerifyStages = 4;     // ring tiles at most
constexpr int kRingBudget = 80 * 1024;  // shared-memory bytes of the ring
constexpr float kLog2e = 1.4426950408889634f;

// one row of a split's partial: acc[Dh], then m and l (16-byte rows)
template <int D>
constexpr int kPartialRow = D + 4;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory; zeros where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// all but the newest n (< kVerifyStages) groups of this thread's copies
__device__ __forceinline__ void cp_async_wait_all_but(int n) {
  switch (n) {
    case 0:
      cp_async_wait<0>();
      break;
    case 1:
      cp_async_wait<1>();
      break;
    case 2:
      cp_async_wait<2>();
      break;
    default:
      cp_async_wait<3>();
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// an int8 lane dequantized as the plain version does it for bf16 q
__device__ __forceinline__ __nv_bfloat16 deq(int8_t x, float s) {
  return __float2bfloat16_rn(__fmul_rn(static_cast<float>(x), s));
}

// (x, y) as two bf16 A-fragment halves: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat16 hx = __float2bfloat16_rn(x);
  const __nv_bfloat16 hy = __float2bfloat16_rn(y);
  hi = pack2(hx, hy);
  lo = pack2(__float2bfloat16_rn(x - __bfloat162float(hx)),
             __float2bfloat16_rn(y - __bfloat162float(hy)));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One ring stage: kVerifyKeys rows of K, the same of V (Dh elements plus
// 16 bytes of padding a row, so ldmatrix and the int8 fragment reads hit
// distinct banks), then for int8 the keys' K and V scales.
template <typename S, int D>
struct Ring {
  static constexpr bool QUANT = std::is_same<S, int8_t>::value;
  static constexpr int ROW = D + 16 / static_cast<int>(sizeof(S));
  static constexpr int ROW_BYTES = ROW * static_cast<int>(sizeof(S));
  static constexpr int KV_BYTES = kVerifyKeys * ROW_BYTES;
  static constexpr int BYTES = 2 * KV_BYTES + (QUANT ? 2 * kVerifyKeys * 4 : 0);
  static constexpr int CHUNKS = D * static_cast<int>(sizeof(S)) / 16;
  static_assert(CHUNKS >= 1 && ROW_BYTES % 16 == 0, "16-byte rows");
};

// the ring's tiles for a split: the whole split in flight at once where
// it fits the budget, at least one tile
template <typename S, int D>
int ring_stages(int split) {
  const int fit = kRingBudget / Ring<S, D>::BYTES;
  return std::max(1, std::min({split / kVerifyKeys, kVerifyStages, fit}));
}

// what a verify CTA holds in dynamic shared memory: the ring (which the
// bf16 body reuses to merge its 4 warps' states), and the f32 body's q
// rows, logits and row state
template <typename T, typename S, int D>
int verify_smem_bytes(int stages) {
  const int ring = stages * Ring<S, D>::BYTES;
  if (std::is_same<T, float>::value)
    return ring + 4 * (kVerifyRows * D + kVerifyRows * (kVerifyKeys + 1) +
                       3 * kVerifyRows);
  return std::max(ring, 4 * (4 * kVerifyRows * (D + 2)));
}

// stage keys [key0, key0 + kVerifyKeys) of (slot b, head h) into `stage`;
// keys at or past `kend`, and the columns past the head_dim a.D, are
// zero-filled and never read (zero columns add nothing to q . k and give
// zero output columns)
template <typename S, int D, bool PAGED>
__device__ __forceinline__ void stage_keys(const PmdtDecodeArgs& a,
                                           unsigned char* stage, int b, int h,
                                           const int* t_row, int key0,
                                           int kend) {
  using R = Ring<S, D>;
  constexpr int N = kVerifyKeys * R::CHUNKS / kVerifyThreads;  // copies
  static_assert(N * kVerifyThreads == kVerifyKeys * R::CHUNKS,
                "whole copies a thread");
  // the storage row of each copy's key: every table read of the tile is
  // issued before the first copy (a copy's asm orders memory after it)
  long long row[N];  // dense: the slot; paged: the page
  long long col[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int j = key0 + (threadIdx.x + n * kVerifyThreads) / R::CHUNKS;
    row[n] = b;
    col[n] = j;
    if (PAGED && j < kend) {
      const int blk = j / a.page_size;
      row[n] = t_row[blk];
      col[n] = j - blk * a.page_size;
    }
  }
  const S* k = static_cast<const S*>(a.k) + h * a.k_s2;
  const S* v = static_cast<const S*>(a.v) + h * a.v_s2;
  const uint32_t base = smem_u32(stage);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int c = threadIdx.x + n * kVerifyThreads;
    const int i = c / R::CHUNKS;
    const int part = c - i * R::CHUNKS;
    const bool valid = key0 + i < kend;
    const long long kr = row[n] * a.k_s0 + col[n] * a.k_s1;
    const long long vr = row[n] * a.v_s0 + col[n] * a.v_s1;
    const int off = part * (16 / static_cast<int>(sizeof(S)));
    const bool in_row = valid && off < a.D;
    const uint32_t dst = base + i * R::ROW_BYTES + part * 16;
    cp_async16(dst, in_row ? k + kr + off : k, in_row);
    cp_async16(dst + R::KV_BYTES, in_row ? v + vr + off : v, in_row);
    if (R::QUANT && part == 0) {
      const uint32_t sdst = base + 2 * R::KV_BYTES + i * 4;
      cp_async4(sdst,
                valid ? a.k_scale + row[n] * a.ks_s0 + col[n] * a.ks_s1 +
                            h * a.ks_s2
                      : a.k_scale,
                valid);
      cp_async4(sdst + kVerifyKeys * 4,
                valid ? a.v_scale + row[n] * a.vs_s0 + col[n] * a.vs_s1 +
                            h * a.vs_s2
                      : a.v_scale,
                valid);
    }
  }
}

// four consecutive lanes (Dh offset d) of key j's K (which 0) or V (1) row
// of a stage, as f32 (int8: each dequantized by the key's scale)
template <typename S, int D>
__device__ __forceinline__ float4 lanes4(const unsigned char* stage,
                                         int which, int j, int d) {
  using R = Ring<S, D>;
  const unsigned char* row = stage + which * R::KV_BYTES + j * R::ROW_BYTES;
  if constexpr (R::QUANT) {
    const char4 c = *reinterpret_cast<const char4*>(row + d);
    const float s = reinterpret_cast<const float*>(
        stage + 2 * R::KV_BYTES)[which * kVerifyKeys + j];
    return make_float4(__fmul_rn(c.x, s), __fmul_rn(c.y, s),
                       __fmul_rn(c.z, s), __fmul_rn(c.w, s));
  } else {
    return *reinterpret_cast<const float4*>(row + d * 4);
  }
}

// one warp's 16 keys (from `wk`) of a staged tile on the tensor cores:
// S = Q K^T, the row-staggered mask, the online softmax in the log2 domain
// and O += P V, with P as hi + lo bf16 halves
template <typename S, int D>
__device__ __forceinline__ void mma_keys(
    const unsigned char* st, int warp, int lane, int wk, int kend,
    const int (&lim)[2], float c, const uint32_t (&qa)[D / 16][4],
    float (&m)[2], float (&l)[2], float (&acc)[D / 8][4]) {
  using R = Ring<S, D>;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int cq = lane & 3;  // fragment column pair
  const uint32_t k_sm = smem_u32(st) + warp * 16 * R::ROW_BYTES;
  const uint32_t v_sm = k_sm + R::KV_BYTES;
  const float* scales = reinterpret_cast<const float*>(
      st + 2 * R::KV_BYTES) + warp * 16;

  // S = Q K^T over the warp's 16 keys: two n-tiles of 8
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t kb[4];  // n-tile 0: kb[0..1]; n-tile 1: kb[2..3]
    if constexpr (R::QUANT) {
      const int8_t* k8 =
          reinterpret_cast<const int8_t*>(st) + warp * 16 * R::ROW_BYTES;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int key = nt * 8 + g;
        const int8_t* kr = k8 + key * R::ROW_BYTES + ks * 16 + 2 * cq;
        const float sc = scales[key];
        kb[2 * nt] = pack2(deq(kr[0], sc), deq(kr[1], sc));
        kb[2 * nt + 1] = pack2(deq(kr[8], sc), deq(kr[9], sc));
      }
    } else {
      const int key = (lane & 7) + ((lane >> 4) << 3);
      const int d = ks * 16 + ((lane >> 3) & 1) * 8;
      ldsm_x4(kb, k_sm + key * R::ROW_BYTES + d * 2);
    }
    mma_bf16(s[0], qa[ks], kb[0], kb[1]);
    mma_bf16(s[1], qa[ks], kb[2], kb[3]);
  }

  // the row-staggered mask, then the online softmax in the log2 domain
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = wk + nt * 8 + 2 * cq + (e & 1);
      const float t = key < kend && key <= lim[e >> 1]
                          ? s[nt][e] * c
                          : -INFINITY;
      s[nt][e] = t;
      mx[e >> 1] = fmaxf(mx[e >> 1], t);
    }
  float base[2];
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], quad_max(mx[i]));
    base[i] = m_new == -INFINITY ? 0.f : m_new;
    corr[i] = ex2(m[i] - base[i]);  // m = -inf: 0
    m[i] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = ex2(s[nt][e] - base[e >> 1]);
      rs[e >> 1] += s[nt][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc[nd][0] *= corr[0];
    acc[nd][1] *= corr[0];
    acc[nd][2] *= corr[1];
    acc[nd][3] *= corr[1];
  }

  // O += P V, P as hi + lo bf16 halves (the S fragment is P's A layout)
  uint32_t ph[4];
  uint32_t pl[4];
  split2(s[0][0], s[0][1], ph[0], pl[0]);
  split2(s[0][2], s[0][3], ph[1], pl[1]);
  split2(s[1][0], s[1][1], ph[2], pl[2]);
  split2(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t vb[4];  // n-tile 2dp: vb[0..1]; n-tile 2dp+1: vb[2..3]
    if constexpr (R::QUANT) {
      const int8_t* v8 = reinterpret_cast<const int8_t*>(st) +
                         R::KV_BYTES + warp * 16 * R::ROW_BYTES;
      const float* vsc = scales + kVerifyKeys;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int key = kk * 8 + 2 * cq;
          const int d = dp * 16 + half * 8 + g;
          vb[2 * half + kk] =
              pack2(deq(v8[key * R::ROW_BYTES + d], vsc[key]),
                    deq(v8[(key + 1) * R::ROW_BYTES + d], vsc[key + 1]));
        }
    } else {
      const int key = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int d = dp * 16 + (lane >> 4) * 8;
      ldsm_x4_t(vb, v_sm + key * R::ROW_BYTES + d * 2);
    }
    mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
    mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
    mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
    mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
  }
}

template <typename T, typename S, int D, bool PAGED>
__global__ void __launch_bounds__(kVerifyThreads)
verify_split_kernel(const PmdtVerifyArgs va, const int stages) {
  using R = Ring<S, D>;
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem[];

  const PmdtDecodeArgs& a = va.d;
  const int H = a.H;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int r0 = blockIdx.z * kVerifyRows;        // first query row
  const int rows = min(kVerifyRows, va.k1 - r0);  // real rows of the tile
  const int pos = a.positions[b];
  const int reach = min(pos + r0 + rows - 1, a.W - 1);
  // splits in reverse: the last ones, most often past a slot's reach,
  // are dispatched first and leave their slots to the live ones
  const int split = gridDim.y - 1 - blockIdx.y;
  const int kbeg = split * va.split;
  if (kbeg > reach) return;  // no reachable key in this split
  // the merge kernel may start and wait for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int kend = min(kbeg + va.split, reach + 1);
  const int n_tiles = (kend - kbeg + kVerifyKeys - 1) / kVerifyKeys;
  const int* t_row =
      PAGED ? a.table + static_cast<long long>(b) * a.table_stride : nullptr;
  const float c = a.scale * kLog2e;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* part = va.partials +
                ((static_cast<long long>(blockIdx.x) * gridDim.z +
                  blockIdx.z) * gridDim.y + split) *
                    kVerifyRows * kPartialRow<D>;
  auto stage = [&](int i) { return smem + (i % stages) * R::BYTES; };
  auto fill = [&](int i) {
    if (i < n_tiles)
      stage_keys<S, D, PAGED>(a, stage(i), b, h, t_row,
                              kbeg + i * kVerifyKeys, kend);
    cp_async_commit();  // an empty group keeps the count uniform
  };
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
                r0 * va.q_sq;
  for (int i = 0; i < stages; ++i) fill(i);  // in flight before q is read

  if constexpr (MMA) {
    // ---- bf16 q: mma.sync on the 16-row tile; each warp 16 keys a tile
    const int g = lane >> 2;  // fragment row (and row + 8)
    const int cq = lane & 3;  // fragment column pair
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + (e & 1) * 8;
        const int col = ks * 16 + (e >> 1) * 8 + 2 * cq;
        __nv_bfloat16 x = __float2bfloat16_rn(0.f);
        __nv_bfloat16 y = x;
        if (row < rows && col < a.D) {  // a.D even: col + 1 too
          x = qb[row * va.q_sq + col];
          y = qb[row * va.q_sq + col + 1];
        }
        qa[ks][e] = pack2(x, y);
      }
    }
    const int lim[2] = {min(pos + r0 + g, a.W - 1),
                        min(pos + r0 + g + 8, a.W - 1)};
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float acc[D / 8][4];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait_all_but(stages - 1);
      __syncthreads();
      const int wk = kbeg + it * kVerifyKeys + warp * 16;
      if (wk < kend)  // warp-uniform: the warp has keys in this tile
        mma_keys<S, D>(stage(it), warp, lane, wk, kend, lim, c, qa, m, l,
                       acc);
      __syncthreads();  // the stage is consumed: refill it
      fill(it + stages);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: merge the 4 warps through it

    float* xm = reinterpret_cast<float*>(smem);  // [4][16]
    float* xl = xm + 4 * kVerifyRows;            // [4][16]
    float* xa = xl + 4 * kVerifyRows;            // [4][16][D]
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = warp * kVerifyRows + g + 8 * i;
      const float li = quad_sum(l[i]);
      if (cq == 0) {
        xm[row] = m[i];
        xl[row] = li;
      }
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<float2*>(xa + row * D + nd * 8 + 2 * cq) =
            make_float2(acc[nd][2 * i], acc[nd][2 * i + 1]);
    }
    __syncthreads();
    for (int idx = tid; idx < rows * (D / 4); idx += kVerifyThreads) {
      const int r = idx / (D / 4);
      const int d = (idx - r * (D / 4)) * 4;
      float mw = -INFINITY;
#pragma unroll
      for (int w = 0; w < 4; ++w) mw = fmaxf(mw, xm[w * kVerifyRows + r]);
      float den = 0.f;
      float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float mi = xm[w * kVerifyRows + r];
        const float wt = mi == -INFINITY ? 0.f : ex2(mi - mw);
        const float4 x = *reinterpret_cast<const float4*>(
            xa + (w * kVerifyRows + r) * D + d);
        den = fmaf(xl[w * kVerifyRows + r], wt, den);
        num = make_float4(fmaf(x.x, wt, num.x), fmaf(x.y, wt, num.y),
                          fmaf(x.z, wt, num.z), fmaf(x.w, wt, num.w));
      }
      float* row = part + r * kPartialRow<D>;
      *reinterpret_cast<float4*>(row + d) = num;
      if (d == 0) {
        row[D] = mw;
        row[D + 1] = den;
      }
    }
  } else {
    // ---- f32 q: CUDA-core FMAs, three passes a tile through shared memory
    constexpr int KP = kVerifyKeys + 1;  // logit row stride
    float* sq = reinterpret_cast<float*>(smem + stages * R::BYTES);
    float* sp = sq + kVerifyRows * D;     // [16][KP] logits, then p
    float* sm = sp + kVerifyRows * KP;    // m [16], l [16], corr [16]
    for (int idx = tid; idx < kVerifyRows * D; idx += kVerifyThreads) {
      const int r = idx / D;
      const int col = idx - r * D;
      sq[idx] = r < rows && col < a.D ? to_float(qb[r * va.q_sq + col]) : 0.f;
    }
    if (tid < kVerifyRows) {
      sm[tid] = -INFINITY;
      sm[kVerifyRows + tid] = 0.f;
    }
    constexpr int DQ = D / 4;                   // float4 columns of a row
    constexpr int RG = kVerifyThreads / DQ;     // row groups
    constexpr int RPT = kVerifyRows / RG;       // rows a thread accumulates
    const int dq = tid % DQ;
    const int rg = tid / DQ;
    float acc[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait_all_but(stages - 1);
      __syncthreads();
      const unsigned char* st = stage(it);
      const int key0 = kbeg + it * kVerifyKeys;

      // logits: thread owns key j of the tile and rows rh, rh + 2, ...
      {
        const int j = tid % kVerifyKeys;
        const int rh = tid / kVerifyKeys;
        constexpr int RS = kVerifyThreads / kVerifyKeys;
        float s[kVerifyRows / RS];
#pragma unroll
        for (int i = 0; i < kVerifyRows / RS; ++i) s[i] = 0.f;
        const int key = key0 + j;
        if (key < kend) {
#pragma unroll 4
          for (int d = 0; d < D; d += 4) {
            const float4 kf = lanes4<S, D>(st, 0, j, d);
#pragma unroll
            for (int i = 0; i < kVerifyRows / RS; ++i) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(sq + (rh + RS * i) * D + d);
              s[i] = fmaf(qv.x, kf.x, s[i]);
              s[i] = fmaf(qv.y, kf.y, s[i]);
              s[i] = fmaf(qv.z, kf.z, s[i]);
              s[i] = fmaf(qv.w, kf.w, s[i]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kVerifyRows / RS; ++i) {
          const int r = rh + RS * i;
          if (r < rows)
            sp[r * KP + j] =
                key < kend && key <= min(pos + r0 + r, a.W - 1)
                    ? s[i] * c
                    : -INFINITY;
        }
      }
      __syncthreads();
      // softmax: warp w takes rows w, w + 4, ...
      for (int r = warp; r < rows; r += kVerifyThreads / 32) {
        const float x0 = sp[r * KP + lane];
        const float x1 = sp[r * KP + lane + 32];
        const float m_old = sm[r];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float p0 = ex2(x0 - base);
        const float p1 = ex2(x1 - base);
        sp[r * KP + lane] = p0;
        sp[r * KP + lane + 32] = p1;
        const float sum = warp_sum(p0 + p1);
        if (lane == 0) {
          const float corr = ex2(m_old - base);
          sm[2 * kVerifyRows + r] = corr;
          sm[kVerifyRows + r] = sm[kVerifyRows + r] * corr + sum;
          sm[r] = m_new;
        }
      }
      __syncthreads();
      // O += P V over the tile's keys
      const int nk = min(kVerifyKeys, kend - key0);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg + RG * i;
        if (r < rows) {
          const float corr = sm[2 * kVerifyRows + r];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] *= corr;
          for (int j = 0; j < nk; ++j) {
            const float p = sp[r * KP + j];
            const float4 vf = lanes4<S, D>(st, 1, j, dq * 4);
            acc[i][0] = fmaf(p, vf.x, acc[i][0]);
            acc[i][1] = fmaf(p, vf.y, acc[i][1]);
            acc[i][2] = fmaf(p, vf.z, acc[i][2]);
            acc[i][3] = fmaf(p, vf.w, acc[i][3]);
          }
        }
      }
      __syncthreads();  // the stage is consumed: refill it
      fill(it + stages);
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + RG * i;
      if (r < rows) {
        float* row = part + r * kPartialRow<D>;
        *reinterpret_cast<float4*>(row + dq * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        if (dq == 0) {
          row[D] = sm[r];
          row[D + 1] = sm[kVerifyRows + r];
        }
      }
    }
  }
}

// one row's partials over the `live` splits (`stride` floats apart)
// folded in split order, four columns from d: (m, l, acc) online, eight
// splits at a time, each eight's loads issued before any is used; acc / l
template <int D>
__device__ __forceinline__ float4 fold_splits(const float* __restrict__ part,
                                              int stride, int live, int d) {
  constexpr int kBatch = 8;  // splits whose loads are in flight together
  float mx = -INFINITY;
  float den = 0.f;
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < live; s0 += kBatch) {
    float m[kBatch];
    float l[kBatch];
    float4 x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const float* p = part + (s0 + j) * stride;
      m[j] = s0 + j < live ? p[D] : -INFINITY;
      if (s0 + j < live) {
        l[j] = p[D + 1];
        x[j] = *reinterpret_cast<const float4*>(p + d);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (m[j] == -INFINITY) continue;  // no key of this row: skipped
      const float m_new = fmaxf(mx, m[j]);
      const float co = ex2(mx - m_new);  // mx = -inf: 0
      const float cn = ex2(m[j] - m_new);
      den = fmaf(den, co, l[j] * cn);
      num = make_float4(fmaf(num.x, co, x[j].x * cn),
                        fmaf(num.y, co, x[j].y * cn),
                        fmaf(num.z, co, x[j].z * cn),
                        fmaf(num.w, co, x[j].w * cn));
      mx = m_new;
    }
  }
  den = fmaxf(den, 1e-30f);
  return make_float4(num.x / den, num.y / den, num.z / den, num.w / den);
}

// out[b, r, h, :] from the live splits' partials, folded in split order:
// a thread takes four columns of a row
template <int D>
__global__ void __launch_bounds__(kVerifyThreads)
verify_merge_kernel(const PmdtVerifyArgs va) {
  const PmdtDecodeArgs& a = va.d;
  const int H = a.H;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int r0 = blockIdx.y * kVerifyRows;
  const int rows = min(kVerifyRows, va.k1 - r0);
  const int reach = min(a.positions[b] + r0 + rows - 1, a.W - 1);
  const int live = reach < 0 ? 0 : reach / va.split + 1;  // as the CTAs
  // the partials are the split kernel's: wait for its grid to end
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  constexpr int P = kVerifyRows * kPartialRow<D>;  // one split's partial
  const float* __restrict__ part =
      va.partials +
      (static_cast<long long>(blockIdx.x) * gridDim.y + blockIdx.y) *
          va.n_splits * P;
  for (int idx = threadIdx.x; idx < rows * (D / 4); idx += kVerifyThreads) {
    const int r = idx / (D / 4);
    const int d = (idx - r * (D / 4)) * 4;
    if (d < a.D)  // a.D a multiple of 4
      *reinterpret_cast<float4*>(
          a.out + ((static_cast<long long>(b) * va.k1 + r0 + r) * H + h) *
                      a.D + d) =
          fold_splits<D>(part + r * kPartialRow<D>, P, live, d);
  }
}

// the split kernel, then the merge kernel as its programmatic dependent
// (launched while the split kernel runs, it waits for its end)
template <typename T, typename S, int D>
cudaError_t launch_verify(const PmdtVerifyArgs& a, cudaStream_t stream) {
  const int tiles = (a.k1 + kVerifyRows - 1) / kVerifyRows;
  const int stages = ring_stages<S, D>(a.split);
  const int bytes = verify_smem_bytes<T, S, D>(stages);
  const auto kernel = a.d.table != nullptr
                          ? verify_split_kernel<T, S, D, true>
                          : verify_split_kernel<T, S, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.d.B * a.d.H, a.n_splits, tiles), kVerifyThreads, bytes,
           stream>>>(a, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.d.B * a.d.H, tiles);
  cfg.blockDim = dim3(kVerifyThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, verify_merge_kernel<D>, a);
}

// a head_dim of 1..128 whose K/V rows are whole 16-byte copies
template <typename S>
bool head_dim_ok(int dh) {
  return dh >= 1 && dh <= 128 && dh * static_cast<int>(sizeof(S)) % 16 == 0;
}

template <typename T, typename S>
cudaError_t launch_verify_dim(const PmdtVerifyArgs& a, cudaStream_t stream) {
  if (!head_dim_ok<S>(a.d.D)) return cudaErrorInvalidValue;
  if (a.d.D <= 32) return launch_verify<T, S, 32>(a, stream);
  if (a.d.D <= 64) return launch_verify<T, S, 64>(a, stream);
  return launch_verify<T, S, 128>(a, stream);
}

}  // namespace

// One call of the verify variant `args` names (dtype, quant, table): the
// split kernel, then the merge kernel, on `stream`. The Python wrapper
// checks shapes, the row count, unit head_dim strides and 16-byte row
// alignment, and allocates the partials. Returns a cudaError_t.
extern "C" int pmdt_verify_attention(const PmdtVerifyArgs* args,
                                     void* stream) {
  const PmdtVerifyArgs& a = *args;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.k1 < 1 || a.split < kVerifyKeys || a.split % kVerifyKeys != 0 ||
      a.n_splits != (a.d.W + a.split - 1) / a.split)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.d.dtype == 0)
    return static_cast<int>(a.d.quant
                                ? launch_verify_dim<float, int8_t>(a, s)
                                : launch_verify_dim<float, float>(a, s));
  if (a.d.dtype == 1)
    return static_cast<int>(
        a.d.quant ? launch_verify_dim<__nv_bfloat16, int8_t>(a, s)
                  : launch_verify_dim<__nv_bfloat16, __nv_bfloat16>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---- one query row: rows 1 and 2 ------------------------------------------
//
// `decode_split_kernel` (on the verify kernels' ring and staging) and
// `decode_merge_kernel`; the design is in the note at the top of the file.

struct PmdtDecodeSplitArgs {
  PmdtDecodeArgs d;  // d.out is [B, 1, H, Dh] f32, contiguous
  float* partials;   // [B*H, n_splits, tile + 4] f32 workspace; null for one
  int split;         // keys a CTA walks, a multiple of kVerifyKeys
  int n_splits;      // ceil(W / split); 1: the CTA writes out itself
};

namespace {

constexpr int kWarpKeys = kVerifyKeys / 4;  // keys of a tile a warp takes

template <typename S, int N>
struct alignas(sizeof(S) * N) Pack {
  S x[N];
};

// the dequantized value as the query's dtype T holds it
template <typename T>
__device__ __forceinline__ float dequant(float x, float s) {
  const float y = __fmul_rn(x, s);
  return std::is_same<T, float>::value
             ? y
             : __bfloat162float(__float2bfloat16_rn(y));
}

// byte k of a word of four int8 lanes as an exact f32, without the
// conversion unit: the byte, biased to unsigned, becomes the low mantissa
// byte of 2^23, and 2^23 + 128 comes off
__device__ __forceinline__ float s8_lane(uint32_t biased, int k) {
  return __uint_as_float(__byte_perm(biased, 0x4b000000u, 0x7540 + k)) -
         8388736.f;
}

// N consecutive lanes, from element e, of a staged K or V row as f32;
// int8 lanes dequantized as the plain version does: the f32 product with
// the key's scale s, rounded to the query's dtype T
template <typename T, typename S, int N>
__device__ __forceinline__ void row_lanes(const unsigned char* row, int e,
                                          float s, float (&f)[N]) {
  const unsigned char* at = row + e * static_cast<int>(sizeof(S));
  if constexpr (std::is_same<S, int8_t>::value) {
    constexpr int NW = (N + 3) / 4;  // words of four lanes
    uint32_t w[NW];
    if constexpr (N >= 4) {
      const Pack<uint32_t, NW> p =
          *reinterpret_cast<const Pack<uint32_t, NW>*>(at);
#pragma unroll
      for (int i = 0; i < NW; ++i) w[i] = p.x[i] ^ 0x80808080u;
    } else if constexpr (N == 2) {
      w[0] = *reinterpret_cast<const uint16_t*>(at) ^ 0x80808080u;
    } else {
      w[0] = *at ^ 0x80808080u;
    }
    if constexpr (std::is_same<T, float>::value || N == 1) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        f[i] = dequant<T>(s8_lane(w[i / 4], i % 4), s);
    } else {  // two lanes a bf16 rounding (one cvt.rn.bf16x2.f32)
#pragma unroll
      for (int i = 0; i < N; i += 2) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(
            __fmul_rn(s8_lane(w[i / 4], i % 4), s),
            __fmul_rn(s8_lane(w[i / 4], i % 4 + 1), s));
        const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
        f[i] = __uint_as_float(u << 16);
        f[i + 1] = __uint_as_float(u & 0xffff0000u);
      }
    }
  } else {
    const Pack<S, N> p = *reinterpret_cast<const Pack<S, N>*>(at);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_float(p.x[i]);
  }
}

template <typename T, typename S, int D, bool PAGED>
__global__ void __launch_bounds__(kVerifyThreads)
decode_split_kernel(const PmdtDecodeSplitArgs da, const int stages) {
  using R = Ring<S, D>;
  constexpr int HALF = D / 2;  // q and K lanes of a thread: half a row
  constexpr int VEC = 16 / static_cast<int>(sizeof(S));  // a 16-byte read
  constexpr int CPL = D / 32;  // V columns of a lane
  static_assert(D % 32 == 0 && HALF % VEC == 0, "head_dim 32, 64 or 128");
  extern __shared__ __align__(16) unsigned char smem[];

  const PmdtDecodeArgs& a = da.d;
  const int H = a.H;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int reach = max(min(a.positions[b], a.W - 1), -1);
  const bool single = da.n_splits == 1;  // no merge: write out here
  // splits in reverse: the last ones, most often past a slot's reach,
  // are dispatched first and leave their slots to the live ones
  const int split = gridDim.y - 1 - blockIdx.y;
  const int kbeg = split * da.split;
  if (!single && kbeg > reach) return;  // no reachable key in this split
  // the merge kernel may start and wait for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int kend = max(kbeg, min(kbeg + da.split, reach + 1));
  const int n_tiles = (kend - kbeg + kVerifyKeys - 1) / kVerifyKeys;
  const int* t_row =
      PAGED ? a.table + static_cast<long long>(b) * a.table_stride : nullptr;
  auto stage = [&](int i) { return smem + (i % stages) * R::BYTES; };
  auto fill = [&](int i) {
    if (i < n_tiles)
      stage_keys<S, D, PAGED>(a, stage(i), b, h, t_row,
                              kbeg + i * kVerifyKeys, kend);
    cp_async_commit();  // an empty group keeps the count uniform
  };
  for (int i = 0; i < stages; ++i) fill(i);  // in flight before q is read

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = lane & 1;  // lanes 2i and 2i + 1 take key i of the warp
  const int kj = warp * kWarpKeys + (lane >> 1);  // that key in a tile
  const float c = a.scale * kLog2e;
  float qf[HALF];
  {
    const T* qr = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
                  half * HALF;
#pragma unroll
    for (int i = 0; i < HALF; ++i)
      qf[i] = half * HALF + i < a.D ? to_float(qr[i]) : 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;
  float acc[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all_but(stages - 1);
    __syncthreads();
    const unsigned char* st = stage(it);
    const int wk = kbeg + it * kVerifyKeys + warp * kWarpKeys;
    if (wk < kend) {  // warp-uniform: the warp has keys in this tile
      const float* sc = reinterpret_cast<const float*>(st + 2 * R::KV_BYTES);
      // the logit of key kj, each lane of the pair over half of Dh
      const unsigned char* kr = st + kj * R::ROW_BYTES;
      const float ks = R::QUANT ? sc[kj] : 0.f;
      float s4[4] = {0.f, 0.f, 0.f, 0.f};  // four chains in flight
#pragma unroll
      for (int e = 0; e < HALF; e += VEC) {
        float kf[VEC];
        row_lanes<T, S, VEC>(kr, half * HALF + e, ks, kf);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          s4[i % 4] = fmaf(qf[e + i], kf[i], s4[i % 4]);
      }
      float s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      const float t = wk + (lane >> 1) < kend ? s * c : -INFINITY;
      // the online softmax in the log2 domain over the warp's 16 keys
      float mx = t;
#pragma unroll
      for (int off = 16; off > 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float corr = ex2(m - base);  // m = -inf: 0
      const float p = ex2(t - base);     // a key past kend: 0
      float ps = p;
#pragma unroll
      for (int off = 16; off > 1; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l = l * corr + ps;
      m = m_new;
      // acc = acc * corr + P V, the lane's CPL columns over the 16 keys
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[i] *= corr;
      const unsigned char* vr =
          st + R::KV_BYTES + warp * kWarpKeys * R::ROW_BYTES;
#pragma unroll
      for (int j = 0; j < kWarpKeys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, 2 * j);
        const float vs =
            R::QUANT ? sc[kVerifyKeys + warp * kWarpKeys + j] : 0.f;
        float vf[CPL];
        row_lanes<T, S, CPL>(vr + j * R::ROW_BYTES, lane * CPL, vs, vf);
#pragma unroll
        for (int i = 0; i < CPL; ++i) acc[i] = fmaf(pj, vf[i], acc[i]);
      }
    }
    __syncthreads();  // the stage is consumed: refill it
    fill(it + stages);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: merge the 4 warps through it

  float* xm = reinterpret_cast<float*>(smem);  // [4]
  float* xl = xm + 4;                          // [4]
  float* xa = xl + 4;                          // [4][D]
  if (lane == 0) {
    xm[warp] = m;
    xl[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) xa[warp * D + lane * CPL + i] = acc[i];
  __syncthreads();
  if (tid < D) {
    float mw = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mw = fmaxf(mw, xm[w]);
    float den = 0.f;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      // a warp that saw no key keeps m = -inf and weighs nothing
      const float wt = xm[w] == -INFINITY ? 0.f : ex2(xm[w] - mw);
      den = fmaf(xl[w], wt, den);
      num = fmaf(xa[w * D + tid], wt, num);
    }
    if (single) {  // no key at all (a negative position): zeros
      if (tid < a.D)
        a.out[static_cast<long long>(blockIdx.x) * a.D + tid] =
            num / fmaxf(den, 1e-30f);
    } else {
      float* row = da.partials +
                   (static_cast<long long>(blockIdx.x) * da.n_splits + split) *
                       kPartialRow<D>;
      row[tid] = num;
      if (tid == 0) {
        row[D] = mw;
        row[D + 1] = den;
      }
    }
  }
}

// out[b, 0, h, :] from the live splits' partials, folded in split order:
// a thread takes four columns of one (slot, head) row
template <int D>
__global__ void __launch_bounds__(kVerifyThreads)
decode_merge_kernel(const PmdtDecodeSplitArgs da) {
  constexpr int TPR = D / 4;                 // threads a row
  constexpr int RPC = kVerifyThreads / TPR;  // rows of a CTA
  const PmdtDecodeArgs& a = da.d;
  const int row = blockIdx.x * RPC + threadIdx.x / TPR;  // b * H + h
  const int d = (threadIdx.x % TPR) * 4;
  const bool valid = row < a.B * a.H;
  int live = 0;  // as the split CTAs count them
  if (valid) {
    const int reach = min(a.positions[row / a.H], a.W - 1);
    live = reach < 0 ? 0 : reach / da.split + 1;
  }
  // the partials are the split kernel's: wait for its grid to end
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (!valid || d >= a.D) return;  // a.D a multiple of 4
  *reinterpret_cast<float4*>(a.out + static_cast<long long>(row) * a.D + d) =
      fold_splits<D>(
          da.partials + static_cast<long long>(row) * da.n_splits *
                            kPartialRow<D>,
          kPartialRow<D>, live, d);
}

// the split kernel, then (more than one split) the merge kernel as its
// programmatic dependent (launched while the split kernel runs, it waits
// for its end)
template <typename T, typename S, int D>
cudaError_t launch_decode(const PmdtDecodeSplitArgs& a, cudaStream_t stream) {
  // the ring holds the whole split where it fits, and no more keys than
  // the window has
  const int span = std::min(
      a.split, (a.d.W + kVerifyKeys - 1) / kVerifyKeys * kVerifyKeys);
  const int stages = ring_stages<S, D>(span);
  const int bytes = stages * Ring<S, D>::BYTES;
  const auto kernel = a.d.table != nullptr
                          ? decode_split_kernel<T, S, D, true>
                          : decode_split_kernel<T, S, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.d.B * a.d.H, a.n_splits), kVerifyThreads, bytes,
           stream>>>(a, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return err;
  constexpr int rows = kVerifyThreads / (D / 4);  // merge rows of a CTA
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.d.B * a.d.H + rows - 1) / rows);
  cfg.blockDim = dim3(kVerifyThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_merge_kernel<D>, a);
}

template <typename T, typename S>
cudaError_t launch_decode_dim(const PmdtDecodeSplitArgs& a,
                              cudaStream_t stream) {
  if (!head_dim_ok<S>(a.d.D)) return cudaErrorInvalidValue;
  if (a.d.D <= 32) return launch_decode<T, S, 32>(a, stream);
  if (a.d.D <= 64) return launch_decode<T, S, 64>(a, stream);
  return launch_decode<T, S, 128>(a, stream);
}

}  // namespace

// One decode call of the variant `args` names (dtype, quant, table): the
// split kernel, then for more than one split the merge kernel, on
// `stream`. The Python wrapper checks shapes, unit head_dim strides and
// 16-byte row alignment, and allocates the partials. Returns a
// cudaError_t.
extern "C" int pmdt_decode_attention(const PmdtDecodeSplitArgs* args,
                                     void* stream) {
  const PmdtDecodeSplitArgs& a = *args;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.d.W < 1 || a.split < kVerifyKeys || a.split % kVerifyKeys != 0 ||
      a.n_splits != (a.d.W + a.split - 1) / a.split ||
      (a.n_splits > 1) != (a.partials != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.d.dtype == 0)
    return static_cast<int>(a.d.quant
                                ? launch_decode_dim<float, int8_t>(a, s)
                                : launch_decode_dim<float, float>(a, s));
  if (a.d.dtype == 1)
    return static_cast<int>(
        a.d.quant ? launch_decode_dim<__nv_bfloat16, int8_t>(a, s)
                  : launch_decode_dim<__nv_bfloat16, __nv_bfloat16>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
