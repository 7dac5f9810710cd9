// Flash attention for Hopper (sm_90a): the forward and the two backward
// kernels of FlashAttention-2, f32 accumulation, bf16 or f32 I/O.
//
// Replaces the TPU kernels of
//   pytorch_multiprocessing_distributed_tpu/ops/pallas/flash_attention.py
//   `_fwd_kernel`     (launched by `_flash_fwd`)        -> flash_fwd_*
//   `_bwd_dq_kernel`  (launched by `_flash_pair_grads`) -> flash_bwd_dq_*
//   `_bwd_dkv_kernel` (launched by `_flash_pair_grads`) -> flash_bwd_dkv_*
// each as `*_mma_kernel` (bf16) and `*_kernel` (f32).
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
// the H100's flop/byte ridge once tiles are in shared memory. Two
// families of kernels, chosen by the input type:
//   - bf16 (the training path): the products run on the tensor cores as
//     mma.sync m16n8k16 (bf16 in, f32 accumulate) in FlashAttention-2's
//     register layout, described above the `*_mma_kernel`s below;
//   - f32: the products run as f32 FMAs on the CUDA cores (67 TFLOP/s
//     peak), 256 threads as 16 x 16, each owning a 4 x 4 block of the
//     64 x 64 logit tile, tiles in shared memory as f32 with a row stride
//     of Dh + 1 so the 16 columns a thread row reads fall in 16 banks.
// Both:
//   - the Pallas grid's sequential innermost axis (k for the forward and
//     dq, q for dk/dv) becomes a loop inside one CTA, so the running
//     max, denominator and accumulators stay in registers for the whole
//     row of tiles and nothing is carried between CTAs (no atomics: dq
//     and dk/dv are FlashAttention-2's two separate passes);
//   - causal tiles wholly above the diagonal are never loaded (a tile is
//     live iff its first column < the tile's last row + 1, the Pallas
//     `k_start < q_end` test), and the q-tile passes launch their longest
//     (last) tiles first;
//   - inputs are read through element strides, so the [B, S, H, Dh]
//     views of the fused QKV projection are never copied.
// Not yet: wgmma and TMA (Hopper's warpgroup products and bulk copies),
// and overlapping the next tile's loads with the current products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // rows of a q-tile and of a k-tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kTP = kTile + 1; // row stride of the 64 x 64 P/dS tiles
constexpr float kNegInf = -1e30f;

struct Strides {  // element strides of a [B, S, H, Dh] tensor (Dh: 1)
  long long b, s, h;
};

// rows [row0, row0 + kTile) of head (b, h) into tile[kTile][D + 1] as
// f32; rows >= n_rows are zero
template <int D>
__device__ __forceinline__ void load_tile(float* tile, const float* base,
                                          Strides st, int b, int h,
                                          int row0, int n_rows) {
  const float* p = base + b * st.b + h * st.h;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = row0 + r;
    tile[r * (D + 1) + c] =
        row < n_rows ? p[static_cast<long long>(row) * st.s + c] : 0.f;
  }
}

// per-row values [bh, S] -> smem[kTile], zero past n_rows
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long bh, int row0,
                                          int n_rows) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int row = row0 + r;
    dst[r] = row < n_rows ? src[bh * n_rows + row] : 0.f;
  }
}

// reduce over the 16 lanes that share a tile row (lanes differ in tx)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int Sq, int Skv,
                 Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int CN = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * DP;
  float* sV = sK + kTile * DP;
  float* sP = sV + kTile * DP;  // [kTile][kTP]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qi = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qi * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<D>(sQ, q, qs, b, h, q0, Sq);

  float m[4], l[4], acc[4][CN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.f;
  }

  int n_k = (Skv + kTile - 1) / kTile;
  if (causal) n_k = min(n_k, qi + 1);  // live iff k_start < q_end

  for (int kb = 0; kb < n_k; ++kb) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(sK, k, ks, b, h, kb * kTile, Skv);
    load_tile<D>(sV, v, vs, b, h, kb * kTile, Skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool ok[4];
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kb * kTile + tx + 16 * j;
        ok[j] = col < Skv && (!causal || col <= row);
        s[i][j] *= scale;
        if (ok[j]) tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(tile_max));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        sP[(ty * 4 + i) * kTP + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[CN];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * kTP + kk];
#pragma unroll
      for (int c = 0; c < CN; ++c) vv[c] = sV[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  float* o = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CN; ++c)
      o[static_cast<long long>(row) * os.s + tx + 16 * c] =
          acc[i][c] / l_safe;
    if (tx == 0)
      lse[static_cast<long long>(bh) * Sq + row] = m[i] + logf(l_safe);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dterm, float* __restrict__ dq,
                    int H, int Sq, int Skv, Strides qs, Strides ks,
                    Strides vs, Strides dos, Strides dqs, float scale,
                    int causal) {
  constexpr int DP = D + 1;
  constexpr int CN = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kTile * DP;
  float* sK = sDO + kTile * DP;
  float* sV = sK + kTile * DP;
  float* sDS = sV + kTile * DP;  // [kTile][kTP]
  float* sL = sDS + kTile * kTP;
  float* sDt = sL + kTile;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int q0 = qi * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<D>(sQ, q, qs, b, h, q0, Sq);
  load_tile<D>(sDO, dout, dos, b, h, q0, Sq);
  load_rows(sL, lse, bh, q0, Sq);
  load_rows(sDt, dterm, bh, q0, Sq);

  float acc[4][CN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.f;

  int n_k = (Skv + kTile - 1) / kTile;
  if (causal) n_k = min(n_k, qi + 1);

  for (int kb = 0; kb < n_k; ++kb) {
    __syncthreads();
    load_tile<D>(sK, k, ks, b, h, kb * kTile, Skv);
    load_tile<D>(sV, v, vs, b, h, kb * kTile, Skv);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty * 4 + i) * DP + d];
        dov[i] = sDO[(ty * 4 + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * DP + d];
        vv[j] = sV[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kb * kTile + tx + 16 * j;
        const bool ok = row < Sq && col < Skv && (!causal || col <= row);
        const float p = ok ? expf(s[i][j] * scale - sL[r]) : 0.f;
        sDS[r * kTP + tx + 16 * j] = p * (dp[i][j] - sDt[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[4], kv[CN];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sDS[(ty * 4 + i) * kTP + kk];
#pragma unroll
      for (int c = 0; c < CN; ++c) kv[c] = sK[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

  float* o = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < CN; ++c)
      o[static_cast<long long>(row) * dqs.s + tx + 16 * c] =
          acc[i][c] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dterm, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Sq, int Skv, Strides qs,
                     Strides ks, Strides vs, Strides dos, Strides dks,
                     Strides dvs, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int CN = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * DP;
  float* sQ = sV + kTile * DP;
  float* sDO = sQ + kTile * DP;
  float* sPT = sDO + kTile * DP;  // P^T  [kTile k][kTP]
  float* sDST = sPT + kTile * kTP;  // dS^T [kTile k][kTP]
  float* sL = sDST + kTile * kTP;
  float* sDt = sL + kTile;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kb = blockIdx.y;  // causal: the first k-tiles see the most rows
  const int k0 = kb * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<D>(sK, k, ks, b, h, k0, Skv);
  load_tile<D>(sV, v, vs, b, h, k0, Skv);

  float dk_acc[4][CN], dv_acc[4][CN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CN; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_q = (Sq + kTile - 1) / kTile;
  // causal: q-tile qi is live iff k0 < (qi + 1) * kTile
  const int qi0 = causal ? k0 / kTile : 0;

  for (int qi = qi0; qi < n_q; ++qi) {
    const int q0 = qi * kTile;
    __syncthreads();
    load_tile<D>(sQ, q, qs, b, h, q0, Sq);
    load_tile<D>(sDO, dout, dos, b, h, q0, Sq);
    load_rows(sL, lse, bh, q0, Sq);
    load_rows(sDt, dterm, bh, q0, Sq);
    __syncthreads();

    // thread (ty, tx): k rows ty*4+i, q columns tx+16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sK[(ty * 4 + i) * DP + d];
        vv[i] = sV[(ty * 4 + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = sQ[(tx + 16 * j) * DP + d];
        dov[j] = sDO[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int col = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int row = q0 + c;
        const bool ok = row < Sq && col < Skv && (!causal || col <= row);
        const float p = ok ? expf(s[i][j] * scale - sL[c]) : 0.f;
        sPT[r * kTP + c] = p;
        sDST[r * kTP + c] = p * (dp[i][j] - sDt[c]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float pv[4], dsv[4], dov[CN], qv[CN];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sPT[(ty * 4 + i) * kTP + qq];
        dsv[i] = sDST[(ty * 4 + i) * kTP + qq];
      }
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        dov[c] = sDO[qq * DP + tx + 16 * c];
        qv[c] = sQ[qq * DP + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          dv_acc[i][c] = fmaf(pv[i], dov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qv[c], dk_acc[i][c]);
        }
    }
  }

  float* ok_ = dk + b * dks.b + h * dks.h;
  float* ov = dv + b * dvs.b + h * dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= Skv) continue;
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      ok_[static_cast<long long>(row) * dks.s + tx + 16 * c] =
          dk_acc[i][c] * scale;
      ov[static_cast<long long>(row) * dvs.s + tx + 16 * c] =
          dv_acc[i][c];
    }
  }
}

// ---- bf16: the same passes on the tensor cores (mma.sync m16n8k16) ----
//
// FlashAttention-2's register layout: 4 warps per CTA, each owning 16
// rows of the 64-row tile. A warp's 16 x 64 logit tile lives in
// registers as eight m16n8 accumulators; the online softmax runs on
// them in place (a row is spread over the 4 lanes of a quad, reduced
// with two shuffles), and the probabilities are re-packed as bf16 A
// fragments for the P.V product without touching shared memory. P and
// dS are rounded to bf16 before their products, where the Pallas
// kernels round them (`p.astype(v.dtype)`, `ds.astype(k.dtype)`).
// Tiles are staged in shared memory as bf16 with 8 elements of row
// padding (conflict-free fragment loads); the operand a product needs
// transposed (V for P.V, K for dS.K, Q and dO for dk/dv) is staged a
// second time transposed while it is loaded.

constexpr int kMmaThreads = 128;  // 4 warps x 16 rows

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 x 16, row-major) at rows r0.., columns c0.. of a
// [.][ld] bf16 tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int r0, int c0, int g, int t) {
  const __nv_bfloat16* p = tile + (r0 + g) * ld + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// A fragment from two m16n8 f32 accumulators (columns 0-7 and 8-15)
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// rows [row0, row0 + kTile) of head (b, h) into dst[kTile][D + 8] and/or
// dstT[D][kTile + 8] (transposed), 16 bytes a thread; rows >= n_rows zero
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               __nv_bfloat16* dstT,
                                               const __nv_bfloat16* base,
                                               Strides st, int b, int h,
                                               int row0, int n_rows) {
  constexpr int CH = D / 8;
  const __nv_bfloat16* p = base + b * st.b + h * st.h;
  for (int idx = threadIdx.x; idx < kTile * CH; idx += kMmaThreads) {
    const int r = idx / CH;
    const int c = (idx - r * CH) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_rows)
      val = *reinterpret_cast<const uint4*>(
          p + static_cast<long long>(row) * st.s + c);
    if (dst != nullptr)
      *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
    if (dstT != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) dstT[(c + i) * (kTile + 8) + r] = e[i];
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int H, int Sq, int Skv, Strides qs, Strides ks,
                     Strides vs, Strides os, float scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int LT = kTile + 8;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kTile * LD;
  __nv_bfloat16* sVt = sK + kTile * LD;  // [D][LT]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int q0 = qi * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;  // this warp's first row in the tile

  load_tile_bf16<D>(sQ, nullptr, q, qs, b, h, q0, Sq);

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  int n_k = (Skv + kTile - 1) / kTile;
  if (causal) n_k = min(n_k, qi + 1);

  for (int kb = 0; kb < n_k; ++kb) {
    __syncthreads();
    load_tile_bf16<D>(sK, nullptr, k, ks, b, h, kb * kTile, Skv);
    load_tile_bf16<D>(nullptr, sVt, v, vs, b, h, kb * kTile, Skv);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4];
      load_a(a, sQ, LD, wr, kc * 16, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kp = sK + (n * 8 + g) * LD + kc * 16 + 2 * t;
        mma_bf16(s[n], a, ld32(kp), ld32(kp + 8));
      }
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + wr + g + 8 * hf;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = kb * kTile + n * 8 + 2 * t + e;
          const bool ok = col < Skv && (!causal || col <= row);
          float& x = s[n][2 * hf + e];
          x = ok ? x * scale : -INFINITY;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[hf], quad_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[hf] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hf + e];
          x = expf(x - m_use);
          psum += x;
        }
      l[hf] = l[hf] * corr + quad_sum(psum);
      m[hf] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * hf] *= corr;
        o[n][2 * hf + 1] *= corr;
      }
    }

#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t a[4];
      pack_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vp = sVt + (n * 8 + g) * LT + kc * 16 + 2 * t;
        mma_bf16(o[n], a, ld32(vp), ld32(vp + 8));
      }
    }
  }

  __nv_bfloat16* op = out + b * os.b + h * os.h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + wr + g + 8 * hf;
    if (row >= Sq) continue;
    const float l_safe = fmaxf(l[hf], 1e-30f);
    const float inv = 1.f / l_safe;
    __nv_bfloat16* rp = op + static_cast<long long>(row) * os.s;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(rp + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * hf] * inv, o[n][2 * hf + 1] * inv);
    if (t == 0)
      lse[static_cast<long long>(bh) * Sq + row] = m[hf] + logf(l_safe);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dterm,
                        __nv_bfloat16* __restrict__ dq, int H, int Sq, int Skv,
                        Strides qs, Strides ks, Strides vs, Strides dos,
                        Strides dqs, float scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int LT = kTile + 8;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + kTile * LD;
  __nv_bfloat16* sK = sDO + kTile * LD;
  __nv_bfloat16* sV = sK + kTile * LD;
  __nv_bfloat16* sKt = sV + kTile * LD;  // [D][LT]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int qi = gridDim.y - 1 - blockIdx.y;
  const int q0 = qi * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;

  load_tile_bf16<D>(sQ, nullptr, q, qs, b, h, q0, Sq);
  load_tile_bf16<D>(sDO, nullptr, dout, dos, b, h, q0, Sq);
  float row_lse[2], row_dt[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + wr + g + 8 * hf;
    const long long at = static_cast<long long>(bh) * Sq + row;
    row_lse[hf] = row < Sq ? lse[at] : 0.f;
    row_dt[hf] = row < Sq ? dterm[at] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int n_k = (Skv + kTile - 1) / kTile;
  if (causal) n_k = min(n_k, qi + 1);

  for (int kb = 0; kb < n_k; ++kb) {
    __syncthreads();
    load_tile_bf16<D>(sK, sKt, k, ks, b, h, kb * kTile, Skv);
    load_tile_bf16<D>(sV, nullptr, v, vs, b, h, kb * kTile, Skv);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t aq[4], ado[4];
      load_a(aq, sQ, LD, wr, kc * 16, g, t);
      load_a(ado, sDO, LD, wr, kc * 16, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kp = sK + (n * 8 + g) * LD + kc * 16 + 2 * t;
        const __nv_bfloat16* vp = sV + (n * 8 + g) * LD + kc * 16 + 2 * t;
        mma_bf16(s[n], aq, ld32(kp), ld32(kp + 8));
        mma_bf16(dp[n], ado, ld32(vp), ld32(vp + 8));
      }
    }

#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const int row = q0 + wr + g + 8 * hf;
        const int col = kb * kTile + n * 8 + 2 * t + (e & 1);
        const bool ok = row < Sq && col < Skv && (!causal || col <= row);
        const float p = ok ? expf(s[n][e] * scale - row_lse[hf]) : 0.f;
        s[n][e] = p * (dp[n][e] - row_dt[hf]);  // dS, in place
      }

#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t a[4];
      pack_a(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* kp = sKt + (n * 8 + g) * LT + kc * 16 + 2 * t;
        mma_bf16(acc[n], a, ld32(kp), ld32(kp + 8));
      }
    }
  }

  __nv_bfloat16* op = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + wr + g + 8 * hf;
    if (row >= Sq) continue;
    __nv_bfloat16* rp = op + static_cast<long long>(row) * dqs.s;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(rp + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * hf] * scale,
                                acc[n][2 * hf + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dterm,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int Sq,
                         int Skv, Strides qs, Strides ks, Strides vs,
                         Strides dos, Strides dks, Strides dvs, float scale,
                         int causal) {
  constexpr int LD = D + 8;
  constexpr int LT = kTile + 8;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTile * LD;
  __nv_bfloat16* sQ = sV + kTile * LD;
  __nv_bfloat16* sDO = sQ + kTile * LD;
  __nv_bfloat16* sQt = sDO + kTile * LD;   // [D][LT]
  __nv_bfloat16* sDOt = sQt + D * LT;      // [D][LT]
  float* sL = reinterpret_cast<float*>(sDOt + D * LT);
  float* sDt = sL + kTile;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kb = blockIdx.y;
  const int k0 = kb * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;  // this warp's first key in the tile

  load_tile_bf16<D>(sK, nullptr, k, ks, b, h, k0, Skv);
  load_tile_bf16<D>(sV, nullptr, v, vs, b, h, k0, Skv);

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int n_q = (Sq + kTile - 1) / kTile;
  const int qi0 = causal ? k0 / kTile : 0;

  for (int qi = qi0; qi < n_q; ++qi) {
    const int q0 = qi * kTile;
    __syncthreads();
    load_tile_bf16<D>(sQ, sQt, q, qs, b, h, q0, Sq);
    load_tile_bf16<D>(sDO, sDOt, dout, dos, b, h, q0, Sq);
    for (int r = threadIdx.x; r < kTile; r += kMmaThreads) {
      const int row = q0 + r;
      const long long at = static_cast<long long>(bh) * Sq + row;
      sL[r] = row < Sq ? lse[at] : 0.f;
      sDt[r] = row < Sq ? dterm[at] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys, columns
    // the tile's queries
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ak[4], av[4];
      load_a(ak, sK, LD, wr, kc * 16, g, t);
      load_a(av, sV, LD, wr, kc * 16, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* qp = sQ + (n * 8 + g) * LD + kc * 16 + 2 * t;
        const __nv_bfloat16* dp = sDO + (n * 8 + g) * LD + kc * 16 + 2 * t;
        mma_bf16(st[n], ak, ld32(qp), ld32(qp + 8));
        mma_bf16(dpt[n], av, ld32(dp), ld32(dp + 8));
      }
    }

#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + wr + g + 8 * (e >> 1);
        const int c = n * 8 + 2 * t + (e & 1);
        const int row = q0 + c;
        const bool ok = row < Sq && key < Skv && (!causal || key <= row);
        const float p = ok ? expf(st[n][e] * scale - sL[c]) : 0.f;
        st[n][e] = p;                         // P^T
        dpt[n][e] = p * (dpt[n][e] - sDt[c]);  // dS^T
      }

#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t ap[4], ads[4];
      pack_a(ap, st[2 * kc], st[2 * kc + 1]);
      pack_a(ads, dpt[2 * kc], dpt[2 * kc + 1]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* dop = sDOt + (n * 8 + g) * LT + kc * 16 + 2 * t;
        const __nv_bfloat16* qp = sQt + (n * 8 + g) * LT + kc * 16 + 2 * t;
        mma_bf16(dv_acc[n], ap, ld32(dop), ld32(dop + 8));
        mma_bf16(dk_acc[n], ads, ld32(qp), ld32(qp + 8));
      }
    }
  }

  __nv_bfloat16* kp = dk + b * dks.b + h * dks.h;
  __nv_bfloat16* vp = dv + b * dvs.b + h * dvs.h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = k0 + wr + g + 8 * hf;
    if (key >= Skv) continue;
    __nv_bfloat16* krow = kp + static_cast<long long>(key) * dks.s;
    __nv_bfloat16* vrow = vp + static_cast<long long>(key) * dvs.s;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(krow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dk_acc[n][2 * hf] * scale,
                                dk_acc[n][2 * hf + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dv_acc[n][2 * hf], dv_acc[n][2 * hf + 1]);
    }
  }
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

using bf16 = __nv_bfloat16;

// launch one pass: the f32 FMA kernel or the bf16 mma kernel, with the
// dynamic shared memory it needs
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t bytes,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd(int dtype, const void* q, const void* k, const void* v,
                void* out, float* lse, int B, int H, int Sq, int Skv,
                const long long* st, float scale, int causal,
                cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + kTile - 1) / kTile);
  const Strides s0 = strides_at(st, 0), s1 = strides_at(st, 1),
                s2 = strides_at(st, 2), s3 = strides_at(st, 3);
  if (dtype == 1)
    return launch(flash_fwd_mma_kernel<D>, grid, kMmaThreads,
                  (2 * kTile * (D + 8) + D * (kTile + 8)) * sizeof(bf16),
                  stream, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  static_cast<bf16*>(out), lse, H, Sq, Skv, s0, s1, s2, s3,
                  scale, causal);
  return launch(flash_fwd_kernel<D>, grid, kThreads,
                (3 * kTile * (D + 1) + kTile * kTP) * sizeof(float), stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(out), lse,
                H, Sq, Skv, s0, s1, s2, s3, scale, causal);
}

template <int D>
cudaError_t bwd_dq(int dtype, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* dterm,
                   void* dq, int B, int H, int Sq, int Skv,
                   const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + kTile - 1) / kTile);
  const Strides s0 = strides_at(st, 0), s1 = strides_at(st, 1),
                s2 = strides_at(st, 2), s3 = strides_at(st, 3),
                s4 = strides_at(st, 4);
  if (dtype == 1)
    return launch(flash_bwd_dq_mma_kernel<D>, grid, kMmaThreads,
                  (4 * kTile * (D + 8) + D * (kTile + 8)) * sizeof(bf16),
                  stream, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  static_cast<const bf16*>(dout), lse, dterm,
                  static_cast<bf16*>(dq), H, Sq, Skv, s0, s1, s2, s3, s4,
                  scale, causal);
  return launch(flash_bwd_dq_kernel<D>, grid, kThreads,
                (4 * kTile * (D + 1) + kTile * kTP + 2 * kTile) *
                    sizeof(float),
                stream, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<const float*>(dout), lse, dterm,
                static_cast<float*>(dq), H, Sq, Skv, s0, s1, s2, s3, s4,
                scale, causal);
}

template <int D>
cudaError_t bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* dterm,
                    void* dk, void* dv, int B, int H, int Sq, int Skv,
                    const long long* st, float scale, int causal,
                    cudaStream_t stream) {
  const dim3 grid(B * H, (Skv + kTile - 1) / kTile);
  const Strides s0 = strides_at(st, 0), s1 = strides_at(st, 1),
                s2 = strides_at(st, 2), s3 = strides_at(st, 3),
                s4 = strides_at(st, 4), s5 = strides_at(st, 5);
  if (dtype == 1)
    return launch(flash_bwd_dkv_mma_kernel<D>, grid, kMmaThreads,
                  (4 * kTile * (D + 8) + 2 * D * (kTile + 8)) * sizeof(bf16) +
                      2 * kTile * sizeof(float),
                  stream, static_cast<const bf16*>(q),
                  static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                  static_cast<const bf16*>(dout), lse, dterm,
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Skv,
                  s0, s1, s2, s3, s4, s5, scale, causal);
  return launch(flash_bwd_dkv_kernel<D>, grid, kThreads,
                (4 * kTile * (D + 1) + 2 * kTile * kTP + 2 * kTile) *
                    sizeof(float),
                stream, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<const float*>(dout), lse, dterm,
                static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Skv,
                s0, s1, s2, s3, s4, s5, scale, causal);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {32, 64, 128}. `strides` holds
// (b, s, h) element strides per tensor, in argument order (the Dh stride
// must be 1; the Python wrapper checks it). lse and dterm are contiguous
// f32 [B * H, Sq]. Each entry returns a cudaError_t.
#define PMDT_DISPATCH(CALL)                              \
  if (dtype != 0 && dtype != 1)                          \
    return static_cast<int>(cudaErrorInvalidValue);      \
  if (D == 32) return static_cast<int>(CALL(32));        \
  if (D == 64) return static_cast<int>(CALL(64));        \
  if (D == 128) return static_cast<int>(CALL(128));      \
  return static_cast<int>(cudaErrorInvalidValue);

extern "C" int pmdt_flash_fwd(const void* q, const void* k, const void* v,
                              void* out, float* lse, int B, int H, int Sq,
                              int Skv, int D, int dtype,
                              const long long* strides, float scale,
                              int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PMDT_FWD(DIM) \
  fwd<DIM>(dtype, q, k, v, out, lse, B, H, Sq, Skv, strides, scale, causal, s)
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
  bwd_dq<DIM>(dtype, q, k, v, dout, lse, dterm, dq, B, H, Sq, Skv,      \
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
               strides, scale, causal, s)
  PMDT_DISPATCH(PMDT_DKV)
#undef PMDT_DKV
}
#undef PMDT_DISPATCH
