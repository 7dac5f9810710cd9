// Flash-decode attention for Hopper (sm_90a): one cached query per slot
// over its KV window, f32 online softmax, f32 output. Four variants of
// one kernel, chosen by a loader template (the k-query verify kernels,
// rows 3 and 4 of the port's kernel table, follow at the end of the
// file):
//
//   dense, model dtype  — replaces `_decode_kernel` (quant=False)
//   dense, int8 + scale — replaces `_decode_kernel` (quant=True)
//   paged, model dtype  — replaces `_paged_decode_kernel` (quant=False)
//   paged, int8 + scale — replaces `_paged_decode_kernel` (quant=True)
//
// (all in pytorch_multiprocessing_distributed_tpu/ops/pallas/
// decode_attention.py, launched by `_pallas_decode` and
// `_pallas_paged_decode`).
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
// What bounds it on the card: HBM bytes. Each (slot, head) reads its
// n_b keys and values once (2 * n_b * Dh * elt bytes, plus 2 * n_b * 4
// bytes of scales for int8) and does 4 flops per element read, far
// below the ~295 flop/byte the H100 needs before compute matters. So
// the design only moves bytes, and moves each once:
//   - one CTA per (slot, head); K/V are read through their strides (the
//     engine's window view `k_cache[:, :W]` and its layer of the page
//     storage are never copied; the Pallas wrapper's merge/moveaxis and
//     the plain version's gather have no twin here);
//   - every thread loads 16 bytes per key (4 f32, 8 bf16 or 16 int8
//     lanes); the lanes of one key form a group of Dh/VEC threads that
//     reads the key's Dh contiguous elements in whole cache lines;
//     groups across the CTA walk different keys in parallel;
//   - int8: the group's first lane reads the key's scale once and
//     shares it by shuffle; each lane dequantizes exactly as
//     `_kernel_dequant` does — f32 product, rounded to the query's dtype
//     (bf16: round to nearest even), widened for the dot — so the
//     kernel agrees with the plain dequantize-then-attend version;
//   - paged: each key reads its page number from the slot's table row
//     (one int per key, an L1 hit for the other keys of the page); a
//     page past the slot's position is never touched, so unallocated
//     entries (the scratch page 0) are never read;
//   - each group keeps its own online-softmax state (running max m,
//     denominator l, unnormalised accumulator) in registers, so the row
//     of logits never touches memory; groups merge once in shared
//     memory at the end;
//   - only columns 0..min(pos, W-1) are read: the work tracks each
//     slot's true length, and a row whose position lies beyond the
//     window (a frozen or inactive slot) is clamped to the window, as
//     the XLA reference does (the Pallas paged kernel would attend the
//     rest of the window's last page).
// Known limit: with 8 slots x 12 heads the grid is 96 CTAs for 132 SMs,
// and one CTA walks the whole row. Splitting the key range across CTAs
// (split-K flash-decoding) is the next step for small batches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;

// 16-byte loads of the K/V storage type, widened to f32
template <typename S>
struct Lanes;

template <>
struct Lanes<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
};

template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

template <>
struct Lanes<int8_t> {
  static constexpr int N = 16;
  static __device__ __forceinline__ void load(const int8_t* p, float* f) {
    const int4 r = *reinterpret_cast<const int4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(c[i]);
  }
};

// 8 int8 lanes (8-byte loads): the verify kernel's int8 loader, so its
// K1 rows of accumulators stay at 8 lanes a thread as in bf16
struct Int8x8 {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const int8_t* p, float* f) {
    const int2 r = *reinterpret_cast<const int2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(c[i]);
  }
};

template <typename S>
struct VerifyLanes {
  using type = Lanes<S>;
};
template <>
struct VerifyLanes<int8_t> {
  using type = Int8x8;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the dequantized value as the query's dtype holds it
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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
  int B, H, W, D;
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

namespace {

template <typename T, typename S, int D, bool PAGED>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const PmdtDecodeArgs a) {
  using L = Lanes<S>;
  constexpr bool QUANT = std::is_same<S, int8_t>::value;
  constexpr int VEC = L::N;
  constexpr int LANES = D / VEC;              // threads per key
  constexpr int KEYS_PER_WARP = 32 / LANES;   // keys a warp reads at once
  constexpr int GROUPS = kWarps * KEYS_PER_WARP;
  static_assert(D % VEC == 0 && LANES <= 32 && 32 % LANES == 0,
                "head_dim must split into 16-byte lanes within a warp");

  __shared__ float sm_m[GROUPS];
  __shared__ float sm_l[GROUPS];
  __shared__ float sm_acc[GROUPS][D];

  const int H = a.H;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LANES;                      // Dh slice of this thread
  const int group = warp * KEYS_PER_WARP + lane / LANES;

  const int pos = a.positions[b];
  const int n_keys = min(pos, a.W - 1) + 1;  // <= 0 only for pos < 0: zeros

  float qf[VEC];
  const T* q_row = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
                   sub * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) qf[i] = to_float(q_row[i]);
  const S* k = static_cast<const S*>(a.k) + h * a.k_s2 + sub * VEC;
  const S* v = static_cast<const S*>(a.v) + h * a.v_s2 + sub * VEC;
  const int* t_row =
      PAGED ? a.table + static_cast<long long>(b) * a.table_stride : nullptr;

  float m = -INFINITY;
  float l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  // The loop bound is uniform across a warp (base steps by GROUPS), so
  // every lane reaches the shuffles below; lanes whose key lies past
  // n_keys skip the loads and the state update.
  for (int base = warp * KEYS_PER_WARP; base < n_keys; base += GROUPS) {
    const int j = base + lane / LANES;
    const bool valid = j < n_keys;
    long long row = b;  // dense: the slot; paged: the page
    long long col = j;
    if (PAGED && valid) {
      const int blk = j / a.page_size;
      row = t_row[blk];
      col = j - blk * a.page_size;
    }
    float kf[VEC];
    float vf[VEC];
    if (valid) {
      L::load(k + row * a.k_s0 + col * a.k_s1, kf);
      L::load(v + row * a.v_s0 + col * a.v_s1, vf);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
    }
    if (QUANT) {
      // one scale read per (token, head), shared across the key's lanes
      float ks = 0.f;
      float vs = 0.f;
      if (valid && sub == 0) {
        ks = a.k_scale[row * a.ks_s0 + col * a.ks_s1 + h * a.ks_s2];
        vs = a.v_scale[row * a.vs_s0 + col * a.vs_s1 + h * a.vs_s2];
      }
      ks = __shfl_sync(0xffffffffu, ks, lane - sub);
      vs = __shfl_sync(0xffffffffu, vs, lane - sub);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        kf[i] = round_to<T>(__fmul_rn(kf[i], ks));
        vf[i] = round_to<T>(__fmul_rn(vf[i], vs));
      }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) s = fmaf(qf[i], kf[i], s);
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (valid) {
      s *= a.scale;
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);  // m = -inf on the first key: 0
      const float p = expf(s - m_new);
      l = l * corr + p;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(acc[i], corr, p * vf[i]);
      m = m_new;
    }
  }

  if (sub == 0) {
    sm_m[group] = m;
    sm_l[group] = l;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) sm_acc[group][sub * VEC + i] = acc[i];
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float mx = -INFINITY;
#pragma unroll 4
    for (int g = 0; g < GROUPS; ++g) mx = fmaxf(mx, sm_m[g]);
    float den = 0.f;
    float num = 0.f;
#pragma unroll 4
    for (int g = 0; g < GROUPS; ++g) {
      // a group that saw no key keeps m = -inf and weighs nothing
      const float w = sm_m[g] == -INFINITY ? 0.f : expf(sm_m[g] - mx);
      den = fmaf(sm_l[g], w, den);
      num = fmaf(sm_acc[g][d], w, num);
    }
    a.out[(static_cast<long long>(b) * H + h) * D + d] =
        num / fmaxf(den, 1e-30f);
  }
}

template <typename T, typename S, int D>
cudaError_t launch(const PmdtDecodeArgs& a, cudaStream_t stream) {
  if (a.table != nullptr)
    decode_attention_kernel<T, S, D, true>
        <<<a.B * a.H, kWarps * 32, 0, stream>>>(a);
  else
    decode_attention_kernel<T, S, D, false>
        <<<a.B * a.H, kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_dim(const PmdtDecodeArgs& a, cudaStream_t stream) {
  switch (a.D) {
    case 32:
      return launch<T, S, 32>(a, stream);
    case 64:
      return launch<T, S, 64>(a, stream);
    case 128:
      return launch<T, S, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch of the variant `args` names (dtype, quant, table). The
// Python wrapper checks shapes, unit head_dim strides and 16-byte row
// alignment. Returns a cudaError_t.
extern "C" int pmdt_decode_attention(const PmdtDecodeArgs* args,
                                     void* stream) {
  const PmdtDecodeArgs& a = *args;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.dtype == 0)
    return static_cast<int>(a.quant ? launch_dim<float, int8_t>(a, s)
                                    : launch_dim<float, float>(a, s));
  if (a.dtype == 1)
    return static_cast<int>(
        a.quant ? launch_dim<__nv_bfloat16, int8_t>(a, s)
                : launch_dim<__nv_bfloat16, __nv_bfloat16>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// What bounds it on the card: still HBM bytes. A key's K/V are read once
// and used by all K1 rows, so the work is 4 * K1 flops per element read
// (20 at K1 = 5), far below the ~295 flop/byte of the H100's balance.
// The design is the decode kernel's, with K1 rows of state:
//   - one CTA per (slot, head, tile of up to QT = 4 or 8 query rows);
//     grid.y walks the tiles, so any K1 >= 1 runs (a K1 of more than 8
//     reads the window once per tile);
//   - the same key-parallel groups and row locator as the decode
//     kernel; each group keeps m[QT], l[QT] and acc[QT][VEC] in
//     registers, and the tile's query rows sit in registers too
//     (int8 lanes are loaded 8 at a time here, not 16, so that the
//     QT x VEC accumulators stay at 64 floats);
//   - the per-row mask: row r takes key j iff j <= min(pos + r, W-1).
//     The CTA walks keys up to the tile's last row's reach; a row that
//     a key does not reach skips the update but its lanes still take
//     part in the shuffles (the loop bound and the row loop are uniform
//     across the warp);
//   - paged: keys past the tile's last reachable column never read the
//     table, so unallocated entries (scratch page 0) are never read;
//   - the end-of-CTA merge goes row by row through one GROUPS x D buffer
//     in static shared memory (at most 8 KB), not GROUPS x QT x D.
// Known limit (as the decode kernel): 8 slots x 12 heads is 96 CTAs for
// 132 SMs; split-K, wgmma and TMA are later work.

struct PmdtVerifyArgs {
  PmdtDecodeArgs d;  // d.out is [B, K1, H, Dh] f32, contiguous
  int k1;            // query rows per slot
  long long q_sq;    // q's stride between rows (elements)
};

namespace {

template <typename T, typename S, int D, int QT, bool PAGED>
__global__ void __launch_bounds__(kWarps * 32)
verify_attention_kernel(const PmdtVerifyArgs va) {
  using L = typename VerifyLanes<S>::type;
  constexpr bool QUANT = std::is_same<S, int8_t>::value;
  constexpr int VEC = L::N;
  constexpr int LANES = D / VEC;
  constexpr int KEYS_PER_WARP = 32 / LANES;
  constexpr int GROUPS = kWarps * KEYS_PER_WARP;
  static_assert(D % VEC == 0 && LANES <= 32 && 32 % LANES == 0,
                "head_dim must split into lanes within a warp");

  __shared__ float sm_m[GROUPS];
  __shared__ float sm_l[GROUPS];
  __shared__ float sm_acc[GROUPS][D];

  const PmdtDecodeArgs& a = va.d;
  const int H = a.H;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int r0 = blockIdx.y * QT;          // first query row of the tile
  const int rows = min(QT, va.k1 - r0);    // uniform across the CTA
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LANES;
  const int group = warp * KEYS_PER_WARP + lane / LANES;

  const int pos = a.positions[b];
  int lim[QT];  // last column row r0 + r attends
#pragma unroll
  for (int r = 0; r < QT; ++r) lim[r] = min(pos + r0 + r, a.W - 1);
  const int n_keys = min(pos + r0 + rows - 1, a.W - 1) + 1;

  float qf[QT][VEC];
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    if (r < rows) {
      const T* q_row = static_cast<const T*>(a.q) + b * a.q_sb +
                       (r0 + r) * va.q_sq + h * a.q_sh + sub * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) qf[r][i] = to_float(q_row[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qf[r][i] = 0.f;
    }
  }
  const S* k = static_cast<const S*>(a.k) + h * a.k_s2 + sub * VEC;
  const S* v = static_cast<const S*>(a.v) + h * a.v_s2 + sub * VEC;
  const int* t_row =
      PAGED ? a.table + static_cast<long long>(b) * a.table_stride : nullptr;

  float m[QT];
  float l[QT];
  float acc[QT][VEC];
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
  }

  for (int base = warp * KEYS_PER_WARP; base < n_keys; base += GROUPS) {
    const int j = base + lane / LANES;
    const bool valid = j < n_keys;
    long long row = b;
    long long col = j;
    if (PAGED && valid) {
      const int blk = j / a.page_size;
      row = t_row[blk];
      col = j - blk * a.page_size;
    }
    float kf[VEC];
    float vf[VEC];
    if (valid) {
      L::load(k + row * a.k_s0 + col * a.k_s1, kf);
      L::load(v + row * a.v_s0 + col * a.v_s1, vf);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
    }
    if (QUANT) {
      float ks = 0.f;
      float vs = 0.f;
      if (valid && sub == 0) {
        ks = a.k_scale[row * a.ks_s0 + col * a.ks_s1 + h * a.ks_s2];
        vs = a.v_scale[row * a.vs_s0 + col * a.vs_s1 + h * a.vs_s2];
      }
      ks = __shfl_sync(0xffffffffu, ks, lane - sub);
      vs = __shfl_sync(0xffffffffu, vs, lane - sub);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        kf[i] = round_to<T>(__fmul_rn(kf[i], ks));
        vf[i] = round_to<T>(__fmul_rn(vf[i], vs));
      }
    }
#pragma unroll
    for (int r = 0; r < QT; ++r) {
      if (r < rows) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) s = fmaf(qf[r][i], kf[i], s);
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (valid && j <= lim[r]) {
          s *= a.scale;
          const float m_new = fmaxf(m[r], s);
          const float corr = expf(m[r] - m_new);
          const float p = expf(s - m_new);
          l[r] = l[r] * corr + p;
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[r][i] = fmaf(acc[r][i], corr, p * vf[i]);
          m[r] = m_new;
        }
      }
    }
  }

  // merge the groups row by row through one buffer
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    if (r < rows) {
      if (sub == 0) {
        sm_m[group] = m[r];
        sm_l[group] = l[r];
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[group][sub * VEC + i] = acc[r][i];
      __syncthreads();
      for (int d = threadIdx.x; d < D; d += blockDim.x) {
        float mx = -INFINITY;
#pragma unroll 4
        for (int g = 0; g < GROUPS; ++g) mx = fmaxf(mx, sm_m[g]);
        float den = 0.f;
        float num = 0.f;
#pragma unroll 4
        for (int g = 0; g < GROUPS; ++g) {
          const float w = sm_m[g] == -INFINITY ? 0.f : expf(sm_m[g] - mx);
          den = fmaf(sm_l[g], w, den);
          num = fmaf(sm_acc[g][d], w, num);
        }
        a.out[((static_cast<long long>(b) * va.k1 + r0 + r) * H + h) * D +
              d] = num / fmaxf(den, 1e-30f);
      }
      __syncthreads();
    }
  }
}

template <typename T, typename S, int D, int QT>
cudaError_t launch_verify(const PmdtVerifyArgs& a, cudaStream_t stream) {
  const dim3 grid(a.d.B * a.d.H, (a.k1 + QT - 1) / QT);
  if (a.d.table != nullptr)
    verify_attention_kernel<T, S, D, QT, true>
        <<<grid, kWarps * 32, 0, stream>>>(a);
  else
    verify_attention_kernel<T, S, D, QT, false>
        <<<grid, kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_verify_dim(const PmdtVerifyArgs& a, cudaStream_t stream) {
  const bool small = a.k1 <= 4;  // one tile of 4 rows, else tiles of 8
  switch (a.d.D) {
    case 32:
      return small ? launch_verify<T, S, 32, 4>(a, stream)
                   : launch_verify<T, S, 32, 8>(a, stream);
    case 64:
      return small ? launch_verify<T, S, 64, 4>(a, stream)
                   : launch_verify<T, S, 64, 8>(a, stream);
    case 128:
      return small ? launch_verify<T, S, 128, 4>(a, stream)
                   : launch_verify<T, S, 128, 8>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch of the verify variant `args` names (dtype, quant, table).
// The Python wrapper checks shapes, the row count, unit head_dim strides
// and 16-byte row alignment. Returns a cudaError_t.
extern "C" int pmdt_verify_attention(const PmdtVerifyArgs* args,
                                     void* stream) {
  const PmdtVerifyArgs& a = *args;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.k1 < 1) return static_cast<int>(cudaErrorInvalidValue);
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
