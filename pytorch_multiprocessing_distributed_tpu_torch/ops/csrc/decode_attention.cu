// Flash-decode attention for Hopper (sm_90a): one cached query per slot
// over a dense KV window, f32 online softmax, f32 output.
//
// Replaces the TPU kernel
//   pytorch_multiprocessing_distributed_tpu/ops/pallas/decode_attention.py
//   `_decode_kernel` (launched by `_pallas_decode`, quant=False).
//
//   out[b, 0, h, :] = softmax(q[b,0,h,:] . K[b, 0..n_b-1, h, :]^T * Dh^-1/2)
//                     . V[b, 0..n_b-1, h, :],   n_b = min(pos_b, W-1) + 1
//
// What bounds it on the card: HBM bytes. Each (slot, head) reads its
// n_b keys and values once (2 * n_b * Dh * elt bytes) and does 4 flops
// per element read, far below the ~295 flop/byte the H100 needs before
// compute matters. So the design only moves bytes, and moves each once:
//   - one CTA per (slot, head); K/V are read through their strides, so
//     the engine's window view `k_cache[:, :W]` is never copied or
//     transposed (the Pallas wrapper's merge/moveaxis has no twin here);
//   - every thread loads 16 bytes per key (4 f32 or 8 bf16 lanes); the
//     lanes of one key form a group of Dh/VEC threads that reads the
//     key's Dh contiguous elements, so a group's load is whole cache
//     lines; groups across the CTA walk different keys in parallel;
//   - each group keeps its own online-softmax state (running max m,
//     denominator l, unnormalised accumulator) in registers, so the row
//     of logits never touches memory; groups merge once in shared
//     memory at the end;
//   - only columns 0..min(pos, W-1) are read: the work tracks each
//     slot's true length (the Pallas kernel's position gate), and a row
//     whose position lies beyond the window (a frozen or inactive slot)
//     is clamped to the window instead of reading out of bounds.
// Known limit: with 8 slots x 12 heads the grid is 96 CTAs for 132 SMs,
// and one CTA walks the whole row. Splitting the key range across CTAs
// (split-K flash-decoding) is the next step for small batches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  using Raw = float4;
  static __device__ __forceinline__ void to_float(const Raw& r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  static __device__ __forceinline__ void to_float(const Raw& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ positions,
                        float* __restrict__ out, int H, int W,
                        long long q_sb, long long q_sh, long long k_sb,
                        long long k_ss, long long k_sh, long long v_sb,
                        long long v_ss, long long v_sh, float scale) {
  using V = Vec16<T>;
  using Raw = typename V::Raw;
  constexpr int VEC = V::N;
  constexpr int LANES = D / VEC;              // threads per key
  constexpr int KEYS_PER_WARP = 32 / LANES;   // keys a warp reads at once
  constexpr int GROUPS = kWarps * KEYS_PER_WARP;
  static_assert(D % VEC == 0 && LANES <= 32 && 32 % LANES == 0,
                "head_dim must split into 16-byte lanes within a warp");

  __shared__ float sm_m[GROUPS];
  __shared__ float sm_l[GROUPS];
  __shared__ float sm_acc[GROUPS][D];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LANES;                      // Dh slice of this thread
  const int group = warp * KEYS_PER_WARP + lane / LANES;

  const int pos = positions[b];
  const int n_keys = min(pos, W - 1) + 1;  // <= 0 only for pos < 0: zeros

  float qf[VEC];
  V::to_float(*reinterpret_cast<const Raw*>(q + b * q_sb + h * q_sh +
                                            sub * VEC),
              qf);
  const T* k_row = k + b * k_sb + h * k_sh + sub * VEC;
  const T* v_row = v + b * v_sb + h * v_sh + sub * VEC;

  float m = -INFINITY;
  float l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  // The loop bound is uniform across a warp (base steps by GROUPS), so
  // every lane reaches the shuffles below; lanes whose key lies past
  // n_keys skip the load and the state update.
  for (int base = warp * KEYS_PER_WARP; base < n_keys; base += GROUPS) {
    const int j = base + lane / LANES;
    const bool valid = j < n_keys;
    float kf[VEC];
    float vf[VEC];
    if (valid) {
      V::to_float(*reinterpret_cast<const Raw*>(k_row + j * k_ss), kf);
      V::to_float(*reinterpret_cast<const Raw*>(v_row + j * v_ss), vf);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) s = fmaf(qf[i], kf[i], s);
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (valid) {
      s *= scale;
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
    out[(static_cast<long long>(b) * H + h) * D + d] =
        num / fmaxf(den, 1e-30f);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* positions, float* out, int B, int H, int W,
                   long long q_sb, long long q_sh, long long k_sb,
                   long long k_ss, long long k_sh, long long v_sb,
                   long long v_ss, long long v_sh, float scale,
                   cudaStream_t stream) {
  decode_attention_kernel<T, D><<<B * H, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), positions, out, H, W, q_sb, q_sh, k_sb, k_ss,
      k_sh, v_sb, v_ss, v_sh, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// (head_dim) stride of q, k and v must be 1 and every row start 16-byte
// aligned (the Python wrapper checks both). Returns a cudaError_t.
extern "C" int pmdt_decode_attention(
    const void* q, const void* k, const void* v, const int* positions,
    float* out, int B, int H, int W, int D, int dtype, long long q_sb,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PMDT_CASE(T, DIM)                                                   \
  if (D == DIM)                                                             \
    return static_cast<int>(launch<T, DIM>(q, k, v, positions, out, B, H,  \
                                           W, q_sb, q_sh, k_sb, k_ss,      \
                                           k_sh, v_sb, v_ss, v_sh, scale,  \
                                           s));
  if (dtype == 0) {
    PMDT_CASE(float, 32)
    PMDT_CASE(float, 64)
    PMDT_CASE(float, 128)
  } else if (dtype == 1) {
    PMDT_CASE(__nv_bfloat16, 32)
    PMDT_CASE(__nv_bfloat16, 64)
    PMDT_CASE(__nv_bfloat16, 128)
  }
#undef PMDT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
