// Fused SGD update for Hopper (sm_90a): torch-exact SGD with momentum,
// weight decay and Nesterov in one pass over flat f32 buffers, in place.
//
// Replaces the TPU kernel
//   pytorch_multiprocessing_distributed_tpu/ops/pallas/fused_update.py
//   `_kernel` (launched per leaf by `_fused_leaf`; entries
//   `fused_sgd_apply` and `sgd_pallas`).
//
// Per element i < n:
//   g   = grad + wd * p
//   buf = init * momentum * buf + g        (init = 0 before the first step)
//   d   = g + momentum * buf   (nesterov)  |  buf
//   p   = p - lr * d
// p and buf are written in place. `init` is the device flag
// `initialized`; the device flag `keep` (the NaN guard's all-finite
// predicate) gates everything: when it is false no element is written and
// the flags do not advance. Both flags are read on the device, so the
// caller never syncs with the host; lr is a kernel argument (the host's
// epoch schedule).
//
// What bounds it on the card: HBM bytes. Each element reads p, grad and
// buf and writes p and buf (5 x 4 bytes) for ~8 flops, so the kernel is a
// bandwidth pass (~29 us for ResNet-18's 4.9 M parameters at 3.35 TB/s).
// The design only moves those bytes once, in wide transactions:
//   - the whole model is one launch over the port's flat buffers (the
//     Pallas version runs one kernel per leaf on [rows, 128] tiles);
//   - each thread moves 16 bytes per operand (float4) in a grid-stride
//     loop; the n % 4 tail (and buffers that are not 16-byte aligned)
//     take a scalar loop;
//   - every product and sum is rounded on its own (__fmul_rn,
//     __fadd_rn, __fsub_rn are never contracted into an FMA), the
//     rounding of the plain PyTorch version, whose ops are separate
//     kernels: the two agree bit for bit;
//   - `initialized` and `count` advance in a one-thread kernel launched
//     after the pass on the same stream, so no block of the pass can see
//     the flag change under it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

struct Hyper {
  float lr, momentum, wd;
  int nesterov;
};

__device__ __forceinline__ void sgd_one(float& p, float g, float& b,
                                        float init_m, const Hyper& h) {
  const float gw = __fadd_rn(g, __fmul_rn(h.wd, p));
  const float nb = __fadd_rn(__fmul_rn(init_m, b), gw);
  const float d = h.nesterov ? __fadd_rn(gw, __fmul_rn(h.momentum, nb)) : nb;
  p = __fsub_rn(p, __fmul_rn(h.lr, d));
  b = nb;
}

__global__ void fused_sgd_vec_kernel(float* __restrict__ p,
                                     const float* __restrict__ g,
                                     float* __restrict__ b,
                                     const uint8_t* __restrict__ keep,
                                     const uint8_t* __restrict__ initialized,
                                     long long n, Hyper h) {
  if (!*keep) return;
  // init * momentum, as the Pallas kernel forms it: 0 or momentum exactly
  const float init_m = *initialized ? h.momentum : 0.0f;
  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* b4 = reinterpret_cast<float4*>(b);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += stride) {
    float4 pv = p4[i];
    const float4 gv = g4[i];
    float4 bv = b4[i];
    sgd_one(pv.x, gv.x, bv.x, init_m, h);
    sgd_one(pv.y, gv.y, bv.y, init_m, h);
    sgd_one(pv.z, gv.z, bv.z, init_m, h);
    sgd_one(pv.w, gv.w, bv.w, init_m, h);
    p4[i] = pv;
    b4[i] = bv;
  }
  // the n % 4 tail: at most three elements, on the first block
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long long i = 4 * n4 + threadIdx.x;
    float pv = p[i], bv = b[i];
    sgd_one(pv, g[i], bv, init_m, h);
    p[i] = pv;
    b[i] = bv;
  }
}

__global__ void fused_sgd_scalar_kernel(float* __restrict__ p,
                                        const float* __restrict__ g,
                                        float* __restrict__ b,
                                        const uint8_t* __restrict__ keep,
                                        const uint8_t* __restrict__ initialized,
                                        long long n, Hyper h) {
  if (!*keep) return;
  const float init_m = *initialized ? h.momentum : 0.0f;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float pv = p[i], bv = b[i];
    sgd_one(pv, g[i], bv, init_m, h);
    p[i] = pv;
    b[i] = bv;
  }
}

// initialized |= keep; count += keep (one thread, after the pass)
__global__ void fused_sgd_flags_kernel(const uint8_t* __restrict__ keep,
                                       uint8_t* __restrict__ initialized,
                                       int* __restrict__ count) {
  if (*keep) {
    *initialized = 1;
    *count += 1;
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

}  // namespace

// p, grad, buf: f32 [n] (p and buf updated in place; none may alias
// another). keep, initialized: bool (one byte) device scalars; count:
// int32 device scalar. n >= 0. Returns a cudaError_t.
extern "C" int pmdt_fused_sgd(float* p, const float* grad, float* buf,
                              const uint8_t* keep, uint8_t* initialized,
                              int* count, long long n, float lr,
                              float momentum, float weight_decay,
                              int nesterov, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyper h{lr, momentum, weight_decay, nesterov};
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(grad) |
        reinterpret_cast<uintptr_t>(buf)) & 15) == 0;
  const long long work = aligned ? n / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;  // the tail, or n == 0 (a no-op pass)
  if (aligned) {
    fused_sgd_vec_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
        p, grad, buf, keep, initialized, n, h);
  } else {
    fused_sgd_scalar_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
        p, grad, buf, keep, initialized, n, h);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_sgd_flags_kernel<<<1, 1, 0, s>>>(keep, initialized, count);
  return static_cast<int>(cudaGetLastError());
}
