// Ring all-reduce for Hopper (sm_90a) over peer memory: a sum over n
// ranks in 2(n-1) hops, pipelined as a ring of small steps, with the
// reduce fused into the forward push.
//
// Replaces the TPU kernel
//   pytorch_multiprocessing_distributed_tpu/ops/pallas/ring_allreduce.py
//   `_ring_kernel` (launched by `ring_all_reduce`), whose RDMA hops become
//   stores through CUDA IPC mappings.
//
// Layout (the wrapper's `ring_layout`, the JAX padding exactly): each
// rank's payload is `size` f32, read as if zero-padded to n chunks of
// `chunk` elements (a multiple of 1024). Element e of chunk c sums as
// x[c+n-1] + (... + (x[c+1] + x[c])), ranks mod n, the order of the JAX
// kernel; each add is __fadd_rn(own, incoming), never contracted, so the
// result is bit-equal to the wrapper's plain version.
//
// Schedule of rank r (NCCL's recvReduceSend / recvCopySend): 2(n-1)
// pushes into the right neighbour, 2(n-1) receipts from the left one.
//   push 0:                 x[chunk r], straight from the input;
//   receipt q < n-2:        chunk r-1-q: push own x + incoming on;
//   receipt n-2:            chunk r+1 is now whole: write it to the
//                           output and push it (all-gather hop 0);
//   receipt q in n-1..2n-4: a whole chunk: write it and push it on;
//   receipt 2n-3:           write it.
// The input is read once, every landing slot once, the output written
// once; nothing is written back locally before it is pushed. Elements
// at or past `size` read as 0 and are never written, so the wrapper
// neither pads nor copies. The input may be the output (the loopback's
// in-place form): a block reads every chunk of x in its column range
// before it writes any of them.
//
// Protocol. Block b of every rank owns the same column range of every
// chunk (the wrapper's `ring_plan`) and runs its own ring with block b
// of its neighbours, so no block waits for another block of its own
// rank. The range is cut into `steps` steps per hop; the block's step j
// (counted over all calls: `seq` on the device, so nothing is reset
// between calls) lands in slot j % K of the right neighbour's K landing
// slots. Every rank's comm buffer is fixed in size:
//   slots [cap][K][slot] f32, then u64 ready[cap][K], ack[cap][K], seq[cap].
//   - credit: before pushing step j the sender waits, on its own ack,
//     for the receipt of step j - K (the last user of that slot);
//   - push: 16-byte stores into the slot, then one st.release.sys (the
//     step's one system-scope fence) of ready = j + 1 into the right
//     neighbour's flags;
//   - receipt: an ld.acquire.sys spin on its own ready, __ldcg reads of
//     the slot (its lines may sit stale in this SM's L1), then
//     ack = j + 1 into the left neighbour's flags.
// Every spin is bounded (%globaltimer, 10 s), then __trap(): a protocol
// fault is a CUDA error at the next synchronize, not a hang.
//
// A block is `control` control warps (the plan's; 1 to 7) and 8 or 16
// data warps. The data warps move iteration after iteration (a window's
// step through one stage); iteration it belongs to control warp
// it % control, whose lane 0 spins until its flags are set, releases
// the data warps at a named barrier (GO), waits for them at another
// (DONE), and posts. So each control warp's release store (the system
// fence, microseconds) and flag spin overlap the data warps' next
// iterations, and the link, HBM and the flags stay busy together. A
// post never waits on a later iteration's flags, so no rank waits on a
// post that waits on it. The iterations run in windows of `window`
// steps through every stage (see `decode`), so a step's receipt comes
// `window` iterations after its push: the neighbour's fence and flag
// latency is hidden too. The wrapper's defaults (blocks, data warps,
// step, K, control warps) are the winner of an A/B in turns across
// four H100s.
//
// What bounds it on this card: across cards, NVLink — each rank pushes
// 2(n-1)/n of the padded payload to its neighbour, at most 450 GB/s
// each way on an H100 SXM; in loopback (n ranks on one card), HBM —
// each rank's payload read once and its result written once at
// 3.35 TB/s, to which the landing slots add 2(n-1)/n of a payload
// written and read again by every rank, which the 50 MB L2 holds only
// in part.
//
// Two launches share the `__device__` body: one rank per card
// (`pmdt_ring_allreduce`), and a loopback with n ranks on one card in one
// launch (`pmdt_ring_allreduce_loopback`, blockIdx.y = rank, "peer"
// pointers into the same card), launched cooperatively so that a grid
// whose n * blocks cannot all be resident is refused, not hung.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

// One call's cut, from the wrapper's `ring_plan` (counts in f32 elements).
struct PmdtRingPlan {
  long long size;   // elements of each rank's payload
  long long chunk;  // elements of a chunk (multiple of 4)
  long long per;    // elements of a chunk each block owns (multiple of 4)
  long long step;   // elements a step moves (multiple of 4, <= slot)
  long long slot;   // elements a landing slot holds (multiple of 4)
  int n;            // ranks
  int blocks;       // blocks launched per rank
  int cap_blocks;   // blocks the comm buffer holds (>= blocks)
  int slots;        // K, landing slots per block (>= 2)
  int steps;        // steps per hop
  int window;       // steps taken through every hop together (2 window <= K)
  int data_warps;   // 8 or 16
  int control;      // control warps a block, 1 to 7
};

namespace {

constexpr int kMaxLoopback = 8;
constexpr int kUnroll = 4;
// iteration it is control warp c = it % control's, which meets the data
// warps at named barriers kGo + 2c and kDone + 2c (ids up to 14)
constexpr int kMaxControl = 7;
constexpr int kGo = 1;    // named barrier: control warp -> data warps
constexpr int kDone = 2;  // named barrier: data warps -> control warp
constexpr u64 kSpinTimeoutNs = 10ull * 1000ull * 1000ull * 1000ull;

// one rank's pointers: its input and output, its comm buffer, and its
// neighbours'
struct RankView {
  const float* x;      // [size] f32, 16-byte aligned
  float* y;            // [size] f32, 16-byte aligned (may be x)
  const float4* slots; // own landing slots
  u64* flags;          // own ready, ack, seq
  float4* right_slots; // the right neighbour's landing slots
  u64* right_flags;    // the right neighbour's flags (its ready is written)
  u64* left_flags;     // the left neighbour's flags (its ack is written)
};

struct LoopbackParams {
  RankView rank[kMaxLoopback];
};

// block b's flags in the comm buffers
struct Flags {
  u64* ready;        // own [K], written by the left neighbour
  u64* ack;          // own [K], written by the right neighbour
  u64* right_ready;  // the right neighbour's ready [K]
  u64* left_ack;     // the left neighbour's ack [K]
};

__device__ __forceinline__ u64 ld_acquire_sys(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void st_relaxed_sys(u64* p, u64 v) {
  asm volatile("st.relaxed.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 now_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// spin until *p >= want; trap after kSpinTimeoutNs
__device__ void wait_at_least(const u64* p, u64 want) {
  if (ld_acquire_sys(p) >= want) return;
  const u64 start = now_ns();
  while (ld_acquire_sys(p) < want) {
    if (now_ns() - start > kSpinTimeoutNs) __trap();
  }
}

__device__ __forceinline__ int wrap(int a, int n) { return ((a % n) + n) % n; }

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// the input's 4 elements from e (a multiple of 4); 0 at or past size
__device__ __forceinline__ float4 load_x(const float* x, long long e,
                                         long long size) {
  if (e + 4 <= size) return __ldcg(reinterpret_cast<const float4*>(x + e));
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (e < size) r.x = __ldcg(x + e);
  if (e + 1 < size) r.y = __ldcg(x + e + 1);
  if (e + 2 < size) r.z = __ldcg(x + e + 2);
  return r;
}

// the output's 4 elements from e; none at or past size
__device__ __forceinline__ void store_y(float* y, long long e, float4 v,
                                        long long size) {
  if (e + 4 <= size) {
    __stcs(reinterpret_cast<float4*>(y + e), v);
    return;
  }
  if (e < size) y[e] = v.x;
  if (e + 1 < size) y[e + 1] = v.y;
  if (e + 2 < size) y[e + 2] = v.z;
}

// One step over `len` float4s: kIn reads the landing slot, kOwn this
// rank's input (own + incoming when both), kPush stores into the right
// neighbour's slot, kWrite into the output. e0: the step's first element
// in the payload.
template <int D, bool kIn, bool kOwn, bool kPush, bool kWrite>
__device__ __forceinline__ void move_step(const float4* in, const float* x,
                                          float4* out, float* y, long long e0,
                                          long long len, long long size,
                                          int tid) {
  constexpr int kStride = 32 * D;
  for (long long i0 = tid; i0 < len; i0 += kStride * kUnroll) {
    float4 a[kUnroll], o[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * kStride;
      if (i < len) {
        if (kIn) a[u] = __ldcg(in + i);
        if (kOwn) o[u] = load_x(x, e0 + 4 * i, size);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * kStride;
      if (i < len) {
        float4 r;
        if (kIn && kOwn) r = add4(o[u], a[u]);
        else if (kIn) r = a[u];
        else r = o[u];
        if (kPush) out[i] = r;
        if (kWrite) store_y(y, e0 + 4 * i, r, size);
      }
    }
  }
}

// Iteration `it` of a block's (2(n-1) + 1) * steps: windows of
// `window` steps (the last may be narrower), each through every stage k
// (push only at k = 0, receive only at k = 2(n-1)), step by step. So a
// step's receipt comes `window` iterations after the left neighbour
// pushed it, and 2 * window <= K slots hold every step in flight.
// push / recv: the step numbers (from the call's first) of the stage's
// push (k < 2(n-1)) and receipt (k >= 1), in the order both sides move
// them.
struct Iter {
  int k, s;
  long long push, recv;
};

__device__ __forceinline__ Iter decode(const PmdtRingPlan& p, int it) {
  const int hops = 2 * (p.n - 1), w_max = p.window;
  const int per_window = w_max * (hops + 1);
  const int full = p.steps / w_max;
  int w, r, width;
  if (it < full * per_window) {
    w = it / per_window;
    r = it - w * per_window;
    width = w_max;
  } else {
    w = full;
    r = it - full * per_window;
    width = p.steps - full * w_max;
  }
  Iter t;
  t.k = r / width;
  const int local = r - t.k * width;
  t.s = w * w_max + local;
  const long long before = static_cast<long long>(w) * w_max * hops;
  t.push = before + static_cast<long long>(t.k) * width + local;
  t.recv = t.push - width;
  return t;
}

// wait until iteration it's incoming step has landed and its push's
// slot is free
__device__ void wait_flags(const Flags& f, const PmdtRingPlan& p, u64 base,
                           int it) {
  const int K = p.slots;
  const Iter t = decode(p, it);
  if (t.k >= 1) {
    const u64 jr = base + t.recv;
    wait_at_least(f.ready + jr % K, jr + 1);
  }
  const u64 jp = base + t.push;
  if (t.k < 2 * (p.n - 1) && jp >= static_cast<u64>(K))
    wait_at_least(f.ack + jp % K, jp - K + 1);
}

// after iteration it's data warps are done: ready to the right
// neighbour, the credit to the left one. The first store is a release
// at system scope (the fence that makes the data warps' stores, ordered
// before it by the DONE barrier, visible to the neighbour first); a
// second store rides behind the same fence.
__device__ void post(const Flags& f, const PmdtRingPlan& p, u64 base,
                     int it) {
  const int K = p.slots;
  const Iter t = decode(p, it);
  const bool push = t.k < 2 * (p.n - 1), recv = t.k >= 1;
  const u64 jp = base + t.push, jr = base + t.recv;
  if (push) st_release_sys(f.right_ready + jp % K, jp + 1);
  if (recv && push) st_relaxed_sys(f.left_ack + jr % K, jr + 1);
  if (recv && !push) st_release_sys(f.left_ack + jr % K, jr + 1);
}

// the data warps' part of iteration it
template <int D>
__device__ void move(const RankView& v, int rank, const PmdtRingPlan& p,
                     u64 base, int it, int b, int tid) {
  const int n = p.n, hops = 2 * (n - 1);
  const Iter t = decode(p, it);
  const int k = t.k, s = t.s;
  const long long per4 = p.per >> 2, step4 = p.step >> 2;
  const long long lo = b * per4 + s * step4;
  const long long hi = min(min(p.chunk >> 2, (b + 1) * per4), lo + step4);
  if (lo >= hi) return;
  const long long len = hi - lo;
  // the stage's chunk: its own at push 0, else the one received
  const int c = k == 0 ? rank : k <= n - 1 ? wrap(rank - k, n)
                                           : wrap(rank - (k - n), n);
  const long long e0 = c * p.chunk + 4 * lo;
  const long long slot4 = p.slot >> 2;
  const long long row = static_cast<long long>(b) * p.slots;
  const float4* in = k == 0 ? nullptr
      : v.slots + (row + (base + t.recv) % p.slots) * slot4;
  float4* out = k == hops ? nullptr
      : v.right_slots + (row + (base + t.push) % p.slots) * slot4;
  if (k == 0)
    move_step<D, false, true, true, false>(in, v.x, out, v.y, e0, len,
                                           p.size, tid);
  else if (k < n - 1)
    move_step<D, true, true, true, false>(in, v.x, out, v.y, e0, len,
                                          p.size, tid);
  else if (k == n - 1)
    move_step<D, true, true, true, true>(in, v.x, out, v.y, e0, len,
                                         p.size, tid);
  else if (k < hops)
    move_step<D, true, false, true, true>(in, v.x, out, v.y, e0, len,
                                          p.size, tid);
  else
    move_step<D, true, false, false, true>(in, v.x, out, v.y, e0, len,
                                           p.size, tid);
}

template <int D>
__device__ void ring_body(const RankView& v, int rank, const PmdtRingPlan& p) {
  // a named barrier's threads: the data warps and one control warp
  constexpr int kBar = 32 * (D + 1);
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int iters = (2 * (p.n - 1) + 1) * p.steps;
  __shared__ u64 base_s;

  const long long kb = static_cast<long long>(b) * p.slots;
  const long long all = static_cast<long long>(p.cap_blocks) * p.slots;
  u64* seq = v.flags + 2 * all + b;
  if (threadIdx.x == 0) base_s = __ldcg(seq);
  __syncthreads();
  const u64 base = base_s;
  // the next call on this rank reads it after this launch has ended
  if (threadIdx.x == 0) *seq = base + static_cast<u64>(iters - p.steps);

  if (warp >= p.control) {  // data warps
    for (int it = 0; it < iters; ++it) {
      const int c = it % p.control;
      bar_sync(kGo + 2 * c, kBar);
      move<D>(v, rank, p, base, it, b, threadIdx.x - 32 * p.control);
      bar_arrive(kDone + 2 * c, kBar);
    }
    return;
  }

  // control warp c: lane 0 spins and posts for the iterations c,
  // c + control, ...; the warp meets the barriers converged. A post
  // never waits on a later iteration's flags.
  Flags f;
  f.ready = v.flags + kb;
  f.ack = v.flags + all + kb;
  f.right_ready = v.right_flags + kb;
  f.left_ack = v.left_flags + all + kb;
  const int c = warp;
  for (int it = c; it < iters; it += p.control) {
    if (lane == 0) wait_flags(f, p, base, it);
    __syncwarp();
    bar_arrive(kGo + 2 * c, kBar);
    bar_sync(kDone + 2 * c, kBar);
    if (lane == 0) post(f, p, base, it);
    __syncwarp();
  }
}

template <int D>
__global__ void __launch_bounds__(32 * (D + kMaxControl))
ring_kernel(RankView v, int rank, PmdtRingPlan p) {
  ring_body<D>(v, rank, p);
}

template <int D>
__global__ void __launch_bounds__(32 * (D + kMaxControl))
ring_loopback_kernel(LoopbackParams lp, PmdtRingPlan p) {
  ring_body<D>(lp.rank[blockIdx.y], blockIdx.y, p);
}

// byte offset of the flags in a comm buffer
inline long long flags_offset(int cap_blocks, int slots, long long slot) {
  return static_cast<long long>(cap_blocks) * slots * slot * 4;
}

bool plan_ok(const PmdtRingPlan& p) {
  return p.n >= 2 && p.size >= 1 && p.chunk >= 4 && p.chunk % 4 == 0 &&
         p.size <= p.chunk * p.n && p.per % 4 == 0 && p.step % 4 == 0 &&
         p.slot % 4 == 0 && p.step >= 4 && p.step <= p.slot &&
         p.blocks >= 1 && p.blocks <= p.cap_blocks && p.slots >= 2 &&
         p.steps >= 1 && p.per * p.blocks >= p.chunk &&
         p.step * p.steps >= p.per && p.window >= 1 &&
         2 * p.window <= p.slots &&
         (2LL * (p.n - 1) + 1) * p.steps < (1LL << 30) &&
         (p.data_warps == 8 || p.data_warps == 16) && p.control >= 1 &&
         p.control <= kMaxControl;
}

bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

RankView view(const float* x, float* y, char* own, char* right, char* left,
              long long off) {
  RankView v;
  v.x = x;
  v.y = y;
  v.slots = reinterpret_cast<const float4*>(own);
  v.flags = reinterpret_cast<u64*>(own + off);
  v.right_slots = reinterpret_cast<float4*>(right);
  v.right_flags = reinterpret_cast<u64*>(right + off);
  v.left_flags = reinterpret_cast<u64*>(left + off);
  return v;
}

template <int D>
cudaError_t launch_loopback(const LoopbackParams& lp, const PmdtRingPlan& p,
                            cudaStream_t stream) {
  LoopbackParams a = lp;
  PmdtRingPlan b = p;
  void* args[] = {&a, &b};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(ring_loopback_kernel<D>), dim3(p.blocks, p.n),
      dim3(32 * (D + p.control)), args, 0, stream);
}

}  // namespace

// Bytes of one rank's comm buffer: landing slots [cap][K][slot] f32,
// then (2K + 1) * cap u64 flags. Independent of the payload.
extern "C" long long pmdt_ring_comm_bytes(int cap_blocks, int slots,
                                          long long slot) {
  return flags_offset(cap_blocks, slots, slot) +
         (2LL * slots + 1) * cap_blocks * 8;
}

// Blocks of the loopback kernel (data_warps 8 or 16, control warps) that
// one card holds at once: its cooperative launch needs n * blocks of
// them resident.
extern "C" int pmdt_ring_resident(int device, int data_warps, int control,
                                  int* out) {
  if (control < 1 || control > kMaxControl)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    if (data_warps == 8)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ring_loopback_kernel<8>, 32 * (8 + control), 0);
    else if (data_warps == 16)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ring_loopback_kernel<16>, 32 * (16 + control), 0);
    else
      err = cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) *out = sms * per_sm;
  return static_cast<int>(err);
}

// A zeroed comm buffer of `bytes` on `device` (cudaMalloc: one whole
// allocation, which an IPC handle covers).
extern "C" int pmdt_ring_alloc(int device, long long bytes, void** out) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(out, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaMemset(*out, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}

extern "C" int pmdt_ring_free(int device, void* p) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(p);
  return static_cast<int>(err);
}

// The 64-byte IPC handle of a buffer from pmdt_ring_alloc.
extern "C" int pmdt_ring_ipc_handle(int device, void* p, unsigned char* out) {
  cudaError_t err = cudaSetDevice(device);
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h, p);
  if (err == cudaSuccess) {
    for (int i = 0; i < CUDA_IPC_HANDLE_SIZE; ++i) out[i] = h.reserved[i];
  }
  return static_cast<int>(err);
}

// Map another process's buffer into this process's context on `device`,
// with peer access enabled.
extern "C" int pmdt_ring_ipc_open(int device, const unsigned char* handle,
                                  void** out) {
  cudaError_t err = cudaSetDevice(device);
  cudaIpcMemHandle_t h;
  for (int i = 0; i < CUDA_IPC_HANDLE_SIZE; ++i) h.reserved[i] = handle[i];
  if (err == cudaSuccess)
    err = cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
  return static_cast<int>(err);
}

extern "C" int pmdt_ring_ipc_close(int device, void* p) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(p);
  return static_cast<int>(err);
}

// One rank's launch. x: this rank's payload, y: its result (both
// plan->size f32, 16-byte aligned; y may be x). own / right / left: the
// comm buffers (own, and the mappings of the neighbours'; right == left
// for n == 2), each laid out for plan->cap_blocks, slots and slot.
extern "C" int pmdt_ring_allreduce(int device, int rank, const float* x,
                                   float* y, void* own, void* right,
                                   void* left, const PmdtRingPlan* plan,
                                   void* stream) {
  const PmdtRingPlan p = *plan;
  if (!plan_ok(p) || rank < 0 || rank >= p.n || !aligned16(x) ||
      !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const RankView v = view(x, y, static_cast<char*>(own),
                          static_cast<char*>(right), static_cast<char*>(left),
                          flags_offset(p.cap_blocks, p.slots, p.slot));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.data_warps == 8)
    ring_kernel<8><<<p.blocks, 32 * (8 + p.control), 0, s>>>(v, rank, p);
  else
    ring_kernel<16><<<p.blocks, 32 * (16 + p.control), 0, s>>>(v, rank, p);
  return static_cast<int>(cudaGetLastError());
}

// n = plan->n ranks on one card in one cooperative launch. xs[r], ys[r]:
// rank r's payload and result (ys[r] may be xs[r]); comm: n comm buffers
// of comm_stride bytes each (rank r's at comm + r * comm_stride).
extern "C" int pmdt_ring_allreduce_loopback(int device, const float* const* xs,
                                            float* const* ys, void* comm,
                                            long long comm_stride,
                                            const PmdtRingPlan* plan,
                                            void* stream) {
  const PmdtRingPlan p = *plan;
  const int n = p.n;
  if (!plan_ok(p) || n > kMaxLoopback ||
      comm_stride < pmdt_ring_comm_bytes(p.cap_blocks, p.slots, p.slot) ||
      comm_stride % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int r = 0; r < n; ++r) {
    if (!aligned16(xs[r]) || !aligned16(ys[r]))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long off = flags_offset(p.cap_blocks, p.slots, p.slot);
  char* base = static_cast<char*>(comm);
  LoopbackParams lp;
  for (int r = 0; r < n; ++r) {
    lp.rank[r] = view(xs[r], ys[r], base + r * comm_stride,
                      base + ((r + 1) % n) * comm_stride,
                      base + ((r + n - 1) % n) * comm_stride, off);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = p.data_warps == 8 ? launch_loopback<8>(lp, p, s)
                          : launch_loopback<16>(lp, p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
