// Ring all-reduce for Hopper (sm_90a) over peer memory: a sum over n
// ranks in 2(n-1) hops, each hop a push of one chunk into the right
// neighbour's landing slot, with flags in peer memory for data and
// credits.
//
// Replaces the TPU kernel
//   pytorch_multiprocessing_distributed_tpu/ops/pallas/ring_allreduce.py
//   `_ring_kernel` (launched by `ring_all_reduce`), whose RDMA hops become
//   stores through CUDA IPC mappings.
//
// Layout (the wrapper's `ring_layout`, the JAX padding exactly): the
// payload is f32, padded to rows * 128 elements with rows a multiple of
// 8n, and cut into n chunks of `chunk` elements (a multiple of 1024).
// Rank r's work buffer holds its payload and is reduced in place.
//   reduce-scatter, hop t in [0, n-1): send chunk (r - t), accumulate
//     the incoming chunk (r - t - 1) as own + incoming;
//   all-gather, hop t: send chunk (r + 1 - t), store the incoming chunk
//     (r - t).
// So element e of chunk c sums as x[c+n-1] + (... + (x[c+1] + x[c])),
// ranks mod n, the order of the JAX kernel; each add is __fadd_rn, never
// contracted, and the result is bit-equal to the wrapper's plain version.
//
// Protocol, per block b of each rank (block b owns the same column range
// of every chunk and runs its own ring with block b of its neighbours, so
// no block ever waits for another block of its own rank):
//   - every rank owns one comm buffer: landing slots [2][cap] f32, then
//     u64 flags ready[2][G], ack[2][G] and seq[G];
//   - global hop number gi = seq * 2(n-1) + g, where seq counts this
//     block's calls (kept on the device, so nothing is reset between calls
//     and no entry barrier or drain is needed);
//   - credit: before hop gi writes slot gi % 2 of the right neighbour, the
//     sender waits for ack[slot] >= gi - 1, the receipt of hop gi - 2 into
//     that slot (the credit rule of the TPU kernel);
//   - push: 16-byte stores into the right neighbour's slot, then
//     __threadfence_system, __syncthreads, and one thread's system-scope
//     release store ready[slot] = gi + 1 into the neighbour's flags;
//   - receive: one thread spins on its own ready[slot] with acquire loads,
//     the block reads the slot with L2 loads (__ldcg: the slot's lines may
//     sit stale in this SM's L1 from two hops ago), adds or stores, then
//     publishes ack[slot] = gi + 1 into the left neighbour's flags;
//   - every spin is bounded (%globaltimer, 10 s), then __trap(): a
//     protocol fault is a CUDA error at the next synchronize, not a hang.
//
// What bounds it on this card: across cards, NVLink — each rank pushes
// 2(n-1)/n of the padded payload to its neighbour, at most 450 GB/s each
// way on an H100 SXM; in loopback (n ranks on one card), HBM — each
// rank's payload read once and written once at 3.35 TB/s. The design
// moves each byte once per hop in 16-byte stores from G blocks per rank
// (several loads in flight per thread before the stores), and the hop's
// only latency is one flag write and one flag read over NVLink.
//
// Two launches share the `__device__` body: one rank per card
// (`pmdt_ring_allreduce`, G blocks), and a loopback with n ranks on one
// card in one launch (`pmdt_ring_allreduce_loopback`, blockIdx.y = rank,
// "peer" pointers into the same card), launched cooperatively so that a
// grid whose n * G blocks cannot all be resident is refused, not hung.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr int kMaxLoopback = 8;
constexpr u64 kSpinTimeoutNs = 10ull * 1000ull * 1000ull * 1000ull;

// one rank's pointers: its own work and comm buffer, and its neighbours'
struct RankView {
  float* work;        // [n * chunk] f32, reduced in place
  float* slots;       // own landing slots [2][cap]
  u64* flags;         // own ready[2][G], ack[2][G], seq[G]
  float* right_slots; // the right neighbour's landing slots
  u64* right_flags;   // the right neighbour's flags (its ready is written)
  u64* left_flags;    // the left neighbour's flags (its ack is written)
};

struct LoopbackParams {
  RankView rank[kMaxLoopback];
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

__device__ __forceinline__ u64 now_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
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

// block blockIdx.x of rank `rank`: 2(n-1) hops over its column range
__device__ void ring_body(const RankView& v, int rank, int n, long long chunk4,
                          long long cap4, int blocks) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int hops = 2 * (n - 1);
  u64* ready = v.flags;
  u64* ack = v.flags + 2 * blocks;
  u64* seq = v.flags + 4 * blocks;
  __shared__ u64 base_s;
  if (tid == 0) base_s = __ldcg(seq + b) * static_cast<u64>(hops);
  __syncthreads();
  const u64 base = base_s;

  const long long per = (chunk4 + blocks - 1) / blocks;
  const long long lo = min(chunk4, b * per);
  const long long hi = min(chunk4, lo + per);
  float4* work = reinterpret_cast<float4*>(v.work);
  const float4* mine = reinterpret_cast<const float4*>(v.slots);
  float4* theirs = reinterpret_cast<float4*>(v.right_slots);

  for (int g = 0; g < hops; ++g) {
    const u64 gi = base + g;
    const int slot = g & 1;
    const bool reduce = g < n - 1;
    const int t = reduce ? g : g - (n - 1);
    const int send = reduce ? wrap(rank - t, n) : wrap(rank + 1 - t, n);
    const int recv = reduce ? wrap(rank - t - 1, n) : wrap(rank - t, n);

    // credit: the right neighbour consumed hop gi - 2 from this slot
    if (tid == 0 && gi >= 2) wait_at_least(ack + slot * blocks + b, gi - 1);
    __syncthreads();

    // push my chunk `send` into the right neighbour's slot
    const float4* src = work + send * chunk4;
    float4* dst = theirs + slot * cap4;
    for (long long i0 = lo + tid; i0 < hi; i0 += kThreads * kUnroll) {
      float4 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + u * kThreads;
        if (i < hi) r[u] = src[i];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + u * kThreads;
        if (i < hi) dst[i] = r[u];
      }
    }
    __threadfence_system();
    __syncthreads();
    if (tid == 0) st_release_sys(v.right_flags + slot * blocks + b, gi + 1);

    // receive the left neighbour's chunk `recv` from my slot
    if (tid == 0) wait_at_least(ready + slot * blocks + b, gi + 1);
    __syncthreads();
    const float4* in = mine + slot * cap4;
    float4* acc = work + recv * chunk4;
    for (long long i0 = lo + tid; i0 < hi; i0 += kThreads * kUnroll) {
      float4 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + u * kThreads;
        if (i < hi) r[u] = __ldcg(in + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = i0 + u * kThreads;
        if (i < hi) acc[i] = reduce ? add4(acc[i], r[u]) : r[u];
      }
    }
    __syncthreads();
    // consumed: return the credit to the left neighbour
    if (tid == 0) {
      __threadfence_system();
      st_release_sys(v.left_flags + 2 * blocks + slot * blocks + b, gi + 1);
    }
  }
  if (tid == 0) seq[b] = __ldcg(seq + b) + 1;
}

__global__ void __launch_bounds__(kThreads)
ring_kernel(RankView v, int rank, int n, long long chunk4, long long cap4,
            int blocks) {
  ring_body(v, rank, n, chunk4, cap4, blocks);
}

__global__ void __launch_bounds__(kThreads)
ring_loopback_kernel(LoopbackParams p, int n, long long chunk4,
                     long long cap4, int blocks) {
  ring_body(p.rank[blockIdx.y], blockIdx.y, n, chunk4, cap4, blocks);
}

// byte offset of the flags inside a comm buffer of `cap` slot elements
inline long long flags_offset(long long cap) { return 2 * cap * 4; }

bool shape_ok(int n, long long chunk, long long cap, int blocks) {
  return n >= 2 && blocks >= 1 && chunk > 0 && chunk % 4 == 0 &&
         cap % 64 == 0 && chunk <= cap;
}

}  // namespace

// Bytes of one rank's comm buffer: landing slots [2][cap] f32, then
// 5 * blocks u64 flags. cap must be a multiple of 64.
extern "C" long long pmdt_ring_comm_bytes(long long cap, int blocks) {
  return flags_offset(cap) + 5LL * blocks * 8;
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

// One rank's launch. work: this rank's [n * chunk] f32 payload, reduced
// in place. own / right / left: the comm buffers (own, and the mappings
// of the neighbours'; right == left for n == 2). chunk, cap: elements.
extern "C" int pmdt_ring_allreduce(int device, int rank, int n, float* work,
                                   void* own, void* right, void* left,
                                   long long chunk, long long cap, int blocks,
                                   void* stream) {
  if (!shape_ok(n, chunk, cap, blocks) || rank < 0 || rank >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long off = flags_offset(cap);
  RankView v;
  v.work = work;
  v.slots = static_cast<float*>(own);
  v.flags = reinterpret_cast<u64*>(static_cast<char*>(own) + off);
  v.right_slots = static_cast<float*>(right);
  v.right_flags = reinterpret_cast<u64*>(static_cast<char*>(right) + off);
  v.left_flags = reinterpret_cast<u64*>(static_cast<char*>(left) + off);
  ring_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, rank, n, chunk / 4, cap / 4, blocks);
  return static_cast<int>(cudaGetLastError());
}

// n ranks on one card in one cooperative launch. work: [n][work_stride]
// f32 (rank r's payload at work + r * work_stride); comm: n comm buffers
// of comm_stride bytes each (rank r's at comm + r * comm_stride).
extern "C" int pmdt_ring_allreduce_loopback(int device, int n, float* work,
                                            long long work_stride, void* comm,
                                            long long comm_stride,
                                            long long chunk, long long cap,
                                            int blocks, void* stream) {
  if (!shape_ok(n, chunk, cap, blocks) || n > kMaxLoopback ||
      comm_stride < pmdt_ring_comm_bytes(cap, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long off = flags_offset(cap);
  char* base = static_cast<char*>(comm);
  LoopbackParams p;
  for (int r = 0; r < n; ++r) {
    char* own = base + r * comm_stride;
    char* right = base + ((r + 1) % n) * comm_stride;
    char* left = base + ((r + n - 1) % n) * comm_stride;
    RankView& v = p.rank[r];
    v.work = work + r * work_stride;
    v.slots = reinterpret_cast<float*>(own);
    v.flags = reinterpret_cast<u64*>(own + off);
    v.right_slots = reinterpret_cast<float*>(right);
    v.right_flags = reinterpret_cast<u64*>(right + off);
    v.left_flags = reinterpret_cast<u64*>(left + off);
  }
  long long chunk4 = chunk / 4, cap4 = cap / 4;
  void* args[] = {&p, &n, &chunk4, &cap4, &blocks};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(ring_loopback_kernel), dim3(blocks, n),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
