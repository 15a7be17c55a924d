// byte_histogram for Hopper (sm_90a): the histogram of int32 values into
// n_bins <= 512 bins; values outside [0, n_bins) are dropped.
//
// Replaces the Pallas kernel suffix_tpu/ops/pallas_kernels.py
// (_hist_kernel / _hist_pallas / byte_histogram, pl.pallas_call at :51).
// The TPU kernel walks (8, 128) tiles in order on one core and sums an
// (8, 512) one-hot table in VMEM across grid steps. Here blocks run in
// parallel in no order, so the design is the card's own.
//
// Bound: each value read once (4 B) and each bin written once (4 B):
// 2^22 values and 258 bins are 16.78 MB, 0.00501 ms at 3.35 TB/s. No
// arithmetic comes near it, so the kernel has to keep the memory busy
// while it counts, and keep what follows the last load short.
//
// - Bytes in flight. A persistent grid, one CTA an SM, walks the aligned
//   body's 32 KiB chunks (chunk g to CTA g mod grid). Thread 0 keeps a
//   ring of four chunk stages in shared memory filled by TMA bulk copies
//   (cp.async.bulk completing on an mbarrier): 128 KiB an SM in flight,
//   against the ~18 KiB that 3.35 TB/s x ~0.7 us over 132 SMs asks for,
//   and no load instruction for the other threads to run. A stage is
//   refilled once every warp has read it (an "empty" mbarrier of 32
//   arrivals). The vectors past the last whole chunk go on ld.global.nc
//   v4 loads, and a misaligned head (a view such as x[1:]) and a ragged
//   tail, at most 3 values each, on scalar loads by warp 0 of CTA 0.
//   The split is ops/kernels.py::histogram_plan. In one call on the H100
//   the ring beat a persistent grid of 1024-thread CTAs, 2 an SM, whose
//   lanes each keep four ld.global.nc.v4 loads in flight.
// - Contention. Each warp counts into its own 512-bin table in shared
//   memory (32 x 2 KiB a CTA), so no two warps meet on a shared atomic.
//   Aggregating inside the warp first (__match_any_sync, the lowest lane
//   of a group adding its size) was slower on every input on the H100,
//   3.4 times on uniform bytes: its cost grows with the distinct values a
//   warp holds, and 32 lanes on one address cost less than that.
// - One launch, no memset. The CTA sums its warps' tables and adds each
//   non-zero bin to an accumulator of 512 int32 plus a ticket that the
//   wrapper keeps zeroed per (device, stream). After the CTA's barrier,
//   thread 0 fences (cumulative over the CTA's writes, as a grid sync
//   does) and draws a ticket; the CTA that draws the last one copies the
//   accumulator into `out` (all n_bins bins), zeroing it on the way, and
//   resets the ticket, so the next call on the stream finds it at rest.
//   One CTA an SM also keeps the global atomics few: 132 a bin.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBins = 512;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkVecs = 2048;  // int4 vectors a chunk: 32 KiB
constexpr int kStages = 4;
constexpr int kRingBytes = kStages * kChunkVecs * 16;     // 128 KiB
constexpr int kSmem = kRingBytes + kWarps * kMaxBins * 4;  // + 64 KiB
static_assert(kChunkVecs % kThreads == 0, "a thread reads whole vectors");

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// `bytes` from global to shared memory; `bar` completes when they land.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes from global memory through the read-only path.
__device__ __forceinline__ int4 load_vec(const int4* p) {
  int4 v;
  asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Counts one value a lane into the warp's table; dropped values (-1 stands
// for "none") count nowhere.
__device__ __forceinline__ void count(int32_t v, int n_bins, int32_t* table) {
  if (static_cast<uint32_t>(v) < static_cast<uint32_t>(n_bins)) {
    atomicAdd(&table[v], 1);
  }
}

__device__ __forceinline__ void count4(int4 v, int n_bins, int32_t* table) {
  count(v.x, n_bins, table);
  count(v.y, n_bins, table);
  count(v.z, n_bins, table);
  count(v.w, n_bins, table);
}

// values[0, head) scalar, then `vecs` int4 vectors from values + head (16-
// byte aligned): the first `chunks` x kChunkVecs through the ring, the
// rest on plain loads; then values[head + 4 * vecs, n) scalar (at most 3).
// accum: kMaxBins int32 and a ticket, zero at rest.
__global__ void __launch_bounds__(kThreads, 1)
byte_histogram_kernel(const int32_t* __restrict__ values, int64_t n,
                      int n_bins, int head, int64_t vecs, int64_t chunks,
                      int32_t* __restrict__ out, int32_t* accum) {
  extern __shared__ __align__(128) unsigned char smem[];
  int4* ring = reinterpret_cast<int4*>(smem);
  int32_t* tables = reinterpret_cast<int32_t*>(smem + kRingBytes);
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ bool last;
  const int4* body = reinterpret_cast<const int4*>(values + head);
  const int64_t mine = blockIdx.x < chunks
      ? (chunks - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(shared_addr(&full[s]), 1);
      bar_init(shared_addr(&empty[s]), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int64_t i = 0; i < mine && i < kStages; ++i) {
      bulk_load(shared_addr(ring + i * kChunkVecs),
                body + (blockIdx.x + i * gridDim.x) * kChunkVecs,
                kChunkVecs * 16, shared_addr(&full[i]));
    }
  }
  // The tables are zeroed while the first chunks load.
  for (int i = threadIdx.x; i < kWarps * kMaxBins / 4; i += kThreads) {
    reinterpret_cast<int4*>(tables)[i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int32_t* table = tables + warp * kMaxBins;
  for (int64_t j = 0; j < mine; ++j) {
    const int s = static_cast<int>(j % kStages);
    const uint32_t parity = static_cast<uint32_t>((j / kStages) & 1);
    bar_wait(shared_addr(&full[s]), parity);
    int4 v[kChunkVecs / kThreads];
#pragma unroll
    for (int k = 0; k < kChunkVecs / kThreads; ++k) {
      v[k] = ring[s * kChunkVecs + k * kThreads + threadIdx.x];
    }
    __syncwarp();
    if (lane == 0) bar_arrive(shared_addr(&empty[s]));
#pragma unroll
    for (int k = 0; k < kChunkVecs / kThreads; ++k) {
      count4(v[k], n_bins, table);
    }
    if (threadIdx.x == 0 && j + kStages < mine) {
      bar_wait(shared_addr(&empty[s]), parity);
      bulk_load(shared_addr(ring + s * kChunkVecs),
                body + (blockIdx.x + (j + kStages) * gridDim.x) * kChunkVecs,
                kChunkVecs * 16, shared_addr(&full[s]));
    }
  }
  for (int64_t i = chunks * kChunkVecs
                   + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < vecs; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    count4(load_vec(body + i), n_bins, table);
  }
  if (blockIdx.x == 0 && warp == 0) {
    // Lanes 0-3 take the head, lanes 4-7 the tail.
    const int64_t tail = head + 4 * vecs + (lane - 4);
    int32_t v = -1;
    if (lane < head) {
      v = values[lane];
    } else if (lane >= 4 && lane < 8 && tail < n) {
      v = values[tail];
    }
    count(v, n_bins, table);
  }
  __syncthreads();

  for (int b = threadIdx.x; b < n_bins; b += kThreads) {
    int32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) sum += tables[k * kMaxBins + b];
    if (sum != 0) atomicAdd(&accum[b], sum);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&accum[kMaxBins], 1) == static_cast<int>(gridDim.x) - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (last) {
    for (int b = threadIdx.x; b < n_bins; b += kThreads) {
      out[b] = atomicExch(&accum[b], 0);
    }
    if (threadIdx.x == 0) atomicExch(&accum[kMaxBins], 0);
  }
}

cudaError_t allow_smem() {
  return cudaFuncSetAttribute(byte_histogram_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmem);
}

}  // namespace

// Launches `grid` CTAs on `stream` (PyTorch's current stream); the split
// (head, vecs, chunks, grid) is ops/kernels.py::histogram_plan. `out`
// holds n_bins int32 and needs no zeroing; `accum` holds kMaxBins + 1
// int32, zero at rest, used by one stream at a time. Returns
// cudaGetLastError() right after the launch.
extern "C" int byte_histogram_launch(const void* values, int64_t n,
                                     int n_bins, int head, int64_t vecs,
                                     int64_t chunks, int grid, void* out,
                                     void* accum, void* stream) {
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  byte_histogram_kernel<<<grid, kThreads, kSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(values), n, n_bins, head, vecs, chunks,
      static_cast<int32_t*>(out), static_cast<int32_t*>(accum));
  return static_cast<int>(cudaGetLastError());
}

// Threads a CTA and CTAs an SM (the occupancy calculator) of the kernel.
extern "C" int byte_histogram_occupancy(int* threads, int* ctas_per_sm) {
  *threads = kThreads;
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, byte_histogram_kernel, kThreads, kSmem));
}
