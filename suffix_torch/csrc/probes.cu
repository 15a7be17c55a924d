// The bandwidth battery's kernels for Hopper (sm_90a): a blocked copy, a
// five-stream copy and a 16-stage min/max probe, all on int32.
//
// Replace the Pallas kernels of scripts/round3_study.py section_bw:
//
// - copy_blocks   <- pallas_copy  (copy_kernel, pl.pallas_call at :114):
//   a (2^15, 128) int32 copy in (2048, 128) VMEM blocks.
// - copy5_blocks  <- pallas_copy5 (copy_kernel5, pl.pallas_call at :140):
//   five independent copies in one kernel, (512, 128) blocks.
// - minmax_stages <- pallas_vpu   (vpu_kernel, pl.pallas_call at :169):
//   16 stages of w = roll(v, 1+s) inside each (2048, 128) block, then even
//   rows take min(v, w) and odd rows max(v, w).
//
// The TPU's block shapes are a VMEM budget. Here the copies move 16-byte
// (int4) words, one block per contiguous 16 KiB tile, four loads in flight
// per thread; copy5_blocks is one launch over five source/destination
// pairs (blockIdx.y picks the pair).
// Bound (copies): bytes moved / 3.35 TB/s, 2 x 4 B per element.
//
// minmax_stages: the roll wraps inside each block_rows-row block, and
// stage s reads rows written by stage s-1, so a CTA owns one whole block
// for a slab of kSlab columns, keeps it in shared memory (two buffers of
// block_rows x kSlab int32: 128 KiB at 2048 rows, so one CTA an SM), runs
// every stage there with one __syncthreads() between stages, and writes
// the block back. Device memory is read once and written once, as int4
// with four loads in flight per thread. The stage loop works on int4 quads
// of one row: at one cell a thread its index arithmetic, not the shared
// memory traffic, was what bounded it. Bound: the larger of 2 x 4 B per
// element / 3.35 TB/s and 3 int32 operations (min, max, select) per
// element per stage over the card's int32 rate.
//
// Each entry point launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;            // int4 loads in flight per thread
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr int kStreams = 5;
constexpr int kSlab = 8;           // columns per minmax CTA: one 32 B sector
constexpr int kMinmaxThreads = 1024;

struct CopyPairs {
  const int32_t* src[kStreams];
  int32_t* dst[kStreams];
};

// dst[0, n) = src[0, n) for blocks block, block + n_blocks, ... of
// kVec * blockDim.x int4 (16 KiB at 256 threads): each thread keeps kVec
// int4 loads in flight, a warp's accesses are 512 contiguous bytes, a
// block's a contiguous tile. Both pointers are 16-byte aligned (the
// wrapper checks); block 0 copies the scalar tail.
__device__ __forceinline__ void copy_range(const int32_t* __restrict__ src,
                                           int32_t* __restrict__ dst,
                                           int64_t n, int64_t block,
                                           int64_t n_blocks) {
  const int64_t n4 = n / 4;
  const int4* __restrict__ s4 = reinterpret_cast<const int4*>(src);
  int4* __restrict__ d4 = reinterpret_cast<int4*>(dst);
  const int64_t tile = static_cast<int64_t>(kVec) * blockDim.x;
  for (int64_t base = block * tile + threadIdx.x; base < n4;
       base += n_blocks * tile) {
    int4 v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t i = base + static_cast<int64_t>(k) * blockDim.x;
      if (i < n4) v[k] = s4[i];
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t i = base + static_cast<int64_t>(k) * blockDim.x;
      if (i < n4) d4[i] = v[k];
    }
  }
  if (block == 0) {
    for (int64_t j = 4 * n4 + threadIdx.x; j < n; j += blockDim.x) {
      dst[j] = src[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
copy_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ dst,
            int64_t n) {
  copy_range(src, dst, n, blockIdx.x, gridDim.x);
}

__global__ void __launch_bounds__(kThreads)
copy5_kernel(CopyPairs pairs, int64_t n) {
  const int k = blockIdx.y;
  copy_range(pairs.src[k], pairs.dst[k], n, blockIdx.x, gridDim.x);
}

constexpr int kQuadsPerRow = kSlab / 4;
static_assert(kSlab % 4 == 0, "a slab row is whole int4 quads");

// A whole block_rows x kSlab tile between device and shared memory, as
// int4: quad q is (row q / kQuadsPerRow, columns 4 * (q % kQuadsPerRow)..).
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ src,
                                          int32_t* tile, int64_t row0,
                                          int col0, int width, int cells) {
  const int quads = cells / 4;
  int4* t4 = reinterpret_cast<int4*>(tile);
  for (int base = threadIdx.x; base < quads; base += kVec * blockDim.x) {
    int4 v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int q = base + k * blockDim.x;
      if (q < quads) {
        v[k] = *reinterpret_cast<const int4*>(
            src + (row0 + q / kQuadsPerRow) * width + col0
            + 4 * (q % kQuadsPerRow));
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int q = base + k * blockDim.x;
      if (q < quads) t4[q] = v[k];
    }
  }
}

__device__ __forceinline__ void store_tile(const int32_t* tile,
                                           int32_t* __restrict__ dst,
                                           int64_t row0, int col0, int width,
                                           int cells) {
  const int quads = cells / 4;
  const int4* t4 = reinterpret_cast<const int4*>(tile);
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    *reinterpret_cast<int4*>(dst + (row0 + q / kQuadsPerRow) * width + col0
                             + 4 * (q % kQuadsPerRow)) = t4[q];
  }
}

__global__ void __launch_bounds__(kMinmaxThreads)
minmax_kernel(const int32_t* __restrict__ src, int32_t* __restrict__ dst,
              int width, int block_rows, int stages) {
  extern __shared__ int32_t smem[];
  int32_t* cur = smem;
  int32_t* nxt = smem + block_rows * kSlab;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * block_rows;
  const int col0 = blockIdx.y * kSlab;
  const int cells = block_rows * kSlab;

  // Cell e is (row e / kSlab, column e % kSlab): 8 neighbouring threads
  // read one 32-byte row segment, and a warp's shared accesses hit 32
  // consecutive words (no bank conflicts), shifted rows included. When
  // the width is a multiple of the slab, the block moves as int4 (two
  // per row segment), kVec of them in flight per thread.
  const bool whole = width % kSlab == 0;
  if (whole) {
    load_tile(src, cur, row0, col0, width, cells);
  } else {
    for (int e = threadIdx.x; e < cells; e += blockDim.x) {
      const int col = col0 + e % kSlab;
      cur[e] = col < width ? src[(row0 + e / kSlab) * width + col] : 0;
    }
  }
  __syncthreads();
  // Each stage works on int4 quads (4 columns of one row), so the index
  // arithmetic, which bounds this loop, is paid once per 4 cells; a
  // warp reads 32 consecutive quads (the shifted ones too).
  const int quads = cells / 4;
  for (int s = 0; s < stages; ++s) {
    const int shift = (1 + s) % block_rows;
    const int4* c4 = reinterpret_cast<const int4*>(cur);
    int4* n4 = reinterpret_cast<int4*>(nxt);
    for (int q = threadIdx.x; q < quads; q += blockDim.x) {
      const int r = q / kQuadsPerRow;
      int from = r - shift;  // w[r] = v[(r - shift) mod block_rows]
      if (from < 0) from += block_rows;
      const int4 v = c4[q];
      const int4 w = c4[from * kQuadsPerRow + q % kQuadsPerRow];
      const bool odd = r & 1;
      n4[q] = make_int4(odd ? max(v.x, w.x) : min(v.x, w.x),
                        odd ? max(v.y, w.y) : min(v.y, w.y),
                        odd ? max(v.z, w.z) : min(v.z, w.z),
                        odd ? max(v.w, w.w) : min(v.w, w.w));
    }
    __syncthreads();
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (whole) {
    store_tile(cur, dst, row0, col0, width, cells);
  } else {
    for (int e = threadIdx.x; e < cells; e += blockDim.x) {
      const int col = col0 + e % kSlab;
      if (col < width) dst[(row0 + e / kSlab) * width + col] = cur[e];
    }
  }
}

// One block per 16 KiB tile (blocks are short, so the card schedules them
// in waves without a long tail), capped for huge arrays, whose blocks then
// loop over tiles.
unsigned copy_grid(int64_t n) {
  const int64_t tiles = (n / 4 + kVec * kThreads - 1) / (kVec * kThreads);
  const int64_t blocks = tiles < kMaxBlocks ? tiles : kMaxBlocks;
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

}  // namespace

// dst[0, n) = src[0, n), int32; both 16-byte aligned.
extern "C" int copy_blocks_launch(const void* src, void* dst, int64_t n,
                                  void* stream) {
  copy_kernel<<<copy_grid(n), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<int32_t*>(dst), n);
  return static_cast<int>(cudaGetLastError());
}

// dst_k[0, n) = src_k[0, n) for k = 0..4, in one launch.
extern "C" int copy5_blocks_launch(const void* src0, const void* src1,
                                   const void* src2, const void* src3,
                                   const void* src4, void* dst0, void* dst1,
                                   void* dst2, void* dst3, void* dst4,
                                   int64_t n, void* stream) {
  CopyPairs pairs;
  const void* srcs[kStreams] = {src0, src1, src2, src3, src4};
  void* dsts[kStreams] = {dst0, dst1, dst2, dst3, dst4};
  for (int k = 0; k < kStreams; ++k) {
    pairs.src[k] = static_cast<const int32_t*>(srcs[k]);
    pairs.dst[k] = static_cast<int32_t*>(dsts[k]);
  }
  copy5_kernel<<<dim3(copy_grid(n), kStreams), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(pairs, n);
  return static_cast<int>(cudaGetLastError());
}

// src and dst are (rows, width) int32, rows a multiple of block_rows,
// block_rows <= 2048 (shared memory: 2 x block_rows x kSlab x 4 B).
extern "C" int minmax_stages_launch(const void* src, void* dst, int64_t rows,
                                    int width, int block_rows, int stages,
                                    void* stream) {
  const int smem = 2 * block_rows * kSlab * static_cast<int>(sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      minmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows / block_rows),
                  static_cast<unsigned>((width + kSlab - 1) / kSlab));
  minmax_kernel<<<grid, kMinmaxThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<int32_t*>(dst), width,
      block_rows, stages);
  return static_cast<int>(cudaGetLastError());
}
