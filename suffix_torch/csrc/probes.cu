// The bandwidth battery's kernels for Hopper (sm_90a): a copy, a
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
// All three are bound by device memory: 2 x 4 B an element over 3.35
// TB/s. minmax_stages also needs one int32 min or max an element a stage
// (a row's parity fixes which), 0.4 of its bytes term at the battery's
// shape.
//
// Copies (copy_ring_kernel, both wrappers). A CTA that copies one tile
// and exits waits out two memory latencies with nothing else in flight,
// and a grid of such CTAs runs in waves with a half-empty last one. Here
// a persistent grid, one CTA an SM, walks the pairs' 32 KiB chunks pair
// by pair. One thread keeps a ring of four shared-memory stages fed by
// TMA bulk copies: chunk i + 2 is loading while chunk i is stored, and a
// stage is refilled once its store has read it out. The values past a
// pair's last whole chunk go on plain loads by the other warps.
//
// minmax_stages. The roll wraps inside each block_rows-row block and stage
// s reads rows that stage s-1 wrote, so a CTA owns whole blocks.
// - Register path (block_rows 2048, 16 stages, width a multiple of 16): a
//   CTA holds one block of a 16-column slab, a warp a column, a lane 64
//   consecutive rows of it in registers. At stage s, w[i] = v[i - 1 - s]
//   is a register rename for i > s; the first 1 + s rows come from the
//   previous lane by __shfl_sync (lane 0 from lane 31: the wrap). Row
//   parity is static, so a cell costs one min or max a stage. Shared
//   memory only transposes the tile in and out, padded so that neither
//   side has bank conflicts. A slab row is 64 B (8-column slabs, 32 B,
//   read slower), the loads ask L2 for 256 B, and the grid's fastest
//   index is the slab, so the CTAs that share a row's lines run together.
// - Shared path (every other shape): a CTA keeps a whole block of an
//   8-column slab in two shared buffers (128 KiB at 2048 rows, one CTA an
//   SM) and runs each stage there on int4 quads.
//
// Each entry point launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError() right after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 4;            // int4 loads in flight per thread
constexpr int kStreams = 5;
constexpr int kSlab = 8;           // columns per shared-path CTA: 32 B
constexpr int kMinmaxThreads = 1024;

struct CopyPairs {
  const int32_t* src[kStreams];
  int32_t* dst[kStreams];
};

// ---- copies: the bulk-copy ring ------------------------------------------

constexpr int kChunkBytes = 32 * 1024;
constexpr int kChunkInts = kChunkBytes / 4;
constexpr int kRingStages = 4;
constexpr int kRingLead = 2;       // chunks loading ahead of the store
constexpr int kRingSmem = kChunkBytes * kRingStages;  // 128 KiB: one CTA/SM
constexpr int kRingThreads = 128;  // warp 0 drives the ring, 1-3 the rest
static_assert(kChunkBytes % 16 == 0 && kRingLead >= 1 &&
                  kRingLead < kRingStages,
              "bulk copies move multiples of 16 B; a stage is refilled "
              "only after its store");

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(1)
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

// `bytes` from shared to global memory, as one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// dst_k[0, n) = src_k[0, n) for k < n_pairs. Chunk g of the n_pairs x
// chunks whole chunks (pair g / chunks) goes to CTA g mod gridDim.x.
// Thread 0 runs the ring: it loads chunk i into stage i mod kRingStages,
// kRingLead chunks ahead of the store of chunk i - kRingLead, and refills
// a stage only once the store that used it has read it out. Warps 1-3
// copy each pair's values past its last whole chunk.
__global__ void __launch_bounds__(kRingThreads)
copy_ring_kernel(CopyPairs pairs, int n_pairs, int64_t n, int64_t chunks) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t landed[kRingStages];
  const int64_t total = n_pairs * chunks;
  if (threadIdx.x == 0 && blockIdx.x < total) {
#pragma unroll
    for (int s = 0; s < kRingStages; ++s) bar_init(shared_addr(&landed[s]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const int64_t mine = (total - blockIdx.x + gridDim.x - 1) / gridDim.x;
    for (int64_t i = 0; i < mine + kRingLead; ++i) {
      if (i < mine) {
        const int s = static_cast<int>(i % kRingStages);
        // Stores committed since stage s's last one: kRingStages - 1 -
        // kRingLead; all older ones have read their stage out.
        asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(
                         kRingStages - 1 - kRingLead)
                     : "memory");
        const int64_t g = blockIdx.x + i * gridDim.x;
        const int k = static_cast<int>(g / chunks);
        bulk_load(shared_addr(ring + s * kChunkBytes),
                  pairs.src[k] + (g - k * chunks) * kChunkInts, kChunkBytes,
                  shared_addr(&landed[s]));
      }
      if (i >= kRingLead) {
        const int64_t j = i - kRingLead;
        const int s = static_cast<int>(j % kRingStages);
        bar_wait(shared_addr(&landed[s]),
                 static_cast<uint32_t>((j / kRingStages) & 1));
        const int64_t g = blockIdx.x + j * gridDim.x;
        const int k = static_cast<int>(g / chunks);
        bulk_store(pairs.dst[k] + (g - k * chunks) * kChunkInts,
                   shared_addr(ring + s * kChunkBytes), kChunkBytes);
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
  const int64_t head = chunks * kChunkInts;
  const int64_t rest = n - head;
  if (rest > 0 && threadIdx.x >= 32) {
    const int lanes = blockDim.x - 32;
    const int64_t step = static_cast<int64_t>(gridDim.x) * lanes;
    for (int64_t j = static_cast<int64_t>(blockIdx.x) * lanes + threadIdx.x
                     - 32;
         j < n_pairs * rest; j += step) {
      const int k = static_cast<int>(j / rest);
      const int64_t i = head + j - k * rest;
      pairs.dst[k][i] = pairs.src[k][i];
    }
  }
}

// ---- minmax_stages: shared path ------------------------------------------

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

// ---- minmax_stages: register path ----------------------------------------

constexpr int kStrip = 64;                  // rows a lane: 2048 / 32
constexpr int kRegStages = 16;
constexpr int kRegBlockRows = 32 * kStrip;  // 2048
constexpr int kRegCols = 16;                // a CTA's slab: 64 B a row
constexpr int kRegThreads = 32 * kRegCols;  // a warp a column
// Shared tile, column-major: column c, lane l's strip at word
// c * kColPitch + (c / 8) * 8 + l * kStripPitch. The strip pitch (68 = 4
// mod 32) puts a quarter-warp's int4 strip reads on 32 distinct banks.
// On the coalesced side a warp moves 8 rows x 4 quads with scalar
// accesses: the column pitch (2180 = 4 mod 8) and the 8-word step of the
// second 8 columns put the four quads 0, 16, 8 and 24 banks apart.
constexpr int kStripPitch = kStrip + 4;
constexpr int kColPitch = 32 * kStripPitch + 4;
constexpr int kRegSmem = (kRegCols * kColPitch + kRegCols / 8 * 8) * 4;
static_assert(kStripPitch % 32 == 4 && kColPitch % 8 == 4 &&
                  kColPitch % 4 == 0,
              "padding keeps both sides free of bank conflicts");
static_assert(kStrip % 2 == 0, "a lane's row parity is its register's");

__device__ __forceinline__ int tile_word(int row, int col) {
  return col * kColPitch + (col >> 3) * 8 + (row / kStrip) * kStripPitch
         + row % kStrip;
}

// 16 bytes from global memory, read-only, asking L2 for the whole 256 B
// around them: the neighbouring CTAs read the rest of those lines.
__device__ __forceinline__ int4 load_quad(const int32_t* p) {
  int4 v;
  asm("ld.global.nc.L2::256B.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// One 16-byte global store. Written out, because the compiler split the
// int4 store of this loop into four 4-byte ones (twice the kernel's time).
__device__ __forceinline__ void store_quad(int32_t* p, int4 v) {
  asm volatile("st.global.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// kStages stages on a lane's strip v (rows lane * K .. lane * K + K - 1 of
// a block column held by the warp). Stage s, d = 1 + s: w[i] = v[i - d]
// for i >= d; the first d rows take the previous lane's last d (lane 0
// lane 31's: the roll's wrap). Every index is static once unrolled.
template <int K, int kStages>
__device__ __forceinline__ void roll_stages(int32_t (&v)[K]) {
  static_assert(kStages <= K, "a shift reaches only the previous lane");
  const int prev = (threadIdx.x + 31) & 31;
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    const int d = 1 + s;
    int32_t head[kStages];
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      if (i < d) head[i] = __shfl_sync(0xffffffffu, v[K - d + i], prev);
    }
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      if (i >= d) v[i] = (i & 1) ? max(v[i], v[i - d]) : min(v[i], v[i - d]);
    }
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      if (i < d) v[i] = (i & 1) ? max(v[i], head[i]) : min(v[i], head[i]);
    }
  }
}

// Block blockIdx.y, slab blockIdx.x (the slab is the fastest index).
__global__ void __launch_bounds__(kRegThreads, 1)
minmax_registers_kernel(const int32_t* __restrict__ src,
                        int32_t* __restrict__ dst, int width) {
  extern __shared__ __align__(16) int32_t tile[];
  constexpr int kQPR = kRegCols / 4;                    // quads a row
  constexpr int kRowsPerPass = kRegThreads / kQPR;      // 128
  constexpr int kPasses = kRegBlockRows / kRowsPerPass;  // 16 int4 a thread
  constexpr int kPassWords = kRowsPerPass / kStrip * kStripPitch;
  static_assert(kRowsPerPass % kStrip == 0, "a pass is whole strips");
  // Thread t moves quad t % kQPR of rows t / kQPR + kRowsPerPass * u:
  // the same column and the same row of a strip in every pass u, so its
  // shared words are one base plus compile-time offsets.
  const int c = 4 * (threadIdx.x % kQPR);
  const int r = threadIdx.x / kQPR;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * kRegBlockRows + r;
  const int64_t at = row * width + blockIdx.x * kRegCols + c;
  const int64_t pass_stride = static_cast<int64_t>(kRowsPerPass) * width;
  int32_t* word = tile + tile_word(r, c);

  int4 in[kPasses];
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
    in[u] = load_quad(src + at + u * pass_stride);
  }
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
    word[u * kPassWords] = in[u].x;
    word[u * kPassWords + kColPitch] = in[u].y;
    word[u * kPassWords + 2 * kColPitch] = in[u].z;
    word[u * kPassWords + 3 * kColPitch] = in[u].w;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  int4* strip = reinterpret_cast<int4*>(
      tile + tile_word(lane * kStrip, threadIdx.x >> 5));
  int32_t v[kStrip];
#pragma unroll
  for (int m = 0; m < kStrip / 4; ++m) {
    const int4 t = strip[m];
    v[4 * m] = t.x;
    v[4 * m + 1] = t.y;
    v[4 * m + 2] = t.z;
    v[4 * m + 3] = t.w;
  }
  roll_stages<kStrip, kRegStages>(v);
  // Each lane writes back exactly the words it read: no barrier needed
  // before, one after.
#pragma unroll
  for (int m = 0; m < kStrip / 4; ++m) {
    strip[m] = make_int4(v[4 * m], v[4 * m + 1], v[4 * m + 2], v[4 * m + 3]);
  }
  __syncthreads();

#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
    store_quad(dst + at + u * pass_stride,
               make_int4(word[u * kPassWords], word[u * kPassWords + kColPitch],
                         word[u * kPassWords + 2 * kColPitch],
                         word[u * kPassWords + 3 * kColPitch]));
  }
}

// Dynamic shared memory above 48 KB has to be allowed first.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int launch_ring(const void* const* srcs, void* const* dsts, int n_pairs,
                int64_t n, int64_t chunks, int grid, void* stream) {
  CopyPairs pairs = {};
  for (int k = 0; k < n_pairs; ++k) {
    pairs.src[k] = static_cast<const int32_t*>(srcs[k]);
    pairs.dst[k] = static_cast<int32_t*>(dsts[k]);
  }
  const cudaError_t err = set_smem(copy_ring_kernel, kRingSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  copy_ring_kernel<<<grid, kRingThreads, kRingSmem,
                     static_cast<cudaStream_t>(stream)>>>(pairs, n_pairs, n,
                                                          chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dst[0, n) = src[0, n), int32, both 16-byte aligned, in one launch of
// `grid` CTAs: `chunks` whole 32 KiB chunks go through the bulk-copy
// ring, the rest on plain loads (ops/probes.py::copy_plan).
extern "C" int copy_blocks_launch(const void* src, void* dst, int64_t n,
                                  int64_t chunks, int grid, void* stream) {
  return launch_ring(&src, &dst, 1, n, chunks, grid, stream);
}

// dst_k[0, n) = src_k[0, n) for k = 0..4, likewise in one launch.
extern "C" int copy5_blocks_launch(const void* src0, const void* src1,
                                   const void* src2, const void* src3,
                                   const void* src4, void* dst0, void* dst1,
                                   void* dst2, void* dst3, void* dst4,
                                   int64_t n, int64_t chunks, int grid,
                                   void* stream) {
  const void* srcs[kStreams] = {src0, src1, src2, src3, src4};
  void* dsts[kStreams] = {dst0, dst1, dst2, dst3, dst4};
  return launch_ring(srcs, dsts, kStreams, n, chunks, grid, stream);
}

// The shared path. src and dst are (rows, width) int32, rows a multiple
// of block_rows, block_rows <= 2048 (2 x block_rows x kSlab x 4 B of
// shared memory).
extern "C" int minmax_stages_launch(const void* src, void* dst, int64_t rows,
                                    int width, int block_rows, int stages,
                                    void* stream) {
  const int smem = 2 * block_rows * kSlab * static_cast<int>(sizeof(int32_t));
  const cudaError_t err = set_smem(minmax_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows / block_rows),
                  static_cast<unsigned>((width + kSlab - 1) / kSlab));
  minmax_kernel<<<grid, kMinmaxThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<int32_t*>(dst), width,
      block_rows, stages);
  return static_cast<int>(cudaGetLastError());
}

// The register path: block_rows 2048, 16 stages; rows a multiple of 2048,
// width a multiple of 16.
extern "C" int minmax_registers_launch(const void* src, void* dst,
                                       int64_t rows, int width,
                                       void* stream) {
  const cudaError_t err = set_smem(minmax_registers_kernel, kRegSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(width / kRegCols),
                  static_cast<unsigned>(rows / kRegBlockRows));
  minmax_registers_kernel<<<grid, kRegThreads, kRegSmem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<int32_t*>(dst), width);
  return static_cast<int>(cudaGetLastError());
}

// CTAs an SM, from the occupancy calculator, of `kernel`: 0 the copy
// ring, 1 the minmax register path, 2 the minmax shared path at
// `block_rows`.
extern "C" int probes_ctas_per_sm(int kernel, int block_rows, int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  if (kernel == 0) {
    err = set_smem(copy_ring_kernel, kRingSmem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, copy_ring_kernel, kRingThreads, kRingSmem);
    }
  } else if (kernel == 1) {
    err = set_smem(minmax_registers_kernel, kRegSmem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, minmax_registers_kernel, kRegThreads, kRegSmem);
    }
  } else if (kernel == 2) {
    const int smem = 2 * block_rows * kSlab * 4;
    err = set_smem(minmax_kernel, smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, minmax_kernel, kMinmaxThreads, smem);
    }
  }
  return static_cast<int>(err);
}
