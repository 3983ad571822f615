// Row copies of the beam KV cache, for Hopper: a gather (K6) and an in-place
// copy-on-write fork copy (K7), one launch each over every leaf of the cache.
//
// Replaces the TPU kernels whisper_tpu/kernels/beam_gather.py:
//   * permute_rows_multi (_dma_kernel / _permute_rows_blocked):
//       out_leaf[j] = leaf[rows[j]] along axis 0, every leaf in one launch;
//   * cow_copy_rows (_cow_kernel): in place, leaf[i] <- leaf[src[i]] where
//       src[i] != i. The caller guarantees that no source row is also a
//       destination row (decoding/device_beam.cow_assign makes src so), so the
//       copies cannot conflict, in any order.
//
// Every leaf is batch-leading and contiguous, so one row of a leaf is one
// contiguous span of row_bytes (3.07 MB for a large-v3 int8 cache row of
// 32 layers x 20 heads x 64 x 75, 192 KB for its f32 scales, 36.7 MB for a
// bf16 row of 448 positions). Leaves may differ in dtype and trailing shape:
// the kernels see bytes.
//
// What bounds them: nothing but the bytes. A gather of the whole 160-row int8
// cache (4 leaves) reads each distinct source row once and writes every
// output row once, ~1.7 GB, 0.51 ms at 3.35 TB/s; a fork copy moves 2 x 6.5
// MB per forked row. The TPU kernels issued one DMA per (leaf, row) through a
// window of semaphores. Here one block copies one piece: CHUNK bytes (the
// last piece of a row fewer) of one row of one leaf. The grid enumerates only
// real pieces, in the order of the launch plan that
// kernels/beam_gather.copy_plan computes on the host: leaf by leaf, chunk by
// chunk, with the output rows innermost, so every copy of one source chunk
// runs close together in time and a repeated source is read from L2. The
// host passes each leaf's first block and chunks per row; a block finds its
// leaf among at most 8 and never returns empty. Each thread issues UNROLL
// 16-byte loads before its stores, so a block keeps its whole 128 KB piece in
// flight (bytes where a row start is not 16-byte aligned, with a byte tail
// where a row's size is not a multiple of 16). cp.async.bulk through shared
// memory was the alternative; plain loads with this much in flight already
// cover the memory latency, and need no barriers.
//
// K7 follows the same plan over its n_rows rows. A block reads its own src[i]
// first and returns when src[i] == i, so identity rows cost one index load
// and no copy (a grid over the forked rows only is later work); K7 never
// synchronises, and runs on the caller's stream before the decoder appends
// into the same cache.
//
// Plain C interface, loaded with ctypes by whisper_tpu_torch/kernels/build.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int UNROLL = 16;                             // 16-byte loads in flight per thread
constexpr long long CHUNK = THREADS * 16LL * UNROLL;   // 128 KB: bytes per block
constexpr int MAX_LEAVES = 8;

struct Leaves {
  const char* src[MAX_LEAVES];
  char* dst[MAX_LEAVES];
  long long row_bytes[MAX_LEAVES];
  long long first[MAX_LEAVES + 1];  // the first block of each leaf; first[n_leaves] = grid size
  int n_leaves;
};

// Copy bytes [c0, c1) of one row from s to d, c1 - c0 <= CHUNK.
__device__ __forceinline__ void copy_piece(const char* __restrict__ s, char* __restrict__ d,
                                           long long c0, long long c1) {
  const bool vec = ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d)) & 15) == 0;
  if (vec) {
    const int n16 = static_cast<int>((c1 - c0) / 16);
    const uint4* s16 = reinterpret_cast<const uint4*>(s + c0);
    uint4* d16 = reinterpret_cast<uint4*>(d + c0);
    uint4 r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = threadIdx.x + u * THREADS;
      if (i < n16) r[u] = s16[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = threadIdx.x + u * THREADS;
      if (i < n16) d16[i] = r[u];
    }
    for (long long i = c0 + n16 * 16LL + threadIdx.x; i < c1; i += THREADS) d[i] = s[i];
  } else {
    for (long long i = c0 + threadIdx.x; i < c1; i += THREADS) d[i] = s[i];
  }
}

// Block b -> (leaf z, chunk c, row j) by the launch plan.
__device__ __forceinline__ void piece(const Leaves& leaves, int n_rows, int& z, long long& c,
                                      long long& j) {
  const long long b = blockIdx.x;
  z = 0;
  while (z + 1 < leaves.n_leaves && b >= leaves.first[z + 1]) ++z;
  const long long local = b - leaves.first[z];
  c = local / n_rows;
  j = local % n_rows;
}

// K6: out row j of leaf z <- row rows[j] of leaf z.
__global__ void __launch_bounds__(THREADS)
permute_rows_kernel(Leaves leaves, const long long* __restrict__ rows, int n_rows) {
  int z;
  long long c, j;
  piece(leaves, n_rows, z, c, j);
  const long long rb = leaves.row_bytes[z];
  const long long c0 = c * CHUNK, c1 = c0 + CHUNK < rb ? c0 + CHUNK : rb;
  copy_piece(leaves.src[z] + rows[j] * rb, leaves.dst[z] + j * rb, c0, c1);
}

// K7: in place, row i of leaf z <- row src[i] of leaf z where src[i] != i.
__global__ void __launch_bounds__(THREADS)
cow_copy_kernel(Leaves leaves, const long long* __restrict__ src, int n_rows) {
  int z;
  long long c, i;
  piece(leaves, n_rows, z, c, i);
  const long long from = src[i];
  if (from == i) return;
  const long long rb = leaves.row_bytes[z];
  const long long c0 = c * CHUNK, c1 = c0 + CHUNK < rb ? c0 + CHUNK : rb;
  char* base = leaves.dst[z];
  copy_piece(base + from * rb, base + i * rb, c0, c1);
}

cudaError_t fill(Leaves* leaves, const void* const* src, void* const* dst,
                 const long long* row_bytes, const long long* first, int n_leaves) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES) return cudaErrorInvalidValue;
  leaves->n_leaves = n_leaves;
  for (int z = 0; z < n_leaves; ++z) {
    leaves->src[z] = static_cast<const char*>(src[z]);
    leaves->dst[z] = static_cast<char*>(dst[z]);
    leaves->row_bytes[z] = row_bytes[z];
  }
  for (int z = 0; z <= n_leaves; ++z) leaves->first[z] = first[z];
  return first[n_leaves] > 0x7fffffffLL ? cudaErrorInvalidValue : cudaSuccess;
}

}  // namespace

// The piece size the launch plan must use (kernels/beam_gather.CHUNK_BYTES).
extern "C" long long whisper_row_copy_chunk_bytes() { return CHUNK; }

// K6. src[z] and dst[z] are contiguous leaves whose row r starts at
// r * row_bytes[z]; rows (device, int64, n_rows) indexes src rows, in range
// (unchecked). first[0..n_leaves] is the launch plan (leaf z's first block;
// first[n_leaves] blocks in all). dst rows 0..n_rows-1 are written. Launches
// on `stream`, returns the cudaError_t of the launch; does not synchronise.
extern "C" int whisper_permute_rows(const void* const* src, void* const* dst,
                                    const long long* row_bytes, const long long* first,
                                    int n_leaves, const void* rows, int n_rows, void* stream) {
  Leaves leaves;
  cudaError_t err = fill(&leaves, src, dst, row_bytes, first, n_leaves);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows == 0 || first[n_leaves] == 0) return 0;
  permute_rows_kernel<<<static_cast<unsigned>(first[n_leaves]), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      leaves, static_cast<const long long*>(rows), n_rows);
  return static_cast<int>(cudaGetLastError());
}

// K7. leaf[z] is contiguous with n_rows rows of row_bytes[z]; src (device,
// int64, n_rows) in range, with no source row also a destination row
// (unchecked); first as for K6. In place; launches on `stream`, returns the
// cudaError_t of the launch; does not synchronise.
extern "C" int whisper_cow_copy_rows(void* const* leaf, const long long* row_bytes,
                                     const long long* first, int n_leaves, const void* src,
                                     int n_rows, void* stream) {
  Leaves leaves;
  cudaError_t err = fill(&leaves, leaf, leaf, row_bytes, first, n_leaves);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows == 0 || first[n_leaves] == 0) return 0;
  cow_copy_kernel<<<static_cast<unsigned>(first[n_leaves]), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      leaves, static_cast<const long long*>(src), n_rows);
  return static_cast<int>(cudaGetLastError());
}
