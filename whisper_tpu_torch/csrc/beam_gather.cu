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
// cache (4 leaves) reads and writes 1.6 GB, ~0.48 ms at 3.35 TB/s; a fork copy
// moves 2 x 6.5 MB per forked row. The TPU kernels issued one DMA per (leaf,
// row) through a window of semaphores. Here the grid is (chunk, row, leaf):
// a block copies one CHUNK-byte piece of one row of one leaf with 16-byte
// loads and stores where both row starts are 16-byte aligned (always, for
// PyTorch's allocations and these row sizes), and bytes otherwise, with a
// byte tail where a row's size is not a multiple of 16. Blocks past a small
// leaf's last chunk return at once. K7's block reads its own src[i] first
// and returns when src[i] == i, so identity rows cost one index load and no
// copy; K7 never synchronises, and runs on the caller's stream before the
// decoder appends into the same cache.
//
// Plain C interface, loaded with ctypes by whisper_tpu_torch/kernels/build.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long CHUNK = THREADS * 16 * 4;  // bytes per block: 4 x 16 B per thread
constexpr int MAX_LEAVES = 8;

struct Leaves {
  const char* src[MAX_LEAVES];
  char* dst[MAX_LEAVES];
  long long row_bytes[MAX_LEAVES];
};

// Copy bytes [c0, c1) of one row from s to d.
__device__ __forceinline__ void copy_span(const char* __restrict__ s, char* __restrict__ d,
                                          long long c0, long long c1) {
  const bool vec = ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d)) & 15) == 0;
  if (vec) {
    const long long n16 = (c1 - c0) / 16;
    const uint4* s16 = reinterpret_cast<const uint4*>(s + c0);
    uint4* d16 = reinterpret_cast<uint4*>(d + c0);
    for (long long i = threadIdx.x; i < n16; i += THREADS) d16[i] = s16[i];
    for (long long i = c0 + n16 * 16 + threadIdx.x; i < c1; i += THREADS) d[i] = s[i];
  } else {
    for (long long i = c0 + threadIdx.x; i < c1; i += THREADS) d[i] = s[i];
  }
}

// K6: out row j of leaf z <- row rows[j] of leaf z.
__global__ void __launch_bounds__(THREADS)
permute_rows_kernel(Leaves leaves, const long long* __restrict__ rows) {
  const int z = blockIdx.z;
  const long long rb = leaves.row_bytes[z];
  const long long c0 = blockIdx.x * CHUNK;
  if (c0 >= rb) return;
  const long long c1 = c0 + CHUNK < rb ? c0 + CHUNK : rb;
  const long long j = blockIdx.y;
  copy_span(leaves.src[z] + rows[j] * rb, leaves.dst[z] + j * rb, c0, c1);
}

// K7: in place, row i of leaf z <- row src[i] of leaf z where src[i] != i.
__global__ void __launch_bounds__(THREADS)
cow_copy_kernel(Leaves leaves, const long long* __restrict__ src) {
  const long long i = blockIdx.y;
  const long long from = src[i];
  if (from == i) return;
  const int z = blockIdx.z;
  const long long rb = leaves.row_bytes[z];
  const long long c0 = blockIdx.x * CHUNK;
  if (c0 >= rb) return;
  const long long c1 = c0 + CHUNK < rb ? c0 + CHUNK : rb;
  char* base = leaves.dst[z];
  copy_span(base + from * rb, base + i * rb, c0, c1);
}

cudaError_t fill(Leaves* leaves, const void* const* src, void* const* dst,
                 const long long* row_bytes, int n_leaves, long long* max_row) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES) return cudaErrorInvalidValue;
  *max_row = 0;
  for (int z = 0; z < n_leaves; ++z) {
    leaves->src[z] = static_cast<const char*>(src[z]);
    leaves->dst[z] = static_cast<char*>(dst[z]);
    leaves->row_bytes[z] = row_bytes[z];
    if (row_bytes[z] > *max_row) *max_row = row_bytes[z];
  }
  return cudaSuccess;
}

}  // namespace

// K6. src[z] and dst[z] are contiguous leaves whose row r starts at
// r * row_bytes[z]; rows (device, int64, n_rows) indexes src rows, in range
// (unchecked). dst rows 0..n_rows-1 are written. Launches on `stream`,
// returns the cudaError_t of the launch; does not synchronise.
extern "C" int whisper_permute_rows(const void* const* src, void* const* dst,
                                    const long long* row_bytes, int n_leaves, const void* rows,
                                    int n_rows, void* stream) {
  Leaves leaves;
  long long max_row;
  cudaError_t err = fill(&leaves, src, dst, row_bytes, n_leaves, &max_row);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows == 0 || max_row == 0) return 0;
  const dim3 grid(static_cast<unsigned>((max_row + CHUNK - 1) / CHUNK), n_rows, n_leaves);
  permute_rows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      leaves, static_cast<const long long*>(rows));
  return static_cast<int>(cudaGetLastError());
}

// K7. leaf[z] is contiguous with n_rows rows of row_bytes[z]; src (device,
// int64, n_rows) in range, with no source row also a destination row
// (unchecked). In place; launches on `stream`, returns the cudaError_t of
// the launch; does not synchronise.
extern "C" int whisper_cow_copy_rows(void* const* leaf, const long long* row_bytes,
                                     int n_leaves, const void* src, int n_rows, void* stream) {
  Leaves leaves;
  long long max_row;
  cudaError_t err = fill(&leaves, leaf, leaf, row_bytes, n_leaves, &max_row);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows == 0 || max_row == 0) return 0;
  const dim3 grid(static_cast<unsigned>((max_row + CHUNK - 1) / CHUNK), n_rows, n_leaves);
  cow_copy_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      leaves, static_cast<const long long*>(src));
  return static_cast<int>(cudaGetLastError());
}
