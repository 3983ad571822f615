// Decode-step self-attention over one layer of the float KV cache, for Hopper.
//
// Replaces the TPU kernel whisper_tpu/kernels/decode_attention.py
// (cached_attention -> _cached_attn_kernel), with the numerics of the path
// the JAX package runs at this site (model/decoder.py _kvmajor_sdpa):
//
//   logits[t, c] = (sum_d q[t, d] * k[d, c]) * scale              f32
//   logits[t, c] = -1e30 where c > n_past + t                     (causal)
//   p[t, c]      = exp(logits - max_c) / sum_c exp(logits - max_c) f32
//   out[t, d]    = sum_c KV(p[t, c]) * v[d, c]                    f32 sum
//
// where KV() rounds to the cache's dtype (bf16 or f32): the probabilities are
// rounded AFTER they are normalised, as _kvmajor_sdpa's probs.astype(v.dtype)
// does. (The Pallas kernel keeps p in f32; the two agree at f32 and differ by
// up to an ulp of the output at bf16.) Because the rounding follows the
// normalisation, an online softmax would not reproduce it: this is K4's
// two-pass shape, with the f32 logits of a block of query rows held in
// shared memory (C <= 448 positions, 14 KB at 8 rows).
//
// q (B, H, T, 64) and out of q's dtype (f32 or bf16), contiguous; k and v
// (B, H, 64, C) of the cache's dtype, kv-major: the batch stride is an
// argument, so a layer slice of the batch-leading (B, L, H, D, C) cache is
// read in place (within one batch row (H, D, C) is contiguous). No 128-
// padded context and no layer-leading layout, which the TPU kernel needed.
//
// What bounds it: each (b, h) needs 2 * 64 * (n_past + T) cache elements
// (the keys past the causal mask are never read) and does ~4 T flops per
// element, far below the card's balance point, so it is a memory-bound
// stream; at decode (T = 1) and batch 8 the whole call reads under a MB and
// is launch-bound. One block of 256 threads owns one (b, h) and up to ROWS
// query rows, and reads each K and V element its rows can see once; keys
// past the last row's mask contribute exp(-1e30 - max) = 0 and are skipped,
// which leaves every sum as it was:
//   1. each thread takes key columns c (consecutive across the warp, so the
//      rows of kv-major K coalesce) and dots them with the ROWS query rows
//      held in shared memory (broadcast reads);
//   2. one warp per query row takes the row's max and sum, then overwrites
//      each logit with KV(p);
//   3. each warp takes output columns d; its lanes stream the contiguous row
//      v[d, :] against the ROWS probability rows and reduce by shuffles.
// The f32 path is the same code on f32 loads (CUDA-core FMAs), for the
// f32 parity path.
//
// Plain C interface, loaded with ctypes by whisper_tpu_torch/kernels/build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename TQ, typename TKV, int ROWS>
__global__ void __launch_bounds__(THREADS)
cached_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v, TQ* __restrict__ out, int n_head, int tq,
                        int c_len, long long kv_bstride, int n_past, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;             // [ROWS][D]
  float* lg = smem + ROWS * D;  // [ROWS][c_len]

  const int bh = blockIdx.x;
  const int b = bh / n_head, h = bh % n_head;
  const int t0 = blockIdx.y * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // keys any of this block's rows can see
  const int c_hi = min(c_len, n_past + min(t0 + ROWS, tq));

  const TKV* kb = k + b * kv_bstride + (long long)h * D * c_len;
  const TKV* vb = v + b * kv_bstride + (long long)h * D * c_len;

  // Query rows past tq are zeros: their (unused) softmax stays finite.
  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    const int r = i / D;
    qs[i] = (t0 + r < tq) ? load_f32(q + ((long long)bh * tq + t0 + r) * D + i % D) : 0.f;
  }
  __syncthreads();

  // 1. logits
  for (int c = threadIdx.x; c < c_hi; c += THREADS) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kv = load_f32(kb + (long long)d * c_len + c);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(qs[r * D + d], kv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      lg[r * c_len + c] = (c <= n_past + t0 + r) ? acc[r] * scale : MASKED;
    }
  }
  __syncthreads();

  // 2. softmax, one warp per row, then the normalised p rounded to the
  //    cache's dtype, in place
  for (int r = warp; r < ROWS; r += WARPS) {
    float* row = lg + r * c_len;
    float m = MASKED;
    for (int c = lane; c < c_hi; c += 32) m = fmaxf(m, row[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
    for (int c = lane; c < c_hi; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      s += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    for (int c = lane; c < c_hi; c += 32) row[c] = round_to(row[c] / s, kb);
  }
  __syncthreads();

  // 3. out[r, d] = sum_c p[r, c] * v[d, c]
  for (int d = warp; d < D; d += WARPS) {
    const TKV* vr = vb + (long long)d * c_len;
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    for (int c = lane; c < c_hi; c += 32) {
      const float vv = load_f32(vr + c);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(lg[r * c_len + c], vv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (t0 + r < tq) store(out + ((long long)bh * tq + t0 + r) * D + d, acc[r]);
      }
    }
  }
}

template <typename TQ, typename TKV, int ROWS>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch,
                   int n_head, int tq, int c_len, long long kv_bstride, int n_past, float scale,
                   cudaStream_t s) {
  const size_t smem = sizeof(float) * static_cast<size_t>(ROWS) * (D + c_len);
  auto kernel = cached_attention_kernel<TQ, TKV, ROWS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(batch * n_head, (tq + ROWS - 1) / ROWS);
  kernel<<<grid, THREADS, smem, s>>>(static_cast<const TQ*>(q), static_cast<const TKV*>(k),
                                     static_cast<const TKV*>(v), static_cast<TQ*>(out), n_head,
                                     tq, c_len, kv_bstride, n_past, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch(int rows, const void* q, const void* k, const void* v, void* out,
                     int batch, int n_head, int tq, int c_len, long long kv_bstride, int n_past,
                     float scale, cudaStream_t s) {
  switch (rows) {
    case 1:
      return launch<TQ, TKV, 1>(q, k, v, out, batch, n_head, tq, c_len, kv_bstride, n_past,
                                scale, s);
    case 2:
      return launch<TQ, TKV, 2>(q, k, v, out, batch, n_head, tq, c_len, kv_bstride, n_past,
                                scale, s);
    case 4:
      return launch<TQ, TKV, 4>(q, k, v, out, batch, n_head, tq, c_len, kv_bstride, n_past,
                                scale, s);
    case 8:
      return launch<TQ, TKV, 8>(q, k, v, out, batch, n_head, tq, c_len, kv_bstride, n_past,
                                scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q and out (batch, n_head, tq, 64) contiguous, f32 (q_bf16 == 0) or bf16;
// k and v f32 (kv_bf16 == 0) or bf16 at [b * kv_bstride + (h * 64 + d) *
// c_len + c]. Key c attends query t iff c <= n_past + t. rows (1, 2, 4 or 8)
// query rows per block; sizeof(float) * rows * (64 + c_len) bytes of shared
// memory must fit the block. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); it does not synchronise.
extern "C" int whisper_cached_attention(const void* q, const void* k, const void* v, void* out,
                                        int batch, int n_head, int tq, int c_len,
                                        long long kv_bstride, int n_past, float scale, int rows,
                                        int q_bf16, int kv_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16 && kv_bf16) {
    err = dispatch<__nv_bfloat16, __nv_bfloat16>(rows, q, k, v, out, batch, n_head, tq, c_len,
                                                 kv_bstride, n_past, scale, s);
  } else if (q_bf16) {
    err = dispatch<__nv_bfloat16, float>(rows, q, k, v, out, batch, n_head, tq, c_len,
                                         kv_bstride, n_past, scale, s);
  } else if (kv_bf16) {
    err = dispatch<float, __nv_bfloat16>(rows, q, k, v, out, batch, n_head, tq, c_len,
                                         kv_bstride, n_past, scale, s);
  } else {
    err = dispatch<float, float>(rows, q, k, v, out, batch, n_head, tq, c_len, kv_bstride,
                                 n_past, scale, s);
  }
  return static_cast<int>(err);
}
