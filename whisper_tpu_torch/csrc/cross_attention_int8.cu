// Decode-step attention over int8 K/V with per-position scales, for Hopper.
//
// Replaces the TPU kernel whisper_tpu/kernels/cross_attention_int8.py
// (cross_attention_int8 -> _kernel), with the numerics of the path the JAX
// package runs (model/quant.py qk_logits -> softmax -> pv_out):
//
//   logits[t, c] = (sum_d q[t, d] * k8[d, c]) * k_scale[c]        f32
//   logits[t, c] = -1e30 where c > n_past + t  (self-attention; none for cross)
//   p[t, c]      = exp(logits - max_c) / sum_c exp(logits - max_c)  f32
//   out[t, d]    = sum_c bf16(p[t, c] * v_scale[c]) * v8[d, c]    f32 sum
//
// q (B, H, T, 64) f32 or bf16, out of q's dtype; k8 and v8 (B, H, 64, C) int8,
// kv-major; scales (B, H, C) f32. The batch stride of k8/v8 and of the scales
// is an argument, so a layer slice of the batch-leading (B, L, H, D, C) self
// cache is read in place; within one batch row (H, D, C) is contiguous.
//
// What bounds it: at decode (T = 1..3) each (b, h) reads 2 * 64 * C bytes of
// int8 K/V and does ~4 flops per byte, far below the card's balance point, so
// it is a memory-bound stream (7.9 GB of cross memory per large-v3 step at
// batch 64). The TPU kernel dequantized whole K/V blocks in VMEM. Here one
// block of 256 threads owns one (b, h) and up to ROWS query rows and reads
// each K and V byte its rows can see once, converting on read (in the self
// cache the keys past the last row's causal mask contribute exp(-1e30 - max)
// = 0 and are skipped, which leaves every sum as it was):
//   1. each thread takes key columns c (consecutive across the warp, so the
//      int8 rows of kv-major K coalesce), dots them with the ROWS query rows
//      held in shared memory (broadcast reads), and writes the scaled, masked
//      f32 logits to shared memory (ROWS * C * 4 bytes, 48 KB at 8 x 1500);
//   2. one warp per query row takes that row's max and sum, then overwrites
//      each logit with bf16(p * v_scale): the probabilities are normalised
//      BEFORE the PV sum, as pv_out rounds them, so this is two passes over
//      the logits in shared memory and not an online softmax;
//   3. each warp takes output columns d; its lanes stream the contiguous int8
//      row v8[d, :] and the ROWS probability rows, and reduce by shuffles.
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

template <typename T, int ROWS>
__global__ void __launch_bounds__(THREADS)
attention_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k8,
                      const float* __restrict__ ks, const int8_t* __restrict__ v8,
                      const float* __restrict__ vs, T* __restrict__ out, int n_head, int tq,
                      int c_len, long long data_bstride, long long scale_bstride, int n_past) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [ROWS][D]
  float* lg = smem + ROWS * D;      // [ROWS][c_len]

  const int bh = blockIdx.x;
  const int b = bh / n_head, h = bh % n_head;
  const int t0 = blockIdx.y * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // keys any of this block's rows can see
  const int c_hi = n_past < 0 ? c_len : min(c_len, n_past + min(t0 + ROWS, tq));

  const int8_t* kb = k8 + b * data_bstride + (long long)h * D * c_len;
  const int8_t* vb = v8 + b * data_bstride + (long long)h * D * c_len;
  const float* ksb = ks + b * scale_bstride + (long long)h * c_len;
  const float* vsb = vs + b * scale_bstride + (long long)h * c_len;

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
      const float kv = static_cast<float>(kb[(long long)d * c_len + c]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(qs[r * D + d], kv, acc[r]);
    }
    const float sc = ksb[c];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const bool ok = n_past < 0 || c <= n_past + t0 + r;
      lg[r * c_len + c] = ok ? acc[r] * sc : MASKED;
    }
  }
  __syncthreads();

  // 2. softmax, one warp per row, then bf16(p * v_scale) in place
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
    for (int c = lane; c < c_hi; c += 32) {
      row[c] = __bfloat162float(__float2bfloat16_rn((row[c] / s) * vsb[c]));
    }
  }
  __syncthreads();

  // 3. out[r, d] = sum_c pv[r, c] * v8[d, c]
  for (int d = warp; d < D; d += WARPS) {
    const int8_t* vr = vb + (long long)d * c_len;
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    for (int c = lane; c < c_hi; c += 32) {
      const float vv = static_cast<float>(vr[c]);
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

template <typename T, int ROWS>
cudaError_t launch(const void* q, const void* k8, const void* ks, const void* v8, const void* vs,
                   void* out, int batch, int n_head, int tq, int c_len, long long data_bstride,
                   long long scale_bstride, int n_past, cudaStream_t s) {
  const size_t smem = sizeof(float) * static_cast<size_t>(ROWS) * (D + c_len);
  auto kernel = attention_int8_kernel<T, ROWS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(batch * n_head, (tq + ROWS - 1) / ROWS);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k8), static_cast<const float*>(ks),
      static_cast<const int8_t*>(v8), static_cast<const float*>(vs), static_cast<T*>(out), n_head,
      tq, c_len, data_bstride, scale_bstride, n_past);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int rows, const void* q, const void* k8, const void* ks, const void* v8,
                     const void* vs, void* out, int batch, int n_head, int tq, int c_len,
                     long long data_bstride, long long scale_bstride, int n_past,
                     cudaStream_t s) {
  switch (rows) {
    case 1:
      return launch<T, 1>(q, k8, ks, v8, vs, out, batch, n_head, tq, c_len, data_bstride,
                          scale_bstride, n_past, s);
    case 2:
      return launch<T, 2>(q, k8, ks, v8, vs, out, batch, n_head, tq, c_len, data_bstride,
                          scale_bstride, n_past, s);
    case 4:
      return launch<T, 4>(q, k8, ks, v8, vs, out, batch, n_head, tq, c_len, data_bstride,
                          scale_bstride, n_past, s);
    case 8:
      return launch<T, 8>(q, k8, ks, v8, vs, out, batch, n_head, tq, c_len, data_bstride,
                          scale_bstride, n_past, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q and out (batch, n_head, tq, 64) contiguous, f32 (is_bf16 == 0) or bf16;
// k8/v8 int8 at [b * data_bstride + (h * 64 + d) * c_len + c]; k_scale/v_scale
// f32 at [b * scale_bstride + h * c_len + c]. n_past < 0: every key attends
// (cross-attention); n_past >= 0: key c attends query t iff c <= n_past + t.
// rows (1, 2, 4 or 8) query rows per block; sizeof(float) * rows * (64 + c_len)
// bytes of shared memory must fit the block. Launches on `stream` and returns
// the cudaError_t of the launch (0 on success); it does not synchronise.
extern "C" int whisper_attention_int8(const void* q, const void* k8, const void* k_scale,
                                      const void* v8, const void* v_scale, void* out, int batch,
                                      int n_head, int tq, int c_len, long long data_bstride,
                                      long long scale_bstride, int n_past, int rows, int is_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(rows, q, k8, k_scale, v8, v_scale, out, batch, n_head, tq,
                                        c_len, data_bstride, scale_bstride, n_past, s)
              : dispatch<float>(rows, q, k8, k_scale, v8, v_scale, out, batch, n_head, tq,
                                c_len, data_bstride, scale_bstride, n_past, s);
  return static_cast<int>(err);
}
