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
// normalisation, an online softmax would not reproduce it: the f32 logits of
// a block's query rows are held whole in shared memory (two passes).
//
// q (B, H, T, 64) and out of q's dtype (f32 or bf16), contiguous; k and v
// (B, H, 64, C) of the cache's dtype, kv-major: the batch stride is an
// argument, so a layer slice of the batch-leading (B, L, H, D, C) cache is
// read in place (within one batch row (H, D, C) is contiguous).
//
// What bounds it: each (b, h) needs 2 * 64 * (n_past + T) cache elements
// (keys past the causal mask are never read) and does ~4 T flops per element,
// far below the card's balance point. At decode (T = 1) and batch 8 the call
// reads under 2 MB: it is bound by latency, the launch and each memory round
// trip a block waits on. So one block of 256 threads owns one (b, h) and up
// to ROWS query rows (kernels/decode_attention.py:cached_attention_plan) and
// waits on device memory once:
//   0. at entry it issues every visible byte of the head's K and V, 16-byte
//      cp.async from each row's aligned start into a row of `pitch` bytes
//      (K in one commit group, V in the next, so V lands during steps 1-2),
//      and loads its query rows. A kv-major row starts at d * C elements,
//      which is 16-byte aligned at C = 104 or 448 in bf16 but not at a
//      general C: each row is read back at its own byte shift. A piece that
//      would cross the head's first or last byte (a base that is not 16-byte
//      aligned) is copied element by element instead, so nothing outside
//      the head is read;
//   1. logits: one thread per (query row, key), a sequential f32 sum over
//      d = 0..63 as the current plain product takes it (a split of d moves a
//      logit by an ulp, which can move the rounded p); neighbouring lanes
//      take neighbouring keys, so the K reads are conflict-free;
//   2. softmax: one warp per query row, max and sum by shuffles, then the
//      normalised p rounded to the cache's dtype, in place;
//   3. P.V: each thread owns one output column d and a quarter of the keys,
//      for all ROWS query rows (one V read feeds ROWS sums); the four
//      quarters are added by shuffles. Rows of `pitch` = 16 mod 128 bytes put
//      a warp's eight columns on distinct banks.
// A head whose visible K and V do not fit shared memory at once (an f32
// cache near C = 448) is walked in tiles of `width` keys through two slots:
// K tiles, then V tiles, each issued as soon as its slot is free. At the
// main paths' shapes K and V are one tile each, both in flight from entry.
// Keys past the last row's mask contribute exp(-1e30 - max) = 0 and are
// skipped, which leaves every sum as it was. The serving engine's slots
// each carry their own position: a ragged call reads row b's n_past from a
// (B,) int32 array in device memory, so the host never learns the largest
// one; its launch plan is sized for the whole cache, and each block copies
// and computes only its own row's visible keys. The launch has no host
// sync and allocates nothing, so it can be captured in a CUDA graph.
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
constexpr int SLICES = THREADS / D;  // step 3: lanes per output column
constexpr float MASKED = -1e30f;
constexpr int SMEM_MAX = 232448;  // 227 KB, what a block may take

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Shared memory of one block (kernels/decode_attention.py:_layout computes
// the same): q rows and logits in f32, then two slots of 64 K or V rows.
struct Layout {
  int pitch;    // bytes of a slot's row: `width` keys and up to 15 bytes of
                // shift, = 16 mod 128
  int lstride;  // floats of a logits row
  int lg;       // float offset of the logits, after [rows][64] q
  int slot;     // bytes of one slot
  int slots;    // byte offset of slot 0
  int bytes;
};

__host__ __device__ inline Layout layout(int rows, int c_max, int width, int esz) {
  Layout l;
  l.pitch = (width * esz + 15 + 15) & ~15;
  l.pitch += (144 - l.pitch % 128) % 128;
  l.lstride = (c_max + 3) & ~3;
  l.lg = rows * D;
  l.slot = D * l.pitch;
  l.slots = ((l.lg + rows * l.lstride) * 4 + 15) & ~15;
  l.bytes = l.slots + 2 * l.slot;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Byte shift of row d of a head at `head` (rows c_len elements apart) from
// its 16-byte aligned start.
template <typename T>
__device__ __forceinline__ int row_shift(const T* head, int c_len, int d) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(head) +
                           static_cast<uintptr_t>(d) * c_len * sizeof(T)) & 15);
}

// Issue keys [c0, c0 + n) of the head's 64 rows into `slot` (row d at
// d * pitch, from the 16-byte aligned start of its first key): 16-byte
// cp.async for every piece inside the head, the needed elements of a piece
// across the head's bounds one by one. kernels/decode_attention.py:
// tile_pieces states the same plan.
template <typename T>
__device__ __forceinline__ void issue_tile(unsigned char* slot, const T* head, int c_len, int c0,
                                           int n, int pitch) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(head);
  const uintptr_t hi = lo + static_cast<uintptr_t>(D) * c_len * sizeof(T);
  const int pieces = (n * static_cast<int>(sizeof(T)) + 15 + 15) / 16;  // a row's span, at most
  for (int i = threadIdx.x; i < D * pieces; i += THREADS) {
    const int d = i / pieces, piece = i % pieces;
    const uintptr_t a = lo + (static_cast<uintptr_t>(d) * c_len + c0) * sizeof(T);
    const uintptr_t e = a + static_cast<uintptr_t>(n) * sizeof(T);
    const uintptr_t p = (a & ~uintptr_t(15)) + 16 * piece;
    if (p >= e) continue;
    unsigned char* dst = slot + d * pitch + 16 * piece;
    if (p >= lo && p + 16 <= hi) {
      cp_async16(dst, reinterpret_cast<const void*>(p));
    } else {
      for (uintptr_t s = (p > a ? p : a); s < p + 16 && s < e; s += sizeof(T)) {
        *reinterpret_cast<T*>(dst + (s - p)) = *reinterpret_cast<const T*>(s);
      }
    }
  }
}

template <typename TQ, typename TKV, int ROWS>
__global__ void __launch_bounds__(THREADS)
cached_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v, TQ* __restrict__ out, int n_head, int tq,
                        int c_len, long long kv_bstride, int n_past_all,
                        const int* __restrict__ n_past_rows, float scale, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ESZ = sizeof(TKV);
  // the layout is the plan's, sized from the scalar n_past (C - T for a
  // ragged call: every key of the cache)
  const int c_max = min(c_len, n_past_all + tq);
  const Layout l = layout(ROWS, c_max, width, ESZ);
  float* qs = reinterpret_cast<float*>(smem);  // [ROWS][D]
  float* lg = qs + l.lg;                        // [ROWS][lstride]
  unsigned char* slots = smem + l.slots;        // [2][D][pitch]

  const int bh = blockIdx.x;
  const int b = bh / n_head, h = bh % n_head;
  // this row's position: its own from device memory when the call is ragged
  const int n_past = n_past_rows != nullptr ? n_past_rows[b] : n_past_all;
  const int t0 = blockIdx.y * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // keys any of this block's rows can see
  const int c_hi = min(c_len, n_past + min(t0 + ROWS, tq));
  const int tiles = (c_hi + width - 1) / width;  // of K, and as many of V

  const TKV* kb = k + b * kv_bstride + static_cast<long long>(h) * D * c_len;
  const TKV* vb = v + b * kv_bstride + static_cast<long long>(h) * D * c_len;
  // tile i < tiles: K keys [i * width, ...); tile tiles + j: V keys [j * width, ...)
  auto issue = [&](int i) {
    const bool is_k = i < tiles;
    const int c0 = (is_k ? i : i - tiles) * width;
    issue_tile(slots + (i & 1) * l.slot, is_k ? kb : vb, c_len, c0, min(width, c_hi - c0),
               l.pitch);
  };
  issue(0);
  cp_async_commit();
  issue(1);
  cp_async_commit();

  // Query rows past tq are zeros: their (unused) softmax stays finite.
  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    const int r = i / D;
    qs[i] = (t0 + r < tq) ? load_f32(q + (static_cast<long long>(bh) * tq + t0 + r) * D + i % D)
                          : 0.f;
  }

  // step 3's column and quarter of the keys
  const int col = threadIdx.x / SLICES, slice = threadIdx.x % SLICES;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;

  for (int i = 0; i < 2 * tiles; ++i) {
    cp_async_wait1();  // every group but the newest: tile i has landed
    __syncthreads();
    const unsigned char* slot = slots + (i & 1) * l.slot;
    if (i < tiles) {
      // 1. logits of keys [c0, c0 + n)
      const int c0 = i * width, n = min(width, c_hi - c0);
      for (int pair = threadIdx.x; pair < ROWS * n; pair += THREADS) {
        const int r = pair / n, c = pair % n;
        const float* qr = qs + r * D;
        float a = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          const TKV* kr = reinterpret_cast<const TKV*>(slot + d * l.pitch +
                                                       row_shift(kb + c0, c_len, d));
          a = fmaf(qr[d], load_f32(kr + c), a);
        }
        lg[r * l.lstride + c0 + c] = (c0 + c <= n_past + t0 + r) ? a * scale : MASKED;
      }
      if (i == tiles - 1) {
        __syncthreads();
        // 2. softmax, one warp per row, then the normalised p rounded to the
        //    cache's dtype, in place
        for (int r = warp; r < ROWS; r += WARPS) {
          float* row = lg + r * l.lstride;
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
      }
    } else {
      // 3. acc[r] += p[r, c] * v[col, c] over this quarter of the tile's keys
      const int c0 = (i - tiles) * width, n = min(width, c_hi - c0);
      const TKV* vr = reinterpret_cast<const TKV*>(slot + col * l.pitch +
                                                   row_shift(vb + c0, c_len, col));
      for (int c = slice; c < n; c += SLICES) {
        const float vv = load_f32(vr + c);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(lg[r * l.lstride + c0 + c], vv, acc[r]);
      }
    }
    __syncthreads();  // slot i & 1 is free, p is visible
    if (i + 2 < 2 * tiles) issue(i + 2);
    cp_async_commit();  // possibly empty: one group per iteration
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int o = SLICES / 2; o > 0; o >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
  }
  if (slice == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (t0 + r < tq) store(out + (static_cast<long long>(bh) * tq + t0 + r) * D + col, acc[r]);
    }
  }
}

template <typename TQ, typename TKV, int ROWS>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch,
                   int n_head, int tq, int c_len, long long kv_bstride, int n_past,
                   const int* n_past_rows, float scale, int width, cudaStream_t s) {
  const int c_max = min(c_len, n_past + tq);
  const Layout l = layout(ROWS, c_max, width, sizeof(TKV));
  if (width < 1 || l.bytes > SMEM_MAX) return cudaErrorInvalidValue;
  auto kernel = cached_attention_kernel<TQ, TKV, ROWS>;
  static bool opted_in = false;  // the largest size, once per instantiation
  if (l.bytes > 48 * 1024 && !opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(batch * n_head, (tq + ROWS - 1) / ROWS);
  kernel<<<grid, THREADS, l.bytes, s>>>(static_cast<const TQ*>(q), static_cast<const TKV*>(k),
                                        static_cast<const TKV*>(v), static_cast<TQ*>(out),
                                        n_head, tq, c_len, kv_bstride, n_past, n_past_rows,
                                        scale, width);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch(int rows, const void* q, const void* k, const void* v, void* out,
                     int batch, int n_head, int tq, int c_len, long long kv_bstride, int n_past,
                     const int* n_past_rows, float scale, int width, cudaStream_t s) {
  switch (rows) {
    case 1:
      return launch<TQ, TKV, 1>(q, k, v, out, batch, n_head, tq, c_len, kv_bstride, n_past,
                                n_past_rows, scale, width, s);
    case 2:
      return launch<TQ, TKV, 2>(q, k, v, out, batch, n_head, tq, c_len, kv_bstride, n_past,
                                n_past_rows, scale, width, s);
    case 4:
      return launch<TQ, TKV, 4>(q, k, v, out, batch, n_head, tq, c_len, kv_bstride, n_past,
                                n_past_rows, scale, width, s);
    case 8:
      return launch<TQ, TKV, 8>(q, k, v, out, batch, n_head, tq, c_len, kv_bstride, n_past,
                                n_past_rows, scale, width, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q and out (batch, n_head, tq, 64) contiguous, f32 (q_bf16 == 0) or bf16;
// k and v f32 (kv_bf16 == 0) or bf16 at [b * kv_bstride + (h * 64 + d) *
// c_len + c]. Key c attends query t of row b iff c <= n_past[b] + t, where
// n_past[b] is n_past_rows[b] (a (batch,) int32 array on the device, each
// >= 0: the serving engine's slots) or, when n_past_rows is null, n_past.
// A ragged call passes n_past = max(0, c_len - tq), which sizes the layout
// for every key of the cache; each block still reads only its own row's
// min(c_len, n_past[b] + tq) keys. rows (1, 2, 4 or 8) query rows per
// block; width keys a K or V tile holds, as cached_attention_plan gives
// them; the layout must fit 227 KB. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); it does not synchronise.
extern "C" int whisper_cached_attention(const void* q, const void* k, const void* v, void* out,
                                        int batch, int n_head, int tq, int c_len,
                                        long long kv_bstride, int n_past, const int* n_past_rows,
                                        float scale, int rows, int width, int q_bf16,
                                        int kv_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16 && kv_bf16) {
    err = dispatch<__nv_bfloat16, __nv_bfloat16>(rows, q, k, v, out, batch, n_head, tq, c_len,
                                                 kv_bstride, n_past, n_past_rows, scale, width,
                                                 s);
  } else if (q_bf16) {
    err = dispatch<__nv_bfloat16, float>(rows, q, k, v, out, batch, n_head, tq, c_len,
                                         kv_bstride, n_past, n_past_rows, scale, width, s);
  } else if (kv_bf16) {
    err = dispatch<float, __nv_bfloat16>(rows, q, k, v, out, batch, n_head, tq, c_len,
                                         kv_bstride, n_past, n_past_rows, scale, width, s);
  } else {
    err = dispatch<float, float>(rows, q, k, v, out, batch, n_head, tq, c_len, kv_bstride,
                                 n_past, n_past_rows, scale, width, s);
  }
  return static_cast<int>(err);
}
