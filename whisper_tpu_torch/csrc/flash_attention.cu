// Encoder self-attention for Hopper: softmax(q k^T / sqrt(D)) v, D = 64.
//
// Replaces the TPU kernel whisper_tpu/kernels/flash_attention.py
// (flash_attention -> _attn_kernel). That kernel holds one head's whole K and
// V in VMEM and builds a full (768 x T_pad) f32 score tile with no online
// softmax. On this card a block has at most 227 KB of shared memory: K and V
// of one head at T = 1500 are 2 x 188 KB in bf16, and the score tile alone
// would be 4.7 MB. So both kernels here stream K/V tiles through shared
// memory with an online softmax in f32 (running max, running sum), over a
// grid of (B*H, ceil(Tq / query rows per block)) blocks.
//
// What bounds it: the score and PV products, 4 * Tq * Tk * D flops per head,
// against 2 * Tk * D * bytes of K/V read per query block -- hundreds of flops
// per byte at T = 1500, far above the card's balance point. So the work goes
// where the flops are cheapest for each input type:
//
//   * bf16 (the serving path): tensor cores through mma.sync m16n8k16 with
//     f32 accumulation, FlashAttention-2 style. Four warps own 16 query rows
//     each; Q fragments stay in registers; each 64-key tile of K and of V
//     (transposed) is staged in padded shared memory, so fragment loads hit
//     32 distinct banks. The scores' accumulator layout is reused directly as
//     the A operand of the PV product, rounded to bf16 (the TPU kernel also
//     rounds the probabilities to v's dtype before that product).
//   * f32 (the parity path): CUDA-core FMAs, one query row per thread, with
//     the q row and the D = 64 accumulator in registers; every thread of a
//     warp reads the same key row, so shared-memory reads are broadcasts, and
//     the online softmax rescales once per CHUNK keys.
//
// wgmma, TMA and a pipelined producer warp are later work.
//
// Masks match the TPU kernel exactly: keys >= tk never take part (the TPU
// kernel pads K and masks them to -1e30), and the causal rule is key <= q
// with no offset between the query and key positions. Scores are scaled in
// f32 (exact for D = 64: the scale is 2^-3).
//
// Plain C interface, loaded with ctypes by whisper_tpu_torch/kernels/build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;
constexpr float MASKED = -1e30f;

// ---------------------------------------------------------------- f32 path

constexpr int F32_ROWS = 128;  // threads per block = query rows per block
constexpr int F32_KEYS = 64;   // keys per shared-memory tile
constexpr int CHUNK = 8;       // keys per online-softmax rescale

__global__ void __launch_bounds__(F32_ROWS)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int tq, int tk, int causal, float scale) {
  __shared__ __align__(16) float ks[F32_KEYS * D];
  __shared__ __align__(16) float vs[F32_KEYS * D];

  const long long bh = blockIdx.x;
  const int row = blockIdx.y * F32_ROWS + threadIdx.x;
  const bool valid = row < tq;

  float qr[D];
  const float* qp = q + (bh * tq + (valid ? row : 0)) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = valid ? qp[d] * scale : 0.f;

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  // Causal blocks stop at the block's last query row: later keys are masked
  // for every row of the block.
  const int kend = causal ? min(tk, (int)(blockIdx.y + 1) * F32_ROWS) : tk;
  const float* kb = k + bh * tk * D;
  const float* vb = v + bh * tk * D;

  for (int t0 = 0; t0 < kend; t0 += F32_KEYS) {
    const int n = min(F32_KEYS, tk - t0);
    __syncthreads();  // the previous tile is consumed
    // A tile of n key rows is one contiguous span of n * D elements.
    for (int i = threadIdx.x; i < F32_KEYS * D; i += F32_ROWS) {
      const bool in = i < n * D;
      ks[i] = in ? kb[(long long)t0 * D + i] : 0.f;
      vs[i] = in ? vb[(long long)t0 * D + i] : 0.f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < n; j0 += CHUNK) {
      float s[CHUNK];
      float cmax = MASKED;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(ks + (j0 + jj) * D);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 kk = kr[d4];
          dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
          dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
          dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
          dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
        }
        const int key = t0 + j0 + jj;
        const bool ok = key < tk && (!causal || key <= row);
        s[jj] = ok ? dot : MASKED;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);  // 0 on the first chunk (m = -inf)
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs + (j0 + jj) * D);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (valid) {
    const float inv = 1.f / l;
    float* op = o + (bh * tq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d] * inv;
  }
}

// --------------------------------------------------------------- bf16 path

constexpr int MMA_WARPS = 4;
constexpr int MMA_ROWS = 16 * MMA_WARPS;  // query rows per block
constexpr int MMA_KEYS = 64;              // keys per shared-memory tile
constexpr int PAD = 8;                    // row padding: 144-byte rows, no bank conflicts

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&h);
}

// Copy `rows` rows of D bf16 (contiguous in global memory) into a padded
// shared tile, 16 bytes per thread per step; rows past `valid` become 0.
__device__ __forceinline__ void load_rows(__nv_bfloat16 (*dst)[D + PAD],
                                          const __nv_bfloat16* src, int rows, int valid) {
  for (int i = threadIdx.x; i < rows * (D / 8); i += blockDim.x) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < valid) x = *reinterpret_cast<const uint4*>(src + (long long)r * D + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = x;
  }
}

__global__ void __launch_bounds__(32 * MMA_WARPS)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      int tq, int tk, int causal, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[MMA_ROWS][D + PAD];
  __shared__ __align__(16) __nv_bfloat16 ks[MMA_KEYS][D + PAD];
  __shared__ __align__(16) __nv_bfloat16 vt[D][MMA_KEYS + PAD];  // V transposed

  const long long bh = blockIdx.x;
  const int q0 = blockIdx.y * MMA_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int r0 = q0 + 16 * warp + g;     // this thread's two rows: r0, r0 + 8

  load_rows(qs, q + (bh * tq + q0) * D, MMA_ROWS, tq - q0);
  __syncthreads();
  uint32_t qa[D / 16][4];  // A fragments of this warp's 16 x 64 Q slice
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* lo = &qs[16 * warp + g][16 * kk + 2 * t];
    const __nv_bfloat16* hi = &qs[16 * warp + g + 8][16 * kk + 2 * t];
    qa[kk][0] = ld32(lo);
    qa[kk][1] = ld32(hi);
    qa[kk][2] = ld32(lo + 8);
    qa[kk][3] = ld32(hi + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows r0, r0 + 8
  float l[2] = {0.f, 0.f};              // this thread's share of the running sums

  const int kend = causal ? min(tk, q0 + MMA_ROWS) : tk;
  const __nv_bfloat16* kb = k + bh * tk * D;
  const __nv_bfloat16* vb = v + bh * tk * D;

  for (int t0 = 0; t0 < kend; t0 += MMA_KEYS) {
    const int n_keys = min(MMA_KEYS, tk - t0);
    __syncthreads();  // the previous tile is consumed
    load_rows(ks, kb + (long long)t0 * D, MMA_KEYS, n_keys);
    for (int i = threadIdx.x; i < MMA_KEYS * (D / 8); i += blockDim.x) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r < n_keys) x = *reinterpret_cast<const uint4*>(vb + (long long)(t0 + r) * D + c);
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vt[c + 2 * j][r] = __ushort_as_bfloat16(static_cast<unsigned short>(w[j] & 0xffffu));
        vt[c + 2 * j + 1][r] = __ushort_as_bfloat16(static_cast<unsigned short>(w[j] >> 16));
      }
    }
    __syncthreads();
    // A causal tile that starts past this warp's last row is all masked.
    if (causal && t0 > q0 + 16 * warp + 15) continue;

    // S = Q K^T for 16 rows x 64 keys: 8 key tiles of 8.
    float s[MMA_KEYS / 8][4];
#pragma unroll
    for (int j = 0; j < MMA_KEYS / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = &ks[8 * j + g][16 * kk + 2 * t];
        mma_bf16(s[j], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }
    float mx[2] = {MASKED, MASKED};
#pragma unroll
    for (int j = 0; j < MMA_KEYS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + 8 * j + 2 * t + (e & 1);
        const int row = r0 + 8 * (e >> 1);
        const bool ok = key < tk && (!causal || key <= row);
        s[j][e] = ok ? s[j][e] * scale : MASKED;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the 4 threads of a quad share a row
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);  // 0 on the first tile (m = -inf)
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < MMA_KEYS / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    }
    // O += P V: the score accumulators of key tiles 2kk, 2kk+1 are the A
    // fragment of keys 16kk .. 16kk+15.
#pragma unroll
    for (int kk = 0; kk < MMA_KEYS / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vr = &vt[8 * n + g][16 * kk + 2 * t];
        mma_bf16(acc[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= tq) continue;
    const float inv = 1.f / l[h];
    __nv_bfloat16* op = o + (bh * tq + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(op + 8 * n) =
          pack_bf16(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    }
  }
}

}  // namespace

// q (bh, tq, 64), k and v (bh, tk, 64), o (bh, tq, 64): contiguous, one dtype
// (f32 when is_bf16 == 0, bf16 otherwise). Launches on `stream` and returns
// the cudaError_t of the launch (0 on success); it does not synchronise.
extern "C" int whisper_flash_attention(const void* q, const void* k, const void* v,
                                       void* o, int bh, int tq, int tk, int causal,
                                       int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid(bh, (tq + MMA_ROWS - 1) / MMA_ROWS);
    attention_bf16_kernel<<<grid, 32 * MMA_WARPS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        tq, tk, causal, scale);
  } else {
    const dim3 grid(bh, (tq + F32_ROWS - 1) / F32_ROWS);
    attention_f32_kernel<<<grid, F32_ROWS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), tq, tk, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
