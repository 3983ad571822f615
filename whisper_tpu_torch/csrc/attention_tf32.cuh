// f32 attention on the tensor cores by split TF32, shared by the K1 forward
// (flash_attention.cu) and the K1c backward (flash_attention_bwd.cu). D = 64.
//
// Split TF32 ("3xTF32"): each f32 operand x becomes hi = x rounded to TF32
// (to nearest) and lo = x - hi (exact), which the tensor core reads
// truncated to TF32, and each product is lo_a·hi_b + hi_a·lo_b + hi_a·hi_b,
// accumulated in f32 by mma.sync m16n8k8 (small terms first). What it
// drops, lo_a·lo_b and lo's truncation, is ~2^-21 of the product: near-f32
// accuracy at three TF32 products (495 TFLOP/s dense, so ~165 TFLOP/s of
// f32 work, against 67 on the CUDA cores). The rounding is two integer
// ops: cvt.rna.tf32.f32 issues at a fraction of the FP32 rate, and with it
// on both halves the backward took 2.17 ms at (40, 1500, 64) on an H100,
// against 1.18 ms this way, at no larger error against an f64 truth
// (utils/attention_variants.py).
//
// Tiles sit in shared memory as f32 rows of 64 padded to LD = 68 floats.
// Every fragment read below is then free of bank conflicts, at a fixed
// offset from the lane's base address: A and "n-major" B fragments read
// rows g (0..7) at columns 8k + t (t 0..3), banks 4g + t; "k-major" B
// fragments read rows 8k + 2t + e at columns 8n + g, banks 8t + 4e + g.
// The k-major reads take the product's k index t as row 2t and
// t + 4 as row 2t + 1 (any order of k gives the same sum, as long as A
// and B share it). With that order an accumulator tile is already the A
// fragment of the next product (P after S = QKᵀ, dS after dPᵀ): no
// shuffles. wgmma would take 32-bit operands only K-major from shared
// memory, and P V needs V MN-major; mma.sync reads its B fragments from
// registers, so the order above covers both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Internal linkage: each library that includes this keeps its own copies.
namespace {
namespace tf32 {

constexpr int D = 64;
constexpr int LD = D + 4;  // a tile row in shared memory, in floats
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ int at(int r, int c) { return r * LD + c; }

// x rounded to TF32 (10 mantissa bits; to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds) for finite x
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = round_tf32(x[i]);
    lo[i] = __float_as_uint(__fsub_rn(x[i], __uint_as_float(hi[i])));
  }
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c (16 x 8) += A (16 x 8) B (8 x 8) in split TF32.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(c, al, bh);
  mma(c, ah, bl);
  mma(c, ah, bh);
}

// Fragments, for a lane with g = lane / 4, t = lane % 4. The accumulator c
// of a 16 x 8 tile holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

// A[m][k] = s[r0 + m][k0 + k]
__device__ __forceinline__ void frag_a(const float* s, int r0, int k0, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float x[4] = {s[at(r0 + g, k0 + t)], s[at(r0 + g + 8, k0 + t)],
                      s[at(r0 + g, k0 + t + 4)], s[at(r0 + g + 8, k0 + t + 4)]};
  split(x, hi, lo);
}

// A[m][k] = s[k0 + π(k)][m0 + m]: a tile stored k-major (dSᵀ for dQ = dS K)
__device__ __forceinline__ void frag_a_kmajor(const float* s, int k0, int m0, int g, int t,
                                              uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float x[4] = {s[at(k0 + 2 * t, m0 + g)], s[at(k0 + 2 * t, m0 + g + 8)],
                      s[at(k0 + 2 * t + 1, m0 + g)], s[at(k0 + 2 * t + 1, m0 + g + 8)]};
  split(x, hi, lo);
}

// The accumulator of a 16 x 8 tile as the A fragment of its 8 columns, in π order.
__device__ __forceinline__ void frag_a_acc(const float (&c)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split(x, hi, lo);
}

// B[k][n] = s[n0 + n][k0 + k]: a tile that holds B transposed (K in Q Kᵀ)
__device__ __forceinline__ void frag_b_nmajor(const float* s, int n0, int k0, int g, int t,
                                              uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float x[2] = {s[at(n0 + g, k0 + t)], s[at(n0 + g, k0 + t + 4)]};
  split(x, hi, lo);
}

// B[k][n] = s[k0 + π(k)][n0 + n]: a tile stored k-major (V in P V)
__device__ __forceinline__ void frag_b_kmajor(const float* s, int k0, int n0, int g, int t,
                                              uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float x[2] = {s[at(k0 + 2 * t, n0 + g)], s[at(k0 + 2 * t + 1, n0 + g)]};
  split(x, hi, lo);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows row0 .. row0 + ROWS - 1 of the (n, 64) matrix src into the padded
// tile dst; rows at or past n arrive as zeros. f32 goes by cp.async (wait
// with cp_async_wait); bf16 is read, widened and stored by the threads.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int n) {
  for (int i = threadIdx.x; i < ROWS * D / 4; i += THREADS) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4));
    const bool valid = row0 + r < n;
    cp_async16(dst + at(r, c), src + static_cast<long long>(valid ? row0 + r : 0) * D + c, valid);
  }
}
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* src, int row0, int n) {
  for (int i = threadIdx.x; i < ROWS * D / 4; i += THREADS) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4));
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) {
      const uint2 u =
          *reinterpret_cast<const uint2*>(src + static_cast<long long>(row0 + r) * D + c);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      f = make_float4(a.x, a.y, b.x, b.y);
    }
    *reinterpret_cast<float4*>(dst + at(r, c)) = f;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// ------------------------------------------------------------ the forward
//
// A block owns FWD_Q query rows of one head (eight warps of 16 rows) and
// streams FWD_K-key K/V tiles through two cp.async stages, with an online
// softmax in f32 (exp2, log2(e) · D^-0.5 folded into one FMA). Tile plan:
// kernels/flash_attention.attention_tile_plan(tq, tk, causal, FWD_Q,
// FWD_K): under causal the tiles wholly past the block's last row are not
// loaded, and only ragged or diagonal tiles take the per-element mask.
//
// DELTA is the K1c backward's first pass for bf16 inputs: with the
// forward's lse known, p = exp(s - lse) needs no online rescaling, and the
// block writes delta = rowsum(g ⊙ (p v)) with p and the sum in f32 (the
// bf16 output rounds p to bf16, so rowsum(g ⊙ out) is not JAX's Σ dp·p).

constexpr int FWD_Q = 128, FWD_K = 64, FWD_THREADS = 32 * FWD_Q / 16;
constexpr int FWD_SMEM = (FWD_Q + 4 * FWD_K) * LD * 4;  // Q, and K and V in two stages

template <typename T>
struct FwdParams {
  const T* q;
  const T* k;
  const T* v;
  float* o;             // (bh, tq, 64) output (forward)
  float* lse;           // (bh, tq) m·D^-0.5 + log(l), or null: not written (forward)
  const float* lse_in;  // the forward's lse (DELTA)
  const T* g;           // the output's gradient (DELTA)
  float* delta;         // (bh, tq) rowsum(g ⊙ p v) (DELTA)
  int tq, tk, causal;
  float scale;
};

__device__ __forceinline__ int fwd_key_tiles(int q0, int tq, int tk, int causal) {
  const int n = (tk + FWD_K - 1) / FWD_K;
  return causal ? min(n, (min(q0 + FWD_Q, tq) - 1) / FWD_K + 1) : n;
}
__device__ __forceinline__ bool fwd_tile_masked(int n, int q0, int tk, int causal) {
  return (n + 1) * FWD_K > tk || (causal && (n + 1) * FWD_K - 1 > q0);
}

template <typename T, bool DELTA>
__global__ void __launch_bounds__(FWD_THREADS, 2) attention_tf32_kernel(const FwdParams<T> p) {
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);
  float* kv = qs + FWD_Q * LD;  // stage s: K at kv + 2 s FWD_K LD, V after it

  const int q0 = blockIdx.x * FWD_Q;
  const long long bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const T* kb = p.k + bh * p.tk * D;
  const T* vb = p.v + bh * p.tk * D;
  const int n_tiles = fwd_key_tiles(q0, p.tq, p.tk, p.causal);

  load_tile<FWD_Q, FWD_THREADS>(qs, p.q + bh * p.tq * D, q0, p.tq);
  load_tile<FWD_K, FWD_THREADS>(kv, kb, 0, p.tk);
  load_tile<FWD_K, FWD_THREADS>(kv + FWD_K * LD, vb, 0, p.tk);
  cp_async_commit();

  const int r0 = 16 * warp;  // the warp's rows in the tile; the lane's: r0 + g, r0 + g + 8
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const float c = p.scale * LOG2E;
  float o[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, mc[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  if (DELTA) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < p.tq) mc[h] = p.lse_in[bh * p.tq + row[h]] * LOG2E;
  }

  for (int n = 0; n < n_tiles; ++n) {
    if (n + 1 < n_tiles) {
      float* next = kv + ((n + 1) & 1) * 2 * FWD_K * LD;
      load_tile<FWD_K, FWD_THREADS>(next, kb, (n + 1) * FWD_K, p.tk);
      load_tile<FWD_K, FWD_THREADS>(next + FWD_K * LD, vb, (n + 1) * FWD_K, p.tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = kv + (n & 1) * 2 * FWD_K * LD;
    const float* vs = ks + FWD_K * LD;

    // S = Q Kᵀ: 16 rows x FWD_K keys for this warp
    float s[FWD_K / 8][4];
#pragma unroll
    for (int j = 0; j < FWD_K / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      frag_a(qs, r0, 8 * kk, g, t, ah, al);
#pragma unroll
      for (int j = 0; j < FWD_K / 8; ++j) {
        uint32_t bh2[2], bl2[2];
        frag_b_nmajor(ks, 8 * j, 8 * kk, g, t, bh2, bl2);
        mma3(s[j], ah, al, bh2, bl2);
      }
    }
    if (fwd_tile_masked(n, q0, p.tk, p.causal)) {
#pragma unroll
      for (int j = 0; j < FWD_K / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n * FWD_K + 8 * j + 2 * t + (e & 1);
          if (key >= p.tk || (p.causal && key > row[e >> 1])) s[j][e] = -INFINITY;
        }
    }
    float corr[2] = {1.f, 1.f};
    if (!DELTA) {
      // Every row sees key 0 in tile 0, so the running max is finite from then on.
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < FWD_K / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = quad_max(mx[h]);
        corr[h] = exp2f((m[h] - mx[h]) * c);  // 0 on the first tile (m = -inf)
        m[h] = mx[h];
        mc[h] = mx[h] * c;
        l[h] *= corr[h];
      }
    }
#pragma unroll
    for (int j = 0; j < FWD_K / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(fmaf(s[j][e], c, -mc[e >> 1]));
        if (!DELTA) l[e >> 1] += s[j][e];
      }

    // O = O corr + P V, P straight from the score accumulators. The tile's
    // P V is summed apart and added to O in f32: the tensor cores' f32
    // accumulation drops low bits, and a chain over every key tile left O
    // several times further from an f64 truth than cuBLAS's f32 (PERF.md).
    float pv[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) pv[j][0] = pv[j][1] = pv[j][2] = pv[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < FWD_K / 8; ++kk) {
      uint32_t ah[4], al[4];
      frag_a_acc(s[kk], ah, al);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t bh2[2], bl2[2];
        frag_b_kmajor(vs, 8 * kk, 8 * j, g, t, bh2, bl2);
        mma3(pv[j], ah, al, bh2, bl2);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = fmaf(o[j][e], corr[e >> 1], pv[j][e]);
    __syncthreads();  // the stage is consumed before the next load overwrites it
  }

  if (!DELTA) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = quad_sum(l[h]);
      if (row[h] >= p.tq) continue;
      const float inv = 1.f / l[h];
      float* op = p.o + (bh * p.tq + row[h]) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(op + 8 * j + 2 * t) =
            make_float2(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
      if (p.lse != nullptr && t == 0) p.lse[bh * p.tq + row[h]] = m[h] * p.scale + logf(l[h]);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float d = 0.f;
      if (row[h] < p.tq) {
        const T* gp = p.g + (bh * p.tq + row[h]) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          d += o[j][2 * h] * to_f32(gp[8 * j + 2 * t]) +
               o[j][2 * h + 1] * to_f32(gp[8 * j + 2 * t + 1]);
      }
      d = quad_sum(d);
      if (row[h] < p.tq && t == 0) p.delta[bh * p.tq + row[h]] = d;
    }
  }
}

template <typename T, bool DELTA>
cudaError_t launch_tf32_forward(const FwdParams<T>& p, int bh, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_tf32_kernel<T, DELTA>, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.tq + FWD_Q - 1) / FWD_Q, bh);  // q tile fastest: a head's blocks run together
  attention_tf32_kernel<T, DELTA><<<grid, FWD_THREADS, FWD_SMEM, s>>>(p);
  return cudaGetLastError();
}

}  // namespace tf32
}  // namespace
