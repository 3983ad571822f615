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
// What bounds it: at decode (T = 1..5 query rows) each (b, h) reads 2 * 64 * C
// bytes of int8 K/V and does ~4 flops per byte, far below the card's balance
// point: a memory-bound stream (7.9 GB of cross memory per large-v3 step at
// batch 64, 78 us at 3.35 TB/s). The TPU kernel dequantized whole K/V blocks
// in VMEM. Here a thread-block cluster of `ranks` blocks owns one (b, h) and
// up to ROWS query rows; rank i owns keys [i * chunk, (i + 1) * chunk) of the
// keys the call can see (chunk a multiple of 4; the plan is
// kernels/cross_attention_int8.py:cross_attention_int8_plan):
//   0. at block start the rank issues every byte of its K and V range (and
//      their scales) into shared memory with cp.async, K in one group and V in
//      the next. A row of K starts at d * C, which is only 4-byte aligned at
//      C = 1500 (and byte aligned in the self cache), so each row is copied in
//      16-byte pieces from its aligned start and read back at its byte shift
//      (a funnel shift of two words);
//   1. once K has landed, each thread dots four keys (one 32-bit word of
//      codes) with the ROWS query rows, a sequential f32 sum over d = 0..63 as
//      the plain product takes it (a split of d moves logits by an ulp, which
//      moves the bf16 rounding of p and an f32 output past K4_TOL); V lands
//      meanwhile;
//   2. the rank's logits (scaled, masked) give a local max per row; the ranks
//      exchange them through distributed shared memory, each takes the global
//      max, writes exp(logit - max), and the ranks exchange the sums the same
//      way. Only then is bf16(p / sum * v_scale) rounded, exactly as pv_out
//      rounds the normalised probability: a split that rescaled partial
//      outputs after the rounding (flash decoding) would round other numbers;
//   3. P.V. For several query rows (a prefill, the beam fold) on the tensor
//      cores: p is exactly bf16 and an int8 code is exact in bf16, so
//      mma.sync m16n8k16 (bf16 in, f32 sums) takes pv_out's own product, with
//      the query rows as M (zero rows up to 16), 16 keys as K and warp w's
//      eight output columns as N. For one row (a greedy step), where a
//      product's A would be 15/16 zeros, on the CUDA cores: each warp takes
//      eight columns, its lanes four keys at a time, reduced by shuffles. The
//      ranks' partial rows are summed through distributed shared memory,
//      each rank writing 64 / ranks columns.
// Every exchange is a push: a rank stores its values into each peer's shared
// memory, then a cluster barrier, then each rank reads only its own. So there
// are three barriers (and one at the start, waited on only after step 1), no
// block reads a peer's shared memory, and none can leave while a peer still
// has to store into its own.
// int8 -> f32 takes no conversion unit: a byte permute puts each code (+128)
// under the exponent of 2^23 and one subtraction leaves the exact integer, so
// four codes cost four PRMT and four FADD, shared by the ROWS query rows (and
// two more PRMT take the bf16 halves for the tensor cores).
// Keys past the last row's causal limit are neither copied nor computed; a
// masked logit contributes exp(-1e30 - max) = 0, which leaves every sum as it
// was. The serving engine's slots each carry their own position: a ragged
// self call reads row b's n_past from device memory, its plan is sized for
// the whole cache, and a rank whose keys lie wholly past its row's limit
// copies nothing and pushes a max of -1e30 and a sum of 0 (rank 0 always
// holds key 0, so the global max is finite and no sum is 0). The launch has no host sync and allocates nothing, so it can be
// captured in a CUDA graph.
//
// Plain C interface, loaded with ctypes by whisper_tpu_torch/kernels/build.py.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int D = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // one warp per 8 output columns in step 3
constexpr int MAX_RANKS = 8;         // the portable cluster size
constexpr int MAX_CHUNK = 1024;      // keys a rank holds (cross_attention_int8.py MAX_CHUNK)
constexpr float MASKED = -1e30f;
static_assert(WARPS * 8 == D, "step 3 gives each warp one n-tile of eight columns");

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Shared memory of one block, in floats then int8 rows (every region
// 16-byte aligned: chunk is a multiple of 4).
struct Layout {
  int pitch;    // bytes per int8 row: the rank's keys and up to 15 bytes of
                // shift, = 16 mod 128 so that step 3's eight rows hit 32 banks
  int pstride;  // bf16 p per row: chunk rounded up to a 16-key step
  int qs, lg, pb, part, mx, sm, in, stat, ksc, vsc, floats;
  size_t bytes;
};

__host__ __device__ inline Layout layout(int rows, int chunk, int ranks) {
  Layout l;
  l.pitch = (chunk + 15 + 15) & ~15;
  l.pitch += (144 - l.pitch % 128) % 128;
  l.pstride = (chunk + 15) & ~15;
  l.qs = 0;                                    // [rows][64] query rows
  l.lg = l.qs + rows * D;                      // [rows][chunk] logits, then exp
  l.pb = l.lg + rows * chunk;                  // [rows][pstride] bf16 p * v_scale (rows > 1)
  l.part = l.pb + (rows > 1 ? rows * l.pstride / 2 : 0);  // [rows][64] this rank's P.V
  l.mx = l.part + rows * D;                    // [ranks][WARPS][rows] pushed row max
  l.sm = l.mx + ranks * WARPS * rows;          // [ranks][WARPS][rows] pushed row sums
  l.in = l.sm + ranks * WARPS * rows;          // [ranks][rows][64] pushed P.V parts
  l.stat = l.in + ranks * rows * D;            // [2][rows] global max, sum
  l.ksc = l.stat + ((2 * rows + 3) & ~3);      // [chunk] k_scale
  l.vsc = l.ksc + chunk;                       // [chunk] v_scale
  l.floats = l.vsc + chunk;
  // 32 bytes past V: step 3 reads a last 16-key step whole
  l.bytes = sizeof(float) * static_cast<size_t>(l.floats)
            + 2 * D * static_cast<size_t>(l.pitch) + 32;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Byte shift of row d of a (64, c_len) int8 block at `base` from its 16-byte
// aligned start.
__device__ __forceinline__ int row_shift(const int8_t* base, int c_len, int d) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(base) + static_cast<uintptr_t>(d) * c_len)
                          & 15);
}

// Copy n keys of each of the 64 rows of `src` (row pitch c_len) into rows of
// `pitch` bytes at `dst`, each in 16-byte pieces from its aligned start, and
// n f32 scales.
__device__ __forceinline__ void issue_rows(int8_t* dst, const int8_t* src, int c_len, int n,
                                           int pitch, float* sdst, const float* ssrc) {
  const int pieces = (n + 15 + 15) / 16;  // a row's span, at most
  for (int i = threadIdx.x; i < D * pieces; i += THREADS) {
    const int d = i / pieces, piece = i % pieces;
    const uintptr_t a = reinterpret_cast<uintptr_t>(src) + static_cast<uintptr_t>(d) * c_len;
    const uintptr_t a0 = a & ~uintptr_t(15);
    const uintptr_t a1 = (a + n + 15) & ~uintptr_t(15);
    if (a0 + 16 * piece < a1) {
      cp_async16(dst + d * pitch + 16 * piece, reinterpret_cast<const void*>(a0 + 16 * piece));
    }
  }
  for (int c = threadIdx.x; c < n; c += THREADS) cp_async4(sdst + c, ssrc + c);
}

// The codes of keys 4j .. 4j + 3 of a row copied at byte shift `shift`
// (ALIGNED: a multiple of 4, so one word).
template <bool ALIGNED>
__device__ __forceinline__ uint32_t quad(const int8_t* row, int shift, int j) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (shift >> 2) + j;
  if (ALIGNED) return w[0];
  return __funnelshift_r(w[0], w[1], 8 * (shift & 3));
}

// Four int8 codes to exact f32: code + 128 under the exponent of 2^23.
__device__ __forceinline__ void to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// Four int8 codes to two bf16 pairs: an integer below 2^8 is exact in bf16,
// the high half of its f32.
__device__ __forceinline__ void to_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  float f[4];
  to_f32(w, f);
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// c += A B on the tensor cores, A (16 x 16 bf16) with only rows 0..7 nonzero
// (a0: row g, k 2t, 2t+1; a2: row g, k 2t+8, 2t+9), B (16 x 8 bf16).
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Step 1: the raw logits of the rank's key quads, each a sequential f32 sum
// over d = 0..63 (the order of a plain f32 product, which keeps the logits,
// and so the bf16 rounding of p, where the plain version has them).
template <int ROWS, bool ALIGNED>
__device__ __forceinline__ void logits_pass(const float* qs, const int8_t* kt, int pitch,
                                            const int8_t* kb, int c_len, int nq, int chunk,
                                            float* lg) {
  for (int j = threadIdx.x; j < nq; j += THREADS) {
    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < D; d0 += 4) {
      float4 qv[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) qv[r] = *reinterpret_cast<const float4*>(qs + r * D + d0);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const int d = d0 + dd;
        float f[4];
        to_f32(quad<ALIGNED>(kt + d * pitch, row_shift(kb, c_len, d), j), f);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float q1 = dd == 0 ? qv[r].x : dd == 1 ? qv[r].y : dd == 2 ? qv[r].z : qv[r].w;
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[r][x] = fmaf(q1, f[x], acc[r][x]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      *reinterpret_cast<float4*>(lg + r * chunk + 4 * j) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

// Step 3 for one query row, on the CUDA cores: warp w takes columns
// d = w + WARPS * i, its lanes key quads, reduced by shuffles into part[d].
template <bool ALIGNED>
__device__ __forceinline__ void pv_pass_row(const float* p, const int8_t* vt, int pitch,
                                            const int8_t* vb, int c_len, int nq, float* part) {
  constexpr int DW = D / WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[DW];
#pragma unroll
  for (int i = 0; i < DW; ++i) acc[i] = 0.f;
  for (int j = lane; j < nq; j += 32) {
    const float4 pj = *reinterpret_cast<const float4*>(p + 4 * j);
#pragma unroll
    for (int i = 0; i < DW; ++i) {
      const int d = warp + WARPS * i;
      float f[4];
      to_f32(quad<ALIGNED>(vt + d * pitch, row_shift(vb, c_len, d), j), f);
      acc[i] = fmaf(pj.w, f[3], fmaf(pj.z, f[2], fmaf(pj.y, f[1], fmaf(pj.x, f[0], acc[i]))));
    }
  }
#pragma unroll
  for (int i = 0; i < DW; ++i) {
    const float v = warp_sum(acc[i]);
    if (lane == 0) part[warp + WARPS * i] = v;
  }
}

// Step 3 for several query rows, on the tensor cores: out[r, 8w + n] +=
// sum_c p[r, c] * v8[8w + n, c] over the rank's `steps` 16-key steps, warp w
// one n-tile. Lane (g, t) feeds keys 4t .. 4t + 3 of each step as its four k
// (2t, 2t + 1, 2t + 8, 2t + 9): one word of V's row 8w + g and two bf16
// pairs of p's row g, the same permutation on both sides of the sum. Two
// accumulators take the even and odd steps. Lane (g, t) holds row g,
// columns 8w + 2t and 8w + 2t + 1, and writes them to part[g][.].
template <int ROWS, bool ALIGNED>
__device__ __forceinline__ void pv_pass_rows(const __nv_bfloat16* pb, int pstride,
                                             const int8_t* vt, int pitch, const int8_t* vb,
                                             int c_len, int steps, float* part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int d = 8 * warp + g;
  const int8_t* vrow = vt + d * pitch;
  const int shift = row_shift(vb, c_len, d);
  const __nv_bfloat16* prow = pb + (g < ROWS ? g : 0) * pstride + 4 * t;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  auto step = [&](int s, float(&c)[4]) {
    uint2 a = make_uint2(0u, 0u);
    if (g < ROWS) a = *reinterpret_cast<const uint2*>(prow + 16 * s);
    uint32_t b0, b1;
    to_bf16x2(quad<ALIGNED>(vrow, shift, 4 * s + t), b0, b1);
    mma_bf16(c, a.x, a.y, b0, b1);
  };
  int s = 0;
  for (; s + 1 < steps; s += 2) {
    step(s, acc[0]);
    step(s + 1, acc[1]);
  }
  if (s < steps) step(s, acc[0]);
  if (g < ROWS) {
    part[g * D + 8 * warp + 2 * t] = acc[0][0] + acc[1][0];
    part[g * D + 8 * warp + 2 * t + 1] = acc[0][1] + acc[1][1];
  }
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(THREADS)
attention_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k8,
                      const float* __restrict__ ks, const int8_t* __restrict__ v8,
                      const float* __restrict__ vs, T* __restrict__ out, int n_head, int tq,
                      int c_len, long long data_bstride, long long scale_bstride, int n_past_all,
                      const int* __restrict__ n_past_rows, int chunk) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Layout lay = layout(ROWS, chunk, ranks);
  float* qs = smem + lay.qs;
  float* lg = smem + lay.lg;
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(smem + lay.pb);
  float* mx = smem + lay.mx;
  float* sm = smem + lay.sm;
  float* in = smem + lay.in;
  float* stat = smem + lay.stat;
  float* ksc = smem + lay.ksc;
  float* vsc = smem + lay.vsc;
  int8_t* kt = reinterpret_cast<int8_t*>(smem + lay.floats);
  int8_t* vt = kt + D * lay.pitch;

  const int bh = blockIdx.x / ranks;
  const int b = bh / n_head, h = bh % n_head;
  // this row's position (< 0: cross-attention, every key): its own from
  // device memory when the call is ragged
  const int n_past = n_past_rows != nullptr ? n_past_rows[b] : n_past_all;
  const int t0 = blockIdx.y * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this rank's keys that any of this block's rows can see
  const int k0 = rank * chunk;
  int k1 = min(c_len, k0 + chunk);
  if (n_past >= 0) k1 = min(k1, n_past + min(t0 + ROWS, tq));
  const int n = max(0, k1 - k0);
  const int n4 = (n + 3) & ~3;     // whole quads; the keys past n are zeroed in step 2
  const int n16 = (n + 15) & ~15;  // whole 16-key steps of step 3

  const int8_t* kb = k8 + b * data_bstride + (long long)h * D * c_len + k0;
  const int8_t* vb = v8 + b * data_bstride + (long long)h * D * c_len + k0;
  const float* ksb = ks + b * scale_bstride + (long long)h * c_len + k0;
  const float* vsb = vs + b * scale_bstride + (long long)h * c_len + k0;

  // Peers store into this block's shared memory from step 2 on, which is safe
  // once every block of the cluster runs: arrive now, wait before step 2.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // 0. every byte of the rank's K (group 0) and V (group 1) in flight at once
  if (n > 0) issue_rows(kt, kb, c_len, n, lay.pitch, ksc, ksb);
  cp_async_commit();
  if (n > 0) issue_rows(vt, vb, c_len, n, lay.pitch, vsc, vsb);
  cp_async_commit();
  // Query rows past tq are zeros: their (unused) softmax stays finite.
  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    const int r = i / D;
    qs[i] = (t0 + r < tq) ? load_f32(q + ((long long)bh * tq + t0 + r) * D + i % D) : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();

  // 1. raw logits; V lands meanwhile. Rows of K and V start 4-byte aligned
  // when the blocks and C are (the cross memory: 1500 keys), and a quad is
  // then one word.
  const bool aligned = ((reinterpret_cast<uintptr_t>(kb) | reinterpret_cast<uintptr_t>(vb)
                         | static_cast<uintptr_t>(c_len)) & 3) == 0;
  if (aligned) {
    logits_pass<ROWS, true>(qs, kt, lay.pitch, kb, c_len, n4 / 4, chunk, lg);
  } else {
    logits_pass<ROWS, false>(qs, kt, lay.pitch, kb, c_len, n4 / 4, chunk, lg);
  }
  __syncthreads();

  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // 2a. scaled, masked logits; each warp's max per row pushed to every rank
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float m = MASKED;
    for (int c = threadIdx.x; c < n4; c += THREADS) {
      float l = MASKED;
      if (c < n && (n_past < 0 || k0 + c <= n_past + t0 + r)) l = lg[r * chunk + c] * ksc[c];
      lg[r * chunk + c] = l;
      m = fmaxf(m, l);
    }
    m = warp_max(m);
    if (lane < ranks) cluster.map_shared_rank(mx, lane)[(rank * WARPS + warp) * ROWS + r] = m;
  }
  cluster.sync();
  if (warp == 0) {  // the global max, the same in every rank
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float m = MASKED;
      for (int i = lane; i < ranks * WARPS; i += 32) m = fmaxf(m, mx[i * ROWS + r]);
      m = warp_max(m);
      if (lane == 0) stat[r] = m;
    }
  }
  __syncthreads();

  // 2b. exp(logit - global max); each warp's sum per row pushed to every rank
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float m = stat[r];
    float s = 0.f;
    for (int c = threadIdx.x; c < n4; c += THREADS) {
      const float e = c < n ? expf(lg[r * chunk + c] - m) : 0.f;
      lg[r * chunk + c] = e;
      s += e;
    }
    s = warp_sum(s);
    if (lane < ranks) cluster.map_shared_rank(sm, lane)[(rank * WARPS + warp) * ROWS + r] = s;
  }
  cluster.sync();
  if (warp == 0) {  // the global sum, added in the same order in every rank
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float s = 0.f;
      for (int i = lane; i < ranks * WARPS; i += 32) s += sm[i * ROWS + r];
      s = warp_sum(s);
      if (lane == 0) stat[ROWS + r] = s;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 2c. bf16(p * v_scale) of the normalised p, as pv_out rounds it: in place
  // for one row; for more, as bf16 with zeros up to the last 16-key step
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float s = stat[ROWS + r];
    for (int c = threadIdx.x; c < (ROWS == 1 ? n4 : n16); c += THREADS) {
      const __nv_bfloat16 pv =
          __float2bfloat16_rn(c < n ? (lg[r * chunk + c] / s) * vsc[c] : 0.f);
      if constexpr (ROWS == 1) {
        lg[c] = __bfloat162float(pv);
      } else {
        pb[r * lay.pstride + c] = pv;
      }
    }
  }
  __syncthreads();

  // 3. this rank's part of P.V, pushed to the rank that writes its columns
  float* part = smem + lay.part;
  if constexpr (ROWS == 1) {
    if (aligned) {
      pv_pass_row<true>(lg, vt, lay.pitch, vb, c_len, n4 / 4, part);
    } else {
      pv_pass_row<false>(lg, vt, lay.pitch, vb, c_len, n4 / 4, part);
    }
  } else {
    if (aligned) {
      pv_pass_rows<ROWS, true>(pb, lay.pstride, vt, lay.pitch, vb, c_len, n16 / 16, part);
    } else {
      pv_pass_rows<ROWS, false>(pb, lay.pstride, vt, lay.pitch, vb, c_len, n16 / 16, part);
    }
  }
  __syncthreads();
  const int per = (D + ranks - 1) / ranks;  // columns each rank writes
  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    const int r = i / D, d = i % D;
    cluster.map_shared_rank(in, d / per)[(rank * ROWS + r) * D + d] = part[i];
  }
  cluster.sync();  // the last barrier: every read below is of this block's own memory

  // the ranks' parts summed in rank order; rank i writes its share of d
  for (int i = threadIdx.x; i < ROWS * per; i += THREADS) {
    const int r = i / per, col = rank * per + i % per;
    if (col < D && t0 + r < tq) {
      float o = 0.f;
      for (int k = 0; k < ranks; ++k) o += in[(k * ROWS + r) * D + col];
      store(out + ((long long)bh * tq + t0 + r) * D + col, o);
    }
  }
}

template <typename T, int ROWS>
cudaError_t launch(const void* q, const void* k8, const void* ks, const void* v8, const void* vs,
                   void* out, int batch, int n_head, int tq, int c_len, long long data_bstride,
                   long long scale_bstride, int n_past, const int* n_past_rows, int ranks,
                   int chunk, cudaStream_t s) {
  if (ranks < 1 || ranks > MAX_RANKS || chunk < 4 || chunk % 4 != 0 || chunk > MAX_CHUNK) {
    return cudaErrorInvalidValue;
  }
  const Layout lay = layout(ROWS, chunk, ranks);
  auto kernel = attention_int8_kernel<T, ROWS>;
  // once per instantiation: allow the largest layout a launch can ask for
  // (MAX_CHUNK keys, MAX_RANKS ranks); each launch takes only its own size
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(layout(ROWS, MAX_CHUNK, MAX_RANKS).bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * n_head * ranks, (tq + ROWS - 1) / ROWS);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const int8_t*>(k8),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v8),
      static_cast<const float*>(vs), static_cast<T*>(out), n_head, tq, c_len, data_bstride,
      scale_bstride, n_past, n_past_rows, chunk);
  const cudaError_t last = cudaGetLastError();  // read (and clear) either way
  return err != cudaSuccess ? err : last;
}

template <typename T>
cudaError_t dispatch(int rows, const void* q, const void* k8, const void* ks, const void* v8,
                     const void* vs, void* out, int batch, int n_head, int tq, int c_len,
                     long long data_bstride, long long scale_bstride, int n_past,
                     const int* n_past_rows, int ranks, int chunk, cudaStream_t s) {
#define WHISPER_K4_ROWS(R)                                                                   \
  case R:                                                                                    \
    return launch<T, R>(q, k8, ks, v8, vs, out, batch, n_head, tq, c_len, data_bstride,      \
                        scale_bstride, n_past, n_past_rows, ranks, chunk, s);
  switch (rows) {
    WHISPER_K4_ROWS(1)
    WHISPER_K4_ROWS(2)
    WHISPER_K4_ROWS(4)
    WHISPER_K4_ROWS(5)
    WHISPER_K4_ROWS(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef WHISPER_K4_ROWS
}

}  // namespace

// q and out (batch, n_head, tq, 64) contiguous, f32 (is_bf16 == 0) or bf16;
// k8/v8 int8 at [b * data_bstride + (h * 64 + d) * c_len + c]; k_scale/v_scale
// f32 at [b * scale_bstride + h * c_len + c]. n_past < 0 and n_past_rows
// null: every key attends (cross-attention); otherwise key c attends query t
// of row b iff c <= n_past[b] + t, where n_past[b] is n_past_rows[b] (a
// (batch,) int32 array on the device, each >= 0: the serving engine's
// slots) or n_past. A ragged call's plan covers every key of the cache
// (cross_attention_int8_plan(c_len, tq, c_len - tq)); each rank still copies
// only the keys of its range that its row can see, and a rank with none
// adds a max of -1e30 and a sum of 0 to the cluster's exchange.
// rows (1, 2, 4, 5 or 8) query rows per cluster; ranks (1..8) blocks per
// cluster, rank i holding keys [i * chunk, (i + 1) * chunk) of those the call
// sees (chunk a multiple of 4, at most 1024). Launches on `stream` and
// returns the cudaError_t of the launch (0 on success); it does not
// synchronise.
extern "C" int whisper_attention_int8(const void* q, const void* k8, const void* k_scale,
                                      const void* v8, const void* v_scale, void* out, int batch,
                                      int n_head, int tq, int c_len, long long data_bstride,
                                      long long scale_bstride, int n_past,
                                      const int* n_past_rows, int rows, int ranks, int chunk,
                                      int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(rows, q, k8, k_scale, v8, v_scale, out, batch, n_head, tq,
                                        c_len, data_bstride, scale_bstride, n_past, n_past_rows,
                                        ranks, chunk, s)
              : dispatch<float>(rows, q, k8, k_scale, v8, v_scale, out, batch, n_head, tq,
                                c_len, data_bstride, scale_bstride, n_past, n_past_rows, ranks,
                                chunk, s);
  return static_cast<int>(err);
}
