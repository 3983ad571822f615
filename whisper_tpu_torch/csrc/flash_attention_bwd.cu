// The attention backward (K1c) for Hopper: dq, dk and dv of
// softmax(q kᵀ / sqrt(D)) v, D = 64, from q, k, v, the output's gradient g
// and the forward's row statistics lse = m / sqrt(D) + log(l).
//
// Replaces the TPU path whisper_tpu/kernels/flash_attention.py:183-213:
// flash_sdpa, a custom_vjp whose forward is the Pallas kernel (pallas_call
// at :141) and whose backward is XLA einsums (_flash_sdpa_bwd) that
// materialise the (Tq, Tk) f32 scores, probabilities and their gradients.
// This kernel is FlashAttention-2's backward: no (Tq, Tk) tensor reaches
// device memory.
//
// What bounds it: operations. Five products of 2·Tq·Tk·D each per head (S =
// Q Kᵀ again, dV, dP, dK and dQ): 57.6 GFLOP at the training path's (40,
// 1500, 64), 0.35 ms as three TF32 products at 495 TFLOP/s, against 0.04 ms
// for its 123 MB of q, k, v, out, g, lse, dq, dk and dv at 3.35 TB/s. The products run in
// split TF32 on mma.sync (attention_tf32.cuh), so f32 inputs keep f32
// accuracy, and bf16 inputs are read as bf16 and computed in f32, as JAX's
// einsums do (preferred_element_type=f32).
//
// Design. A block owns BWD_K = 64 keys of one head (four warps of 16 keys)
// with their dK and dV in registers, and walks the query tiles of BWD_Q =
// 64 rows: S = Q Kᵀ is recomputed as Sᵀ (keys x queries), Pᵀ = exp(Sᵀ /
// sqrt(D) - lse) under the forward's mask (key <= query, aligned top-left;
// keys >= tk), dV += Pᵀ dO, dPᵀ = V dOᵀ, dSᵀ = Pᵀ ⊙ (dPᵀ - delta) / sqrt(D),
// dK += dSᵀ Q, and dQ += dS K. Pᵀ and dSᵀ go from accumulators to the next
// product's A fragments in registers; dSᵀ also goes through shared memory,
// where each warp reads the dS rows of its 16 queries for dQ. The next
// query tile is loaded by cp.async while dQ is computed. Under causal the
// query tiles wholly before the block's first key are skipped, and only
// ragged or diagonal tiles take the per-element mask: the plan is
// kernels/flash_attention.backward_tile_plan.
//
// dQ: f32 atomics into an f32 buffer (zeroed here first): each of the
// ceil(tk / 64) key blocks adds its part of every row. The order of those
// adds changes from run to run, so dq may differ between runs by f32
// rounding; dk and dv are summed in a fixed order. (The deterministic
// alternative, a second kernel over query tiles, costs two more products.)
//
// delta = Σⱼ dPᵢⱼ Pᵢⱼ (JAX's, with P in f32) comes from a first launch: for
// f32 inputs rowsum(g ⊙ out), which equals it to f32 rounding; for bf16
// the forward's output rounded p to bf16 before P V, so the first launch
// recomputes p v in f32 from lse (attention_tf32.cuh, DELTA) and takes
// rowsum(g ⊙ p v).
//
// Plain C interface, loaded with ctypes by whisper_tpu_torch/kernels/build.py.

#include "attention_tf32.cuh"

namespace {

using namespace tf32;

constexpr int BWD_K = 64, BWD_Q = 64, BWD_THREADS = 128;
// K, V, Q, dO, dSᵀ ([key][query]) in rows of LD; lse, delta. Two blocks an SM.
constexpr int BWD_SMEM = (3 * BWD_K + 2 * BWD_Q) * LD * 4 + 2 * BWD_Q * 4;

template <typename T>
struct BwdParams {
  const T* q;
  const T* k;
  const T* v;
  const T* g;
  const float* lse;
  const float* delta;
  float* dq;  // f32, zeroed, added to atomically
  T* dk;
  T* dv;
  int tq, tk, causal;
  float scale;
};

// The query tiles a key block visits (first .. ceil(tq / BWD_Q) - 1), and
// whether tile n takes the per-element mask: the rule of
// kernels/flash_attention.backward_tile_plan.
__device__ __forceinline__ int bwd_first_tile(int k0, int causal) {
  return causal ? k0 / BWD_Q : 0;
}
__device__ __forceinline__ bool bwd_tile_masked(int n, int k0, int tq, int tk, int causal) {
  return k0 + BWD_K > tk || (n + 1) * BWD_Q > tq || (causal && k0 + BWD_K - 1 > n * BWD_Q);
}

// p[0] += a, p[1] += b in device memory, atomically (one vector reduction)
__device__ __forceinline__ void red_add2(float* p, float a, float b) {
  asm volatile("red.relaxed.gpu.global.add.v2.f32 [%0], {%1, %2};" ::"l"(p), "f"(a), "f"(b)
               : "memory");
}

// acc (16 x 64) += a (16 x BWD_Q, accumulators) · b (BWD_Q x 64, k-major in
// shared memory), the product summed on the tensor cores from zero and then
// added to acc in f32
__device__ __forceinline__ void tile_product_add(float (&acc)[D / 8][4],
                                                 const float (&a)[BWD_Q / 8][4], const float* b,
                                                 int g, int t) {
  float tile[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) tile[j][0] = tile[j][1] = tile[j][2] = tile[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < BWD_Q / 8; ++kk) {
    uint32_t ah[4], al[4];
    frag_a_acc(a[kk], ah, al);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      uint32_t bh2[2], bl2[2];
      frag_b_kmajor(b, 8 * kk, 8 * j, g, t, bh2, bl2);
      mma3(tile[j], ah, al, bh2, bl2);
    }
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += tile[j][e];
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, 2) attention_bwd_kernel(const BwdParams<T> p) {
  extern __shared__ float4 smem_f4[];
  float* ks = reinterpret_cast<float*>(smem_f4);
  float* vs = ks + BWD_K * LD;
  float* qs = vs + BWD_K * LD;
  float* dos = qs + BWD_Q * LD;
  float* dst = dos + BWD_Q * LD;  // dSᵀ: [key][query]
  float* lse_s = dst + BWD_K * LD;
  float* delta_s = lse_s + BWD_Q;

  const int k0 = blockIdx.x * BWD_K;
  const long long bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int kr0 = 16 * warp;  // the warp's keys in the tile; the lane's: kr0 + g, kr0 + g + 8
  const int tq = p.tq, tk = p.tk, causal = p.causal;
  const T* qb = p.q + bh * tq * D;
  const T* gb = p.g + bh * tq * D;

  auto load_queries = [&](int n) {
    load_tile<BWD_Q, BWD_THREADS>(qs, qb, n * BWD_Q, tq);
    load_tile<BWD_Q, BWD_THREADS>(dos, gb, n * BWD_Q, tq);
    for (int i = threadIdx.x; i < BWD_Q; i += BWD_THREADS) {
      const int r = n * BWD_Q + i;
      lse_s[i] = r < tq ? p.lse[bh * tq + r] * LOG2E : 0.f;  // in log2 units
      delta_s[i] = r < tq ? p.delta[bh * tq + r] : 0.f;
    }
  };

  load_tile<BWD_K, BWD_THREADS>(ks, p.k + bh * tk * D, k0, tk);
  load_tile<BWD_K, BWD_THREADS>(vs, p.v + bh * tk * D, k0, tk);
  const int first = bwd_first_tile(k0, causal), n_q = (tq + BWD_Q - 1) / BWD_Q;
  if (first < n_q) load_queries(first);
  cp_async_commit();

  const float c = p.scale * LOG2E;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int n = first; n < n_q; ++n) {
    cp_async_wait<0>();
    __syncthreads();
    const int qt0 = n * BWD_Q;

    // Sᵀ = K Qᵀ: this warp's 16 keys x the tile's queries
    float s[BWD_Q / 8][4];
#pragma unroll
    for (int j = 0; j < BWD_Q / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      frag_a(ks, kr0, 8 * kk, g, t, ah, al);
#pragma unroll
      for (int j = 0; j < BWD_Q / 8; ++j) {
        uint32_t bh2[2], bl2[2];
        frag_b_nmajor(qs, 8 * j, 8 * kk, g, t, bh2, bl2);
        mma3(s[j], ah, al, bh2, bl2);
      }
    }
    // Pᵀ = exp(Sᵀ / sqrt(D) - lse), 0 where the forward's mask drops the pair
    const bool masked = bwd_tile_masked(n, k0, tq, tk, causal);
#pragma unroll
    for (int j = 0; j < BWD_Q / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * j + 2 * t + (e & 1);
        float pr = exp2f(fmaf(s[j][e], c, -lse_s[ql]));
        if (masked) {
          const int key = k0 + kr0 + g + 8 * (e >> 1), q = qt0 + ql;
          if (key >= tk || q >= tq || (causal && key > q)) pr = 0.f;
        }
        s[j][e] = pr;
      }
    // dV += Pᵀ dO, the tile's product summed apart and added in f32 (as O
    // in the forward: a tensor-core chain over every query tile loses bits)
    tile_product_add(dv, s, dos, g, t);
    // dPᵀ = V dOᵀ
    float dp[BWD_Q / 8][4];
#pragma unroll
    for (int j = 0; j < BWD_Q / 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      frag_a(vs, kr0, 8 * kk, g, t, ah, al);
#pragma unroll
      for (int j = 0; j < BWD_Q / 8; ++j) {
        uint32_t bh2[2], bl2[2];
        frag_b_nmajor(dos, 8 * j, 8 * kk, g, t, bh2, bl2);
        mma3(dp[j], ah, al, bh2, bl2);
      }
    }
    // dSᵀ = Pᵀ ⊙ (dPᵀ - delta) / sqrt(D), kept in s and stored [key][query]
#pragma unroll
    for (int j = 0; j < BWD_Q / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * j + 2 * t + (e & 1);
        s[j][e] = s[j][e] * (dp[j][e] - delta_s[ql]) * p.scale;
        dst[at(kr0 + g + 8 * (e >> 1), ql)] = s[j][e];
      }
    // dK += dSᵀ Q
    tile_product_add(dk, s, qs, g, t);
    __syncthreads();  // dSᵀ is whole; Q, dO, lse and delta are free
    if (n + 1 < n_q) {
      load_queries(n + 1);
      cp_async_commit();
    }
    // dQ of this warp's 16 query rows: dS K over the block's 64 keys
    float dq[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BWD_K / 8; ++kk) {
      uint32_t ah[4], al[4];
      frag_a_kmajor(dst, 8 * kk, 16 * warp, g, t, ah, al);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t bh2[2], bl2[2];
        frag_b_kmajor(ks, 8 * kk, 8 * j, g, t, bh2, bl2);
        mma3(dq[j], ah, al, bh2, bl2);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = qt0 + 16 * warp + g + 8 * h;
      if (q >= tq) continue;
      float* dqp = p.dq + (bh * tq + q) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) red_add2(dqp + 8 * j, dq[j][2 * h], dq[j][2 * h + 1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + kr0 + g + 8 * h;
    if (key >= tk) continue;
    T* dkp = p.dk + (bh * tk + key) * D + 2 * t;
    T* dvp = p.dv + (bh * tk + key) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(dkp + 8 * j, dk[j][2 * h], dk[j][2 * h + 1]);
      store2(dvp + 8 * j, dv[j][2 * h], dv[j][2 * h + 1]);
    }
  }
}

// delta = rowsum(g ⊙ out) for f32 inputs: one warp a row.
__global__ void __launch_bounds__(256) row_delta_kernel(const float* __restrict__ g,
                                                        const float* __restrict__ o,
                                                        float* __restrict__ delta, long long rows) {
  const long long row = blockIdx.x * 8LL + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // a whole warp leaves together
  const float2 a = reinterpret_cast<const float2*>(g + row * D)[lane];
  const float2 b = reinterpret_cast<const float2*>(o + row * D)[lane];
  float d = a.x * b.x + a.y * b.y;
#pragma unroll
  for (int off = 16; off; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
  if (lane == 0) delta[row] = d;
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* g,
                       const float* lse, float* delta, float* dq, void* dk, void* dv, int bh,
                       int tq, int tk, int causal, float scale, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(dq, 0, sizeof(float) * bh * tq * D, s);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  if constexpr (sizeof(T) == 4) {
    const long long rows = static_cast<long long>(bh) * tq;
    row_delta_kernel<<<(rows + 7) / 8, 256, 0, s>>>(gt, static_cast<const float*>(o), delta, rows);
    err = cudaGetLastError();
  } else {
    const FwdParams<T> fp{qt, kt, vt, nullptr, nullptr, lse, gt, delta, tq, tk, causal, scale};
    err = launch_tf32_forward<T, true>(fp, bh, s);
  }
  if (err != cudaSuccess) return err;
  static bool configured = false;
  if (!configured) {
    err = cudaFuncSetAttribute(attention_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BWD_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const BwdParams<T> bp{qt, kt, vt, gt, lse, delta, dq, static_cast<T*>(dk), static_cast<T*>(dv),
                        tq, tk, causal, scale};
  const dim3 grid((tk + BWD_K - 1) / BWD_K, bh);
  attention_bwd_kernel<T><<<grid, BWD_THREADS, BWD_SMEM, s>>>(bp);
  return cudaGetLastError();
}

}  // namespace

// q, o and g (bh, tq, 64), k and v (bh, tk, 64): contiguous, one dtype (f32
// when is_bf16 == 0, bf16 otherwise, 16-byte aligned); lse and delta (bh,
// tq) f32 (delta is scratch); dq (bh, tq, 64) f32, written here (zeroed,
// then summed by atomics); dk and dv (bh, tk, 64) in the inputs' dtype.
// Three launches on `stream` (a memset, the delta pass, the backward);
// returns the first cudaError_t that is not success, or 0. It does not
// synchronise.
extern "C" int whisper_flash_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* o, const void* g, const float* lse,
                                           float* delta, float* dq, void* dk, void* dv, int bh,
                                           int tq, int tk, int causal, int is_bf16, float scale,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_bwd<__nv_bfloat16>(q, k, v, o, g, lse, delta, dq, dk, dv, bh, tq, tk,
                                          causal, scale, s)
              : launch_bwd<float>(q, k, v, o, g, lse, delta, dq, dk, dv, bh, tq, tk, causal,
                                  scale, s);
  return static_cast<int>(err);
}
