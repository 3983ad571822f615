// Encoder self-attention for Hopper: softmax(q k^T / sqrt(D)) v, D = 64.
//
// Replaces the TPU kernel whisper_tpu/kernels/flash_attention.py
// (flash_attention -> _attn_kernel). That kernel holds one head's whole K and
// V in VMEM and builds a full (768 x T_pad) f32 score tile with no online
// softmax. On this card a block has at most 227 KB of shared memory: K and V
// of one head at T = 1500 are 2 x 188 KB in bf16, and the score tile alone
// would be 4.7 MB. So both kernels here stream K/V tiles through shared
// memory with an online softmax in f32 (running max, running sum).
//
// What bounds it: operations. The score and PV products are 4 * Tq * Tk * D
// flops per head: 92.2 GFLOP for the encoder at batch 8 (160 heads, T = 1500),
// 0.093 ms at the card's 989 TFLOP/s bf16 peak, against 0.04 ms for its
// 123 MB of q, k, v and o at 3.35 TB/s. At D = 64 the softmax's exponentials
// (one per score, on the 16-per-clock special-function unit) take as many
// cycles as the tensor cores' products, so the design keeps both busy:
//
//   * bf16 (the serving path), FlashAttention-3's shape written in PTX. A
//     block owns 192 query rows of one head: three consumer warpgroups of 64
//     rows each and one producer warpgroup, which hands most of its
//     registers to the consumers (setmaxnreg). One producer thread issues
//     TMA tile loads (cp.async.bulk.tensor over a 3-D tensor map (64, T,
//     B*H), 128-byte swizzle, so a tile never crosses into the next head and
//     rows past T arrive as zeros): the Q tile once, then 128-key K and V
//     tiles into a ring of STAGES buffers, each completing on an mbarrier.
//     Each consumer computes S = Q K^T with four wgmma m64n128k16 (Q and K
//     both K-major from shared memory), the online softmax in registers
//     (exp2 with log2(e) / sqrt(D) folded into one FMA; row max and sum over
//     the quad that shares a row), and O += P V with eight wgmma m64n64k16:
//     P from registers, rounded to bf16 in the accumulator-to-A-fragment
//     layout, V from shared memory as an MN-major operand (wgmma's
//     transpose flag), so V is never transposed by hand. The consumers take
//     turns to issue their products (named barriers), so the tensor cores
//     run one warpgroup's products while the others compute exponentials,
//     and each issues the P V product of tile n - 1 beside the score product
//     of tile n, so it overlaps tile n's softmax.
//     Only the last key tile, or under `causal` the diagonal ones, take the
//     per-element mask (zero-filled K rows score 0, so the ragged tile must
//     be masked); tiles wholly past the block's last row are never loaded.
//     The output goes back through shared memory and a TMA store, which
//     clips rows past Tq. Grid (q tiles, B*H) with the q tile fastest: the
//     blocks of one head run together, so its K/V (384 KB at T = 1500) is
//     read from device memory about once and then from L2.
//     kernels/flash_attention.attention_tile_plan states the same tile plan
//     in Python for the tests.
//   * f32 (the parity path): CUDA-core FMAs, one query row per thread, with
//     the q row and the D = 64 accumulator in registers; every thread of a
//     warp reads the same key row, so shared-memory reads are broadcasts, and
//     the online softmax rescales once per CHUNK keys; grid (B*H, q tiles).
//
// Masks match the TPU kernel: keys >= tk never take part (the TPU kernel
// pads K and masks them to -1e30), and the causal rule is key <= q with no
// offset between the query and key positions. Scores and the softmax are in
// f32; the bf16 path rounds the unnormalised probabilities to bf16 for the
// PV product, which accumulates in f32.
//
// The qk_int8 variant (K1b; the TPU kernel's _attn_kernel(qk_int8=True),
// which the JAX package wires into no model path) quantizes each row of Q and
// K to int8 (scale max(max|x|, 1e-6) * f32(1/127), codes rint(x / scale)
// clipped to +-127: the TPU kernel's arithmetic as XLA compiles it) in a
// first launch, one warp a row, into scratch the wrapper allocates. The
// attention launch is simple and exact rather than fast, since no model path
// runs it: one query row per thread, its 64 codes in 16 registers, the key
// codes in shared memory read as broadcasts, the int32 score by __dp4a
// (exact, |s| < 2^24), then s32 * (q_scale * D^-0.5) * k_scale in the TPU
// kernel's order, so the f32 scores equal the plain version's bit for bit.
// Three passes over the keys (max, sum, output) give the plain version's
// normalised probabilities exp(s - max) / sum, rounded to v's dtype before
// the PV product (f32 FMAs), with no online rescaling.
//
// Plain C interface, loaded with ctypes by whisper_tpu_torch/kernels/build.py.
// The host encodes the tensor maps with cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint[ByVersion], so no -lcuda is needed.

#include <cuda.h>
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

constexpr int NUM_WG = 3;                  // consumer warpgroups, 64 query rows each
constexpr int BM = 64 * NUM_WG;            // query rows per block
constexpr int BN = 128;                    // keys per K/V tile
constexpr int STAGES = 3;                  // K/V ring depth
constexpr int Q_BYTES = BM * D * 2;        // 24 KB
constexpr int TILE_BYTES = BN * D * 2;     // 16 KB: one K or V tile
constexpr int CONSUMERS = 128 * NUM_WG;
constexpr int THREADS = CONSUMERS + 128;   // and a producer warpgroup
constexpr int BAR_OFFSET = Q_BYTES + 2 * STAGES * TILE_BYTES;
constexpr int SMEM_BYTES = BAR_OFFSET + 128 + 1024;  // tiles, barriers, alignment slack
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One (64 x rows) box of head `bh` starting at row `row` into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(bh)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(0), "r"(row), "r"(bh)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// wgmma shared-memory descriptor of a tile written by TMA with 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// leading offset is unused for these layouts. K-major Q and K tiles step
// through D by adding 32 bytes to the start; the MN-major V tile steps
// through keys by 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>  // wait until at most N committed groups are pending
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators across
// the asynchronous instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) (+)= A (64 x 16) B (16 x 128): A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 64):
// B MN-major in shared memory (transpose flag set).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&h);
}

// Key tiles a block visits, and whether tile n needs the per-element mask:
// the rule of kernels/flash_attention.attention_tile_plan.
__device__ __forceinline__ int key_tiles(int q0, int tq, int tk, int causal) {
  const int n = (tk + BN - 1) / BN;
  return causal ? min(n, (min(q0 + BM, tq) - 1) / BN + 1) : n;
}
__device__ __forceinline__ bool tile_masked(int n, int q0, int tk, int causal) {
  return (n + 1) * BN > tk || (causal && (n + 1) * BN - 1 > q0);
}

// Named barriers: 1 + wg for warpgroup wg's output store, SCHED + wg for its
// turn to issue products.
constexpr int SCHED = 1 + NUM_WG;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// Hand a K/V stage back to the producer: one arrival per consumer warp.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// S = Q K^T: 64 rows x 128 keys, four k-steps of 16 over D.
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_qk(sc, sw128_desc(q + 32 * kk), sw128_desc(k + 32 * kk), kk > 0);
}

// O += P V: eight k-steps of 16 keys.
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[BN / 16][4],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) wgmma_pv(o, pa[kk], sw128_desc(v + kk * 16 * 128));
}

// The online softmax of one score tile, in place: sc[4j + e] (row row0 +
// 8 (e >> 1), key key0 + 8 j + 2 t + (e & 1)) becomes exp2((s - m) *
// scale_log2) under the new running max m; l is rescaled and takes the new
// sum; corr returns the rescale factor of each row's output.
__device__ __forceinline__ void online_softmax(float (&sc)[64], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], float scale_log2, bool masked,
                                               int key0, int row0, int tk, int causal, int t) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * j + 2 * t + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (key >= tk || (causal && key > row)) sc[4 * j + e] = -INFINITY;
      }
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float mc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the 4 threads of a quad share a row
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    // Every row sees key 0 in its first tile, so mx is finite.
    corr[h] = ex2((m[h] - mx[h]) * scale_log2);  // 0 on the first tile (m = -inf)
    m[h] = mx[h];
    mc[h] = mx[h] * scale_log2;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = ex2(fmaf(sc[i], scale_log2, -mc[(i >> 1) & 1]));
    l[(i >> 1) & 1] += sc[i];
  }
}

// The probabilities as bf16 A fragments: the score accumulators of key
// blocks 2kk, 2kk + 1 are the A fragment of keys 16kk .. 16kk + 15.
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    pa[j / 2][2 * (j % 2)] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
attention_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap o_map, int tq, int tk, int causal,
                      float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)));
  const uint32_t q_s = base;
  const uint32_t k_s = base + Q_BYTES;                        // + stage * TILE_BYTES
  const uint32_t v_s = k_s + STAGES * TILE_BYTES;             // + stage * TILE_BYTES
  const uint32_t q_full = base + BAR_OFFSET;
  const uint32_t full = q_full + 8;                           // + stage * 8
  const uint32_t empty = full + 8 * STAGES;                   // + stage * 8

  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int n_tiles = key_tiles(q0, tq, tk, causal);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread issues every load; the warpgroup hands most
    // of its registers to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, Q_BYTES);
      tma_load(q_s, &q_map, q_full, q0, bh);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % STAGES;
        if (n >= STAGES) mbar_wait(empty + 8 * s, ((n / STAGES) - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * TILE_BYTES);
        tma_load(k_s + s * TILE_BYTES, &k_map, full + 8 * s, n * BN, bh);
        tma_load(v_s + s * TILE_BYTES, &v_map, full + 8 * s, n * BN, bh);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;");
    // The warpgroups take turns, in order, to issue their products (named
    // barriers SCHED + wg), so one's products run while the others compute
    // their softmax; within a warpgroup the P V product of tile n - 1 is
    // issued beside the score product of tile n and overlaps its softmax.
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;       // accumulator fragment coordinates
    const int row0 = q0 + 64 * wg + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    const uint32_t q_wg = q_s + wg * (64 * 128);

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
    float l[2] = {0.f, 0.f};              // this thread's share of the running sums
    float sc[64], corr[2];
    uint32_t pa[BN / 16][4];

    const int next = SCHED + (wg + 1) % NUM_WG;  // the warpgroup whose turn follows
    if (wg == NUM_WG - 1) named_arrive(SCHED);  // warpgroup 0 issues first
    mbar_wait(q_full, 0);
    mbar_wait(full, 0);
    named_sync(SCHED + wg);
    wgmma_fence();
    issue_qk(sc, q_wg, k_s);
    wgmma_commit();
    named_arrive(next);
    wgmma_wait<0>();
    fence_regs(sc);
    online_softmax(sc, m, l, corr, scale_log2, tile_masked(0, q0, tk, causal), 0, row0, tk,
                   causal, t);
    pack_p(sc, pa);

    for (int n = 1; n < n_tiles; ++n) {
      const int s = n % STAGES, prev = (n - 1) % STAGES;
      mbar_wait(full + 8 * s, (n / STAGES) & 1);
      named_sync(SCHED + wg);
      wgmma_fence();
      issue_qk(sc, q_wg, k_s + s * TILE_BYTES);
      wgmma_commit();
      issue_pv(o, pa, v_s + prev * TILE_BYTES);
      wgmma_commit();
      named_arrive(next);
      wgmma_wait<1>();  // the score product; P V may still run
      fence_regs(sc);
      online_softmax(sc, m, l, corr, scale_log2, tile_masked(n, q0, tk, causal), n * BN, row0,
                     tk, causal, t);
      wgmma_wait<0>();
      fence_regs(o);
      release(empty + 8 * prev, lane);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
      pack_p(sc, pa);
    }
    named_sync(SCHED + wg);
    fence_regs(o);
    wgmma_fence();
    issue_pv(o, pa, v_s + ((n_tiles - 1) % STAGES) * TILE_BYTES);
    wgmma_commit();
    if (wg != NUM_WG - 1) named_arrive(next);  // the last warpgroup's turn ends the block
    wgmma_wait<0>();
    fence_regs(o);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    // The output of this warpgroup's 64 rows replaces its Q rows in shared
    // memory (its last S product has completed), in the 128-byte swizzle the
    // tensor map expects: 16-byte chunk c of row r sits at chunk c ^ (r % 8).
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    uint8_t* out = base_ptr + wg * (64 * 128);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(out + r * 128 + ((j ^ (r % 8)) * 16) + 4 * t) =
            pack_bf16(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (threadIdx.x % 128 == 0 && q0 + 64 * wg < tq) tma_store(&o_map, q_wg, q0 + 64 * wg, bh);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (bh, t, 64) bf16 tensor at ptr as a 3-D tensor map read in boxes of
// `rows` rows of one head, 128-byte swizzled; rows past t read as zeros and
// are not written.
bool tensor_map(CUtensorMap* map, const void* ptr, int bh, int t, int rows) {
  const cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(t), static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {D * 2, static_cast<cuuint64_t>(t) * D * 2};
  const cuuint32_t box[3] = {D, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int tq,
                        int tk, int causal, float scale, cudaStream_t s) {
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm, om;
  if (!(tensor_map(&qm, q, bh, tq, BM) && tensor_map(&km, k, bh, tk, BN) &&
        tensor_map(&vm, v, bh, tk, BN) && tensor_map(&om, o, bh, tq, 64)))
    return cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((tq + BM - 1) / BM, bh);  // q tile fastest: a head's blocks run together
  attention_bf16_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(qm, km, vm, om, tq, tk, causal,
                                                          scale * LOG2E);
  return cudaGetLastError();
}

// ------------------------------------------------------- qk_int8 path (K1b)

constexpr int Q8_WARPS = 8;     // rows quantized per block, one warp each
constexpr int I8_ROWS = 128;    // threads per block = query rows per block
constexpr int I8_KEYS = 64;     // keys per shared-memory tile
constexpr float INV_127 = 1.0f / 127.0f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ int code_of(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));  // IEEE division, round half to even
  return static_cast<int>(fminf(fmaxf(r, -127.f), 127.f));
}

// codes (rows, 64) int8 and scales (rows,) f32 of the (rows, 64) x.
template <typename T>
__global__ void __launch_bounds__(32 * Q8_WARPS)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ codes,
                     float* __restrict__ scales, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * Q8_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // a whole warp leaves together
  const float a = to_f32(x[row * D + 2 * lane]), b = to_f32(x[row * D + 2 * lane + 1]);
  float amax = fmaxf(fabsf(a), fabsf(b));
#pragma unroll
  for (int off = 16; off; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(amax, 1e-6f) * INV_127;
  char2 c;
  c.x = static_cast<char>(code_of(a, scale));
  c.y = static_cast<char>(code_of(b, scale));
  reinterpret_cast<char2*>(codes + row * D)[lane] = c;
  if (lane == 0) scales[row] = scale;
}

template <typename T>
__global__ void __launch_bounds__(I8_ROWS)
attention_qk_int8_kernel(const int8_t* __restrict__ q8, const float* __restrict__ qs,
                         const int8_t* __restrict__ k8, const float* __restrict__ ks,
                         const T* __restrict__ v, T* __restrict__ o, int tq, int tk, int causal,
                         float scale) {
  __shared__ int kc[I8_KEYS * D / 4];  // a tile's key codes, 16 words a key
  __shared__ float ksc[I8_KEYS];
  __shared__ float vs[I8_KEYS * D];

  const long long bh = blockIdx.x;
  const int row = blockIdx.y * I8_ROWS + threadIdx.x;
  const bool valid = row < tq;
  int qc[D / 4];
  const int* qp = reinterpret_cast<const int*>(q8 + (bh * tq + (valid ? row : 0)) * D);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) qc[i] = qp[i];
  const float qscale = qs[bh * tq + (valid ? row : 0)] * scale;  // (q_scale * D^-0.5)
  // Causal blocks stop at the block's last query row.
  const int kend = causal ? min(tk, (int)(blockIdx.y + 1) * I8_ROWS) : tk;
  const int* kb = reinterpret_cast<const int*>(k8 + bh * tk * D);
  const T* vb = v + bh * tk * D;

  float m = -INFINITY, l = 0.f, acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  // pass 0: the row's max score; pass 1: sum of exp(s - max); pass 2: PV
  for (int pass = 0; pass < 3; ++pass) {
    for (int t0 = 0; t0 < kend; t0 += I8_KEYS) {
      const int n = min(I8_KEYS, kend - t0);
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < I8_KEYS * D / 4; i += I8_ROWS)
        kc[i] = i < n * D / 4 ? kb[(long long)t0 * D / 4 + i] : 0;
      for (int i = threadIdx.x; i < I8_KEYS; i += I8_ROWS)
        ksc[i] = i < n ? ks[bh * tk + t0 + i] : 0.f;
      if (pass == 2)
        for (int i = threadIdx.x; i < I8_KEYS * D; i += I8_ROWS)
          vs[i] = i < n * D ? to_f32(vb[(long long)t0 * D + i]) : 0.f;
      __syncthreads();
      if (!valid) continue;
      const int jend = causal ? min(n, row - t0 + 1) : n;  // keys <= row
      for (int j = 0; j < jend; ++j) {
        int dot = 0;
#pragma unroll
        for (int i = 0; i < D / 4; ++i) dot = __dp4a(qc[i], kc[j * (D / 4) + i], dot);
        const float s = static_cast<float>(dot) * qscale * ksc[j];
        if (pass == 0) {
          m = fmaxf(m, s);
        } else if (pass == 1) {
          l += expf(s - m);
        } else {
          // the normalised probability, rounded to v's dtype
          const float p = to_f32(from_f32<T>(__fdiv_rn(expf(s - m), l)));
          const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 vv = vr[d4];
            acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
            acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
            acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
            acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
          }
        }
      }
    }
  }
  if (valid) {
    T* op = o + (bh * tq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = from_f32<T>(acc[d]);
  }
}

template <typename T>
cudaError_t launch_qk_int8(const void* q, const void* k, const void* v, void* o, void* q8,
                           void* qs, void* k8, void* ks, int bh, int tq, int tk, int causal,
                           float scale, cudaStream_t s) {
  const long long q_rows = static_cast<long long>(bh) * tq, k_rows = static_cast<long long>(bh) * tk;
  quantize_rows_kernel<T><<<(q_rows + Q8_WARPS - 1) / Q8_WARPS, 32 * Q8_WARPS, 0, s>>>(
      static_cast<const T*>(q), static_cast<int8_t*>(q8), static_cast<float*>(qs), q_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quantize_rows_kernel<T><<<(k_rows + Q8_WARPS - 1) / Q8_WARPS, 32 * Q8_WARPS, 0, s>>>(
      static_cast<const T*>(k), static_cast<int8_t*>(k8), static_cast<float*>(ks), k_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + I8_ROWS - 1) / I8_ROWS);
  attention_qk_int8_kernel<T><<<grid, I8_ROWS, 0, s>>>(
      static_cast<const int8_t*>(q8), static_cast<const float*>(qs),
      static_cast<const int8_t*>(k8), static_cast<const float*>(ks), static_cast<const T*>(v),
      static_cast<T*>(o), tq, tk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// The qk_int8 variant: as whisper_flash_attention, with scratch for the
// codes and scales of every row, q8 (bh, tq, 64) and k8 (bh, tk, 64) int8,
// qs (bh, tq) and ks (bh, tk) f32. Three launches on `stream`; returns the
// first cudaError_t that is not success, or 0.
extern "C" int whisper_flash_attention_qk_int8(const void* q, const void* k, const void* v,
                                               void* o, void* q8, void* qs, void* k8, void* ks,
                                               int bh, int tq, int tk, int causal, int is_bf16,
                                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_qk_int8<__nv_bfloat16>(q, k, v, o, q8, qs, k8, ks, bh, tq, tk, causal,
                                              scale, s)
              : launch_qk_int8<float>(q, k, v, o, q8, qs, k8, ks, bh, tq, tk, causal, scale, s);
  return static_cast<int>(err);
}

// q (bh, tq, 64), k and v (bh, tk, 64), o (bh, tq, 64): contiguous, one dtype
// (f32 when is_bf16 == 0, bf16 otherwise, 16-byte aligned). Launches on
// `stream` and returns the cudaError_t of the launch (0 on success); it does
// not synchronise.
extern "C" int whisper_flash_attention(const void* q, const void* k, const void* v,
                                       void* o, int bh, int tq, int tk, int causal,
                                       int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return static_cast<int>(launch_bf16(q, k, v, o, bh, tq, tk, causal, scale, s));
  const dim3 grid(bh, (tq + F32_ROWS - 1) / F32_ROWS);
  attention_f32_kernel<<<grid, F32_ROWS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), tq, tk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
