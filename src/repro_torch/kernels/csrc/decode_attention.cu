// Attention decode over a global KV cache: one query row a head against the
// cache's first `length` positions, for Hopper (sm_90a), CUDA C++ with a
// plain C entry point.
//
//   q (B, 1, Hq, D); k, v (B, T, Hkv, D), each read through its strides (on
//   the main path the layer's views of the stacked caches, never copied);
//   length = pos_t + 1 <= T  ->  o (B, 1, Hq, D) contiguous, in q's dtype.
//   Query head h reads kv head h / G (G = Hq / Hkv, 1..16).  s = q.k * scale
//   in f32; positions >= length take no part (the plain path's mask gives them
//   exp(-1e30 - m) = 0); softmax in f32; p is rounded to the input dtype
//   before the PV product, which accumulates in f32.  f32 and bf16; head_dim
//   16, 32, 64, 128, 160, 256.  Nothing is written into the cache.
//
// Replaces no TPU kernel: the JAX package's decode is one plain step
// (src/repro/models/attention.py:146, `decode_attention`), which XLA fuses.
// The port's plain step is eager PyTorch: it repeats the kv heads to the
// query heads, casts the repeated cache to f32, lets einsum lay it out again
// for two batched products on f32 `gemvx` kernels, and does all of it over
// every slot of the grown cache.  In the decode_kv cells (64 sessions, 4,097 to
// 6,144 positions, on the H100) that took 415 of 422 ms a qwen2-1.5b step
// (28 layers, Hkv 2, G 6) and 79 of 95 ms a Jamba step (2 layers, Hkv 8, G 4).
//
// What bounds it on the card: bytes.  One read of the bf16 rows below length,
// K and V: 64 x 4,097 x 2 x 128 x 2 B x 2 = 268 MB a qwen2-1.5b layer (80 us
// at 3.35 TB/s), 1.07 GB a Jamba layer.  Each cache element meets G query
// rows, 4 G operations: 12 to 24 operations a byte, far below the ~295 that
// would make the tensor cores the limit; q, o and the partials are < 3%.
//
// What the design does about it:
//   * one block of 4 warps for one (session, kv head, split of the length):
//     each K and V row is loaded once, for all G query heads that read it;
//   * the query group is the row side of bf16 tensor-core products with f32
//     accumulation (mma.sync m16n8k16, operands by ldmatrix from shared
//     memory), padded to 16 rows: at G 6, FMAs on the CUDA cores would need
//     ~40 TFLOP/s to keep up with the memory, the tensor cores idle at ~5%;
//   * K and V tiles of 64 rows come through a three-stage cp.async ring, 16
//     bytes a thread, rows padded by 16 bytes so that ldmatrix is free of bank
//     conflicts; rows at or past the split's end are not read (zero-filled);
//   * each warp takes 16 rows of every tile (S = Q K^T as two n8 tiles, whose
//     accumulators are, rounded to bf16, the A operand of O += P V), with its
//     own online softmax in the log2 domain (as csrc/flash_attention.cu); the
//     block's four warps are merged exactly through shared memory at the end;
//   * split-T: the wrapper cuts the length into splits so that B x Hkv x
//     splits blocks fill the 132 SMs several waves deep (64 x 2 sessions and kv
//     heads in qwen2-1.5b would fill one wave); with more than one split each
//     block writes its partial (m, l, o) in f32 and a second small kernel
//     merges them exactly (o = sum e^(m_s - M) o_s / sum e^(m_s - M) l_s, as
//     models/attention.py::_merge_partials merges the dry run's ranks); with
//     one split the block writes o itself.  At most two launches a call.
// float32 (reached by checks, tests and the reduced models): a scalar kernel
// with the same blocks, splits and merge, its products and softmax in shared
// memory, 32-row tiles.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int ROWS = 16;            // query rows of a block: the group, padded to one mma tile
constexpr int BN = 64;              // cache rows a bf16 tile: 16 a warp
constexpr int STAGES = 3;           // the bf16 ring's tiles
constexpr int F_BN = 32;            // cache rows a f32 tile: one a lane
constexpr int MERGE_THREADS = 128;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

struct Params {
  const void* q; const void* k; const void* v;
  void* o;                          // (B, Hq, D) contiguous
  float* part_o;                    // (B, Hq, splits, D) f32, unnormalised
  float* part_ml;                   // (B, Hq, splits, 2) f32: m (log2 domain), l
  int Hkv, G, D, length, chunk, splits;
  long long q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;   // strides in elements
  float scale_log2;                 // scale * log2(e)
};

// the block's (session, kv head, split) and the split's positions [begin, end)
struct Work { int b, hk, split, begin, end; };
__device__ __forceinline__ Work work(const Params& P) {
  Work w;
  w.split = blockIdx.x % P.splits;
  const int bh = blockIdx.x / P.splits;
  w.hk = bh % P.Hkv;
  w.b = bh / P.Hkv;
  w.begin = w.split * P.chunk;
  w.end = min(P.length, w.begin + P.chunk);
  return w;
}

// Row r < G of the block's result: o / l into o where the block is the only
// split, else the partial (o, m, l) for the merge.
template <typename T>
__device__ __forceinline__ void put(const Params& P, const Work& w, int r, int d, float o,
                                    float m, float l) {
  const long long bh = (long long)w.b * P.Hkv * P.G + (long long)w.hk * P.G + r;
  if (P.splits == 1) {
    static_cast<T*>(P.o)[bh * P.D + d] = from_f32<T>(o / l);
    return;
  }
  const long long s = bh * P.splits + w.split;
  P.part_o[s * P.D + d] = o;
  if (d == 0) { P.part_ml[2 * s] = m; P.part_ml[2 * s + 1] = l; }
}

// ===========================================================================
// bf16: mma.sync over a cp.async ring
// ===========================================================================

template <int D> struct Cfg {
  static constexpr int LD = D + 8;                  // a row in shared memory, +16 bytes
  static constexpr int TILE = BN * LD;              // elements of one K or V tile
  static constexpr size_t bytes = (size_t)(ROWS * LD + STAGES * 2 * TILE) * sizeof(bf16);
  // after the loop the ring holds each warp's (16, D) accumulator, m and l
  static_assert((size_t)WARPS * ROWS * (D + 2) * sizeof(float) <=
                (size_t)STAGES * 2 * TILE * sizeof(bf16), "the merge fits in the ring");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; nothing read and zeros written when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);       // lo in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// K and V rows p0 .. p0 + BN - 1 into one stage; rows at or past `end` zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* sK, bf16* sV, const bf16* k, const bf16* v,
                                          const Params& P, int p0, int end) {
  constexpr int LD = Cfg<D>::LD, CPR = D / 8;      // 16-byte chunks a row
  for (int i = threadIdx.x; i < BN * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = p0 + r < end;
    const long long p = ok ? p0 + r : p0;            // an address inside the cache either way
    cp_async16(smem_addr(sK + r * LD + c * 8), k + p * P.k_st + c * 8, ok);
    cp_async16(smem_addr(sV + r * LD + c * 8), v + p * P.v_st + c * 8, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) decode_bf16_kernel(Params P) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, TILE = C::TILE, NT = D / 8;   // NT: the output's n8 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* ring = sQ + ROWS * LD;                      // stage s: K at 2s TILE, V at (2s + 1) TILE

  const Work w = work(P);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (w.end - w.begin + BN - 1) / BN;
  const bf16* k = static_cast<const bf16*>(P.k) + w.b * P.k_sb + w.hk * P.k_sh;
  const bf16* v = static_cast<const bf16*>(P.v) + w.b * P.v_sb + w.hk * P.v_sh;
  const bf16* q = static_cast<const bf16*>(P.q) + w.b * P.q_sb + (long long)w.hk * P.G * P.q_sh;

  // the group's query rows, zero rows past G; they join the first tile's group
  for (int i = threadIdx.x; i < ROWS * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool ok = r < P.G;
    cp_async16(smem_addr(sQ + r * LD + c * 8), q + (ok ? r : 0) * P.q_sh + c * 8, ok);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles)
      load_tile<D>(ring + 2 * s * TILE, ring + (2 * s + 1) * TILE, k, v, P, w.begin + s * BN,
                   w.end);
    cp_async_commit();
  }

  // this thread's rows of the warp's 16: g and g + 8; its columns 2t, 2t + 1
  const int g = lane >> 2, t = lane & 3;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // ldmatrix row addresses: lane supplies row (lane & 7) of matrix (lane >> 3)
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t q_addr = smem_addr(sQ + ((mi & 1) * 8 + mr) * LD + (mi >> 1) * 8);
  const int k_off = (warp * 16 + (mi >> 1) * 8 + mr) * LD + (mi & 1) * 8;
  const int v_off = (warp * 16 + (mi & 1) * 8 + mr) * LD + (mi >> 1) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                 // tile `it` is in; every warp is done with tile it - 1
    {
      const int nt = it + STAGES - 1, s = nt % STAGES;
      if (nt < n_tiles)
        load_tile<D>(ring + 2 * s * TILE, ring + (2 * s + 1) * TILE, k, v, P,
                     w.begin + nt * BN, w.end);
      cp_async_commit();
    }
    const int s = it % STAGES;
    const uint32_t k_addr = smem_addr(ring + 2 * s * TILE + k_off);
    const uint32_t v_addr = smem_addr(ring + (2 * s + 1) * TILE + v_off);

    // S (16 rows x 16 cache rows) = Q K^T, as two n8 tiles
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, q_addr + kk * 32);
      ldmatrix_x4(b, k_addr + kk * 32);
      mma(sc[0], a, b[0], b[1]);
      mma(sc[1], a, b[2], b[3]);
    }

    // online softmax in the log2 domain; e indexes (row g or g + 8, column)
    const int p0 = w.begin + it * BN + warp * 16;
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = p0 + j * 8 + 2 * t + (e & 1);
        const float x = col < w.end ? sc[j][e] * P.scale_log2 : neg_inf();
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float base[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      base[r] = m_new == neg_inf() ? 0.f : m_new;  // no row seen yet: weights stay 0
      corr[r] = exp2f(m[r] - base[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = exp2f(sc[j][e] - base[e >> 1]);
        sum[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];   // this thread's columns
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
      acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
    }

    // O (16 x D) += P (16 x 16, rounded to bf16) V (16 x D)
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, v_addr + n * 32);
      mma(acc[2 * n], pa, b[0], b[1]);
      mma(acc[2 * n + 1], pa, b[2], b[3]);
    }
  }

  // merge the four warps: each writes its (16, D) accumulator, m and l
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free
  float* sO = reinterpret_cast<float*>(ring);       // (WARPS, 16, D)
  float* sM = sO + WARPS * ROWS * D;                // (WARPS, 16)
  float* sL = sM + WARPS * ROWS;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* o0 = sO + (warp * ROWS + g) * D + 2 * t;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    o0[8 * n] = acc[n][0];
    o0[8 * n + 1] = acc[n][1];
    o0[8 * D + 8 * n] = acc[n][2];
    o0[8 * D + 8 * n + 1] = acc[n][3];
  }
  if (t == 0) {
    sM[warp * ROWS + g] = m[0]; sM[warp * ROWS + g + 8] = m[1];
    sL[warp * ROWS + g] = l[0]; sL[warp * ROWS + g + 8] = l[1];
  }
  __syncthreads();
  // a split holds a row below `end`, so some warp's m is finite
  for (int i = threadIdx.x; i < P.G * D; i += THREADS) {
    const int r = i / D, d = i % D;
    float M = neg_inf();
#pragma unroll
    for (int u = 0; u < WARPS; ++u) M = fmaxf(M, sM[u * ROWS + r]);
    float o = 0.f, L = 0.f;
#pragma unroll
    for (int u = 0; u < WARPS; ++u) {
      const float f = exp2f(sM[u * ROWS + r] - M);
      o += f * sO[(u * ROWS + r) * D + d];
      L += f * sL[u * ROWS + r];
    }
    put<bf16>(P, w, r, d, o, M, L);
  }
}

// ===========================================================================
// float32: scalar, products and softmax through shared memory
// ===========================================================================

template <int D> struct F32Cfg {
  static constexpr int LD = D + 1;                  // odd: a warp reads 32 rows conflict-free
  // q (16, D), K and V (F_BN, LD), p (16, F_BN), o (16, D), m, l, corr (16)
  static constexpr size_t bytes =
      (size_t)(2 * ROWS * D + 2 * F_BN * LD + ROWS * F_BN + 3 * ROWS) * sizeof(float);
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(THREADS) decode_f32_kernel(Params P) {
  constexpr int LD = F32Cfg<D>::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + ROWS * D;
  float* sV = sK + F_BN * LD;
  float* sP = sV + F_BN * LD;
  float* sO = sP + ROWS * F_BN;
  float* sM = sO + ROWS * D;
  float* sL = sM + ROWS;
  float* sC = sL + ROWS;

  const Work w = work(P);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* k = static_cast<const float*>(P.k) + w.b * P.k_sb + w.hk * P.k_sh;
  const float* v = static_cast<const float*>(P.v) + w.b * P.v_sb + w.hk * P.v_sh;
  const float* q = static_cast<const float*>(P.q) + w.b * P.q_sb + (long long)w.hk * P.G * P.q_sh;
  for (int i = threadIdx.x; i < P.G * D; i += THREADS) {
    sQ[i] = q[(i / D) * P.q_sh + i % D];
    sO[i] = 0.f;
  }
  if (threadIdx.x < ROWS) { sM[threadIdx.x] = neg_inf(); sL[threadIdx.x] = 0.f; }

  for (int p0 = w.begin; p0 < w.end; p0 += F_BN) {
    __syncthreads();                 // q and o are in; the previous tile is consumed
    for (int i = threadIdx.x; i < F_BN * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const bool ok = p0 + r < w.end;
      sK[r * LD + d] = ok ? k[(long long)(p0 + r) * P.k_st + d] : 0.f;
      sV[r * LD + d] = ok ? v[(long long)(p0 + r) * P.v_st + d] : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < P.G * F_BN; i += THREADS) {
      const int r = i / F_BN, c = i % F_BN;
      float a = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) a = fmaf(sQ[r * D + d], sK[c * LD + d], a);
      sP[r * F_BN + c] = p0 + c < w.end ? a * P.scale_log2 : neg_inf();
    }
    __syncthreads();
    for (int r = warp; r < P.G; r += WARPS) {     // a warp a row, a lane a cache row
      const float x = sP[r * F_BN + lane];
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float base = m_new == neg_inf() ? 0.f : m_new;
      const float p = exp2f(x - base);
      sP[r * F_BN + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float corr = exp2f(m_old - base);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < P.G * D; i += THREADS) {
      const int r = i / D, d = i % D;
      float a = sO[i] * sC[r];
#pragma unroll 8
      for (int c = 0; c < F_BN; ++c) a = fmaf(sP[r * F_BN + c], sV[c * LD + d], a);
      sO[i] = a;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P.G * D; i += THREADS) {
    const int r = i / D;
    put<float>(P, w, r, i % D, sO[i], sM[r], sL[r]);
  }
}

// ===========================================================================
// the merge of the splits' partials
// ===========================================================================

// one block a (session, query head): o = sum_s e^(m_s - M) o_s / sum_s e^(m_s - M) l_s
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS) merge_kernel(Params P) {
  const long long bh = blockIdx.x;
  const float* ml = P.part_ml + bh * P.splits * 2;
  const float* po = P.part_o + bh * P.splits * P.D;
  float M = neg_inf();
  for (int s = 0; s < P.splits; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f;
  for (int s = 0; s < P.splits; ++s) L += exp2f(ml[2 * s] - M) * ml[2 * s + 1];
  for (int d = threadIdx.x; d < P.D; d += MERGE_THREADS) {
    float o = 0.f;
    for (int s = 0; s < P.splits; ++s) o += exp2f(ml[2 * s] - M) * po[(long long)s * P.D + d];
    static_cast<T*>(P.o)[bh * P.D + d] = from_f32<T>(o / L);
  }
}

// `ready` holds a bit for each device on which the kernel may already take
// `bytes` of shared memory: the attribute is set once per kernel and device.
template <typename Kernel>
cudaError_t launch_pair(Kernel kernel, size_t bytes, std::atomic<uint64_t>& ready,
                        const Params& P, int B, bool is_bf16, cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const uint64_t bit = uint64_t(1) << (dev & 63);
    if (!(ready.load() & bit)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return err;
      ready.fetch_or(bit);
    }
  }
  kernel<<<B * P.Hkv * P.splits, THREADS, bytes, stream>>>(P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || P.splits == 1) return err;
  if (is_bf16) merge_kernel<bf16><<<B * P.Hkv * P.G, MERGE_THREADS, 0, stream>>>(P);
  else merge_kernel<float><<<B * P.Hkv * P.G, MERGE_THREADS, 0, stream>>>(P);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& P, int B, bool is_bf16, cudaStream_t stream) {
  static_assert(Cfg<D>::bytes <= 232448 && F32Cfg<D>::bytes <= 232448,
                "tiles do not fit in shared memory");
  static std::atomic<uint64_t> ready_bf16{0}, ready_f32{0};
  return is_bf16
      ? launch_pair(decode_bf16_kernel<D>, Cfg<D>::bytes, ready_bf16, P, B, true, stream)
      : launch_pair(decode_f32_kernel<D>, F32Cfg<D>::bytes, ready_f32, P, B, false, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, the last dims
// contiguous; o is (B, Hkv G, D) contiguous; part holds B Hkv G splits (D + 2)
// floats when splits > 1.  Returns the launches' cudaGetLastError() (0 on success).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* part, int dtype,
    int B, int Hkv, int G, int D, int length, int chunk, int splits,
    long long q_sb, long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, float scale, void* stream) {
  const long long n_part = (long long)B * Hkv * G * splits;
  Params P{q, k, v, o, part, part ? part + n_part * D : nullptr, Hkv, G, D, length, chunk, splits,
           q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale * LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool is_bf16 = dtype == 1;
  switch (D) {
    case 16: return (int)launch<16>(P, B, is_bf16, st);
    case 32: return (int)launch<32>(P, B, is_bf16, st);
    case 64: return (int)launch<64>(P, B, is_bf16, st);
    case 128: return (int)launch<128>(P, B, is_bf16, st);
    case 160: return (int)launch<160>(P, B, is_bf16, st);
    case 256: return (int)launch<256>(P, B, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
