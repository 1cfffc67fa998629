// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry point.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (Pallas body `_kernel`): blocked attention with an online softmax, causal
// and/or sliding-window masks, GQA through the kv-head index.
//
//   q (B, Hq, S, D), k/v (B, Hkv, T, D)  ->  o (B, Hq, S, D) in q's dtype.
//   s = q.k^T * scale in f32; masked scores are -1e30 (causal: col <= row,
//   window: col > row - window, both top-left aligned); running m, l, acc in
//   f32; p is rounded to the input dtype before the PV product; the final
//   divide floors l at 1e-30.  f32 and bf16; head_dim 16, 32, 64, 128, 256.
//
// What bounds it on the card: at the serving prefill shape (B=4, S=T=2048,
// Hq=12, Hkv=2, D=128, bf16, causal) the two products are ~51.5 GFLOP
// (~52 us at 989 TFLOP/s) against ~59 MB of q, k, v and o (~18 us at
// 3.35 TB/s): the kernel is bound by tensor-core operations.
//
// What the design does about it (first version, simple and right):
//   * one thread block of 4 warps per (b*Hq + h, 64-row q tile); each warp
//     owns 16 query rows.  f32 at head_dim 256 takes 32-row q tiles (8 rows
//     a warp): its 64-row tiles need 301,056 bytes of shared memory, above
//     the 232,448 a block may have.  The TPU's sequential kv grid axis becomes a loop
//     inside the block, and the TPU's `pl.when` block skip becomes the loop
//     bounds: causal stops at the diagonal tile, a window starts at the tile
//     holding q_start - window + 1, so local attention stays O(S*W);
//   * bf16 products run on the tensor cores through nvcuda::wmma 16x16x16
//     fragments with f32 accumulation (QK^T and PV); f32 runs scalar FMA;
//   * q, k and v tiles are staged in shared memory with 16-byte loads and
//     padded rows; GQA reads kv head h / (Hq/Hkv) directly, nothing repeated;
//   * the ragged edge is zero-filled and masked, so any S and T work.
//   wgmma, TMA, pipelined loads and warp specialisation are the next steps.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BK = 64;                  // kv rows per loop step
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = BK + 4;             // f32 score tile row stride
constexpr float MASKED = -1e30f;        // the reference's masked score

template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int v = 4; };
template <> struct Pad<bf16> { static constexpr int v = 8; };

template <typename T, int D> struct Layout {
  // query rows per block: 64 (16 a warp, one wmma row tile); 32 for f32 at
  // head_dim 256, whose 64-row tiles do not fit in shared memory
  static constexpr int BQ = (sizeof(T) == 4 && D == 256) ? 32 : 64;
  static constexpr int RW = BQ / WARPS;        // query rows per warp
  static constexpr int LD = D + Pad<T>::v;     // q/k/v tile row stride
  static constexpr int LDP = BK + Pad<T>::v;   // p tile row stride
  static constexpr int LDO = D + 4;            // f32 accumulator row stride
  static constexpr size_t bytes =
      sizeof(T) * (size_t)(BQ * LD + 2 * BK * LD + BQ * LDP) +
      sizeof(float) * (size_t)(BQ * LDS + BQ * LDO);
};

struct Params {
  const void* q; const void* k; const void* v; void* o;
  int Hq, Hkv, S, T;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale;
  int causal, window;
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [row0, row0 + ROWS) of a (rows, D) matrix with row stride `stride`
// (elements) into shared memory; rows at or past `n_rows` are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride,
                                          int row0, int n_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  constexpr int LD = Layout<T, D>::LD;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = (idx % CHUNKS) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// Scores of one warp's 16 rows against the kv tile: s (16, BK) = q (16, D) . k^T.
template <int D>
__device__ __forceinline__ void warp_scores(const float* q, const float* k, float* s, int lane) {
  constexpr int LD = Layout<float, D>::LD;
  for (int i = 0; i < Layout<float, D>::RW; ++i) {
    for (int c = lane; c < BK; c += 32) {
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) acc = fmaf(q[i * LD + d], k[c * LD + d], acc);
      s[i * LDS + c] = acc;
    }
  }
}

template <int D>
__device__ __forceinline__ void warp_scores(const bf16* q, const bf16* k, float* s, int) {
  constexpr int LD = Layout<bf16, D>::LD;
  static_assert(Layout<bf16, D>::RW == 16, "a warp's rows are one wmma tile");
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, q + kd * 16, LD);
      wmma::load_matrix_sync(b, k + n * 16 * LD + kd * 16, LD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(s + n * 16, acc, LDS, wmma::mem_row_major);
  }
}

// acc (16, D) += p (16, BK) . v (BK, D) for one warp's rows.
template <int D>
__device__ __forceinline__ void warp_pv(const float* p, const float* v, float* acc, int lane) {
  constexpr int LD = Layout<float, D>::LD, LDP = Layout<float, D>::LDP, LDO = Layout<float, D>::LDO;
  for (int i = 0; i < Layout<float, D>::RW; ++i) {
    for (int d = lane; d < D; d += 32) {
      float a = acc[i * LDO + d];
#pragma unroll 16
      for (int c = 0; c < BK; ++c) a = fmaf(p[i * LDP + c], v[c * LD + d], a);
      acc[i * LDO + d] = a;
    }
  }
}

template <int D>
__device__ __forceinline__ void warp_pv(const bf16* p, const bf16* v, float* acc, int) {
  constexpr int LD = Layout<bf16, D>::LD, LDP = Layout<bf16, D>::LDP, LDO = Layout<bf16, D>::LDO;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
    wmma::load_matrix_sync(o, acc + n * 16, LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, p + kk * 16, LDP);
      wmma::load_matrix_sync(b, v + kk * 16 * LD + n * 16, LD);
      wmma::mma_sync(o, a, b, o);
    }
    wmma::store_matrix_sync(acc + n * 16, o, LDO, wmma::mem_row_major);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params P) {
  using L = Layout<T, D>;
  constexpr int BQ = L::BQ, RW = L::RW;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BQ * L::LD;
  T* sV = sK + BK * L::LD;
  T* sP = sV + BK * L::LD;
  float* sS = reinterpret_cast<float*>(sP + BQ * L::LDP);
  float* sO = sS + BQ * LDS;

  const int bh = blockIdx.x;
  const int b = bh / P.Hq, h = bh % P.Hq;
  const int hk = h / (P.Hq / P.Hkv);
  // the longest causal rows first: the last q tile is scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* q = static_cast<const T*>(P.q) + b * P.q_sb + h * P.q_sh;
  const T* k = static_cast<const T*>(P.k) + b * P.k_sb + hk * P.k_sh;
  const T* v = static_cast<const T*>(P.v) + b * P.v_sb + hk * P.v_sh;
  T* o = static_cast<T*>(P.o) + b * P.o_sb + h * P.o_sh;

  load_tile<T, D, BQ>(sQ, q, P.q_ss, q0, P.S);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += THREADS) sO[i] = 0.f;
  __syncthreads();                         // q tile and zeroed acc, even with no kv tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * RW;
  const float neg_inf = __int_as_float(0xff800000);
  float m_run[RW], l_run[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) { m_run[i] = MASKED; l_run[i] = 0.f; }

  // kv tiles that hold at least one unmasked score for some row of this tile
  const int kv_end = P.causal ? min(P.T, q0 + BQ) : P.T;
  const int kv_begin = P.window > 0 ? max(0, q0 - P.window + 1) : 0;
  const int kt_end = (kv_end + BK - 1) / BK;

  for (int kt = kv_begin / BK; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                       // the previous tile is consumed
    load_tile<T, D, BK>(sK, k, P.k_ss, k0, P.T);
    load_tile<T, D, BK>(sV, v, P.v_ss, k0, P.T);
    __syncthreads();

    warp_scores<D>(sQ + r0 * L::LD, sK, sS + r0 * LDS, lane);
    __syncwarp();

#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int row = q0 + r0 + i;
      float s[BK / 32];
      float mx = neg_inf;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = lane + 32 * j, col = k0 + c;
        float x = sS[(r0 + i) * LDS + c] * P.scale;
        bool keep = true;
        if (P.causal) keep = col <= row;
        if (P.window > 0) keep = keep && col > row - P.window;
        if (!keep) x = MASKED;
        if (col >= P.T) x = neg_inf;       // past the ragged edge: no weight at all
        s[j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_run[i], warp_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const float p = expf(s[j] - m_new);
        psum += p;
        sP[(r0 + i) * L::LDP + lane + 32 * j] = from_f32<T>(p);
      }
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + warp_sum(psum);
      m_run[i] = m_new;
      for (int d = lane; d < D; d += 32) sO[(r0 + i) * L::LDO + d] *= corr;
    }
    __syncwarp();

    warp_pv<D>(sP + r0 * L::LDP, sV, sO + r0 * L::LDO, lane);
  }
  __syncwarp();

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = q0 + r0 + i;
    if (row < P.S) {
      const float l = fmaxf(l_run[i], 1e-30f);
      T* orow = o + row * P.o_ss;
      for (int d = lane; d < D; d += 32) orow[d] = from_f32<T>(sO[(r0 + i) * L::LDO + d] / l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& P, int B, cudaStream_t stream) {
  constexpr size_t bytes = Layout<T, D>::bytes;
  static_assert(bytes <= 232448, "tile does not fit in shared memory");
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  constexpr int BQ = Layout<T, D>::BQ;
  dim3 grid(B * P.Hq, (P.S + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& P, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(P, B, stream);
    case 32: return launch<T, 32>(P, B, stream);
    case 64: return launch<T, 64>(P, B, stream);
    case 128: return launch<T, 128>(P, B, stream);
    case 256: return launch<T, 256>(P, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last dim is
// contiguous.  Returns the launch's cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int Hq, int Hkv, int S, int T, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, int window, void* stream) {
  Params P{q, k, v, o, Hq, Hkv, S, T,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
           scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(P, B, D, st);
  if (dtype == 1) return (int)dispatch_d<bf16>(P, B, D, st);
  return (int)cudaErrorInvalidValue;
}
