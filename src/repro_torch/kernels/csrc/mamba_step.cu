// Mamba-1 selective state update of one decode step, in place, for Hopper
// (sm_90a), CUDA C++ with a plain C entry point.
//
//   A = -exp(A_log);  h[b,d,n] <- exp(dt[b,d] A[d,n]) h[b,d,n] + dt[b,d] x[b,d] B[b,n]
//   y[b,d] = sum_n h[b,d,n] C[b,n]
//
//   h (B, D, N) f32, contiguous, updated in place; x, dt (B, D) and Bm, Cm
//   (B, N), all f32 or all bf16, each read through both of its strides (on the
//   main path x is a batch-minor view of the conv step's output, and Bm, Cm
//   are slices of the x_proj product); A_log (D, N) f32  ->  y (B, D) in x's
//   dtype.  The arithmetic is f32.  N is 16 (falcon-mamba-7b) or 8 (its
//   reduced form).
//
// Replaces no TPU kernel: the JAX package computes decode as one plain step
// (repro/models/ssm.py, `apply_mamba`'s decode branch), which XLA fuses.  The
// port's plain step is eager PyTorch: each (B, D, N) f32 intermediate (dt*A,
// its exp, dt*x*B, dA*h, the sum, the cache copy, the product with C) is its
// own pass over memory, ~13 passes of 134 MB a layer at falcon-mamba-7b's
// decode of 256 sessions (B=256, D=8192, N=16), and on the H100 they took
// 50.1 of a 76.7 ms step (64 layers).  This kernel reads each state element
// once and writes it once.
//
// What bounds it on the card: the state, 134 MB read and 134 MB written a
// layer, ~80 us at 3.35 TB/s.  The rest is small: x, dt and y 4 MB each in
// bf16, B and C 16 KB, A_log 512 KB (read from L2 by every batch row group).
// Its ~34 M exponentials a layer (and A's, one per (d, n) per four rows) take
// ~10 us of the SFUs, and ~0.2 GFLOP of f32 work ~3 us: memory bounds it.
//
// What the design does about it:
//   * each (b, d) channel's N states (64 B at N = 16) go to N/4 adjacent lanes,
//     one float4 each, so a warp moves 512 contiguous bytes in 16-byte accesses
//     and y is summed with log2(N/4) xor-shuffles;
//   * a thread updates the same channel in ROWS = 4 batch rows: its four state
//     loads are issued before any is used (bytes in flight hide the memory's
//     latency), and A = -exp(A_log) is formed once for the four;
//   * the state is loaded and stored with streaming hints (__ldcs / __stcs):
//     8.6 GB a step has no reuse in the 50 MB L2;
//   * every element is read and written by the same thread, so the update in
//     place needs no second buffer and no synchronisation;
//   * the state update rounds each product and the sum on its own
//     (__fmul_rn, __fadd_rn, no fused multiply-add), as the plain step's
//     separate passes do, so only the exponential's rounding and the order of
//     y's sum over N can differ from it;
//   * the ragged edge of D is masked (a lane past D computes on zeros and
//     stores nothing, so every shuffle has its whole warp); a block's batch
//     rows past B are skipped whole.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int ROWS = 4;            // batch rows a thread updates

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

struct Params {
  float* h; const void* x; const void* dt; const float* A_log; const void* Bm; const void* Cm;
  void* y;
  int B, D;
  long long x_sb, x_sd, dt_sb, dt_sd, B_sb, B_sn, C_sb, C_sn;   // strides in elements
};

// one state: exp(dt a) h + dtx bm, each product and the sum rounded on its own
__device__ __forceinline__ float update(float h, float dt, float a, float dtx, float bm) {
  return __fadd_rn(__fmul_rn(expf(__fmul_rn(dt, a)), h), __fmul_rn(dtx, bm));
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS) mamba_step_kernel(Params P) {
  constexpr int L = N / 4;                     // lanes a channel, a float4 each
  constexpr int CPB = THREADS / L;             // channels a block
  static_assert(N % 4 == 0 && 32 % L == 0, "a channel's lanes lie in one warp");
  const int j = threadIdx.x % L;               // states 4j .. 4j+3
  const int d = blockIdx.x * CPB + threadIdx.x / L;
  const bool live = d < P.D;
  const int b0 = blockIdx.y * ROWS;

  float4 hv[ROWS];
  float4* hp[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int b = b0 + r;
    hp[r] = reinterpret_cast<float4*>(P.h + ((long long)b * P.D + d) * N) + j;
    hv[r] = (live && b < P.B) ? __ldcs(hp[r]) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    const float4 al = __ldg(reinterpret_cast<const float4*>(P.A_log + (long long)d * N) + j);
    a = make_float4(-expf(al.x), -expf(al.y), -expf(al.z), -expf(al.w));
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int b = b0 + r;
    if (b >= P.B) break;                       // the same for the whole block
    float dt = 0.f, x = 0.f, bm[4] = {0.f, 0.f, 0.f, 0.f}, cm[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
      dt = to_f32(static_cast<const T*>(P.dt)[b * P.dt_sb + d * P.dt_sd]);
      x = to_f32(static_cast<const T*>(P.x)[b * P.x_sb + d * P.x_sd]);
      const T* Bp = static_cast<const T*>(P.Bm) + b * P.B_sb + 4 * j * P.B_sn;
      const T* Cp = static_cast<const T*>(P.Cm) + b * P.C_sb + 4 * j * P.C_sn;
#pragma unroll
      for (int i = 0; i < 4; ++i) { bm[i] = to_f32(Bp[i * P.B_sn]); cm[i] = to_f32(Cp[i * P.C_sn]); }
    }
    const float dtx = __fmul_rn(dt, x);
    float4 hn;
    hn.x = update(hv[r].x, dt, a.x, dtx, bm[0]);
    hn.y = update(hv[r].y, dt, a.y, dtx, bm[1]);
    hn.z = update(hv[r].z, dt, a.z, dtx, bm[2]);
    hn.w = update(hv[r].w, dt, a.w, dtx, bm[3]);
    float part = hn.x * cm[0] + hn.y * cm[1] + hn.z * cm[2] + hn.w * cm[3];
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (live) {
      __stcs(hp[r], hn);
      if (j == 0) static_cast<T*>(P.y)[(long long)b * P.D + d] = from_f32<T>(part);
    }
  }
}

template <typename T, int N>
void launch(const Params& P, cudaStream_t stream) {
  constexpr int CPB = THREADS / (N / 4);
  dim3 grid((P.D + CPB - 1) / CPB, (P.B + ROWS - 1) / ROWS);
  mamba_step_kernel<T, N><<<grid, THREADS, 0, stream>>>(P);
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  dtype: 0 f32, 1 bf16.
extern "C" int mamba_step_fwd(float* h, const void* x, const void* dt, const float* A_log,
                              const void* Bm, const void* Cm, void* y, int dtype, int B, int D,
                              int N, long long x_sb, long long x_sd, long long dt_sb,
                              long long dt_sd, long long B_sb, long long B_sn, long long C_sb,
                              long long C_sn, void* stream) {
  Params P{h, x, dt, A_log, Bm, Cm, y, B, D, x_sb, x_sd, dt_sb, dt_sd, B_sb, B_sn, C_sb, C_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && N == 16) launch<float, 16>(P, s);
  else if (dtype == 0 && N == 8) launch<float, 8>(P, s);
  else if (dtype == 1 && N == 16) launch<bf16, 16>(P, s);
  else if (dtype == 1 && N == 8) launch<bf16, 8>(P, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
