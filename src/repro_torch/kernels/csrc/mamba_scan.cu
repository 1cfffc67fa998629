// Mamba-1 selective scan forward for Hopper (sm_90a), CUDA C++ with a plain C entry point.
//
// Replaces the TPU kernel repro/kernels/mamba_scan.py::mamba_scan (Pallas
// body `_kernel`):
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t,   y_t = h_t . C_t
//
//   u, dt (B, S, D); A (D, N) f32; Bm, Cm (B, S, N); h0 (B, D, N) f32 or none
//   ->  y (B, S, D) in u's dtype, h_fin (B, D, N) f32.  u, dt, Bm, Cm are all
//   f32 or all bf16; the arithmetic is f32.  N is 16 (falcon-mamba-7b) or 8
//   (its reduced form).
//
// What bounds it on the card: at falcon-mamba-7b's prefill (B=4, S=2048,
// D=8192, N=16, bf16) it moves ~407 MB (u, dt and y at 134 MB each, the rest
// small), ~0.12 ms at 3.35 TB/s, against ~7.5 GFLOP of f32 work on the CUDA
// cores (dA, dBu, the state update and y_t for each of B*S*D*N elements),
// ~0.11 ms at 67 TFLOP/s: bound by bytes, with the operations close behind.
//
// What the design does about it (first version, simple and right):
//   * one thread per (b, d) channel, its N states and its row of A in f32
//     registers; the TPU's chunked associative scan becomes a sequential loop
//     over time, and dA and dBu are formed in registers, so nothing of size
//     (S, D, N) touches memory, which is the point of the TPU kernel;
//   * 128 adjacent channels per block, so loads of u and dt and stores of y
//     are coalesced; each chunk of 16 time steps is loaded into registers
//     before it is used, so 32 loads per thread are in flight at once;
//   * each chunk's Bm and Cm rows (N values each, shared by every channel) are
//     staged in shared memory by the whole block; Bm and Cm may be strided
//     views (the main path slices them out of one projection);
//   * the ragged edges of S and D are masked, so any S and D work.
// At B=4, D=8192 this is 32,768 threads, an eighth of what the card holds;
// splitting N or S across threads is for a later version.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;   // channels per block
constexpr int CH = 16;         // time steps per chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

struct Params {
  const void* u; const void* dt; const float* A; const void* Bm; const void* Cm;
  const float* h0; void* y; float* h_fin;
  int S, D;
  // (batch, seq) strides in elements; the last dim of each is contiguous
  long long u_sb, u_ss, dt_sb, dt_ss, B_sb, B_ss, C_sb, C_ss;
};

template <typename T, int N>
__global__ void __launch_bounds__(THREADS) mamba_scan_kernel(Params P) {
  __shared__ float sB[CH][N];
  __shared__ float sC[CH][N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < P.D;
  const T* u = static_cast<const T*>(P.u) + b * P.u_sb + d;
  const T* dt = static_cast<const T*>(P.dt) + b * P.dt_sb + d;
  const T* Bm = static_cast<const T*>(P.Bm) + b * P.B_sb;
  const T* Cm = static_cast<const T*>(P.Cm) + b * P.C_sb;
  T* y = static_cast<T*>(P.y) + (long long)b * P.S * P.D + d;
  const long long hidx = ((long long)b * P.D + d) * N;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? P.A[(long long)d * N + n] : 0.f;
    h[n] = (live && P.h0) ? P.h0[hidx + n] : 0.f;
  }

  for (int t0 = 0; t0 < P.S; t0 += CH) {
    const int len = min(CH, P.S - t0);
    __syncthreads();                       // the previous chunk's rows are consumed
    for (int i = threadIdx.x; i < CH * N; i += THREADS) {
      const int r = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (r < len) {
        bv = to_f32(Bm[(long long)(t0 + r) * P.B_ss + n]);
        cv = to_f32(Cm[(long long)(t0 + r) * P.C_ss + n]);
      }
      sB[r][n] = bv;
      sC[r][n] = cv;
    }
    __syncthreads();
    if (!live) continue;

    float ur[CH], dr[CH];
#pragma unroll
    for (int r = 0; r < CH; ++r) {
      if (r < len) {
        ur[r] = to_f32(u[(long long)(t0 + r) * P.u_ss]);
        dr[r] = to_f32(dt[(long long)(t0 + r) * P.dt_ss]);
      }
    }
#pragma unroll
    for (int r = 0; r < CH; ++r) {
      if (r < len) {
        const float dtu = dr[r] * ur[r];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = expf(dr[r] * a[n]) * h[n] + dtu * sB[r][n];
          acc = fmaf(h[n], sC[r][n], acc);
        }
        y[(long long)(t0 + r) * P.D] = from_f32<T>(acc);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) P.h_fin[hidx + n] = h[n];
  }
}

template <typename T>
cudaError_t dispatch_n(const Params& P, int B, int N, cudaStream_t stream) {
  dim3 grid((P.D + THREADS - 1) / THREADS, B);
  switch (N) {
    case 8: mamba_scan_kernel<T, 8><<<grid, THREADS, 0, stream>>>(P); break;
    case 16: mamba_scan_kernel<T, 16><<<grid, THREADS, 0, stream>>>(P); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of u, dt, Bm, Cm and y).  A, h0 and h_fin
// are contiguous f32; h0 may be null (a zero state).  y is contiguous
// (B, S, D).  Returns the launch's cudaGetLastError() (0 on success).
extern "C" int mamba_scan_fwd(
    const void* u, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* h0, void* y, void* h_fin, int dtype, int B, int S, int D, int N,
    long long u_sb, long long u_ss, long long dt_sb, long long dt_ss,
    long long B_sb, long long B_ss, long long C_sb, long long C_ss, void* stream) {
  Params P{u, dt, static_cast<const float*>(A), Bm, Cm, static_cast<const float*>(h0),
           y, static_cast<float*>(h_fin), S, D,
           u_sb, u_ss, dt_sb, dt_ss, B_sb, B_ss, C_sb, C_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_n<float>(P, B, N, st);
  if (dtype == 1) return (int)dispatch_n<bf16>(P, B, N, st);
  return (int)cudaErrorInvalidValue;
}
