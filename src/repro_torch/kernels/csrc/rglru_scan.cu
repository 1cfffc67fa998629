// RG-LRU linear recurrence forward for Hopper (sm_90a), CUDA C++ with a plain C entry point.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py::rglru_scan (Pallas
// body `_kernel`):
//
//   h_t = a_t * h_{t-1} + b_t
//
//   a, b (B, S, W), one dtype (f32 or bf16); h0 (B, W) f32
//   ->  hs (B, S, W) in a's dtype, h_fin (B, W) f32; the state is f32.
//
// What bounds it on the card: at recurrentgemma-9b's prefill (B=4, S=2048,
// W=4096, f32 a and b) it reads a and b and writes hs, ~403 MB, ~0.12 ms at
// 3.35 TB/s; its 2 operations per element (~67 MFLOP) are nothing beside
// that: bound by bytes.
//
// What the design does about it (first version, simple and right):
//   * one thread per (b, w) channel with its state in an f32 register; the
//     TPU's chunked associative scan becomes a sequential loop over time;
//   * adjacent threads take adjacent w, so every load and store is
//     coalesced; each chunk of 16 time steps of a and b is loaded into
//     registers before it is used, so 32 loads per thread are in flight;
//   * the ragged edges of S and W are masked, so any S and W work.
// At B=4, W=4096 this is 16,384 threads, under one wave of the card;
// splitting S with a carried state is for a later version.
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
  const void* a; const void* b; const float* h0; void* hs; float* h_fin;
  int S, W;
  // (batch, seq) strides in elements; the last dim of each is contiguous
  long long a_sb, a_ss, b_sb, b_ss;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) rglru_scan_kernel(Params P) {
  const int bb = blockIdx.y;
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= P.W) return;
  const T* a = static_cast<const T*>(P.a) + bb * P.a_sb + w;
  const T* b = static_cast<const T*>(P.b) + bb * P.b_sb + w;
  T* hs = static_cast<T*>(P.hs) + (long long)bb * P.S * P.W + w;
  float h = P.h0[(long long)bb * P.W + w];

  for (int t0 = 0; t0 < P.S; t0 += CH) {
    const int len = min(CH, P.S - t0);
    float ar[CH], br[CH];
#pragma unroll
    for (int r = 0; r < CH; ++r) {
      if (r < len) {
        ar[r] = to_f32(a[(long long)(t0 + r) * P.a_ss]);
        br[r] = to_f32(b[(long long)(t0 + r) * P.b_ss]);
      }
    }
#pragma unroll
    for (int r = 0; r < CH; ++r) {
      if (r < len) {
        h = ar[r] * h + br[r];
        hs[(long long)(t0 + r) * P.W] = from_f32<T>(h);
      }
    }
  }
  P.h_fin[(long long)bb * P.W + w] = h;
}

template <typename T>
cudaError_t launch(const Params& P, int B, cudaStream_t stream) {
  dim3 grid((P.W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<T><<<grid, THREADS, 0, stream>>>(P);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of a, b and hs).  h0 and h_fin are
// contiguous f32.  hs is contiguous (B, S, W).
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int rglru_scan_fwd(
    const void* a, const void* b, const void* h0, void* hs, void* h_fin, int dtype,
    int B, int S, int W, long long a_sb, long long a_ss, long long b_sb, long long b_ss,
    void* stream) {
  Params P{a, b, static_cast<const float*>(h0), hs, static_cast<float*>(h_fin), S, W,
           a_sb, a_ss, b_sb, b_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(P, B, st);
  if (dtype == 1) return (int)launch<bf16>(P, B, st);
  return (int)cudaErrorInvalidValue;
}
