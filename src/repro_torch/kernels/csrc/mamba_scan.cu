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
// cores, ~0.11 ms at 67 TFLOP/s.  But each of the B*S*D*N = 1.07e9 state
// elements needs one exponential, and the SFU does 16 a clock per SM:
// ~0.26-0.29 ms at 1.98-1.75 GHz.  The SFU bounds the kernel.
//
// What the design does about it:
//   * G = 2 adjacent lanes share a (b, d) channel and split its N states
//     (8 each at N = 16), so B*D*G threads run (65,536 at the serving shape,
//     against 32,768 with a thread per channel).  Each lane updates its own
//     states; the group sums its partial y_t with log2(G) xor-shuffles.  On
//     the card G = 2 beat G = 4 and 8 at the serving shape (PERF.md): more
//     lanes a channel add shuffles and shared-memory reads per state faster
//     than they add warps;
//   * dA = 2^(dt * a'), with a' = A * log2(e) formed once per state: one FMUL
//     and one ex2.approx per state element, the least the SFU can be given;
//   * time stays sequential inside a thread.  Splitting S across threads
//     would need a carried state whose fix-up costs a second exponential per
//     element (the product of the chunk's dA), doubling the work of the unit
//     that bounds the kernel;
//   * u and dt are read once per group: in each 16-step chunk, lane j of a
//     group loads steps j, j+G, ... and the group shuffles them to each
//     other when needed; likewise lane j keeps y for the steps it loaded and
//     stores them after the chunk.  The next chunk's u, dt, Bm and Cm load
//     into registers while this chunk runs, and a whole chunk's 16 steps are
//     unrolled without a bounds check, so the compiler interleaves them;
//   * each chunk's Bm and Cm rows (N values each, shared by every channel) are
//     staged in shared memory by the whole block; Bm and Cm may be strided
//     views (the main path slices them out of one projection, uncopied);
//   * the ragged edges of S and D are masked (a group past D runs with zeros
//     and stores nothing, so every shuffle has its whole warp), so any S and
//     D work.
// The TPU's chunked associative scan (VMEM state carried across the grid's
// sequential axis) thus becomes a register state carried along a loop, and
// nothing of size (S, D, N) touches memory, the point of the TPU kernel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int G = 2;               // lanes per channel (header: 2 beat 4 and 8)
constexpr int THREADS = 256;
constexpr int CPB = THREADS / G;   // channels per block
constexpr int CH = 16;             // time steps per chunk
constexpr int PER = CH / G;        // steps of a chunk each lane loads and stores
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float fast_exp2(float x) {   // exp2f's one-instruction form
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

struct Params {
  const void* u; const void* dt; const float* A; const void* Bm; const void* Cm;
  const float* h0; void* y; float* h_fin;
  int S, D;
  // (batch, seq) strides in elements; the last dim of each is contiguous
  long long u_sb, u_ss, dt_sb, dt_ss, B_sb, B_ss, C_sb, C_ss;
};

template <typename T, int N>
__global__ void __launch_bounds__(THREADS) mamba_scan_kernel(Params P) {
  constexpr int NS = N / G;                    // states per lane
  static_assert(N % G == 0 && CH * N <= THREADS, "a lane's states; one staged value a thread");
  __shared__ __align__(16) float sB[CH][N];
  __shared__ __align__(16) float sC[CH][N];
  const int b = blockIdx.y;
  const int j = threadIdx.x % G;               // lane within the group: states j*NS ..
  const int lane = threadIdx.x % 32;
  const int leader = lane - j;                 // the group's first lane
  const int d = blockIdx.x * CPB + threadIdx.x / G;
  const bool live = d < P.D;
  const T* u = static_cast<const T*>(P.u) + b * P.u_sb + (live ? d : 0);
  const T* dt = static_cast<const T*>(P.dt) + b * P.dt_sb + (live ? d : 0);
  const T* Bm = static_cast<const T*>(P.Bm) + b * P.B_sb;
  const T* Cm = static_cast<const T*>(P.Cm) + b * P.C_sb;
  T* y = static_cast<T*>(P.y) + (long long)b * P.S * P.D + d;
  const long long hidx = ((long long)b * P.D + d) * N + j * NS;

  float a2[NS], h[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    a2[i] = live ? P.A[(long long)d * N + j * NS + i] * LOG2E : 0.f;
    h[i] = (live && P.h0) ? P.h0[hidx + i] : 0.f;
  }

  // this thread's share of a chunk's loads: u and dt at steps j + G*i, and
  // (thread < CH*N) the Bm and Cm value at (step, state) = divmod(thread, N)
  const bool stager = threadIdx.x < CH * N;
  const int sr = threadIdx.x / N, sn = threadIdx.x % N;
  float nu[PER], ndt[PER], nb = 0.f, nc = 0.f;
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = t0 + j + G * i;
      const bool ok = live && t < P.S;
      nu[i] = ok ? to_f32(u[(long long)t * P.u_ss]) : 0.f;
      ndt[i] = ok ? to_f32(dt[(long long)t * P.dt_ss]) : 0.f;
    }
    if (stager && t0 + sr < P.S) {
      nb = to_f32(Bm[(long long)(t0 + sr) * P.B_ss + sn]);
      nc = to_f32(Cm[(long long)(t0 + sr) * P.C_ss + sn]);
    }
  };
  load(0);

  for (int t0 = 0; t0 < P.S; t0 += CH) {
    const int len = min(CH, P.S - t0);
    __syncthreads();                           // the previous chunk's rows are consumed
    if (stager) {
      sB[sr][sn] = sr < len ? nb : 0.f;
      sC[sr][sn] = sr < len ? nc : 0.f;
    }
    float cdt[PER], cdtu[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) { cdt[i] = ndt[i]; cdtu[i] = ndt[i] * nu[i]; }
    __syncthreads();
    if (t0 + CH < P.S) load(t0 + CH);          // in flight while this chunk runs

    float yv[PER];
    auto step = [&](const int r) {
      const int src = leader + r % G;          // the lane that loaded step r
      const float dtv = __shfl_sync(0xffffffffu, cdt[r / G], src);
      const float dtu = __shfl_sync(0xffffffffu, cdtu[r / G], src);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        h[i] = fast_exp2(dtv * a2[i]) * h[i] + dtu * sB[r][j * NS + i];
        acc = fmaf(h[i], sC[r][j * NS + i], acc);
      }
#pragma unroll
      for (int off = 1; off < G; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (j == r % G) yv[r / G] = acc;
    };
    if (len == CH) {                           // a whole chunk: steps interleave freely
#pragma unroll
      for (int r = 0; r < CH; ++r) step(r);
    } else {                                   // the last, ragged one
#pragma unroll
      for (int r = 0; r < CH; ++r)
        if (r < len) step(r);                  // uniform across the block
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int r = j + G * i;
      if (live && r < len) y[(long long)(t0 + r) * P.D] = from_f32<T>(yv[i]);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NS; ++i) P.h_fin[hidx + i] = h[i];
  }
}

template <typename T>
cudaError_t dispatch_n(const Params& P, int B, int N, cudaStream_t stream) {
  dim3 grid((P.D + CPB - 1) / CPB, B);
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
