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
//   divide floors l at 1e-30.  f32 and bf16; head_dim 16, 32, 64, 128, 160, 256.
//
// What bounds it on the card: at the serving prefill shape (B=4, S=T=2048,
// Hq=12, Hkv=2, D=128, bf16, causal) the two products are ~51.5 GFLOP
// (~52 us at 989 TFLOP/s) against ~59 MB of q, k, v and o (~18 us at
// 3.35 TB/s): the kernel is bound by tensor-core operations, which only
// wgmma reaches.  Its ~1e8 exponentials take ~25 us at the SFU's 16 a clock
// per SM, half that bound, so the softmax has to stay cheap and off the
// tensor cores' critical path.
//
// bf16 (the serving dtype): flash attention on Hopper's warpgroup products.
//   * one block of two warpgroups per (b*Hq + h, 128-row q tile); each
//     warpgroup owns 64 query rows, each of its warps 16.  kv tiles are 128
//     rows (64 at D=160 and 256, whose output accumulators are 80 and 128 f32
//     registers a thread: with 128-row tiles D=160 spilled 104 bytes); one
//     block a SM, up to 255 registers a thread;
//   * S = Q K^T is wgmma.mma_async with both operands in shared memory
//     (K-major), O += P V with P from registers and V N-major.  S and O are
//     accumulator fragments that never leave registers: each thread owns two
//     rows of its warp's 16 (lane/4 and lane/4 + 8), so a row's max and sum
//     take two shuffles within a quad, and the row sum is reduced only once,
//     at the end.  P is rounded to bf16 in registers and becomes the next
//     product's A operand;
//   * the products are asynchronous: step j starts S_j and then O += P_{j-1}
//     V_{j-1}, and runs the softmax of S_j while the PV product is on the
//     tensor cores; only the rescale of O waits for it;
//   * Q, K and V sit in shared memory as wgmma wants them, in 128-byte-swizzled
//     panels (64 columns; 32- and 64-byte swizzles at D=16 and 32; at D=160,
//     which 64-column panels do not divide, five 32-column panels with the
//     64-byte swizzle, so that QK^T takes its 10 k16 steps and PV one
//     m64n160 product a k step, with no padded column), filled
//     by cp.async: K_{j+1} and V_j load while step j computes, through a
//     ring of two K and two V stages;
//   * scores live in the log2 domain: one FFMA turns a raw score into
//     s*scale*log2(e) - m, and ex2.approx gives the weight.  Only the tiles
//     that cut a mask (the diagonal of a causal loop, the first tiles of a
//     window, the ragged edge of T) pay for the compare and select, and a
//     warpgroup skips a tile whose scores are all masked for its 64 rows (the
//     reference gives such scores no weight once the row has seen an
//     unmasked one, which every row < T does);
//   * the TPU's sequential kv grid axis is a loop inside the block and its
//     `pl.when` skip the loop's bounds: causal stops at the diagonal tile, a
//     window starts at the tile holding q_start - window + 1, so local
//     attention stays O(S*W); the last q tile is scheduled first, since its
//     causal rows are the longest;
//   * the output is staged through the warp's own Q rows and written with
//     16-byte stores.
// Tried on the card and dropped (PERF.md): mma.sync with ldmatrix (this
// design's first version), unswizzled tiles, 64-row kv tiles at D=128, a
// three-stage ring, the two warpgroups starting products in turns, one
// warpgroup a block.  Not yet tried: TMA loads from a producer warp with mbarriers, so
// that the warpgroups need no block-wide barrier and can drift apart.
// float32 (reached only by checks, tests and the reduced models): the first
// version's simple scalar kernel, scores and accumulator in shared memory,
// 64-row q tiles (32 rows at head_dim 256, whose 64-row tiles do not fit).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float MASKED = -1e30f;        // the reference's masked score
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct Params {
  const void* q; const void* k; const void* v; void* o;
  int Hq, Hkv, S, T;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale;
  int causal, window;
};

// kv range of a q tile [q0, q0 + rows): the tiles that hold at least one
// unmasked score for some of its rows
struct KvRange { int begin, end; };
__device__ __forceinline__ KvRange kv_range(const Params& P, int q0, int rows) {
  return {P.window > 0 ? max(0, q0 - P.window + 1) : 0,
          P.causal ? min(P.T, q0 + rows) : P.T};
}

// ===========================================================================
// bf16: wgmma, register-resident softmax overlapped with the PV product
// ===========================================================================

template <int D> struct Cfg {
  static constexpr int THREADS = 256;             // two warpgroups, 64 query rows each
  static constexpr int BQ = 128;                  // query rows per block
  // kv rows per tile: 64 from D = 160 up, where the output accumulator (80
  // or 128 f32 registers a thread) beside a 128-column score tile spills
  static constexpr int BK = D >= 160 ? 64 : 128;
  // swizzle width, bytes of a panel row: 128 where D is a multiple of 64;
  // 64 at D = 160 (five 32-column panels) and D = 32; 32 at D = 16
  static constexpr int W = D % 64 == 0 ? 128 : D % 32 == 0 ? 64 : 32;
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  // Q, then two K stages, then two V stages; +1024 to align the base
  static constexpr size_t bytes = (size_t)Q_BYTES + 4 * KV_BYTES + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// orders this thread's writes to shared memory before the tensor cores' reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Tiles are kept as wgmma wants them: a (rows, D) tile is cut into panels of
// W/2 columns (W bytes a row), each panel stored row after row, and the
// 16-byte chunks of a row XOR-permuted by bits 7 and up of their offset (the
// W-byte swizzle; W = 128 from D = 64 up).  Byte offset of chunk c8 of row r:
template <int D, int ROWS>
__device__ __forceinline__ uint32_t chunk_off(int r, int c8) {
  constexpr int W = Cfg<D>::W, CPP = W / 16;     // chunks a panel row
  const uint32_t off = r * W + (c8 % CPP) * 16;
  return (c8 / CPP) * (ROWS * W) + (off ^ (((off >> 7) & (CPP - 1)) << 4));
}

// wgmma shared-memory descriptor: start address, byte strides between
// panels (lbo) and between 8-row groups (sbo), swizzle mode for W
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t mode = Cfg<D>::W == 128 ? 1 : Cfg<D>::W == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of registers that an
// asynchronous product uses across its wait
template <int N> __device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(r[i][k]) :: "memory");
}

#define WG_F4(i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define WG_F8(i) WG_F4(i), WG_F4((i) + 4)
#define WG_F16(i) WG_F8(i), WG_F8((i) + 8)
#define WG_F32(i) WG_F16(i), WG_F16((i) + 16)
#define WG_F64(i) WG_F32(i), WG_F32((i) + 32)
#define WG_F128(i) WG_F64(i), WG_F64((i) + 64)

// ss: d (64 x 64 f32) (+)= A (64 x 16, K-major, shared) . B (64 x 16, K-major, shared)^T
// rs: d (64 x N f32) += A (64 x 16, registers) . B (16 x N, N-major, shared)
// d is this thread's share of the accumulator, in mma.sync's C layout for
// each 8-column block: rows lane/4 and lane/4 + 8 of the warp's 16.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
               "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, %34, 1, 1, 0, 0;\n"
               : WG_F32(0) : "l"(da), "l"(db), "n"(SCALE_D));
}
template <int SCALE_D>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
               "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
               "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
               "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, %66, 1, 1, 0, 0;\n"
               : WG_F64(0) : "l"(da), "l"(db), "n"(SCALE_D));
}
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1, 1;\n"
               : WG_F8(0) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
               : WG_F16(0) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
               "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
               : WG_F32(0) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
               "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
               "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
               "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
               : WG_F64(0) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
__device__ __forceinline__ void wgmma_rs_n160(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
               "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
               "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
               "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, "
               "%65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, {%80, %81, %82, %83}, %84, 1, 1, 1, 1;\n"
               : WG_F64(0), WG_F16(64) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
               "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
               "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
               "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, "
               "%65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, "
               "%81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, "
               "%97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
               "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
               "%123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
               : WG_F128(0) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
#undef WG_F4
#undef WG_F8
#undef WG_F16
#undef WG_F32
#undef WG_F64
#undef WG_F128

template <int N, int SCALE_D>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
  if constexpr (N == 128) wgmma_ss_n128<SCALE_D>(d, da, db);
  else wgmma_ss_n64<SCALE_D>(d, da, db);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 256) wgmma_rs_n256(d, a, db);
  else if constexpr (N == 160) wgmma_rs_n160(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else wgmma_rs_n16(d, a, db);
}

__device__ __forceinline__ float fast_exp2(float x) {   // exp2f's one-instruction form
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + ROWS) of a (rows, D) matrix with row stride `stride`
// (elements) into a swizzled tile at shared address `dst`, asynchronously;
// rows at or past `n_rows` are zero-filled.  Consecutive threads take
// consecutive 16-byte chunks of a row.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src, long long stride,
                                                int row0, int n_rows) {
  constexpr int CHUNKS = D / 8, NT = Cfg<D>::THREADS;
#pragma unroll
  for (int i = 0; i < (ROWS * CHUNKS + NT - 1) / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    if (ROWS * CHUNKS % NT == 0 || idx < ROWS * CHUNKS) {
      const int r = idx / CHUNKS, c8 = idx % CHUNKS;
      const bool ok = row0 + r < n_rows;
      cp_async16(dst + chunk_off<D, ROWS>(r, c8),
                 ok ? src + (long long)(row0 + r) * stride + c8 * 8 : src, ok);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1) flash_bf16_kernel(Params P) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, W = C::W;
  constexpr int NB = BK / 8;        // 8-column blocks of a score tile
  constexpr int DB = D / 8;         // 8-column blocks of the output
  constexpr int KSTEPS = W / 32;    // k16 steps within a panel row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;   // swizzle atoms are 1024-aligned
  const uint32_t sK = sQ + C::Q_BYTES;          // stage s at sK + s * KV_BYTES
  const uint32_t sV = sK + 2 * C::KV_BYTES;     // stage s at sV + s * KV_BYTES

  const int bh = blockIdx.x;
  const int b = bh / P.Hq, h = bh % P.Hq;
  const int hk = h / (P.Hq / P.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // the longest causal rows first
  const bf16* q = static_cast<const bf16*>(P.q) + b * P.q_sb + h * P.q_sh;
  const bf16* k = static_cast<const bf16*>(P.k) + b * P.k_sb + hk * P.k_sh;
  const bf16* v = static_cast<const bf16*>(P.v) + b * P.v_sb + hk * P.v_sh;
  bf16* o = static_cast<bf16*>(P.o) + b * P.o_sb + h * P.o_sh;

  const KvRange kv = kv_range(P, q0, BQ);
  const int kt0 = kv.begin / BK;
  const int n_tiles = (kv.end + BK - 1) / BK - kt0;

  // one cp.async group per step: Q and K_0 first; in step j, K_{j+1} and V_j
  load_tile_async<D, BQ>(sQ, q, P.q_ss, q0, P.S);
  if (n_tiles > 0) load_tile_async<D, BK>(sK, k, P.k_ss, kt0 * BK, P.T);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
  const int g = lane / 4, t = lane % 4;        // fragment row and column pair
  const int wq0 = q0 + warp * 16;              // this warp's first query row
  const int gq0 = q0 + wg * 64;                // this warpgroup's first query row
  const float sl2 = P.scale * LOG2E;

  float acc[DB * 4];
#pragma unroll
  for (int i = 0; i < DB * 4; ++i) acc[i] = 0.f;
  float s[NB * 4];
#pragma unroll
  for (int i = 0; i < NB * 4; ++i) s[i] = 0.f;
  uint32_t pa[BK / 16][4];
  float m_run[2] = {MASKED, MASKED}, l_run[2] = {0.f, 0.f};   // rows g and g + 8, log2 units
  bool prev_live = false;                      // tile j-1 left a P for this warpgroup

  // O += P V_j, V N-major: 16 kv rows (two 8-row groups) a k step
  auto start_pv = [&](int j) {
    const uint32_t v0 = sV + (j % 2) * C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(acc, pa[kk], smem_desc<D>(v0 + kk * 16 * W, BK * W, 8 * W));
    wgmma_commit();
  };

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = (kt0 + j) * BK;
    cp_async_wait_all();                       // K_j and V_{j-1} have landed
    fence_proxy_async();
    __syncthreads();                           // ... for every thread; the stages they replace are free
    if (j + 1 < n_tiles) load_tile_async<D, BK>(sK + ((j + 1) % 2) * C::KV_BYTES, k, P.k_ss, k0 + BK, P.T);
    load_tile_async<D, BK>(sV + (j % 2) * C::KV_BYTES, v, P.v_ss, k0, P.T);
    cp_async_commit();                         // in flight while this step runs

    const bool live = !((P.causal && k0 > gq0 + 63) ||
                        (P.window > 0 && k0 + BK - 1 <= gq0 - P.window));
    wgmma_fence();                             // acc and pa were last written by this thread
    if (live) {                                // S_j = Q K_j^T, uniform across the warpgroup
      const uint32_t qa = sQ + wg * 64 * W, ka = sK + (j % 2) * C::KV_BYTES;
      fence_regs(s);
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint32_t off = (kd % KSTEPS) * 32;
        const uint64_t da = smem_desc<D>(qa + (kd / KSTEPS) * BQ * W + off, 16, 8 * W);
        const uint64_t db = smem_desc<D>(ka + (kd / KSTEPS) * BK * W + off, 16, 8 * W);
        if (kd == 0) wgmma_ss<BK, 0>(s, da, db);
        else wgmma_ss<BK, 1>(s, da, db);
      }
      wgmma_commit();
    }
    if (prev_live) start_pv(j - 1);            // runs on the tensor cores during the softmax
    if (live) {
      if (prev_live) wgmma_wait<1>(); else wgmma_wait<0>();
      fence_regs(s);

      // scores to the log2 domain; only a tile that cuts a mask compares
      float mul = sl2;
      if (k0 + BK > P.T || (P.causal && k0 + BK - 1 > wq0) ||
          (P.window > 0 && k0 <= wq0 + 15 - P.window)) {
        mul = 1.f;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + nb * 8 + 2 * t + (e & 1);
            const int row = wq0 + g + (e >> 1) * 8;
            bool keep = true;
            if (P.causal) keep = col <= row;
            if (P.window > 0) keep = keep && col > row - P.window;
            float x = keep ? s[4 * nb + e] * sl2 : MASKED;
            s[4 * nb + e] = col < P.T ? x : neg_inf();   // past the ragged edge: no weight
          }
        }
      }

      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = s[2 * r];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mx = fmaxf(mx, fmaxf(s[4 * nb + 2 * r], s[4 * nb + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx * mul);
        corr[r] = fast_exp2(m_run[r] - m_new);
        m_run[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[4 * nb + e] = fast_exp2(fmaf(s[4 * nb + e], mul, -m_new));
            sum += s[4 * nb + e];
          }
        }
        l_run[r] = l_run[r] * corr[r] + sum;   // this thread's share; the quad's at the end
      }
      if (prev_live) wgmma_wait<0>();          // PV_{j-1} is done with acc and pa
      fence_regs(acc);
      fence_regs(pa);
#pragma unroll
      for (int i = 0; i < DB; ++i) {
        acc[4 * i] *= corr[0]; acc[4 * i + 1] *= corr[0];
        acc[4 * i + 2] *= corr[1]; acc[4 * i + 3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {   // P_j, rounded to bf16, as the next A operand
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    } else if (prev_live) {
      wgmma_wait<0>();
      fence_regs(acc);
    }
    prev_live = live;
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();                             // V_{n-1} (and Q, with no kv tile) have landed
  if (prev_live) {
    wgmma_fence();
    start_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc);
  }
  __syncthreads();                             // every warpgroup is done with Q

  // epilogue: divide by the row sums, stage in this warp's 16 Q rows, 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
  const int r0 = warp * 16;                    // this warp's rows of the Q tile
#pragma unroll
  for (int i = 0; i < DB; ++i) {
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const uint32_t a = sQ + chunk_off<D, BQ>(r0 + g + 8 * h8, i) + 4 * t;
      const uint32_t val = pack_bf16(acc[4 * i + 2 * h8] * inv[h8], acc[4 * i + 2 * h8 + 1] * inv[h8]);
      asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(a), "r"(val) : "memory");
    }
  }
  __syncwarp();
#pragma unroll
  for (int idx = lane; idx < 16 * DB; idx += 32) {
    const int r = idx / DB, c8 = idx % DB;
    if (wq0 + r < P.S) {
      uint4 val;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                   : "r"(sQ + chunk_off<D, BQ>(r0 + r, c8)) : "memory");
      *reinterpret_cast<uint4*>(o + (long long)(wq0 + r) * P.o_ss + c8 * 8) = val;
    }
  }
}

template <int D>
cudaError_t launch_bf16(const Params& P, int B, cudaStream_t stream) {
  using C = Cfg<D>;
  static_assert(C::bytes <= 232448, "tile does not fit in shared memory");
  cudaError_t err = cudaFuncSetAttribute(flash_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * P.Hq, (P.S + C::BQ - 1) / C::BQ);
  flash_bf16_kernel<D><<<grid, C::THREADS, C::bytes, stream>>>(P);
  return cudaGetLastError();
}

// ===========================================================================
// float32: scalar FMA, scores and accumulator in shared memory
// ===========================================================================

constexpr int F_BK = 64;                // kv rows per loop step
constexpr int F_WARPS = 4;
constexpr int F_THREADS = F_WARPS * 32;
constexpr int F_LDS = F_BK + 4;         // score tile row stride

template <int D> struct F32Layout {
  // query rows per block: 64 (16 a warp); 32 at head_dim 256, whose 64-row
  // tiles need 301,056 bytes of shared memory
  static constexpr int BQ = D == 256 ? 32 : 64;
  static constexpr int RW = BQ / F_WARPS;      // query rows per warp
  static constexpr int LD = D + 4;             // q/k/v tile row stride
  static constexpr int LDP = F_BK + 4;         // p tile row stride
  static constexpr int LDO = D + 4;            // accumulator row stride
  static constexpr size_t bytes =
      sizeof(float) * (size_t)(BQ * LD + 2 * F_BK * LD + BQ * LDP + BQ * F_LDS + BQ * LDO);
};

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

// Rows [row0, row0 + ROWS) into shared memory with 16-byte loads; rows at or
// past `n_rows` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long stride,
                                              int row0, int n_rows) {
  constexpr int CHUNKS = D / 4, LD = F32Layout<D>::LD;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += F_THREADS) {
    const int r = idx / CHUNKS, c = (idx % CHUNKS) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(F_THREADS) flash_f32_kernel(Params P) {
  using L = F32Layout<D>;
  constexpr int BQ = L::BQ, RW = L::RW, LD = L::LD, LDP = L::LDP, LDO = L::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + BQ * LD;
  float* sV = sK + F_BK * LD;
  float* sP = sV + F_BK * LD;
  float* sS = sP + BQ * LDP;
  float* sO = sS + BQ * F_LDS;

  const int bh = blockIdx.x;
  const int b = bh / P.Hq, h = bh % P.Hq;
  const int hk = h / (P.Hq / P.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // the longest causal rows first
  const float* q = static_cast<const float*>(P.q) + b * P.q_sb + h * P.q_sh;
  const float* k = static_cast<const float*>(P.k) + b * P.k_sb + hk * P.k_sh;
  const float* v = static_cast<const float*>(P.v) + b * P.v_sb + hk * P.v_sh;
  float* o = static_cast<float*>(P.o) + b * P.o_sb + h * P.o_sh;

  load_tile_f32<D, BQ>(sQ, q, P.q_ss, q0, P.S);
  for (int i = threadIdx.x; i < BQ * LDO; i += F_THREADS) sO[i] = 0.f;
  __syncthreads();                         // q tile and zeroed acc, even with no kv tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * RW;
  float m_run[RW], l_run[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) { m_run[i] = MASKED; l_run[i] = 0.f; }

  const KvRange kv = kv_range(P, q0, BQ);
  const int kt_end = (kv.end + F_BK - 1) / F_BK;
  for (int kt = kv.begin / F_BK; kt < kt_end; ++kt) {
    const int k0 = kt * F_BK;
    __syncthreads();                       // the previous tile is consumed
    load_tile_f32<D, F_BK>(sK, k, P.k_ss, k0, P.T);
    load_tile_f32<D, F_BK>(sV, v, P.v_ss, k0, P.T);
    __syncthreads();

    // s (RW, BK) = q . k^T for this warp's rows
    for (int i = 0; i < RW; ++i) {
      for (int c = lane; c < F_BK; c += 32) {
        float a = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) a = fmaf(sQ[(r0 + i) * LD + d], sK[c * LD + d], a);
        sS[(r0 + i) * F_LDS + c] = a;
      }
    }
    __syncwarp();

#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int row = q0 + r0 + i;
      float s[F_BK / 32];
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < F_BK / 32; ++j) {
        const int c = lane + 32 * j, col = k0 + c;
        float x = sS[(r0 + i) * F_LDS + c] * P.scale;
        bool keep = true;
        if (P.causal) keep = col <= row;
        if (P.window > 0) keep = keep && col > row - P.window;
        if (!keep) x = MASKED;
        if (col >= P.T) x = neg_inf();       // past the ragged edge: no weight at all
        s[j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_run[i], warp_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < F_BK / 32; ++j) {
        const float p = expf(s[j] - m_new);
        psum += p;
        sP[(r0 + i) * LDP + lane + 32 * j] = p;
      }
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + warp_sum(psum);
      m_run[i] = m_new;
      for (int d = lane; d < D; d += 32) sO[(r0 + i) * LDO + d] *= corr;
    }
    __syncwarp();

    // acc (RW, D) += p (RW, BK) . v (BK, D)
    for (int i = 0; i < RW; ++i) {
      for (int d = lane; d < D; d += 32) {
        float a = sO[(r0 + i) * LDO + d];
#pragma unroll 16
        for (int c = 0; c < F_BK; ++c) a = fmaf(sP[(r0 + i) * LDP + c], sV[c * LD + d], a);
        sO[(r0 + i) * LDO + d] = a;
      }
    }
  }
  __syncwarp();

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = q0 + r0 + i;
    if (row < P.S) {
      const float l = fmaxf(l_run[i], 1e-30f);
      float* orow = o + row * P.o_ss;
      for (int d = lane; d < D; d += 32) orow[d] = sO[(r0 + i) * LDO + d] / l;
    }
  }
}

template <int D>
cudaError_t launch_f32(const Params& P, int B, cudaStream_t stream) {
  constexpr size_t bytes = F32Layout<D>::bytes;
  static_assert(bytes <= 232448, "tile does not fit in shared memory");
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * P.Hq, (P.S + F32Layout<D>::BQ - 1) / F32Layout<D>::BQ);
  flash_f32_kernel<D><<<grid, F_THREADS, bytes, stream>>>(P);
  return cudaGetLastError();
}

template <bool BF16, int D>
cudaError_t launch(const Params& P, int B, cudaStream_t stream) {
  return BF16 ? launch_bf16<D>(P, B, stream) : launch_f32<D>(P, B, stream);
}

template <bool BF16>
cudaError_t dispatch_d(const Params& P, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<BF16, 16>(P, B, stream);
    case 32: return launch<BF16, 32>(P, B, stream);
    case 64: return launch<BF16, 64>(P, B, stream);
    case 128: return launch<BF16, 128>(P, B, stream);
    case 160: return launch<BF16, 160>(P, B, stream);
    case 256: return launch<BF16, 256>(P, B, stream);
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
  if (dtype == 0) return (int)dispatch_d<false>(P, B, D, st);
  if (dtype == 1) return (int)dispatch_d<true>(P, B, D, st);
  return (int)cudaErrorInvalidValue;
}
