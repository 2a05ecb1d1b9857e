// Thin matvec  Y (M, w) = B (M, K) . X (K, w)  on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel benchmarks/mv_kernel_probe.py:_kernel
// (launched by pallas_mv, :52-69): bf16 operands, f32 accumulation, f32
// output.  In the port it is the filter product of the large-graph route's
// streaming regime (vican_torch/solver/scale.py), on the bf16 copy of the
// dense (3C, 3C) scaled Laplacian at w = 10 (the subspace) and w = 1 (the
// lambda_max probes); the probe's own shape is (30208, 31744) x 128.
//
// Operands (see vican_torch/solver/mv.py):
//   B   (M, K)  bf16, row stride ldb >= K (unit column stride)
//   Xt  (wp, ldx) bf16, X transposed: Xt[c, k] = X[k, c]; ldx a multiple of
//       8 and >= K rounded up to 8; zero past K and past w (wp rows, wp a
//       multiple of the column pass width)
//   Y   (M, w)  f32 row-major output
//
// What bounds it: bytes.  B is M*K*2 bytes (1.8 GB for the 30000^2 operator,
// 0.54 ms at 3.35 TB/s) and X and Y are small; the function's 2*M*K*w
// operations at the bf16 tensor-core rate take less.  This first design runs
// on CUDA cores, so at w = 128 its f32 FMAs bound it instead (2.5e11 ops at
// the probe shape, >= 3.7 ms at 67 TFLOP/s); tensor cores are later work.
//
// Design: one warp per ROWS rows of B.  The lanes stride over 8-element
// (16-byte) vectors of those rows, so a warp reads 512 contiguous bytes of a
// row per step; X is staged transposed in shared memory, KT entries of K at a
// time, and shared by the block's 8 warps.  X's columns are taken WC at a
// time: w <= 16 is one pass with WC = w (a template parameter, accumulators
// in registers), wider X goes in passes of 16 columns, and the passes over
// the same rows are neighbouring blocks, so their reads of B mostly hit L2.
// Each output is one warp's lane partials summed by a fixed butterfly: no
// atomics, so runs repeat bit for bit.
//
// Ragged edges: rows past M are clamped for the loads and not stored; the
// last partial vector of K is read element by element under a mask, never
// past K; Xt is zero past K and past w, and columns past w are not stored.
// Rows of B need not start on 16-byte boundaries: the VEC = false variant
// reads B element by element (ldb % 8 != 0 or an unaligned base).  The
// streaming operator is stored with ldb a multiple of 8 and takes VEC.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 4;    // rows of B per warp
constexpr int KT = 1024;   // entries of K staged per step
constexpr int WIDE = 16;   // columns per pass when w > 16 (mv.py:_WIDE)

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// Eight entries of a row of B from column k on, zero at and past K.
template <bool VEC>
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ row, int k, int K,
                                      float (&f)[8]) {
  if (VEC && k + 8 <= K) {
    unpack8(*reinterpret_cast<const uint4*>(row + k), f);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = k + j < K ? __bfloat162float(row[k + j]) : 0.f;
  }
}

template <int WC, bool VEC>
__global__ void __launch_bounds__(THREADS)
thin_mv_kernel(const __nv_bfloat16* __restrict__ B, const __nv_bfloat16* __restrict__ Xt,
               float* __restrict__ Y, int M, int K, int ldb, int ldx, int w, int passes) {
  __shared__ __align__(16) __nv_bfloat16 xs[WC * KT];
  const int pass = blockIdx.x % passes;
  const int group = blockIdx.x / passes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = (group * WARPS + warp) * ROWS;
  const int c0 = pass * WC;
  const bool active = row0 < M;

  const __nv_bfloat16* rows[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) rows[r] = B + (size_t)min(row0 + r, M - 1) * ldb;
  const __nv_bfloat16* xcols = Xt + (size_t)c0 * ldx;

  float acc[ROWS][WC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < WC; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KT) {
    const int vecs = (min(KT, K - k0) + 7) / 8;  // the last may be partial
    // Xt is zero from K to its padded width, so whole vectors stage safely
    for (int i = threadIdx.x; i < WC * vecs; i += THREADS) {
      const int c = i / vecs;
      const int v = i - c * vecs;
      reinterpret_cast<uint4*>(xs + c * KT)[v] =
          reinterpret_cast<const uint4*>(xcols + (size_t)c * ldx + k0)[v];
    }
    __syncthreads();
    if (active) {
#pragma unroll 2
      for (int v = lane; v < vecs; v += 32) {
        const int k = k0 + 8 * v;
        float b[ROWS][8];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) load8<VEC>(rows[r], k, K, b[r]);
#pragma unroll
        for (int c = 0; c < WC; ++c) {
          float x[8];
          unpack8(reinterpret_cast<const uint4*>(xs + c * KT)[v], x);
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[r][c] = fmaf(b[r][j], x[j], acc[r][c]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;

#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < WC; ++c)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < WC; ++c)
        if (row0 + r < M && c0 + c < w) Y[(size_t)(row0 + r) * w + c0 + c] = acc[r][c];
  }
}

template <int WC>
cudaError_t run(const __nv_bfloat16* B, const __nv_bfloat16* Xt, float* Y, int M, int K,
                int ldb, int ldx, int w, bool vec, cudaStream_t stream) {
  const int passes = (w + WC - 1) / WC;
  const int groups = (M + WARPS * ROWS - 1) / (WARPS * ROWS);
  const dim3 grid((unsigned)groups * passes);
  if (vec)
    thin_mv_kernel<WC, true><<<grid, THREADS, 0, stream>>>(B, Xt, Y, M, K, ldb, ldx, w, passes);
  else
    thin_mv_kernel<WC, false><<<grid, THREADS, 0, stream>>>(B, Xt, Y, M, K, ldb, ldx, w, passes);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError().  `vec` != 0
// promises ldb % 8 == 0 and a 16-byte aligned B.
extern "C" int thin_mv_bf16(const void* B, const void* Xt, void* Y, int M, int K, int ldb,
                            int ldx, int w, int vec, void* stream) {
  if (M <= 0 || K <= 0 || w <= 0 || ldb < K || ldx % 8 != 0 || ldx < (K + 7) / 8 * 8 ||
      (vec && (ldb % 8 != 0 || reinterpret_cast<uintptr_t>(B) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const auto* b = static_cast<const __nv_bfloat16*>(B);
  const auto* xt = static_cast<const __nv_bfloat16*>(Xt);
  auto* y = static_cast<float*>(Y);
  auto s = static_cast<cudaStream_t>(stream);
  switch (w) {
#define MV_CASE(N) \
  case N:          \
    return (int)run<N>(b, xt, y, M, K, ldb, ldx, w, vec != 0, s);
    MV_CASE(1) MV_CASE(2) MV_CASE(3) MV_CASE(4)
    MV_CASE(5) MV_CASE(6) MV_CASE(7) MV_CASE(8)
    MV_CASE(9) MV_CASE(10) MV_CASE(11) MV_CASE(12)
    MV_CASE(13) MV_CASE(14) MV_CASE(15)
#undef MV_CASE
    default:
      return (int)run<WIDE>(b, xt, y, M, K, ldb, ldx, w, vec != 0, s);
  }
}

extern "C" const char* mv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
