// CheFSI filter matvec  Y = B Lambda_T B^T X  on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vican_tpu/solver/pallas_pwr.py:_pwr_kernel
// (launched by pwr_apply, pallas_pwr.py:124-185): the power-graph product
// inside the Chebyshev filter of solver/scale.py, ~230 launches per float32
// large-graph solve at maxiter=4.
//
// Operands (see vican_torch/solver/pwr.py):
//   Bt  (3T, ld) bf16 row-major, Bt[3t+a, i] = B[i, 3t+a]; columns >= n zero
//   lam (T, 9)   f32, lam[t, 3a+b] = Lambda_T[t][a][b]
//   Xt  (w, ld)  bf16, the thin operand transposed; columns >= n zero
//   Y   (w, ld)  f32 output, transposed
// Numerics as the TPU kernel (pallas_pwr.py:50-52): bf16 operands, f32
// accumulation, Lambda applied in f32, W = Lambda B^T X rounded to bf16
// before the second product.
//
// What bounds it: bytes.  At 10k cameras Bt is 3C x 3T x 2 B = 1.8 GB and X,
// W, Y are under 3 MB, so a launch can be no faster than one read of Bt
// (0.54 ms at 3.35 TB/s).  The TPU kernel reads each panel once by keeping a
// 5.8 MB (96, n) panel resident in VMEM; an SM has 227 KB of shared memory,
// so this first design does not try: it reads Bt twice, as the two GEMMs of
// the XLA path do, and keeps X and W, which fit L2, in shared memory tiles.
//
//   phase 1  one warp per timestep t: Z[3t+a, :] = Bt[3t+a, :] . X over the
//            camera axis (16-byte loads, X staged in shared memory and shared
//            by the block's 8 warps), a warp reduction, then the 3x3 Lambda_t
//            in the epilogue and W[3t+a, :] stored as bf16.
//   phase 2  each block owns 1024 camera columns and a slice of the 3T rows:
//            Y[:, cols] += W[q, :] Bt[q, cols], W rows staged in shared
//            memory.  Slices write partial sums; a third kernel adds them in
//            a fixed order, so the result does not change from run to run.
//
// The thin width w (1..16) is a template parameter: the accumulators stay
// in registers and ragged widths are never padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K1_WARPS = 8;                   // timesteps per phase-1 block
constexpr int K1_THREADS = 32 * K1_WARPS;
constexpr int K1_TILE = 1024;                 // camera columns of X staged per step
constexpr int K2_THREADS = 256;
constexpr int K2_COLS = 4;                    // camera columns per phase-2 thread
constexpr int K2_TILE = K2_THREADS * K2_COLS;  // must match pwr.py:_K2_TILE
constexpr int K2_ROWS = 128;                  // W rows staged per step

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ void unpack4(const uint2& v, float (&f)[4]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

template <int W>
__global__ void __launch_bounds__(K1_THREADS)
pwr_phase1(const __nv_bfloat16* __restrict__ Bt, const float* __restrict__ lam,
           const __nv_bfloat16* __restrict__ Xt, __nv_bfloat16* __restrict__ Wout,
           int T, int ld) {
  __shared__ __align__(16) __nv_bfloat16 xs[W * K1_TILE];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * K1_WARPS + warp;
  const bool active = t < T;
  const __nv_bfloat16* row = Bt + (size_t)(active ? t : 0) * 3 * ld;

  float acc[3][W];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < W; ++c) acc[a][c] = 0.f;

  for (int k0 = 0; k0 < ld; k0 += K1_TILE) {
    const int vecs = min(K1_TILE, ld - k0) / 8;
    for (int i = threadIdx.x; i < W * vecs; i += K1_THREADS) {
      const int c = i / vecs;
      const int v = i - c * vecs;
      reinterpret_cast<uint4*>(xs + c * K1_TILE)[v] =
          reinterpret_cast<const uint4*>(Xt + (size_t)c * ld + k0)[v];
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int v = lane; v < vecs; v += 32) {
        float b[3][8];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          unpack8(*reinterpret_cast<const uint4*>(row + (size_t)a * ld + k0 + 8 * v), b[a]);
#pragma unroll
        for (int c = 0; c < W; ++c) {
          float x[8];
          unpack8(reinterpret_cast<const uint4*>(xs + c * K1_TILE)[v], x);
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[a][c] = fmaf(b[a][j], x[j], acc[a][c]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;

#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < W; ++c)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[a][c] += __shfl_xor_sync(0xffffffffu, acc[a][c], off);

  if (lane == 0) {
    const float* L = lam + (size_t)t * 9;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int c = 0; c < W; ++c) {
        const float z = L[3 * a] * acc[0][c] + L[3 * a + 1] * acc[1][c] + L[3 * a + 2] * acc[2][c];
        Wout[(size_t)(3 * t + a) * W + c] = __float2bfloat16(z);
      }
  }
}

template <int W>
__global__ void __launch_bounds__(K2_THREADS)
pwr_phase2(const __nv_bfloat16* __restrict__ Bt, const __nv_bfloat16* __restrict__ Win,
           float* __restrict__ Ypart, int Q, int ld, int rows_per_slice) {
  __shared__ float ws[K2_ROWS * W];
  const int col = (blockIdx.x * K2_THREADS + threadIdx.x) * K2_COLS;
  const int q_begin = blockIdx.y * rows_per_slice;
  const int q_end = min(Q, q_begin + rows_per_slice);
  const bool active = col < ld;

  float acc[K2_COLS][W];
#pragma unroll
  for (int j = 0; j < K2_COLS; ++j)
#pragma unroll
    for (int c = 0; c < W; ++c) acc[j][c] = 0.f;

  for (int q0 = q_begin; q0 < q_end; q0 += K2_ROWS) {
    const int nq = min(K2_ROWS, q_end - q0);
    for (int i = threadIdx.x; i < nq * W; i += K2_THREADS)
      ws[i] = __bfloat162float(Win[(size_t)q0 * W + i]);
    __syncthreads();
    if (active) {
      const __nv_bfloat16* p = Bt + (size_t)q0 * ld + col;
#pragma unroll 8
      for (int r = 0; r < nq; ++r) {
        float b[K2_COLS];
        unpack4(*reinterpret_cast<const uint2*>(p + (size_t)r * ld), b);
#pragma unroll
        for (int c = 0; c < W; ++c) {
          const float wv = ws[r * W + c];
#pragma unroll
          for (int j = 0; j < K2_COLS; ++j) acc[j][c] = fmaf(b[j], wv, acc[j][c]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;

  float* out = Ypart + (size_t)blockIdx.y * W * ld + col;
#pragma unroll
  for (int c = 0; c < W; ++c)
    *reinterpret_cast<float4*>(out + (size_t)c * ld) =
        make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
}

// Y = sum over slices of the phase-2 partials, in slice order.
__global__ void pwr_reduce(const float4* __restrict__ part, float4* __restrict__ out,
                           int slices, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 s = part[i];
  for (int k = 1; k < slices; ++k) {
    const float4 v = part[(size_t)k * n4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  out[i] = s;
}

template <int W>
cudaError_t run(const __nv_bfloat16* Bt, const float* lam, const __nv_bfloat16* Xt,
                __nv_bfloat16* Wbuf, float* Ypart, float* Yt, int T, int ld, int slices,
                cudaStream_t stream) {
  const int Q = 3 * T;
  pwr_phase1<W><<<(T + K1_WARPS - 1) / K1_WARPS, K1_THREADS, 0, stream>>>(
      Bt, lam, Xt, Wbuf, T, ld);
  const int rows = (Q + slices - 1) / slices;
  const dim3 grid2((ld + K2_TILE - 1) / K2_TILE, slices);
  pwr_phase2<W><<<grid2, K2_THREADS, 0, stream>>>(
      Bt, Wbuf, slices > 1 ? Ypart : Yt, Q, ld, rows);
  if (slices > 1) {
    const int n4 = W * ld / 4;
    pwr_reduce<<<(n4 + 255) / 256, 256, 0, stream>>>(
        reinterpret_cast<const float4*>(Ypart), reinterpret_cast<float4*>(Yt), slices, n4);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches the three kernels on `stream`; returns cudaGetLastError().
// `Ypart` holds `slices` (w, ld) partials and may alias `Yt` when slices == 1.
extern "C" int pwr_apply_bf16(const void* Bt, const void* lam, const void* Xt, void* Wbuf,
                              void* Ypart, void* Yt, int T, int ld, int w, int slices,
                              void* stream) {
  if (T <= 0 || ld <= 0 || ld % 8 != 0 || slices < 1) return (int)cudaErrorInvalidValue;
  const auto* bt = static_cast<const __nv_bfloat16*>(Bt);
  const auto* lm = static_cast<const float*>(lam);
  const auto* xt = static_cast<const __nv_bfloat16*>(Xt);
  auto* wb = static_cast<__nv_bfloat16*>(Wbuf);
  auto* yp = static_cast<float*>(Ypart);
  auto* yt = static_cast<float*>(Yt);
  auto s = static_cast<cudaStream_t>(stream);
  switch (w) {
#define PWR_CASE(N) \
  case N:           \
    return (int)run<N>(bt, lm, xt, wb, yp, yt, T, ld, slices, s);
    PWR_CASE(1) PWR_CASE(2) PWR_CASE(3) PWR_CASE(4)
    PWR_CASE(5) PWR_CASE(6) PWR_CASE(7) PWR_CASE(8)
    PWR_CASE(9) PWR_CASE(10) PWR_CASE(11) PWR_CASE(12)
    PWR_CASE(13) PWR_CASE(14) PWR_CASE(15) PWR_CASE(16)
#undef PWR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* pwr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
