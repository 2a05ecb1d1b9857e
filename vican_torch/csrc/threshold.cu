// Multi-window adaptive mean-C threshold, bit-packed, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vican_tpu/ops/pallas/threshold.py:_kernel
// (launched by multi_threshold, threshold.py:88) and the bit-pack after it
// in the perception device mode (vican_tpu/perception.py:_build_threshold,
// :742-762): for each of up to 8 odd windows (3, 9, 13, 19, 23, 29, 33 by
// default) and every pixel, foreground = g <= boxmean_win(g) - C with
// replicate borders (cv.adaptiveThreshold MEAN_C + THRESH_BINARY_INV).
//
// Operands (see vican_torch/ops/threshold.py):
//   gray (B, H, W)        uint8, contiguous rows, any byte offset
//   out  (B, n, H, Wb)    uint8, Wb = ceil(W / 8); bit x & 7 of byte x >> 3
//                         is column x (np.packbits bitorder="little"); bits
//                         of columns >= W are zero
// One launch per frame batch; the launch plan (rows per CTA, grid, path)
// comes from vican_torch/ops/threshold.py:threshold_plan.
//
// Exactness: box sums are exact integers (33^2 * 255 < 2^24), taken as
// differences of running column sums below 2^23, all held in floats, where
// every add is exact (see box_mask).  For an integral C (|C| <= 2^13) the
// test is (g + C) * win^2 <= s, which equals the float32 test of
// vican_tpu/ops/detect.adaptive_threshold on every pixel (the proof is in
// vican_tpu/_native/fastthresh.c:11-17).  Otherwise the float32 path is
// taken literally: fl(fl(s / win^2) - C) with IEEE division (__fdiv_rn; the
// build must never use --use_fast_math).  The TPU kernel multiplies by the
// reciprocal instead (threshold.py:66) and may differ at exact ties; this
// kernel follows the spec.
//
// What bounds it: operations.  At 32 x 1280 x 720 the kernel reads 29.5 MB
// and writes 25.8 MB (0.017 ms at 3.35 TB/s), but the function needs ~38
// int32 operations per pixel, ~0.067 ms at the card's INT32 rate (64 lanes
// an SM).  This design runs most of its arithmetic as exact float adds on
// the FP32 pipe (128 lanes an SM) and keeps ~2 integer operations a pixel
// and window (a byte permute and a funnel shift).
//
// Design.  A CTA owns a band of BW = 256 output columns (with a 16-column
// halo each side) over `rows` rows of one frame and walks down them 32 rows
// a step:
// - loads: each step's 32 input rows of the band are staged in shared
//   memory, 16-byte cp.async copies into a three-deep ring when rows and the
//   base are 16-byte aligned (the next step's copies overlap this step's
//   arithmetic), byte loads otherwise; columns outside the frame are not
//   loaded but read through a clamped index (replicate borders), rows are
//   clamped when they are loaded.  Every input byte is loaded once per CTA,
//   plus the 32-row halo of its segment;
// - vertical sums: 144 threads each carry two columns' running sums V (the
//   sum of the column from the segment's first halo row down) in registers,
//   one add per pixel, and write each row of V, as floats, into a 72-row
//   ring in shared memory;
// - horizontal sums: warp j handles the 32 columns 32j..32j+31 of the band,
//   lane i row i of the step.  For a window of radius r, the lane loads the
//   two ring rows y + r and y - r - 1 over its 32 + 2r columns in 16-byte
//   loads, subtracts them into the column sums of the window's rows, and
//   slides the horizontal box along its 32 columns in registers (one add
//   and one subtract a pixel, the radius a compile-time constant through a
//   switch), so a window costs ~2.6 ring words, ~6 float and ~2 integer
//   operations a pixel; the 32 results form one 32-bit mask word, stored
//   whole where aligned.
// Ring rows are 16 bytes longer than a multiple of 128, so the 8 lanes of a
// quarter warp (8 consecutive rows) read 8 distinct bank groups.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WIN = 8;
constexpr int R = 16;                        // the largest radius (win <= 33)
constexpr int BW = 256;                      // output columns per CTA
constexpr int SEG = 32;                      // output columns per lane
constexpr int RS = 32;                       // rows per step, one per lane
constexpr int THREADS = BW / SEG * 32;       // one warp per 32 columns
constexpr int CW = BW + 2 * R;               // staged columns
constexpr int VSTRIDE = CW + 4;              // floats per ring row
constexpr int NR = 72;                       // ring rows >= RS + 2R + 1, a multiple of 8
constexpr int GSTRIDE = CW + 16;             // bytes per staged row
constexpr int NSTAGE = 3;                    // staged steps: being loaded, current, previous
constexpr int SMEM = NR * VSTRIDE * 4 + NSTAGE * RS * GSTRIDE;

struct Params {
  const uint8_t* gray;
  uint8_t* out;
  int H, W, Wb, n, rows;
  int win[MAX_WIN];
  int c_int;
  float c;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage input rows row0 .. row0 + RS - 1 (clamped to the frame) of the
// columns cx0 .. cx0 + CW - 1 that lie inside it.
template <bool ALIGNED>
__device__ __forceinline__ void stage(const uint8_t* img, uint8_t* buf, int row0, int cx0,
                                      int H, int W) {
  if (ALIGNED) {
    // cx0 and W are multiples of 16: each chunk lies wholly in or out
    constexpr int Q = CW / 16;
    for (int k = threadIdx.x; k < RS * Q; k += THREADS) {
      const int i = k / Q, q = k - (k / Q) * Q;
      const int x = cx0 + 16 * q;
      if (x < 0 || x >= W) continue;
      const int y = min(max(row0 + i, 0), H - 1);
      cp_async16(buf + i * GSTRIDE + 16 * q, img + (size_t)y * W + x);
    }
    cp_async_commit();
  } else {
    for (int k = threadIdx.x; k < RS * CW; k += THREADS) {
      const int i = k / CW, c = k - (k / CW) * CW;
      const int x = cx0 + c;
      if (x < 0 || x >= W) continue;
      const int y = min(max(row0 + i, 0), H - 1);
      buf[i * GSTRIDE + c] = img[(size_t)y * W + x];
    }
  }
}

// 2^23 + v as a float's bits for 0 <= v < 2^23: the float 2^23 + v, so
// v = that float - 2^23 exactly, with no conversion instruction
constexpr float MAGIC = 8388608.0f;
__device__ __forceinline__ float exact_float(int v) {
  return __int_as_float(0x4B000000 | v) - MAGIC;
}

// The mask word of one window of radius r for the lane's 32 columns: bit k
// is column k.  lo, hi: the ring rows y - r - 1 and y + r at the lane's
// first output column; g: the lane's 32 pixels, 4 to a word.
//
// Every value here is an integer below 2^24 held in a float, so each add,
// subtract and fused multiply-add is exact and the FP32 pipe does the work:
// column sums d (<= 33 * 255), box sums s (<= 33^2 * 255) and the integral
// test (g + C) win^2 <= s as s - C win^2 - g win^2 >= 0 (|C| <= 2^13 keeps
// C win^2 below 2^24).  Its sign bits are shifted into the word one
// funnel shift a pixel.
template <int r, bool INT_C>
__device__ __forceinline__ uint32_t box_mask(const float* lo, const float* hi, const uint32_t g[8],
                                             float cw2, float c) {
  constexpr int R4 = (r + 3) & ~3;  // loads start 16-byte aligned
  constexpr int N = SEG + 2 * R4;
  constexpr int OFF = R4 - r;
  constexpr float W2 = (float)((2 * r + 1) * (2 * r + 1));
  float d[N];  // the window's column sums over columns -R4 .. 31 + R4
  const float4* lo4 = reinterpret_cast<const float4*>(lo - R4);
  const float4* hi4 = reinterpret_cast<const float4*>(hi - R4);
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 a = hi4[q], b = lo4[q];
    d[4 * q] = a.x - b.x;
    d[4 * q + 1] = a.y - b.y;
    d[4 * q + 2] = a.z - b.z;
    d[4 * q + 3] = a.w - b.w;
  }
  float s = INT_C ? 0.0f - cw2 : 0.0f;  // the integral test carries -C win^2 in s (never -0)
#pragma unroll
  for (int k = OFF; k <= OFF + 2 * r; ++k) s += d[k];
  uint32_t m = 0;  // bit 31 - k set where column k is not foreground
#pragma unroll
  for (int k = 0; k < SEG; ++k) {
    if (k) s = s + d[OFF + 2 * r + k] - d[OFF + k - 1];
    // byte k & 3 of word k >> 2 under the exponent of 2^23
    const float gv = __int_as_float(__byte_perm(g[k >> 2], 0x4B000000u, 0x7540 | (k & 3))) - MAGIC;
    if (INT_C) {
      m = __funnelshift_l(__float_as_uint(__fmaf_rn(gv, -W2, s)), m, 1);
    } else {
      m = (m << 1) | (uint32_t)!(gv <= __fsub_rn(__fdiv_rn(s, W2), c));
    }
  }
  return ~__brev(m);
}

template <bool INT_C>
__device__ __forceinline__ uint32_t window_mask(int r, const float* lo, const float* hi,
                                                const uint32_t g[8], int c_int, float c) {
  const float cw2 = (float)(c_int * (2 * r + 1) * (2 * r + 1));
  switch (r) {
#define VICAN_BOX(RR) \
  case RR:            \
    return box_mask<RR, INT_C>(lo, hi, g, cw2, c);
    VICAN_BOX(0) VICAN_BOX(1) VICAN_BOX(2) VICAN_BOX(3) VICAN_BOX(4) VICAN_BOX(5)
    VICAN_BOX(6) VICAN_BOX(7) VICAN_BOX(8) VICAN_BOX(9) VICAN_BOX(10) VICAN_BOX(11)
    VICAN_BOX(12) VICAN_BOX(13) VICAN_BOX(14) VICAN_BOX(15) VICAN_BOX(16)
#undef VICAN_BOX
    default:
      return 0;
  }
}

template <bool ALIGNED, bool INT_C>
__global__ void __launch_bounds__(THREADS, 2) threshold_band_kernel(Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* ring = reinterpret_cast<float*>(smem);
  uint8_t* stages = smem + NR * VSTRIDE * 4;

  const int b = blockIdx.z;
  const int ya = blockIdx.y * p.rows;           // first output row
  const int bx0 = blockIdx.x * BW;              // first output column
  const int cx0 = bx0 - R;                      // first staged column
  const int yz = ya - R - 1;                    // the ring's zero row (slot 0)
  const int steps = p.rows / RS;                // output steps; input steps 0..steps
  const uint8_t* img = p.gray + (size_t)b * p.H * p.W;

  // ring slot 0: V of row ya - R - 1 is 0
  for (int k = threadIdx.x; k < VSTRIDE; k += THREADS) ring[k] = 0.0f;
  stage<ALIGNED>(img, stages, yz + 1, cx0, p.H, p.W);

  // vertical-sum threads: two staged columns each, read through clamped
  // indices (replicate borders)
  const int u = threadIdx.x;
  const bool vthread = u < CW / 2;
  const int ca = min(max(cx0 + 2 * u, 0), p.W - 1) - cx0;
  const int cb = min(max(cx0 + 2 * u + 1, 0), p.W - 1) - cx0;
  int va = 0, vb = 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x0 = bx0 + SEG * warp;              // the lane's first output column
  const int col0 = R + SEG * warp;              // ... as a staged column

  for (int t = 0; t <= steps; ++t) {
    if (ALIGNED) cp_async_wait_all();
    __syncthreads();  // step t staged; step t-1's reads of ring and stages done
    if (t < steps)
      stage<ALIGNED>(img, stages + ((t + 1) % NSTAGE) * RS * GSTRIDE, yz + 1 + RS * (t + 1),
                     cx0, p.H, p.W);
    // V of input rows yz + 1 + RS t + i
    if (vthread) {
      const uint8_t* src = stages + (t % NSTAGE) * RS * GSTRIDE;
#pragma unroll 8
      for (int i = 0; i < RS; ++i) {
        va += src[i * GSTRIDE + ca];
        vb += src[i * GSTRIDE + cb];
        const int slot = (1 + RS * t + i) % NR;
        *reinterpret_cast<float2*>(ring + slot * VSTRIDE + 2 * u) =
            make_float2(exact_float(va), exact_float(vb));
      }
    }
    __syncthreads();
    if (t == 0 || x0 >= p.W) continue;

    // output row y = ya + RS (t - 1) + lane: input row index RS t - R + lane
    const int y = ya + RS * (t - 1) + lane;
    const int gi = RS * t - R + lane;  // input row y as (step, row) of the stages
    const uint8_t* grow = stages + ((gi / RS) % NSTAGE) * RS * GSTRIDE + (gi % RS) * GSTRIDE + col0;
    uint32_t g[8];
    {
      const uint4 g0 = reinterpret_cast<const uint4*>(grow)[0];
      const uint4 g1 = reinterpret_cast<const uint4*>(grow)[1];
      g[0] = g0.x; g[1] = g0.y; g[2] = g0.z; g[3] = g0.w;
      g[4] = g1.x; g[5] = g1.y; g[6] = g1.z; g[7] = g1.w;
    }
    const bool store = y < p.H && y < ya + p.rows;
    const uint32_t valid = x0 + SEG <= p.W ? 0xffffffffu : (1u << (p.W - x0)) - 1u;
    const int nbytes = min(4, p.Wb - (x0 >> 3));
    const int srow = y - yz;  // ring slot of row y, before the modulo
    for (int wi = 0; wi < p.n; ++wi) {
      const int r = p.win[wi] >> 1;
      const float* lo = ring + ((srow - r - 1) % NR) * VSTRIDE + col0;
      const float* hi = ring + ((srow + r) % NR) * VSTRIDE + col0;
      const uint32_t m = window_mask<INT_C>(r, lo, hi, g, p.c_int, p.c) & valid;
      if (!store) continue;
      uint8_t* o = p.out + ((size_t)(b * p.n + wi) * p.H + y) * p.Wb + (x0 >> 3);
      if (nbytes == 4 && !(reinterpret_cast<uintptr_t>(o) & 3)) {
        *reinterpret_cast<uint32_t*>(o) = m;
      } else {
        for (int k = 0; k < nbytes; ++k) o[k] = (uint8_t)(m >> (8 * k));
      }
    }
  }
}

template <bool ALIGNED, bool INT_C>
int launch(const Params& p, dim3 grid, cudaStream_t stream) {
  auto kernel = threshold_band_kernel<ALIGNED, INT_C>;
  // once per kernel and device (a second thread setting it again is
  // harmless): setting it costs host time on every call otherwise
  static uint64_t smem_set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(smem_set & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set |= bit;
  }
  kernel<<<grid, THREADS, SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError().  `c_is_int`
// selects the integer test with `c_int` == C; otherwise the float test with
// `c`.  Windows: `n_win` odd sizes <= 33 in w0..w7.  The plan: `rows`
// output rows per CTA (a multiple of 32), `segments` CTAs down each frame
// (segments * rows >= H), `aligned` 1 for the cp.async path (W and the base
// address multiples of 16).
extern "C" int threshold_pack_u8(const void* gray, void* out, int B, int H, int W, int n_win,
                                 int w0, int w1, int w2, int w3, int w4, int w5, int w6,
                                 int w7, int c_is_int, int c_int, float c, int rows,
                                 int segments, int aligned, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || n_win < 1 || n_win > MAX_WIN || B > 65535 ||
      rows <= 0 || rows % RS || segments <= 0 || segments > 65535 ||
      (long long)segments * rows < H || (long long)(segments - 1) * rows >= H ||
      (long long)(rows + 2 * R + 1) * 255 >= (1ll << 23) ||
      (c_is_int && (c_int > (1 << 13) || c_int < -(1 << 13))))
    return (int)cudaErrorInvalidValue;
  if (aligned && (W % 16 || reinterpret_cast<uintptr_t>(gray) % 16))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.gray = static_cast<const uint8_t*>(gray);
  p.out = static_cast<uint8_t*>(out);
  p.H = H;
  p.W = W;
  p.Wb = (W + 7) / 8;
  p.n = n_win;
  p.rows = rows;
  const int ws[MAX_WIN] = {w0, w1, w2, w3, w4, w5, w6, w7};
  for (int i = 0; i < MAX_WIN; ++i) {
    p.win[i] = ws[i];
    if (i < n_win && (ws[i] < 1 || ws[i] > 2 * R + 1 || !(ws[i] & 1)))
      return (int)cudaErrorInvalidValue;
  }
  p.c_int = c_int;
  p.c = c;
  const dim3 grid((W + BW - 1) / BW, segments, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned) return c_is_int ? launch<true, true>(p, grid, s) : launch<true, false>(p, grid, s);
  return c_is_int ? launch<false, true>(p, grid, s) : launch<false, false>(p, grid, s);
}

// The kernel's launch constants, for the plan's checks: band columns, rows
// a step, threads, dynamic shared memory bytes; `what` picks one.
extern "C" int threshold_constant(int what) {
  switch (what) {
    case 0: return BW;
    case 1: return RS;
    case 2: return THREADS;
    case 3: return SMEM;
    default: return -1;
  }
}

// An attribute of a kernel variant as the runtime loaded it (a cached build
// has no ptxas report): `variant` bit 0 the 16-byte path, bit 1 the integral
// test; `what` 0 registers a thread, 1 static shared bytes, 2 local memory
// bytes a thread (stack frame and spills).  -1 on error.
extern "C" int threshold_attribute(int variant, int what) {
  cudaFuncAttributes a;
  cudaError_t err;
  switch (variant) {
    case 0: err = cudaFuncGetAttributes(&a, threshold_band_kernel<false, false>); break;
    case 1: err = cudaFuncGetAttributes(&a, threshold_band_kernel<true, false>); break;
    case 2: err = cudaFuncGetAttributes(&a, threshold_band_kernel<false, true>); break;
    case 3: err = cudaFuncGetAttributes(&a, threshold_band_kernel<true, true>); break;
    default: return -1;
  }
  if (err != cudaSuccess) return -1;
  switch (what) {
    case 0: return a.numRegs;
    case 1: return (int)a.sharedSizeBytes;
    case 2: return (int)a.localSizeBytes;
    default: return -1;
  }
}

extern "C" const char* threshold_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
