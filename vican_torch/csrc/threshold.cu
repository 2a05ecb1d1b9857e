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
//   gray (B, H, W)        uint8, contiguous
//   out  (B, n, H, Wb)    uint8, Wb = ceil(W / 8); bit x & 7 of byte x >> 3
//                         is column x (np.packbits bitorder="little"); bits
//                         of columns >= W are zero
// One launch per frame batch.
//
// Exactness: box sums are exact int32 (33^2 * 255 < 2^24).  For an integral
// C the test is (g + C) * win^2 <= s, which equals the float32 test of
// vican_tpu/ops/detect.adaptive_threshold on every pixel (the proof is in
// vican_tpu/_native/fastthresh.c:11-17).  Otherwise the float32 path is
// taken literally: fl(fl(s / win^2) - C) with IEEE division (__fdiv_rn; the
// build must never use --use_fast_math).  The TPU kernel multiplies by the
// reciprocal instead (threshold.py:66) and may differ at exact ties; this
// kernel follows the spec.
//
// What bounds it: integer operations.  At 32 x 1280 x 720 the kernel reads
// 29.5 MB and writes 25.8 MB (0.017 ms at 3.35 TB/s), but the function needs
// ~38 int32 operations per pixel (one integral image of the padded frame,
// g + C once, and per window a 3-term box sum, scale and compare), ~0.067 ms
// at the card's INT32 rate.  This design spends more: it rebuilds the halo's
// integral in every tile, the centre value from the integral, g + C in every
// window.  It is simple: one block per (image, 16-row x
// 128-column tile) builds the integral image of the tile and its 16-pixel
// halo in shared memory (49 x 161 int32 = 31.6 KB; replicate borders by
// clamped indices), then each warp tests 32 adjacent pixels per window and
// packs them with one __ballot_sync: four lanes store the four bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WIN = 8;
constexpr int R = 16;               // halo: the largest radius (win <= 33)
constexpr int TH = 16;              // output rows per block
constexpr int TW = 128;             // output columns per block (4 warps wide)
constexpr int IH = TH + 2 * R + 1;  // integral rows, leading zero row
constexpr int IW = TW + 2 * R + 1;  // integral columns, leading zero column
constexpr int THREADS = 256;

struct Wins {
  int n;
  int w[MAX_WIN];
};

__global__ void __launch_bounds__(THREADS)
threshold_pack_kernel(const uint8_t* __restrict__ gray, uint8_t* __restrict__ out, int H,
                      int W, int Wb, Wins wins, int c_is_int, int c_int, float c) {
  __shared__ int I[IH][IW];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const uint8_t* img = gray + (size_t)b * H * W;

  // the tile and its halo, replicate borders through clamped indices
  for (int k = threadIdx.x; k < IH * IW; k += THREADS) {
    const int i = k / IW, j = k - (k / IW) * IW;
    int v = 0;
    if (i > 0 && j > 0) {
      const int gy = min(max(y0 - R + i - 1, 0), H - 1);
      const int gx = min(max(x0 - R + j - 1, 0), W - 1);
      v = img[(size_t)gy * W + gx];
    }
    I[i][j] = v;
  }
  __syncthreads();
  // row prefix sums (row stride 161 words: consecutive threads, distinct banks)
  for (int i = threadIdx.x; i < IH; i += THREADS) {
    int acc = 0;
    for (int j = 1; j < IW; ++j) {
      acc += I[i][j];
      I[i][j] = acc;
    }
  }
  __syncthreads();
  // column prefix sums: I[i][j] = sum of the tile over rows < i, columns < j
  for (int j = threadIdx.x; j < IW; j += THREADS) {
    int acc = 0;
    for (int i = 1; i < IH; ++i) {
      acc += I[i][j];
      I[i][j] = acc;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int tx = threadIdx.x % TW;
  const int x = x0 + tx;
  const int warp_byte = (x0 + (tx & ~31)) >> 3;  // first output byte of this warp
  const int cx = tx + R;
  for (int ty = threadIdx.x / TW; ty < TH; ty += THREADS / TW) {
    const int y = y0 + ty;
    const int cy = ty + R;
    const int g = I[cy + 1][cx + 1] - I[cy][cx + 1] - I[cy + 1][cx] + I[cy][cx];
    for (int wi = 0; wi < wins.n; ++wi) {
      const int win = wins.w[wi];
      const int r = win >> 1;
      const int s = I[cy + r + 1][cx + r + 1] - I[cy - r][cx + r + 1] -
                    I[cy + r + 1][cx - r] + I[cy - r][cx - r];
      bool fg;
      if (c_is_int) {
        fg = (g + c_int) * (win * win) <= s;
      } else {
        fg = (float)g <= __fsub_rn(__fdiv_rn((float)s, (float)(win * win)), c);
      }
      const unsigned m = __ballot_sync(0xffffffffu, fg && x < W);
      if (lane < 4 && y < H && warp_byte + lane < Wb) {
        out[(((size_t)b * wins.n + wi) * H + y) * Wb + warp_byte + lane] =
            (uint8_t)(m >> (8 * lane));
      }
    }
  }
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError().  `c_is_int`
// selects the integer test with `c_int` == C; otherwise the float test with
// `c`.  Windows: `n_win` odd sizes <= 33 in w0..w7.
extern "C" int threshold_pack_u8(const void* gray, void* out, int B, int H, int W, int n_win,
                                 int w0, int w1, int w2, int w3, int w4, int w5, int w6,
                                 int w7, int c_is_int, int c_int, float c, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || n_win < 1 || n_win > MAX_WIN || B > 65535)
    return (int)cudaErrorInvalidValue;
  Wins wins;
  wins.n = n_win;
  const int ws[MAX_WIN] = {w0, w1, w2, w3, w4, w5, w6, w7};
  for (int i = 0; i < MAX_WIN; ++i) {
    wins.w[i] = ws[i];
    if (i < n_win && (ws[i] < 1 || ws[i] > 2 * R + 1 || !(ws[i] & 1)))
      return (int)cudaErrorInvalidValue;
  }
  const int Wb = (W + 7) / 8;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  threshold_pack_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(gray), static_cast<uint8_t*>(out), H, W, Wb, wins, c_is_int,
      c_int, c);
  return (int)cudaGetLastError();
}

extern "C" const char* threshold_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
