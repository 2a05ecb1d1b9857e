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
//   X   (K, w)  f32 row-major, rounded to bf16 into
//   Xt  (rows, ldx) bf16 scratch, X transposed: Xt[c, k] = X[k, c]; ldx a
//       multiple of 256 and >= K; zero past K and past w; rows = 8 nt, or
//       128 per column slice when w > 128
//   Y   (M, w)  f32 row-major output; Ypart (splits, M, w) f32 scratch
//
// What bounds it: bytes.  B is M*K*2 bytes (1.8 GB for the 30000^2 operator,
// 0.54 ms at 3.35 TB/s); X and Y are small and the 2*M*K*w operations take
// less on the tensor cores, even at the probe's w = 128.  The design is the
// tile engine of thin_mma.cuh (cp.async ring, ldmatrix, mma.sync): every
// column of X up to 128 goes in one pass, so B is read once per 128 columns;
// K is split over blocks only where M's row blocks cannot fill the card,
// and the split partials are added in a fixed order (no atomics).
//
// Rows of B on 16-byte boundaries (vec != 0) are copied as 16-byte vectors,
// zero-filled past K and M; others entry by entry, never past K.
#include "thin_mma.cuh"

namespace {

template <int NT>
cudaError_t run(const thin::MmaArgs& p, int passes, int splits, bool vec, cudaStream_t s) {
  return vec ? thin::launch_mma<NT, false, true>(p, splits, passes, s)
             : thin::launch_mma<NT, false, false>(p, splits, passes, s);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError().  `nt` n8 tiles (1, 2,
// 4, 8 or 16) cover min(w, 128) columns; past 128 columns nt is 16 and the
// grid's z slices take 128 each.  `splits` partials of `tps` stage-depth
// tiles of K (thin_mma.cuh:stage_depth) go to Ypart and are summed into Y
// in split order; with splits == 1 the kernel writes Y.  `vec` != 0 promises ldb % 8 == 0 and an aligned B.
extern "C" int thin_mv_bf16(const void* B, const void* X, void* Xt, void* Ypart, void* Y, int M,
                            int K, int ldb, int ldx, int w, int nt, int splits, int tps, int vec,
                            void* stream) {
  const int passes = (w + thin::PASS - 1) / thin::PASS;
  if (M <= 0 || K <= 0 || w <= 0 || ldb < K || ldx % thin::XT_ALIGN != 0 || ldx < K ||
      nt * 8 < (w < thin::PASS ? w : thin::PASS) || (passes > 1 && nt != 16) || splits < 1 ||
      tps < 1 ||
      (vec && (ldb % 8 != 0 || reinterpret_cast<uintptr_t>(B) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  auto* y = static_cast<float*>(Y);
  auto* xt = static_cast<__nv_bfloat16*>(Xt);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = thin::launch_pack_xt(static_cast<const float*>(X), xt, K, w,
                                       passes > 1 ? passes * thin::PASS : nt * 8, ldx, s);
  if (e != cudaSuccess) return (int)e;
  const thin::MmaArgs p{static_cast<const __nv_bfloat16*>(B), xt,
                        splits > 1 ? static_cast<float*>(Ypart) : y,
                        M, K, ldb, ldx, w, tps};
  switch (nt) {
    case 1: e = run<1>(p, passes, splits, vec != 0, s); break;
    case 2: e = run<2>(p, passes, splits, vec != 0, s); break;
    case 4: e = run<4>(p, passes, splits, vec != 0, s); break;
    case 8: e = run<8>(p, passes, splits, vec != 0, s); break;
    case 16: e = run<16>(p, passes, splits, vec != 0, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || splits == 1) return (int)e;
  return (int)thin::launch_split_reduce(p.out, y, splits, (size_t)M * w, s);
}

// Blocks per SM of the instance for `nt` n8 tiles (vector rows)
extern "C" int thin_mv_occupancy(int nt) {
  switch (nt) {
    case 1: return thin::mma_occupancy<1, false, true>();
    case 2: return thin::mma_occupancy<2, false, true>();
    case 4: return thin::mma_occupancy<4, false, true>();
    case 8: return thin::mma_occupancy<8, false, true>();
    case 16: return thin::mma_occupancy<16, false, true>();
    default: return -(int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
