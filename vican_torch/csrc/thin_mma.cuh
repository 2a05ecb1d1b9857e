// The thin-product tile engine on Hopper's tensor cores (sm_90a), shared by
// mv.cu (thin_mv) and pwr.cu (pwr_apply).
//
//   C (M, w) = A (M, K) . X (K, w)   bf16 operands, float32 accumulation
//
// with A either row-major (A[m, k] at A + m * lda + k) or transposed
// (TRANS: A[m, k] at A + k * lda + m, the power graph's B read from its
// stored transpose Bt), and X given transposed, Xt (rows, ldx) with
// Xt[c, k] = X[k, c], zero past K and past w, ldx a multiple of XT_ALIGN.
//
// What bounds it: bytes.  At w <= 16 the product does 2 * w operations per
// 2-byte entry of A, far below the ~295 per byte at which an H100's bf16
// tensor cores become the limit, so the design goal is to keep enough of A
// in flight: each block streams BM x KD tiles of A (16-64 KB) through a ring of
// STAGES shared-memory buffers filled by 16-byte cp.async copies (zero-filled
// past the edges, never reading past K or M), so 2-3 resident blocks keep
// 100-200 KB per SM in flight.  The products run on mma.sync m16n8k16 (bf16
// in, float32 accumulators in registers) from fragments that ldmatrix reads
// out of XOR-swizzled tiles (ldmatrix.trans for the transposed operand), so
// no entry is widened on CUDA cores.  X is padded with zeros to NT n8 tiles
// (w = 1 -> one, w = 10 -> two, up to 16 = 128 columns per launch slice).
//
// Grid: x = row blocks of BM, y = K splits (each writes its own float32
// partial (M, w); split_reduce adds them in split order), z = 128-column
// slices of X.  No atomics: a second launch returns the same bits.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace thin {

constexpr int BM = 128;           // rows of C per block: 4 warps x 2 m16 tiles
constexpr int XT_ALIGN = 256;     // Xt's row stride is a multiple of every stage depth
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int PASS = 128;         // columns of X per grid-z slice (16 n8 tiles)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; `bytes` (0..16) are read, the rest zero-filled.
// The L2 fetches 256 bytes around each miss: the operator is streamed in
// 512-byte row segments, and with the hint thin_mv ran faster at the
// streaming shape on an H100 than without it, in runs alternating the two
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

// D += A (16x16, row) . B (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// D += A (16x8, row) . B (8x8, col)
__device__ __forceinline__ void mma1688(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Tiles of 8-entry (16-byte) chunks, the chunk index XORed with the row's
// low 3 bits, so the 8 rows an ldmatrix reads at one column fall in 8
// different bank groups.
__device__ __forceinline__ int swz(int row, int chunk, int chunks_per_row) {
  return row * chunks_per_row * 8 + ((chunk ^ (row & 7)) << 3);
}

struct MmaArgs {
  const __nv_bfloat16* A;
  const __nv_bfloat16* Xt;
  float* out;             // (splits, M, w) float32 partials, or C itself
  int M, K, lda, ldx, w;
  int tiles_per_split;    // stage-depth (KD) tiles of K per split
};

// Reduction entries per stage (tiles.py:stage_depth): where the operator
// is read by rows and X is narrow, long row segments of A (512 bytes at
// w <= 16, 256 at w <= 32: fewer DRAM pages opened per byte; faster at
// the streaming shape on an H100 than 256- and 128-byte segments, in runs
// alternating them)
template <int NT, bool TRANS>
__host__ __device__ constexpr int stage_depth() {
  return TRANS ? 64 : NT <= 2 ? 256 : NT <= 4 ? 128 : 64;
}

template <int NT, bool TRANS>
struct Shape {
  static constexpr int KD = stage_depth<NT, TRANS>();
  static constexpr int STAGES = NT >= 8 || KD >= 128 ? 3 : 4;
  static constexpr int A_ELEMS = BM * KD;
  static constexpr int X_ELEMS = NT * 8 * KD;
  static constexpr int STAGE_ELEMS = A_ELEMS + X_ELEMS;
  static constexpr int SMEM = STAGES * STAGE_ELEMS * 2;
};

template <int NT, bool TRANS, bool VEC>
__device__ __forceinline__ void load_stage(const MmaArgs& p, __nv_bfloat16* As,
                                           __nv_bfloat16* Xs, const __nv_bfloat16* xt,
                                           int m0, int k0, int ke) {
  constexpr int KD = stage_depth<NT, TRANS>(), CH = KD / 8;  // chunks a row of k
  const int tid = threadIdx.x;
  static_assert(VEC || !TRANS, "the transposed operand is read as vectors only");
#pragma unroll
  for (int j = 0; j < BM * KD / 8 / THREADS; ++j) {
    const int i = tid + j * THREADS;
    if (TRANS) {
      // tile [KD rows of k][BM columns of m], 16 chunks a row
      const int r = i >> 4, ch = i & 15;
      const int gk = k0 + r, gm = m0 + ch * 8;
      const bool ok = gk < ke && gm < p.M;
      const __nv_bfloat16* src = ok ? p.A + (size_t)gk * p.lda + gm : p.A;
      cp_async16(smem_u32(As + swz(r, ch, BM / 8)), src, ok ? min(8, p.M - gm) * 2 : 0);
    } else {
      // tile [BM rows of m][KD columns of k], CH chunks a row
      const int r = i / CH, ch = i % CH;
      const int gm = m0 + r, gk = k0 + ch * 8;
      const bool ok = gm < p.M && gk < ke;
      __nv_bfloat16* dst = As + swz(r, ch, CH);
      if (VEC) {
        const __nv_bfloat16* src = ok ? p.A + (size_t)gm * p.lda + gk : p.A;
        cp_async16(smem_u32(dst), src, ok ? min(8, ke - gk) * 2 : 0);
      } else {
        // rows at an odd stride or base: entry by entry, zero past the edges
        const uint16_t* row =
            reinterpret_cast<const uint16_t*>(p.A) + (size_t)min(gm, p.M - 1) * p.lda;
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = gk + 2 * e;
          const uint32_t lo = ok && k < ke ? row[k] : 0u;
          const uint32_t hi = ok && k + 1 < ke ? row[k + 1] : 0u;
          v[e] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  // Xt is zero past K up to ldx (a multiple of KD) and past w: whole chunks
  for (int i = tid; i < NT * 8 * CH; i += THREADS) {
    const int r = i / CH, ch = i % CH;
    cp_async16(smem_u32(Xs + swz(r, ch, CH)), xt + (size_t)r * p.ldx + k0 + ch * 8, 16);
  }
}

// One stage: the tile's KD entries of K summed by mma.sync into fresh
// accumulators, which are then added into `acc` on the CUDA cores.  The
// tensor cores' own accumulation does not round to nearest, and over a
// chain of K / 16 steps its error grows with K (1.5e-5 of max |Y| at
// K = 30000 on an H100); a chain of KD / 16 <= 8 steps per stage, added in
// float32 round-to-nearest, keeps the error at that of a float32 sum.
// The n8 tiles go in groups of at most 8 to bound the fresh registers.
template <int NT, bool TRANS>
__device__ __forceinline__ void compute_stage(const __nv_bfloat16* As, const __nv_bfloat16* Xs,
                                              float (&acc)[2][NT][4], int warp, int lane) {
  constexpr int G = NT < 8 ? NT : 8;
  constexpr int KD = stage_depth<NT, TRANS>(), CH = KD / 8;
#pragma unroll
  for (int g0 = 0; g0 < NT; g0 += G) {
    float part[2][G][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int mb = warp * 32 + mt * 16;
        if (TRANS) {
          const int k = kk * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4_trans(smem_u32(As + swz(k, (mb >> 3) + ((lane >> 3) & 1), BM / 8)), a[mt]);
        } else {
          const int r = mb + (lane & 15);
          ldsm_x4(smem_u32(As + swz(r, kk * 2 + (lane >> 4), CH)), a[mt]);
        }
      }
#pragma unroll
      for (int np = 0; np < (G + 1) / 2; ++np) {
        uint32_t b[4];
        const int ch = kk * 2 + ((lane >> 3) & 1);
        if (G == 1) {
          ldsm_x2(smem_u32(Xs + swz(lane & 7, ch, CH)), b[0], b[1]);
        } else {
          const int r = (g0 + 2 * np) * 8 + ((lane >> 4) << 3) + (lane & 7);
          ldsm_x4(smem_u32(Xs + swz(r, ch, CH)), b);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(part[mt][2 * np], a[mt], b[0], b[1]);
          if (2 * np + 1 < G) mma16816(part[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][g0 + j][e] += part[mt][j][e];
  }
}

template <int NT, bool TRANS, bool VEC>
__global__ void __launch_bounds__(THREADS) thin_mma_kernel(MmaArgs p) {
  using S = Shape<NT, TRANS>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int kb = split * p.tiles_per_split * S::KD;
  const int ke = min(p.K, kb + p.tiles_per_split * S::KD);
  const int ntiles = ke > kb ? (ke - kb + S::KD - 1) / S::KD : 0;
  const __nv_bfloat16* xt = p.Xt + (size_t)blockIdx.z * PASS * p.ldx;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < S::STAGES - 1; ++s) {
    __nv_bfloat16* st = smem + s * S::STAGE_ELEMS;
    if (s < ntiles) load_stage<NT, TRANS, VEC>(p, st, st + S::A_ELEMS, xt, m0, kb + s * S::KD, ke);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<S::STAGES - 2>();
    __syncthreads();  // tile t landed for all; tile t - 1's buffer is free
    const int nx = t + S::STAGES - 1;
    if (nx < ntiles) {
      __nv_bfloat16* st = smem + (nx % S::STAGES) * S::STAGE_ELEMS;
      load_stage<NT, TRANS, VEC>(p, st, st + S::A_ELEMS, xt, m0, kb + nx * S::KD, ke);
    }
    cp_async_commit();
    const __nv_bfloat16* st = smem + (t % S::STAGES) * S::STAGE_ELEMS;
    compute_stage<NT, TRANS>(st, st + S::A_ELEMS, acc, warp, lane);
  }
  cp_async_wait<0>();

  // accumulator (mt, nt): rows lane/4 and lane/4 + 8, columns 2 (lane % 4) + {0, 1}
  float* out = p.out + (size_t)split * p.M * p.w;
  const int c0 = blockIdx.z * PASS + (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + warp * 32 + mt * 16 + (lane >> 2) + 8 * h;
      if (r >= p.M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = c0 + nt * 8;
        if (c < p.w) out[(size_t)r * p.w + c] = acc[mt][nt][2 * h];
        if (c + 1 < p.w) out[(size_t)r * p.w + c + 1] = acc[mt][nt][2 * h + 1];
      }
    }
}

// Xt (rows, ldx): Xt[c, k] = bf16(X[k, c]) for k < K and c < w, zero
// elsewhere, from X (K, w) float32 row-major; 32 x 32 tiles transposed
// through shared memory, so reads and writes both go by rows
__global__ void pack_xt(const float* __restrict__ X, __nv_bfloat16* __restrict__ Xt, int K,
                        int w, int rows, int ldx) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int k = k0 + j, c = c0 + threadIdx.x;
    tile[j][threadIdx.x] = k < K && c < w ? X[(size_t)k * w + c] : 0.f;
  }
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int c = c0 + j, k = k0 + threadIdx.x;
    if (c < rows) Xt[(size_t)c * ldx + k] = __float2bfloat16(tile[threadIdx.x][j]);
  }
}

// ldx a multiple of 32
inline cudaError_t launch_pack_xt(const float* X, __nv_bfloat16* Xt, int K, int w, int rows,
                                  int ldx, cudaStream_t s) {
  pack_xt<<<dim3(ldx / 32, (rows + 31) / 32), dim3(32, 8), 0, s>>>(X, Xt, K, w, rows, ldx);
  return cudaGetLastError();
}

// out[i] = sum over parts, in part order, of part[k * n + i]
__global__ void split_reduce(const float* __restrict__ part, float* __restrict__ out, int parts,
                             size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int k = 1; k < parts; ++k) s += part[(size_t)k * n + i];
  out[i] = s;
}

inline cudaError_t launch_split_reduce(const float* part, float* out, int parts, size_t n,
                                       cudaStream_t s) {
  split_reduce<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, out, parts, n);
  return cudaGetLastError();
}

template <int NT, bool TRANS, bool VEC>
cudaError_t launch_mma(const MmaArgs& p, int splits, int passes, cudaStream_t s) {
  using S = Shape<NT, TRANS>;
  if ((long long)splits * p.tiles_per_split * S::KD < p.K) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(thin_mma_kernel<NT, TRANS, VEC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((p.M + BM - 1) / BM), (unsigned)splits, (unsigned)passes);
  thin_mma_kernel<NT, TRANS, VEC><<<grid, THREADS, S::SMEM, s>>>(p);
  return cudaGetLastError();
}

// Blocks of this instance an SM holds at once; a negative CUDA error code
// on failure
template <int NT, bool TRANS, bool VEC>
int mma_occupancy() {
  using S = Shape<NT, TRANS>;
  cudaError_t e = cudaFuncSetAttribute(thin_mma_kernel<NT, TRANS, VEC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, thin_mma_kernel<NT, TRANS, VEC>,
                                                      THREADS, S::SMEM);
  return e == cudaSuccess ? blocks : -(int)e;
}

}  // namespace thin
