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
//   X   (n, w)   f32, rounded to bf16 by the kernels
//   Y   (n, w)   f32 output
// Numerics as the TPU kernel (pallas_pwr.py:50-52): bf16 operands, f32
// accumulation, Lambda applied in f32, W = Lambda B^T X rounded to bf16
// before the second product.
//
// What bounds it: bytes.  At 10k cameras Bt is 3T x 3C x 2 B = 1.8 GB and X,
// W, Y are a few MB, so a launch can be no faster than one read of Bt
// (0.54 ms at 3.35 TB/s).  Two designs, both on the tensor cores, chosen by
// shape in pwr.py:pwr_plan before the launch:
//
// pwr_single_bf16 -- one read of Bt, the counterpart of the TPU kernel's
//   VMEM-resident panel.  A thread-block cluster of CS CTAs owns a range of
//   timesteps; CTA r owns camera columns [r cc, (r+1) cc), holds X's slice
//   as mma fragments in registers and its slice of Y in mma accumulators for
//   the whole run.  Per panel of P = 8 timesteps (24 rows of Bt) the CTA
//   has its (24, cc) slice copied into shared memory by the bulk-copy
//   engine (one copy a row, issued by the lanes of one warp, completing on
//   an mbarrier; the next panel's copies run during this panel's work),
//   computes a partial Z^T = X^T Bt^T (16 x 24), sums the CS partials over
//   distributed shared memory by a fixed shuffle tree (one cluster barrier
//   a panel; the partial buffers alternate so no second barrier guards
//   them), applies Lambda, rounds W to bf16 and adds panel^T W to Y from
//   the slice still in shared memory.  Each cluster writes its (n, w)
//   partial; a last pass adds the clusters' partials in cluster order.
//   What limits it (PERF.md): the barrier per panel, where the slowest CTA
//   of the cluster sets the pace, with no room for a third panel buffer
//   that would let the barrier overlap the next panel's product.
//
// pwr_apply_bf16 -- two reads of Bt, for shapes the single read cannot fit
//   (n > 16 CTAs x 1920 columns): phase 1 Z (3T, w) = Bt X on the tile
//   engine of thin_mma.cuh, then pwr_lambda (K-split partials summed in
//   order, Lambda, bf16 W stored transposed), then phase 2 Y (n, w) =
//   Bt^T W on the same engine with ldmatrix.trans, its K-split partials
//   summed in order.
//
// Neither design uses atomics: a second launch returns the same bits.
#include <cooperative_groups.h>

#include "thin_mma.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------- two reads

// Wt[c, q] = bf16(sum_b lam[t, a, b] Z[3t+b, c]) for q = 3t+a < 3T and
// c < w, zero elsewhere; Z is the sum, in part order, of `parts` (3T, w)
// float32 partials.
__global__ void pwr_lambda(const float* __restrict__ Z, const float* __restrict__ lam,
                           __nv_bfloat16* __restrict__ Wt, int parts, int T, int w, int ldw,
                           int rows) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)rows * ldw) return;
  const int c = (int)(i / ldw), q = (int)(i % ldw);
  float v = 0.f;
  if (c < w && q < 3 * T) {
    const int t = q / 3, a = q - 3 * t;
    const size_t plane = (size_t)3 * T * w;
    float z[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const float* zp = Z + (size_t)(3 * t + b) * w + c;
      float s = zp[0];
      for (int k = 1; k < parts; ++k) s += zp[k * plane];
      z[b] = s;
    }
    const float* L = lam + (size_t)t * 9 + 3 * a;
    v = L[0] * z[0] + L[1] * z[1] + L[2] * z[2];
  }
  Wt[i] = __float2bfloat16(v);
}

template <int NT>
cudaError_t two_read(const __nv_bfloat16* Bt, const float* lam, const float* X,
                     __nv_bfloat16* Xt, float* Zpart, __nv_bfloat16* Wt, float* Ypart, float* Y,
                     int T, int n, int ld, int ldx, int ldw, int w, int s1, int tps1, int s2,
                     int tps2, cudaStream_t s) {
  cudaError_t e = thin::launch_pack_xt(X, Xt, n, w, NT * 8, ldx, s);
  if (e != cudaSuccess) return e;
  const thin::MmaArgs p1{Bt, Xt, Zpart, 3 * T, n, ld, ldx, w, tps1};
  if ((e = thin::launch_mma<NT, false, true>(p1, s1, 1, s)) != cudaSuccess) return e;
  const size_t nw = (size_t)NT * 8 * ldw;
  pwr_lambda<<<(unsigned)((nw + 255) / 256), 256, 0, s>>>(Zpart, lam, Wt, s1, T, w, ldw, NT * 8);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const thin::MmaArgs p2{Bt, Wt, s2 > 1 ? Ypart : Y, n, 3 * T, ld, ldw, w, tps2};
  if ((e = thin::launch_mma<NT, true, true>(p2, s2, 1, s)) != cudaSuccess) return e;
  if (s2 == 1) return cudaSuccess;
  return thin::launch_split_reduce(Ypart, Y, s2, (size_t)n * w, s);
}

// --------------------------------------------------------------- one read

constexpr int SR_WARPS = 8;
constexpr int SR_THREADS = 32 * SR_WARPS;
constexpr int SR_P = 8;            // timesteps per panel (tiles.py:SINGLE_P)
constexpr int SR_Q = 3 * SR_P;     // rows of Bt per panel: one k16 and one k8 step
constexpr int SR_MT = 15;          // most m16 column tiles a warp holds (tiles.py:SINGLE_MT)
constexpr int SR_WSP = 32;         // row pitch of the W^T tile

struct SingleArgs {
  const __nv_bfloat16* Bt;
  const float* lam;
  const float* X;           // (n, w) float32, rounded to bf16 here
  float* Ypart;             // (clusters, n, w)
  int T, n, ld, w;
  int mt;                   // m16 column tiles per warp: cc = 128 mt
};

// bytes of dynamic shared memory for cc columns a CTA (tiles.py:single_smem)
__host__ __device__ constexpr size_t single_smem(int cc) {
  return (size_t)2 * SR_Q * (cc + 8) * 2      // two panels, rows padded by 16 bytes
         + (size_t)SR_WARPS * 16 * SR_Q * 4   // per-warp partial Z^T
         + (size_t)2 * 16 * SR_Q * 4          // the CTA's partial, double-buffered
         + (size_t)2 * SR_P * 9 * 4           // Lambda, double-buffered
         + (size_t)16 * SR_WSP * 2            // W^T, bf16
         + 2 * sizeof(uint64_t);              // the panels' mbarriers
}

// mbarrier and bulk-copy (TMA engine) primitives for the panel copies
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(thin::smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(thin::smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(thin::smem_u32(bar)), "r"(parity) : "memory");
}
// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(thin::smem_u32(dst)), "l"(src), "r"(bytes), "r"(thin::smem_u32(bar)) : "memory");
}

// bf16(X[k, c]) and bf16(X[k + 1, c]) packed low to high; zero past n and w
__device__ __forceinline__ uint32_t xpair(const float* X, int n, int w, int k, int c) {
  const float lo = c < w && k < n ? X[(size_t)k * w + c] : 0.f;
  const float hi = c < w && k + 1 < n ? X[(size_t)(k + 1) * w + c] : 0.f;
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int NT>
__global__ void __launch_bounds__(SR_THREADS, 1) pwr_single(SingleArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int gid = blockIdx.x / cs;
  const int clusters = gridDim.x / cs;
  const int cc = p.mt * 16 * SR_WARPS;
  const int sp = cc + 8;  // row pitch: 16 bytes past a multiple of 128, conflict-free ldmatrix
  const int col0 = rank * cc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int lcol = warp * p.mt * 16;  // the warp's first column in the panel

  __nv_bfloat16* panels = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* zw = reinterpret_cast<float*>(smem_raw + (size_t)2 * SR_Q * sp * 2);
  float* zc = zw + SR_WARPS * 16 * SR_Q;  // the CTA's partial, double-buffered
  float* lams = zc + 2 * 16 * SR_Q;       // the panel's Lambda, double-buffered
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(lams + 2 * SR_P * 9);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ws + 16 * SR_WSP);
  for (int i = tid; i < 16 * SR_WSP; i += SR_THREADS) ws[i] = __float2bfloat16(0.f);
  // columns past ld and rows past 3T are never copied: zero, once
  for (int i = tid; i < 2 * SR_Q * sp / 8; i += SR_THREADS)
    reinterpret_cast<uint4*>(panels)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros, before the copies
  __syncthreads();

  // X^T fragments (rows c, columns k = cameras) of the warp's columns,
  // rounded to bf16 from X (n, w) float32
  uint32_t xa[SR_MT][4];
#pragma unroll
  for (int mt = 0; mt < SR_MT; ++mt) {
    const int k = mt < p.mt ? col0 + lcol + mt * 16 + tig * 2 : p.n;
    // rows 8..15 of X^T are zero at w <= 8 (NT == 1): constants, no registers
    xa[mt][0] = xpair(p.X, p.n, p.w, k, g);
    xa[mt][1] = NT == 1 ? 0u : xpair(p.X, p.n, p.w, k, g + 8);
    xa[mt][2] = xpair(p.X, p.n, p.w, k + 8, g);
    xa[mt][3] = NT == 1 ? 0u : xpair(p.X, p.n, p.w, k + 8, g + 8);
  }
  float acc[SR_MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < SR_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int npanels = (p.T + SR_P - 1) / SR_P;
  const int pb = (int)((long long)gid * npanels / clusters);
  const int pe = (int)((long long)(gid + 1) * npanels / clusters);
  // a row of a panel: this CTA's columns up to ld (multiple of 8), 16-byte aligned
  const uint32_t seg = (uint32_t)max(0, min(cc, p.ld - col0)) * 2;

  // a panel's rows, by warp 0: one bulk copy a lane on the panel's
  // mbarrier, so no warp stalls on the copies; and, by 18 threads, its Lambda
  auto load_panel = [&](int buf, int panel) {
    const int q0 = panel * SR_Q;
    if (warp == 0) {
      const int rows = min(SR_Q, 3 * p.T - q0);
      if (lane == 0) mbar_expect_tx(&bars[buf], rows * seg);
      __syncwarp();
      if (seg > 0 && lane < rows)
        bulk_copy(panels + ((size_t)buf * SR_Q + lane) * sp,
                  p.Bt + (size_t)(q0 + lane) * p.ld + col0, seg, &bars[buf]);
    }
    if (tid < SR_P * 9 / 4) {
      const int e = panel * SR_P * 9 + tid * 4;  // 16-byte aligned: SR_P * 9 * 4 = 288
      const int left = 9 * p.T - e;
      thin::cp_async16(thin::smem_u32(lams + buf * SR_P * 9 + tid * 4),
                       left > 0 ? p.lam + e : p.lam, left > 0 ? min(4, left) * 4 : 0);
    }
  };

  if (pb < pe) load_panel(0, pb);
  thin::cp_async_commit();
  for (int panel = pb; panel < pe; ++panel) {
    const int use = panel - pb, buf = use & 1;
    thin::cp_async_wait<0>();
    mbar_wait(&bars[buf], (use >> 1) & 1);
    __syncthreads();  // this panel landed; the other buffer (panel - 1) is free
    if (panel + 1 < pe) load_panel(buf ^ 1, panel + 1);  // in flight during this panel's work
    thin::cp_async_commit();
    const __nv_bfloat16* pan = panels + (size_t)buf * SR_Q * sp;
    // the 8 rows an ldmatrix lane group addresses: q in [0, 16) by x4, [16, 24) by x2
    const int q16 = (lane & 7) + ((lane >> 4) << 3);
    const int q8 = 16 + (lane & 7);
    const int koff = ((lane >> 3) & 1) * 8;

    // partial Z^T (16 x 24) = X^T (16 x cols) . panel^T over the warp's columns
    float z[3][4];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[j][e] = 0.f;
#pragma unroll
    for (int mt = 0; mt < SR_MT; ++mt) {
      if (mt >= p.mt) break;
      const int kc = lcol + mt * 16 + koff;
      uint32_t b[4], b0, b1;
      thin::ldsm_x4(thin::smem_u32(pan + q16 * sp + kc), b);
      thin::ldsm_x2(thin::smem_u32(pan + q8 * sp + kc), b0, b1);
      thin::mma16816(z[0], xa[mt], b[0], b[1]);
      thin::mma16816(z[1], xa[mt], b[2], b[3]);
      thin::mma16816(z[2], xa[mt], b0, b1);
    }
    float* zwp = zw + warp * 16 * SR_Q;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int q = j * 8 + tig * 2;
      zwp[g * SR_Q + q] = z[j][0];
      zwp[g * SR_Q + q + 1] = z[j][1];
      zwp[(g + 8) * SR_Q + q] = z[j][2];
      zwp[(g + 8) * SR_Q + q + 1] = z[j][3];
    }
    __syncthreads();
    // the CTA's partial: rows c < w of Z^T, the warps' partials in order
    float* zcb = zc + buf * 16 * SR_Q;
    const int zn = p.w * SR_Q;
    for (int e = tid; e < zn; e += SR_THREADS) {
      float s = zw[e];
#pragma unroll
      for (int wi = 1; wi < SR_WARPS; ++wi) s += zw[wi * 16 * SR_Q + e];
      zcb[e] = s;
    }
    // every CTA's partial of this panel is written; the buffer written two
    // panels ago has been read by all (they passed the last barrier after)
    cluster.sync();
    // Z = the CS partials: 16 lanes a 16-byte vector, lane r reading rank r
    // over distributed shared memory, summed by a fixed shuffle tree (the
    // same in every CTA, so all hold the same Z), into zw, which is free
    // until the next panel; each thread's loads issued before any is used
    const int nv = zn / 4;
#pragma unroll
    for (int round = 0; round < 2; ++round) {
      constexpr int PER = 16 * 16 * SR_Q / 4 / SR_THREADS / 2;  // 3
      float4 v[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = tid + (round * PER + k) * SR_THREADS;
        const int r = i & 15, vec = i >> 4;
        v[k] = vec < nv && r < cs
                   ? reinterpret_cast<const float4*>(cluster.map_shared_rank(zcb, r))[vec]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          v[k].x += __shfl_xor_sync(0xffffffffu, v[k].x, off);
          v[k].y += __shfl_xor_sync(0xffffffffu, v[k].y, off);
          v[k].z += __shfl_xor_sync(0xffffffffu, v[k].z, off);
          v[k].w += __shfl_xor_sync(0xffffffffu, v[k].w, off);
        }
        const int i = tid + (round * PER + k) * SR_THREADS;
        if ((i & 15) == 0 && (i >> 4) < nv) reinterpret_cast<float4*>(zw)[i >> 4] = v[k];
      }
    }
    __syncthreads();
    // W = bf16(Lambda Z), stored as W^T for the second product
    if (tid < SR_P * 16) {
      const int tl = tid >> 4, c = tid & 15;
      if (c < p.w) {
        const float* zz = zw + c * SR_Q + 3 * tl;
        const float* L = lams + buf * SR_P * 9 + tl * 9;  // zero past T
#pragma unroll
        for (int a = 0; a < 3; ++a)
          ws[c * SR_WSP + 3 * tl + a] =
              __float2bfloat16(L[3 * a] * zz[0] + L[3 * a + 1] * zz[1] + L[3 * a + 2] * zz[2]);
      }
    }
    __syncthreads();

    // Y (cols x w) += panel^T (cols x 24) . W (24 x w), the panel still resident
    uint32_t wb[NT][3];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* wr = ws + (nt * 8 + g) * SR_WSP + tig * 2;
      wb[nt][0] = *reinterpret_cast<const uint32_t*>(wr);
      wb[nt][1] = *reinterpret_cast<const uint32_t*>(wr + 8);
      wb[nt][2] = *reinterpret_cast<const uint32_t*>(wr + 16);
    }
#pragma unroll
    for (int mt = 0; mt < SR_MT; ++mt) {
      if (mt >= p.mt) break;
      const int mc = lcol + mt * 16 + koff;
      uint32_t a[4], a0, a1;
      thin::ldsm_x4_trans(thin::smem_u32(pan + q16 * sp + mc), a);
      thin::ldsm_x2_trans(thin::smem_u32(pan + q8 * sp + mc), a0, a1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        thin::mma16816(acc[mt][nt], a, wb[nt][0], wb[nt][1]);
        thin::mma1688(acc[mt][nt], a0, a1, wb[nt][2]);
      }
    }
  }
  thin::cp_async_wait<0>();
  cluster.sync();  // no CTA leaves while another may still read its partials

  float* out = p.Ypart + (size_t)gid * p.n * p.w;
#pragma unroll
  for (int mt = 0; mt < SR_MT; ++mt) {
    if (mt >= p.mt) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = col0 + lcol + mt * 16 + g + 8 * h;
      if (m >= p.n) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nt * 8 + tig * 2;
        if (c < p.w) out[(size_t)m * p.w + c] = acc[mt][nt][2 * h];
        if (c + 1 < p.w) out[(size_t)m * p.w + c + 1] = acc[mt][nt][2 * h + 1];
      }
    }
  }
}

template <int NT>
cudaError_t single_config(int cs, int mt, cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  const size_t smem = single_smem(mt * 16 * SR_WARPS);
  cudaError_t e = cudaFuncSetAttribute(pwr_single<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && cs > 8)
    e = cudaFuncSetAttribute(pwr_single<NT>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(SR_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return e;
}

template <int NT>
cudaError_t single_read(const SingleArgs& p, float* Y, int cs, int clusters, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t e = single_config<NT>(cs, p.mt, cfg, attr);
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3((unsigned)(clusters * cs));
  cfg.stream = s;
  if ((e = cudaLaunchKernelEx(&cfg, pwr_single<NT>, p)) != cudaSuccess) return e;
  return thin::launch_split_reduce(p.Ypart, Y, clusters, (size_t)p.n * p.w, s);
}

template <int NT>
int max_clusters(int cs, int mt) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t e = single_config<NT>(cs, mt, cfg, attr);
  cfg.gridDim = dim3((unsigned)cs);
  int count = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&count, pwr_single<NT>, &cfg);
  return e == cudaSuccess ? count : -(int)e;
}

}  // namespace

// Two reads of Bt: launches the pack of X, phase 1, pwr_lambda, phase 2 and
// the reduce on `stream`; returns cudaGetLastError().  Xt (8 nt, ldx) and
// Wt (8 nt, ldw) bf16 scratch, nt = 1 for w <= 8 else 2; Zpart (s1, 3T, w)
// f32; Ypart (s2, n, w) f32 may alias Y when s2 == 1.  ldx and ldw are
// multiples of thin::XT_ALIGN, >= n and >= 3T.
extern "C" int pwr_apply_bf16(const void* Bt, const void* lam, const void* X, void* Xt,
                              void* Zpart, void* Wt, void* Ypart, void* Y, int T, int n, int ld,
                              int ldx, int ldw, int w, int s1, int tps1, int s2, int tps2,
                              void* stream) {
  if (T <= 0 || n <= 0 || n > ld || ld % 8 != 0 || w < 1 || w > 16 ||
      ldx % thin::XT_ALIGN != 0 || ldx < n || ldw % thin::XT_ALIGN != 0 || ldw < 3 * T ||
      s1 < 1 || s2 < 1 || tps1 < 1 || tps2 < 1 || reinterpret_cast<uintptr_t>(Bt) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const auto* bt = static_cast<const __nv_bfloat16*>(Bt);
  const auto* lm = static_cast<const float*>(lam);
  const auto* x = static_cast<const float*>(X);
  auto* xt = static_cast<__nv_bfloat16*>(Xt);
  auto* zp = static_cast<float*>(Zpart);
  auto* wt = static_cast<__nv_bfloat16*>(Wt);
  auto* yp = static_cast<float*>(Ypart);
  auto* y = static_cast<float*>(Y);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(w <= 8 ? two_read<1>(bt, lm, x, xt, zp, wt, yp, y, T, n, ld, ldx, ldw, w, s1,
                                    tps1, s2, tps2, s)
                      : two_read<2>(bt, lm, x, xt, zp, wt, yp, y, T, n, ld, ldx, ldw, w, s1,
                                    tps1, s2, tps2, s));
}

// One read of Bt: launches pwr_single on `clusters` clusters of `cs` CTAs,
// `mt` m16 column tiles a warp (cc = 128 mt columns a CTA, cs * cc >= n),
// then the reduce of the clusters' partials; returns cudaGetLastError().
// Ypart (clusters, n, w) f32.
extern "C" int pwr_single_bf16(const void* Bt, const void* lam, const void* X, void* Ypart,
                               void* Y, int T, int n, int ld, int w, int cs, int mt,
                               int clusters, void* stream) {
  if (T <= 0 || n <= 0 || n > ld || ld % 8 != 0 || w < 1 || w > 16 || cs < 1 || cs > 16 ||
      mt < 1 || mt > SR_MT || clusters < 1 || (long long)cs * mt * 16 * SR_WARPS < n ||
      reinterpret_cast<uintptr_t>(Bt) % 16 != 0 || reinterpret_cast<uintptr_t>(lam) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const SingleArgs p{static_cast<const __nv_bfloat16*>(Bt), static_cast<const float*>(lam),
                     static_cast<const float*>(X), static_cast<float*>(Ypart), T, n, ld, w, mt};
  auto* y = static_cast<float*>(Y);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(w <= 8 ? single_read<1>(p, y, cs, clusters, s)
                      : single_read<2>(p, y, cs, clusters, s));
}

// Clusters of `cs` CTAs that the card holds at once for the single-read
// kernel at this width and column count (cudaOccupancyMaxActiveClusters);
// a negative CUDA error code on failure.
extern "C" int pwr_single_clusters(int cs, int w, int mt) {
  return w <= 8 ? max_clusters<1>(cs, mt) : max_clusters<2>(cs, mt);
}

// Blocks per SM of the two-read kernel's phase (trans = 0: phase 1, 1:
// phase 2) at width w
extern "C" int pwr_mma_occupancy(int w, int trans) {
  if (w <= 8)
    return trans ? thin::mma_occupancy<1, true, true>() : thin::mma_occupancy<1, false, true>();
  return trans ? thin::mma_occupancy<2, true, true>() : thin::mma_occupancy<2, false, true>();
}

extern "C" const char* pwr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
