// Fused joint-plane kernel for Hopper (sm_90a): the joint network's V
// reduction for the RNN-T loss, without materialising the logits.
//
// Replaces rnnt_tpu/ops/joint_loss_fused.py::_plane_kernel (launched by
// _compute_planes).  For every lattice cell n = (b, t, u):
//   h[n]      = tanh(f[b,t] + g[b,u] + b1)             [J], rounded to W
//   logits[n] = h[n] @ W2 + b2                         [V], fp32
//   denom[n]  = logsumexp(logits[n]), blank[n] = logits[n][0],
//   emit[n]   = logits[n][y[b,u]]
// f [B,T,J] and g [B,U+1,J] are the two sides' projections through the first
// joint Dense, in the weight type W; W2 [J,Vp] arrives padded to a multiple
// of VT columns with zeros, and b2 [Vp] in fp32 padded with -1e30, so padded
// columns never win the max nor add to the sum.
//
// Bound on the H100: the [cells, J] x [J, V] product, 2 x cells x J x V
// operations (1.40 TFLOP at B=32, T'=128, U+1=65, J=640, V=4096: 1.41 ms at
// 989 TFLOP/s in bf16; 4.23 ms at B=96); the bytes (f, g, W2 in, three
// planes out) are a few MB.  So the kernel is bound by its tensor-core rate.
//
// Three designs; the launcher of each dtype picks one (planes_last_design()):
//
// WGMMA (bf16, wherever the padded J's h tile and a ring of >= 3 W2 stages
// fit in a block's shared memory: J <= 704 on the H100).  A persistent grid
// of one CTA an SM walks tiles of 128 consecutive cells.  Its threads are two
// consumer warpgroups, each owning 64 cells of the tile, and a producer
// warpgroup, one thread of which issues the copies (setmaxnreg hands the
// rest of its registers to the consumers).  The five things that held the
// WMMA design back, and what this one does about each:
//  1. one block of 8 warps an SM with nothing to hide its stalls: the
//     producer keeps W2's copies in flight while the consumers compute, and
//     a chunk's products run while the previous chunk is folded;
//  2. W2 staged synchronously behind two barriers a slab: W2 arrives by TMA
//     bulk copies (`cp.async.bulk`, 16 KB a stage) into a ring of 3-4
//     stages, each stage completed on its mbarrier and released by the
//     consumers' own mbarrier arrivals: no block-wide barrier in the loop;
//  3. W2 read from L2 once every 64 cells: once every 128 cells (h of 128
//     cells, J=640: 160 KB, built once a tile);
//  4. the logits' round trip through shared memory before the fold: the
//     online logsumexp folds straight from the accumulator registers (each
//     thread 2 rows x 32 columns of a chunk, its own running (max, sum of
//     exp) per row, merged over its quad at the end); blank and emit are
//     picked by the thread that holds their column;
//  5. WMMA 16x16x16 from shared memory: `wgmma.mma_async` m64n128k16, bf16
//     in, fp32 accumulate, A (h) and B (the W2 tile) both read from shared
//     memory in the 128-byte-swizzled K-major layout; two accumulator sets,
//     so the next chunk's first two k-blocks run while a chunk is folded.
// Each launch first packs W2 (`pack_w2_kernel`; `ops/planes_cuda.pack_w2` is
// its plain version): the padded [Jp, Vp] matrix transposed and cut into
// [128 v x 64 k] tiles in the order the consumers read them (V chunk, then
// k-block), each row already swizzled, so every stage is one contiguous 1D
// bulk copy.  That needs no tensor map (its
// encoder, cuTensorMapEncodeTiled, lives in libcuda, which this library does
// not link) and no MN-major B operand; the price is a repack of W2 (5.24 MB
// at the parity width) at every launch, counted in the kernel's time.  No
// L2 eviction hint: the 5.24 MB that every CTA re-reads should stay in L2.
// On the H100 it runs at ~55% of the bound at B=32 (PERF.md): the h build
// (tanhf, not overlapped) and the fold's exponentials are what remain; the
// W2 stream costs ~5%.  The tile machinery is in wgmma.cuh, which the loss
// backward's K8 (joint_loss_bwd.cu) shares with an epilogue of its own; a
// caller may keep the packed W2 (the fused loss does, for K8).
//
// WMMA (bf16 outside that plan: a wide joint).  A block owns CT consecutive
// cells.  It builds their tanh tile once in shared memory (rounded to W, as
// the TPU kernel rounds h before its product), then streams V in chunks of
// VT columns: each chunk's product is computed in the block with W2 staged
// through shared memory in slabs of KS rows, and folded into a running
// (max, sum of exp) per cell; blank and emit are picked from the chunk that
// holds their column.  Warp-level tensor-core MMA (WMMA 16x16x16, fp32
// accumulation; 8 warps, each a 16 x 64 tile of the 64 x 128 chunk).
//
// FMA (fp32): the WMMA design's schedule with plain fp32 FMA on the CUDA
// cores (each thread a 4 x 4 tile of the 32 x 128 chunk), no TF32.

#include <mma.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int PT = 256;  // threads per block (8 warps)
constexpr int VT = 128;  // V columns per chunk
constexpr int KS = 64;   // W2 rows per shared-memory slab

template <typename W>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int CT = 64;  // cells per block
  static constexpr int HPAD = 8;  // row padding of the h tile (elements)
  static constexpr int WPAD = 8;  // row padding of a W2 slab
};
template <>
struct Tile<float> {
  static constexpr int CT = 32;
  static constexpr int HPAD = 0;
  static constexpr int WPAD = 0;
};
constexpr int LPAD = 4;  // row padding of the fp32 logits chunk

// Phases of a block's time (enum PlanePhase).  Diagnostics only, off unless
// built with -DPLANES_PHASE_TIMERS (kernels/lstm_ab.py --kernel planes
// src.cu:PLANES_PHASE_TIMERS=1): thread 0 of every block adds the
// nanoseconds of %globaltimer since its last mark to the phase it just
// finished, in registers, and adds its totals to its block's row of
// g_planes_ns at the end (read back through planes_phases()).
enum PlanePhase {
  PP_BUILD,       // the tanh tile (and the cells' offsets)
  PP_W2_WAIT,     // W2 into shared memory: staging loads (WMMA, FMA), or
                  // waiting for a ring stage (WGMMA)
  PP_PRODUCTS,    // the products (WGMMA: issue and wait_group)
  PP_LOGITS_OUT,  // the accumulators out to the fp32 logits chunk (not in
                  // WGMMA)
  PP_FOLD,        // the online logsumexp, blank and emit
  PP_BARRIER,     // waiting at __syncthreads (WGMMA: the warpgroup's
                  // barrier after its h rows)
  PP_N
};
constexpr int PP_MAX_BLOCKS = 16384;  // rows of g_planes_ns
#ifdef PLANES_PHASE_TIMERS
__device__ unsigned long long g_planes_ns[PP_MAX_BLOCKS][PP_N];
#endif
int g_last_grid = 0;  // blocks of the last launch (host side)
// The design of the last launch, as planes_last_design() reports it.
enum PlaneDesign { D_WGMMA, D_WMMA, D_FMA };
int g_last_design = D_FMA;

struct PlaneTimer {
#ifdef PLANES_PHASE_TIMERS
  unsigned long long mark = 0, ph[PP_N] = {};
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ bool mine() const {
    return threadIdx.x == 0 && blockIdx.x < PP_MAX_BLOCKS;
  }
  __device__ void start() {
    if (mine()) mark = now();
  }
  __device__ void at(int i) {
    if (mine()) {
      const unsigned long long t = now();
      ph[i] += t - mark;
      mark = t;
    }
  }
  __device__ void flush() {
    if (mine())
      for (int i = 0; i < PP_N; ++i) g_planes_ns[blockIdx.x][i] += ph[i];
  }
#else
  __device__ void start() {}
  __device__ void at(int) {}
  __device__ void flush() {}
#endif
};

template <typename W>
inline size_t plane_smem(int J) {
  using T = Tile<W>;
  return sizeof(W) * ((size_t)T::CT * (J + T::HPAD) + (size_t)KS * (VT + T::WPAD)) +
         sizeof(float) * ((size_t)T::CT * (VT + LPAD) + 4 * T::CT) +
         sizeof(int) * 3 * T::CT;
}

// logits chunk ls[CT][VT+LPAD] = hs[CT][J] @ W2[:, v0:v0+VT]
template <typename W>
__device__ void chunk_product(const W* hs, W* ws, float* ls,
                              const W* __restrict__ w2, int J, int Vp,
                              int v0, PlaneTimer& tm);

template <>
__device__ void chunk_product<__nv_bfloat16>(const __nv_bfloat16* hs,
                                             __nv_bfloat16* ws, float* ls,
                                             const __nv_bfloat16* __restrict__ w2,
                                             int J, int Vp, int v0,
                                             PlaneTimer& tm) {
  using namespace nvcuda;
  using T = Tile<__nv_bfloat16>;
  const int warp = threadIdx.x / 32;
  const int rw = warp % 4, cw = warp / 4;  // 16-row group, 64-column group
  const int hld = J + T::HPAD, wld = VT + T::WPAD;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int k0 = 0; k0 < J; k0 += KS) {
    const int ks = min(KS, J - k0);
    // stage W2[k0:k0+ks, v0:v0+VT] with 16-byte loads (8 elements)
    for (int i = threadIdx.x; i < ks * (VT / 8); i += PT) {
      const int r = i / (VT / 8), c8 = (i - r * (VT / 8)) * 8;
      *reinterpret_cast<uint4*>(ws + r * wld + c8) =
          __ldg(reinterpret_cast<const uint4*>(w2 + (size_t)(k0 + r) * Vp +
                                               v0 + c8));
    }
    tm.at(PP_W2_WAIT);
    __syncthreads();
    tm.at(PP_BARRIER);
    for (int kk = 0; kk < ks; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, hs + rw * 16 * hld + k0 + kk, hld);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, ws + kk * wld + cw * 64 + i * 16, wld);
        wmma::mma_sync(acc[i], a, bf, acc[i]);
      }
    }
    tm.at(PP_PRODUCTS);
    __syncthreads();
    tm.at(PP_BARRIER);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    wmma::store_matrix_sync(ls + rw * 16 * (VT + LPAD) + cw * 64 + i * 16,
                            acc[i], VT + LPAD, wmma::mem_row_major);
  tm.at(PP_LOGITS_OUT);
}

template <>
__device__ void chunk_product<float>(const float* hs, float* ws, float* ls,
                                     const float* __restrict__ w2, int J,
                                     int Vp, int v0, PlaneTimer& tm) {
  // thread: rows r0..r0+3, columns lane + 32q (q < 4)
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  for (int k0 = 0; k0 < J; k0 += KS) {
    const int ks = min(KS, J - k0);
    for (int i = threadIdx.x; i < ks * (VT / 4); i += PT) {
      const int r = i / (VT / 4), c4 = (i - r * (VT / 4)) * 4;
      *reinterpret_cast<float4*>(ws + r * VT + c4) = __ldg(
          reinterpret_cast<const float4*>(w2 + (size_t)(k0 + r) * Vp + v0 + c4));
    }
    tm.at(PP_W2_WAIT);
    __syncthreads();
    tm.at(PP_BARRIER);
    for (int kk = 0; kk < ks; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = hs[(r0 + i) * J + k0 + kk];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = ws[kk * VT + lane + 32 * q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], bv[q], acc[i][q]);
    }
    tm.at(PP_PRODUCTS);
    __syncthreads();
    tm.at(PP_BARRIER);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      ls[(r0 + i) * (VT + LPAD) + lane + 32 * q] = acc[i][q];
  tm.at(PP_LOGITS_OUT);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename W>
__global__ void __launch_bounds__(PT)
    plane_kernel(const W* __restrict__ f,      // [B, T, J]
                 const W* __restrict__ g,      // [B, U1, J]
                 const int* __restrict__ y,    // [B, U1] label of each cell
                 const W* __restrict__ b1,     // [J]
                 const W* __restrict__ w2,     // [J, Vp]
                 const float* __restrict__ b2, // [Vp]
                 float* __restrict__ denom,    // [B*T*U1]
                 float* __restrict__ blank,
                 float* __restrict__ emit,
                 int B, int T, int U1, int J, int V, int Vp) {
  using Tl = Tile<W>;
  constexpr int CT = Tl::CT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* hs = reinterpret_cast<W*>(smem_raw);
  W* ws = hs + (size_t)CT * (J + Tl::HPAD);
  float* ls = reinterpret_cast<float*>(ws + (size_t)KS * (VT + Tl::WPAD));
  float* run_m = ls + CT * (VT + LPAD);
  float* run_s = run_m + CT;
  float* run_bl = run_s + CT;
  float* run_em = run_bl + CT;
  int* foff = reinterpret_cast<int*>(run_em + CT);
  int* goff = foff + CT;
  int* ycell = goff + CT;

  const long long N = (long long)B * T * U1;
  const long long n0 = (long long)blockIdx.x * CT;
  const int hld = J + Tl::HPAD;
  PlaneTimer tm;
  tm.start();

  for (int r = threadIdx.x; r < CT; r += PT) {
    const long long n = n0 + r;
    int fo = -1, go = 0, yc = -1;
    if (n < N) {
      const int bt = (int)(n / U1), u = (int)(n - (long long)bt * U1);
      const int b = bt / T;
      fo = bt;
      go = b * U1 + u;
      yc = y[go];
    }
    foff[r] = fo;
    goff[r] = go;
    ycell[r] = yc;
    run_m[r] = NEG;
    run_s[r] = 0.f;
    run_bl[r] = NEG;
    run_em[r] = NEG;
  }
  __syncthreads();
  // the tanh tile, rounded to W; rows past the last cell are zero
  for (int i = threadIdx.x; i < CT * J; i += PT) {
    const int r = i / J, j = i - r * J;
    float v = 0.f;
    if (foff[r] >= 0)
      v = tanhf(to_float(f[(size_t)foff[r] * J + j]) +
                to_float(g[(size_t)goff[r] * J + j]) + to_float(b1[j]));
    hs[r * hld + j] = from_float<W>(v);
  }
  tm.at(PP_BUILD);
  __syncthreads();
  tm.at(PP_BARRIER);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int ROWS_PER_WARP = CT / (PT / 32);
  for (int v0 = 0; v0 < Vp; v0 += VT) {
    chunk_product<W>(hs, ws, ls, w2, J, Vp, v0, tm);
    __syncthreads();
    tm.at(PP_BARRIER);
    // fold the chunk into each cell's running logsumexp (a warp per row)
    for (int k = 0; k < ROWS_PER_WARP; ++k) {
      const int r = warp * ROWS_PER_WARP + k;
      float vals[VT / 32];
      float mx = NEG;
#pragma unroll
      for (int q = 0; q < VT / 32; ++q) {
        const int c = lane + 32 * q;
        vals[q] = ls[r * (VT + LPAD) + c] + b2[v0 + c];
        mx = fmaxf(mx, vals[q]);
      }
      mx = warp_max(mx);
      const float m_old = run_m[r];
      const float m_new = fmaxf(m_old, mx);
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < VT / 32; ++q) s += expf(vals[q] - m_new);
      s = warp_sum(s);
      const int yc = ycell[r];
      if (lane == 0) {
        run_s[r] = run_s[r] * expf(m_old - m_new) + s;
        run_m[r] = m_new;
        if (v0 == 0) run_bl[r] = vals[0];
      }
      if (yc >= v0 && yc < v0 + VT && (yc - v0) % 32 == lane)
        run_em[r] = vals[(yc - v0) / 32];
    }
    tm.at(PP_FOLD);
    __syncthreads();
    tm.at(PP_BARRIER);
  }
  for (int r = threadIdx.x; r < CT; r += PT) {
    const long long n = n0 + r;
    if (n < N) {
      denom[n] = run_m[r] + logf(run_s[r]);
      blank[n] = run_bl[r];
      emit[n] = run_em[r];
    }
  }
  tm.at(PP_FOLD);
  tm.flush();
}

template <typename W>
int launch(const void* f, const void* g, const int* y, const void* b1,
           const void* w2, const float* b2, float* denom, float* blank,
           float* emit, int B, int T, int U1, int J, int V, int Vp,
           void* stream) {
  if (Vp % VT != 0 || (sizeof(W) == 2 && J % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = plane_smem<W>(J);
  auto kernel = plane_kernel<W>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long N = (long long)B * T * U1;
  const int blocks = (int)((N + Tile<W>::CT - 1) / Tile<W>::CT);
  g_last_grid = blocks;
  g_last_design = sizeof(W) == 2 ? D_WMMA : D_FMA;
  kernel<<<blocks, PT, smem, (cudaStream_t)stream>>>(
      (const W*)f, (const W*)g, y, (const W*)b1, (const W*)w2, b2, denom,
      blank, emit, B, T, U1, J, V, Vp);
  return launch_status(cudaSuccess);
}


// ---------------------------------------------------------------- WGMMA

namespace wg {

// One thread's rows of the online logsumexp (its two rows of the tile, 32
// columns of each chunk), and the blank and emit logits it picked.
struct RowFold {
  float m[2], s[2], bl[2], em[2];
  int y[2];
};

// Folds chunk v's accumulators (columns v0 = 128 v ...) plus b2 into the
// running (max, sum of exp) of the thread's two rows; it only reads the
// accumulators (`tile_products`).
__device__ __forceinline__ void fold_chunk(const float (&d)[64], RowFold& r,
                                           const float* __restrict__ b2,
                                           int v0, int q) {
  float2 bb[NV / 8];
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int j = 0; j < NV / 8; ++j) {
    bb[j] = __ldg(reinterpret_cast<const float2*>(b2 + v0 + 8 * j + 2 * q));
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mx[h] = fmaxf(mx[h], fmaxf(d[4 * j + 2 * h] + bb[j].x,
                                 d[4 * j + 2 * h + 1] + bb[j].y));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(r.m[h], mx[h]);
    const float ml = m_new * LOG2E;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NV / 8; ++j)
      sum += ex2(fmaf(d[4 * j + 2 * h] + bb[j].x, LOG2E, -ml)) +
             ex2(fmaf(d[4 * j + 2 * h + 1] + bb[j].y, LOG2E, -ml));
    r.s[h] = r.s[h] * ex2(fmaf(r.m[h], LOG2E, -ml)) + sum;
    r.m[h] = m_new;
    if (v0 == 0 && q == 0) r.bl[h] = d[2 * h] + bb[0].x;
    const int c = r.y[h] - v0 - 2 * q;  // this thread's column offset of y
    if ((unsigned)c < (unsigned)NV) {
#pragma unroll
      for (int j = 0; j < NV / 8; ++j) {
        if (c == 8 * j) r.em[h] = d[4 * j + 2 * h] + bb[j].x;
        if (c == 8 * j + 1) r.em[h] = d[4 * j + 2 * h + 1] + bb[j].y;
      }
    }
  }
}

// f [B,T,J], g [B,U1,J], b1 [J] bf16 with J a multiple of KB (zero-padded);
// w2p: the packed W2 tiles ([Vp/NV][J/KB][NV][KB], each row swizzled); b2
// [Vp] fp32 padded with NEG.
__global__ void __launch_bounds__(THREADS, 1)
    plane_kernel_wgmma(const __nv_bfloat16* __restrict__ f,
                       const __nv_bfloat16* __restrict__ g,
                       const int* __restrict__ y,
                       const __nv_bfloat16* __restrict__ b1,
                       const __nv_bfloat16* __restrict__ w2p,
                       const float* __restrict__ b2,
                       float* __restrict__ denom, float* __restrict__ blank,
                       float* __restrict__ emit, int B, int T, int U1, int J,
                       int Vp, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, J, stages);
  const int nkb = J / KB, nvc = Vp / NV;
  const long long N = (long long)B * T * U1;
  const int ntiles = (int)((N + CELLS - 1) / CELLS);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring(sm, stages);
  if (warp >= CONSUMERS * 4) {
    produce_w2(sm, w2p, ntiles, nkb * nvc, stages);
    return;
  }

  // a consumer warpgroup: rows wgi * 64 .. of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wgi = warp / 4, t = threadIdx.x % 128, q = lane % 4;
  const int row0 = wgi * 64 + 16 * (warp % 4) + lane / 4;  // and row0 + 8
  PlaneTimer tm;
  tm.start();
  Ring rg;
  // two accumulator sets, chunks alternating; the first wgmma of a chunk
  // overwrites its set
  float acc0[64], acc1[64];
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long n0 = (long long)tile * CELLS;
    build_h<false>(f, g, b1, sm.hs, nullptr, n0, N, T, U1, J, wgi, t);
    tm.at(PP_BUILD);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
    tm.at(PP_BARRIER);

    RowFold r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long n = n0 + row0 + 8 * h;
      r.m[h] = NEG;
      r.s[h] = 0.f;
      r.bl[h] = NEG;
      r.em[h] = NEG;
      r.y[h] = -1;
      if (n < N) {
        const int bt = (int)n / U1, u = (int)n - bt * U1, b = bt / T;
        r.y[h] = y[b * U1 + u];
      }
    }
    tile_products(
        sm, rg, acc0, acc1, nkb, nvc, stages, wgi, t,
        [&](const float(&d)[64], int v) { fold_chunk(d, r, b2, v * NV, q); },
        [&](int m) {
          tm.at(m == TM_W2_WAIT ? PP_W2_WAIT
                : m == TM_PRODUCTS ? PP_PRODUCTS : PP_FOLD);
        });
    // merge the quad's running sums; the emit logit from the lane holding
    // y's column
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o < 4; o *= 2) {
        const float mo = __shfl_xor_sync(0xffffffffu, r.m[h], o);
        const float so = __shfl_xor_sync(0xffffffffu, r.s[h], o);
        const float mn = fmaxf(r.m[h], mo);
        r.s[h] = r.s[h] * exp2f((r.m[h] - mn) * LOG2E) +
                 so * exp2f((mo - mn) * LOG2E);
        r.m[h] = mn;
      }
      const float em = __shfl_sync(0xffffffffu, r.em[h],
                                   (lane & ~3) | ((r.y[h] & 7) >> 1));
      const long long n = n0 + row0 + 8 * h;
      if (q == 0 && n < N) {
        denom[n] = r.m[h] + logf(r.s[h]);
        blank[n] = r.bl[h];
        emit[n] = em;
      }
    }
    tm.at(PP_FOLD);
  }
  tm.flush();
}

// W2 [J, V] (bf16, row-major) into the packed tiles the ring streams
// (`planes_cuda.pack_w2` is its plain version): block (chunk, kb) reads
// W2[kb*KB .., chunk*NV ..] row by row, zero past J and V, and writes its
// 16 KB tile, row n = column v0 + n, the 16-byte group c of k at c ^ (n % 8).
__global__ void __launch_bounds__(256)
    pack_w2_kernel(const __nv_bfloat16* __restrict__ w2,
                   __nv_bfloat16* __restrict__ w2p, int J, int V, int nkb) {
  constexpr int LD = NV + 8;  // padded smem row (elements)
  __shared__ __align__(16) __nv_bfloat16 tile[KB * LD];
  const int chunk = blockIdx.x / nkb, kb = blockIdx.x % nkb;
  const int k0 = kb * KB, v0 = chunk * NV;
  for (int i = threadIdx.x; i < KB * NV; i += blockDim.x) {
    const int k = i / NV, n = i % NV;
    tile[k * LD + n] = (k0 + k < J && v0 + n < V)
                           ? w2[(size_t)(k0 + k) * V + v0 + n]
                           : __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  uint4* out = reinterpret_cast<uint4*>(w2p + (size_t)blockIdx.x * NV * KB);
  for (int o = threadIdx.x; o < NV * KB / 8; o += blockDim.x) {
    const int n = o / 8, grp = (o % 8) ^ (n % 8);
    uint4 v;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = tile[(grp * 8 + i) * LD + n];
    out[o] = v;
  }
}

// W2 [Jw, V] packed into w2p (J x Vp values; J a multiple of KB, Vp of NV).
int pack(const void* w2, void* w2p, int J, int Jw, int V, int Vp,
         void* stream) {
  if (J % KB != 0 || Jw > J || Vp % NV != 0 || V > Vp)
    return (int)cudaErrorInvalidValue;
  pack_w2_kernel<<<(Vp / NV) * (J / KB), 256, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)w2, (__nv_bfloat16*)w2p, Jw, V, J / KB);
  return launch_status(cudaSuccess);
}

// The WGMMA design on `stages` ring stages; J (padded) a multiple of KB, at
// least 2 KB (the fold of a chunk waits for the next chunk's second
// k-block); Vp a multiple of NV.  A shape the design cannot run is an error:
// the caller planned it, and no other design runs in its place.
int launch(const void* f, const void* g, const int* y, const void* b1,
           const void* w2, const float* b2, void* w2p, float* denom,
           float* blank, float* emit, int B, int T, int U1, int J, int Jw,
           int V, int Vp, int stages, void* stream) {
  if (J % KB != 0 || J < 2 * KB || Jw > J || Vp % NV != 0 || V > Vp ||
      stages < 3 || stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  int nsm = 0;
  const cudaError_t e = plan(plane_kernel_wgmma, J, stages, &nsm);
  if (e != cudaSuccess) return (int)e;
  const long long N = (long long)B * T * U1;
  if (N > 0x7fffffff) return (int)cudaErrorInvalidValue;  // int cell index
  const long long ntiles = (N + CELLS - 1) / CELLS;
  const int grid = (int)(ntiles < nsm ? ntiles : nsm);
  g_last_grid = grid;
  g_last_design = D_WGMMA;
  const int pe = pack(w2, w2p, J, Jw, V, Vp, stream);
  if (pe != 0) return pe;
  plane_kernel_wgmma<<<grid, THREADS, smem_bytes(J, stages),
                       (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)f, (const __nv_bfloat16*)g, y,
      (const __nv_bfloat16*)b1, (const __nv_bfloat16*)w2p, b2, denom, blank,
      emit, B, T, U1, J, Vp, stages);
  return launch_status(cudaSuccess);
}

}  // namespace wg

}  // namespace

// f [B,T,J], g [B,U1,J], b1 [J], w2 [J,Vp] in the weight type (Vp a multiple
// of 128; bf16 needs J a multiple of 16); y [B,U1] int32; b2 [Vp] f32;
// denom, blank, emit [B,T,U1] f32.  Returns a CUDA error code (0 = launched).
extern "C" int joint_planes_f32(const void* f, const void* g, const int* y,
                                const void* b1, const void* w2,
                                const float* b2, float* denom, float* blank,
                                float* emit, int B, int T, int U1, int J,
                                int V, int Vp, void* stream) {
  return launch<float>(f, g, y, b1, w2, b2, denom, blank, emit, B, T, U1, J,
                       V, Vp, stream);
}

extern "C" int joint_planes_bf16(const void* f, const void* g, const int* y,
                                 const void* b1, const void* w2,
                                 const float* b2, float* denom, float* blank,
                                 float* emit, int B, int T, int U1, int J,
                                 int V, int Vp, void* stream) {
  return launch<__nv_bfloat16>(f, g, y, b1, w2, b2, denom, blank, emit, B, T,
                               U1, J, V, Vp, stream);
}

// The WGMMA design (bf16): f, g, b1 with J padded to a multiple of 64 (at
// least 128) with zeros; w2 [Jw, V] unpadded (Jw <= J); w2p scratch of J x
// Vp values, where the launch packs W2 first (as planes_cuda.pack_w2 does);
// the rest as joint_planes_bf16.  `stages` W2 tiles in the ring (3 or 4,
// planes_cuda.wgmma_stages).
extern "C" int joint_planes_bf16_wgmma(const void* f, const void* g,
                                       const int* y, const void* b1,
                                       const void* w2, const float* b2,
                                       void* w2p, float* denom, float* blank,
                                       float* emit, int B, int T, int U1,
                                       int J, int Jw, int V, int Vp,
                                       int stages, void* stream) {
  return wg::launch(f, g, y, b1, w2, b2, w2p, denom, blank, emit, B, T, U1, J,
                    Jw, V, Vp, stages, stream);
}

// The WGMMA launch's first step alone: w2 [Jw, V] bf16 packed into w2p (J x
// Vp values) as planes_cuda.pack_w2 packs it.
extern "C" int planes_pack_w2(const void* w2, void* w2p, int J, int Jw, int V,
                              int Vp, void* stream) {
  return wg::pack(w2, w2p, J, Jw, V, Vp, stream);
}

// The design of the last launch: 0 WGMMA, 1 WMMA, 2 FMA.
extern "C" int planes_last_design() { return g_last_design; }

// SMs and the shared memory a block may opt in to, of the current device.
extern "C" int planes_card(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(out + 1,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// Columns of a row of planes_phases(): the phases of enum PlanePhase.
extern "C" int planes_phase_count() { return PP_N; }
// Blocks of the last launch: the rows planes_phases() fills (at most
// PP_MAX_BLOCKS).
extern "C" int planes_phase_rows() {
  return g_last_grid < PP_MAX_BLOCKS ? g_last_grid : PP_MAX_BLOCKS;
}

#ifdef PLANES_PHASE_TIMERS
// Every block's nanoseconds by phase, summed over the launches since the
// last reset (reset != 0 zeroes them): out holds planes_phase_rows() rows
// of planes_phase_count() values.
extern "C" int planes_phases(unsigned long long* out, int reset) {
  if (reset) {
    static unsigned long long zero[PP_MAX_BLOCKS][PP_N];
    return (int)cudaMemcpyToSymbol(g_planes_ns, zero, sizeof zero);
  }
  return (int)cudaMemcpyFromSymbol(
      out, g_planes_ns,
      sizeof(unsigned long long) * PP_N * planes_phase_rows());
}
#endif
