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
// 989 TFLOP/s in bf16); the bytes (f, g, W2 in, three planes out) are a few
// MB.  So the kernel is bound by its tensor-core rate.
//
// Design: a block owns CT consecutive cells.  It builds their tanh tile once
// in shared memory (rounded to W, as the TPU kernel rounds h before its
// product), then streams V in chunks of VT columns: each chunk's product is
// computed in the block with W2 staged through shared memory in slabs of KS
// rows, and folded into a running (max, sum of exp) per cell; blank and emit
// are picked from the chunk that holds their column.  The product is the
// kernel's own: for bf16 operands warp-level tensor-core MMA (WMMA 16x16x16,
// fp32 accumulation; 8 warps, each a 16 x 64 tile of the 64 x 128 chunk);
// for fp32 operands plain fp32 FMA on the CUDA cores (each thread a 4 x 4
// tile of the 32 x 128 chunk), no TF32.  wgmma, TMA and double buffering are
// later work.

#include <mma.h>

#include "common.cuh"

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
                              int v0);

template <>
__device__ void chunk_product<__nv_bfloat16>(const __nv_bfloat16* hs,
                                             __nv_bfloat16* ws, float* ls,
                                             const __nv_bfloat16* __restrict__ w2,
                                             int J, int Vp, int v0) {
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
    __syncthreads();
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
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    wmma::store_matrix_sync(ls + rw * 16 * (VT + LPAD) + cw * 64 + i * 16,
                            acc[i], VT + LPAD, wmma::mem_row_major);
}

template <>
__device__ void chunk_product<float>(const float* hs, float* ws, float* ls,
                                     const float* __restrict__ w2, int J,
                                     int Vp, int v0) {
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
    __syncthreads();
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
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      ls[(r0 + i) * (VT + LPAD) + lane + 32 * q] = acc[i][q];
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
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int ROWS_PER_WARP = CT / (PT / 32);
  for (int v0 = 0; v0 < Vp; v0 += VT) {
    chunk_product<W>(hs, ws, ls, w2, J, Vp, v0);
    __syncthreads();
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
    __syncthreads();
  }
  for (int r = threadIdx.x; r < CT; r += PT) {
    const long long n = n0 + r;
    if (n < N) {
      denom[n] = run_m[r] + logf(run_s[r]);
      blank[n] = run_bl[r];
      emit[n] = run_em[r];
    }
  }
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
  kernel<<<blocks, PT, smem, (cudaStream_t)stream>>>(
      (const W*)f, (const W*)g, y, (const W*)b1, (const W*)w2, b2, denom,
      blank, emit, B, T, U1, J, V, Vp);
  return launch_status(cudaSuccess);
}

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
