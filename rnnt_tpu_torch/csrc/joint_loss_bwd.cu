// Backward of the fused joint + loss for Hopper (sm_90a): kernels K8 and K9.
//
// They replace the plain elementwise chain of `ops/joint_loss_fused.py`'s
// `_chunk_grads` around its two products on the card (the JAX package,
// rnnt_tpu/ops/joint_loss_fused.py `_bwd`, leaves that chain to XLA; no
// Pallas kernel of it exists).  For a batch chunk of N = B T (U+1) cells:
//
// K8, joint_dlogits_kernel: the logit tile recomputed on K6's WGMMA
//   machinery (wgmma.cuh: persistent CTAs, 128-cell tiles, h built once a
//   tile in shared memory, the packed W2 streamed by TMA through an mbarrier
//   ring, fp32 accumulators).  In place of K6's logsumexp fold the epilogue
//   forms, from the accumulator registers,
//     dlogits[n, v] = exp(logit + b2 - den) occ - [v = 0, own] g_blank
//                     - [v = y] g_emit
//   in fp32, adds it into per-column db2 partial sums and stores it rounded
//   to bf16 (the dtype of the two products).  It also writes hb, h rounded to
//   bf16, for the dW2 product.  The chain's fp32 [N, V] logits and their
//   exp, casts and sums never exist.
// The two products stay cuBLAS: dh = dlogits W2^T, dW2 += hb^T dlogits.
// K9, dtanh_rows_kernel + dtanh_cols_kernel: h recomputed in fp32 from f, g,
//   b1; dpre = dh (1 - h^2) in registers; only its sums are written: df
//   (over u), dg (over t, in two stages) and db1.
//
// Determinism: every sum has a fixed order, no float atomics.  db2: a
// thread's two rows, then a butterfly over the warp's 8 row lanes (bits 0,
// 1, 2 of the row), then each warp adds its 128 column sums into its own
// row of db2p [CTAs x 8 warps, Vp], tile after tile in the CTA's order;
// the caller sums the rows.  df: u in order; dg: t in order within a
// group of TG rows, then the groups in order (dtanh_cols_kernel), which also
// writes db1's partial sums over groups of UG u rows.
//
// Bound on the H100: K8 is K6's [N, J] x [J, V] product (2 N J V
// operations, 1.40 TFLOP at B=32, T'=128, U+1=65, J=640, V=4096) plus
// writing N V bf16 dlogits (1.09 GB there): ~1.41 ms of products or 0.33 ms
// of stores, so products.  K9 reads dh (4 N J bytes) and writes dg's
// partial sums (4 N J / TG): bytes.

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using namespace wg;

constexpr float DEAD = 1e30f;  // den of a row past the last cell: exp -> 0
// (ops/loss_bwd_cuda.py's WARPS, TG and UG)
constexpr int WARPS = CONSUMERS * 4;  // db2 partial rows a CTA
constexpr int TG = 4;  // t rows a dtanh_rows_kernel block sums for dg
constexpr int UG = 8;  // u rows a dtanh_cols_kernel block sums for db1

// A consumer thread's two rows of the tile: den in log2 units, the
// occupancies, the label's column (-1 outside [0, V)) and the cell (-1 past
// the last one).
struct RowGrad {
  float ml[2], occ[2], gbl[2], gem[2];
  int y[2], n[2];
};

// Row h of a thread's 8 bf16 dlogits pairs w[jj] (columns 8 (j0 + jj) +
// 2 q, + 1 for jj < 4) transposed over its quad, so that lane q holds the 8
// columns 8 (j0 + q) .. + 7 of the row, and stored with one 16-byte store
// (columns past V one by one).  Transposing (lane, jj) swaps bit 0 of the
// two across lanes q ^ 1, then bit 1 across q ^ 2.
__device__ __forceinline__ void store_row(unsigned (&w)[4],
                                          __nv_bfloat16* __restrict__ row,
                                          int c0, int q, int V) {
  const bool q0 = q & 1, q1 = q & 2;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const unsigned got =
        __shfl_xor_sync(0xffffffffu, q0 ? w[2 * k] : w[2 * k + 1], 1);
    if (q0)
      w[2 * k] = got;
    else
      w[2 * k + 1] = got;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const unsigned got =
        __shfl_xor_sync(0xffffffffu, q1 ? w[k] : w[2 + k], 2);
    if (q1)
      w[k] = got;
    else
      w[2 + k] = got;
  }
  const int c = c0 + 8 * q;
  if (c + 8 <= V) {
    *reinterpret_cast<uint4*>(row + c) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c + i < V)
        row[c + i] = __ushort_as_bfloat16(
            (unsigned short)(w[i / 2] >> (16 * (i % 2))));
  }
}

// Chunk v's epilogue (columns v0 = 128 v ...): dlogits from the
// accumulators plus b2, stored in bf16, and the chunk's column sums over
// the warp's 16 rows added to the warp's db2 row.  Thread (lane, q = lane %
// 4) holds columns 8 j + 2 q + e of its two rows (wgmma_m64n128k16).
__device__ __forceinline__ void dlogits_chunk(
    const float (&d)[64], const RowGrad& r, const float* __restrict__ b2,
    __nv_bfloat16* __restrict__ dl, float* __restrict__ db2w, int v0,
    int lane, int V, int ldl, bool blank_own) {
  const int q = lane % 4;
  float s[NV / 4];  // s[2 j + e]: column 8 j + 2 q + e, the two rows' sum
#pragma unroll
  for (int j0 = 0; j0 < NV / 8; j0 += 4) {
    unsigned w[2][4];  // the rows' bf16 pairs of j0 .. j0 + 3
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + jj, c = v0 + 8 * j + 2 * q;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + c));
      float p[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = d[4 * j + 2 * h + e] + (e ? bb.y : bb.x);
          float pv = ex2(fmaf(x, LOG2E, -r.ml[h])) * r.occ[h];
          if (blank_own && c + e == 0) pv -= r.gbl[h];
          if (c + e == r.y[h]) pv -= r.gem[h];
          p[h][e] = pv;
        }
        const __nv_bfloat162 pb = __floats2bfloat162_rn(p[h][0], p[h][1]);
        w[h][jj] = *reinterpret_cast<const unsigned*>(&pb);
      }
      s[2 * j] = p[0][0] + p[1][0];
      s[2 * j + 1] = p[0][1] + p[1][1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)  // the quad's rows are one row: no branch
      store_row(w[h], dl + (size_t)(r.n[h] < 0 ? 0 : r.n[h]) * ldl,
                r.n[h] < 0 ? V : v0 + 8 * j0, q, V);
  }
  // the sum over the warp's 8 row lanes (lane bits 2, 3, 4), halving the
  // values each step: a lane keeps one half and sends the other to its
  // partner, so 16 + 8 + 4 shuffles leave it 4 of the 128 column sums
  const bool k0 = lane & 4, k1 = lane & 8, k2 = lane & 16;
  float s16[16], s8[8], s4[4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    s16[i] = (k0 ? s[16 + i] : s[i]) +
             __shfl_xor_sync(0xffffffffu, k0 ? s[i] : s[16 + i], 4);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    s8[i] = (k1 ? s16[8 + i] : s16[i]) +
            __shfl_xor_sync(0xffffffffu, k1 ? s16[i] : s16[8 + i], 8);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s4[i] = (k2 ? s8[4 + i] : s8[i]) +
            __shfl_xor_sync(0xffffffffu, k2 ? s8[i] : s8[4 + i], 16);
  // s4[2 k + e]: column 8 (jb + k) + 2 q + e
  const int jb = (k0 ? 8 : 0) + (k1 ? 4 : 0) + (k2 ? 2 : 0);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float2* w = reinterpret_cast<float2*>(db2w + v0 + 8 * (jb + k) + 2 * q);
    float2 o = *w;
    o.x += s4[2 * k];
    o.y += s4[2 * k + 1];
    *w = o;
  }
}

// f [B,T,J], g [B,U1,J], b1 [J] bf16 with J a multiple of KB (zero-padded);
// y [B,U1] the labels in this shard's columns; w2p the packed W2; b2 [Vp]
// fp32 padded with NEG; den, occ, gbl, gem [B,T,U1] fp32.  Writes dl
// [N, ldl] (columns < V) and hb [N, J] in bf16, and adds into db2p.
__global__ void __launch_bounds__(THREADS, 1)
    joint_dlogits_kernel(const __nv_bfloat16* __restrict__ f,
                         const __nv_bfloat16* __restrict__ g,
                         const int* __restrict__ y,
                         const __nv_bfloat16* __restrict__ b1,
                         const __nv_bfloat16* __restrict__ w2p,
                         const float* __restrict__ b2,
                         const float* __restrict__ den,
                         const float* __restrict__ occ,
                         const float* __restrict__ gbl,
                         const float* __restrict__ gem,
                         __nv_bfloat16* __restrict__ dl,
                         __nv_bfloat16* __restrict__ hb,
                         float* __restrict__ db2p, int B, int T, int U1,
                         int J, int V, int Vp, int ldl, int stages,
                         int blank_own) {
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

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wgi = warp / 4, t = threadIdx.x % 128;
  const int row0 = wgi * 64 + 16 * (warp % 4) + lane / 4;  // and row0 + 8
  float* db2w = db2p + ((size_t)blockIdx.x * WARPS + warp) * Vp;
  Ring rg;
  float acc0[64], acc1[64];
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long n0 = (long long)tile * CELLS;
    build_h<true>(f, g, b1, sm.hs, hb, n0, N, T, U1, J, wgi, t);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
    RowGrad r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long n = n0 + row0 + 8 * h;
      r.n[h] = -1;
      r.ml[h] = DEAD * LOG2E;
      r.occ[h] = r.gbl[h] = r.gem[h] = 0.f;
      r.y[h] = -1;
      if (n < N) {
        const int bt = (int)n / U1, u = (int)n - bt * U1, b = bt / T;
        const int yy = y[b * U1 + u];
        r.n[h] = (int)n;
        r.ml[h] = den[n] * LOG2E;
        r.occ[h] = occ[n];
        r.gbl[h] = gbl[n];
        r.gem[h] = gem[n];
        r.y[h] = (unsigned)yy < (unsigned)V ? yy : -1;
      }
    }
    tile_products(
        sm, rg, acc0, acc1, nkb, nvc, stages, wgi, t,
        [&](const float(&d)[64], int v) {
          dlogits_chunk(d, r, b2, dl, db2w, v * NV, lane, V, ldl,
                        blank_own != 0);
        },
        [](int) {});
  }
}

// dh [B,T,U1,J] fp32; f [B,T,J], g [B,U1,J], b1 [J] bf16; J a multiple of
// 4, a thread's 4 columns.  Block (t group, b): df [B,T,J] of its TG rows
// (the sum over u, in order) and dgp [B,ceil(T/TG),U1,J], the group's sum
// over its t rows, in order.
__global__ void __launch_bounds__(256)
    dtanh_rows_kernel(const float* __restrict__ dh,
                      const __nv_bfloat16* __restrict__ f,
                      const __nv_bfloat16* __restrict__ g,
                      const __nv_bfloat16* __restrict__ b1,
                      float* __restrict__ df, float* __restrict__ dgp, int T,
                      int U1, int J) {
  const int b = blockIdx.y, tg = blockIdx.x, t0 = tg * TG;
  const int nt = min(TG, T - t0), j = 4 * threadIdx.x;
  if (j >= J) return;
  auto load4 = [](const __nv_bfloat16* p, float (&o)[4]) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    o[0] = a.x;
    o[1] = a.y;
    o[2] = c.x;
    o[3] = c.y;
  };
  float fr[TG][4], dfa[TG][4], bv[4];
  load4(b1 + j, bv);
#pragma unroll
  for (int i = 0; i < TG; ++i) {
    if (i < nt) load4(f + ((size_t)b * T + t0 + i) * J + j, fr[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) dfa[i][e] = 0.f;
  }
  const int ngroups = (T + TG - 1) / TG;
  for (int u = 0; u < U1; ++u) {
    float gv[4];
    load4(g + ((size_t)b * U1 + u) * J + j, gv);
    float4 dv[TG];
#pragma unroll
    for (int i = 0; i < TG; ++i)
      dv[i] = i < nt ? __ldcs(reinterpret_cast<const float4*>(
                           dh + (((size_t)b * T + t0 + i) * U1 + u) * J + j))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    float dgs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < TG; ++i) {
      if (i < nt) {
        const float dd[4] = {dv[i].x, dv[i].y, dv[i].z, dv[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float h = tanhf(fr[i][e] + gv[e] + bv[e]);
          const float dp = dd[e] * (1.f - h * h);
          dfa[i][e] += dp;
          dgs[e] += dp;
        }
      }
    }
    *reinterpret_cast<float4*>(
        dgp + (((size_t)b * ngroups + tg) * U1 + u) * J + j) =
        make_float4(dgs[0], dgs[1], dgs[2], dgs[3]);
  }
#pragma unroll
  for (int i = 0; i < TG; ++i)
    if (i < nt)
      *reinterpret_cast<float4*>(df + ((size_t)b * T + t0 + i) * J + j) =
          make_float4(dfa[i][0], dfa[i][1], dfa[i][2], dfa[i][3]);
}

// Block (u group, b): dg [B,U1,J] of its UG rows, the sum of dgp over the t
// groups in order, and db1p [B,ceil(U1/UG),J], the sum of those rows in
// order.
__global__ void __launch_bounds__(256)
    dtanh_cols_kernel(const float* __restrict__ dgp, float* __restrict__ dg,
                      float* __restrict__ db1p, int ngroups, int U1, int J) {
  const int b = blockIdx.y, ug = blockIdx.x, j = 4 * threadIdx.x;
  if (j >= J) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int u = ug * UG; u < min(U1, ug * UG + UG); ++u) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < ngroups; ++k) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(
          dgp + (((size_t)b * ngroups + k) * U1 + u) * J + j));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(dg + ((size_t)b * U1 + u) * J + j) = s;
    acc.x += s.x;
    acc.y += s.y;
    acc.z += s.z;
    acc.w += s.w;
  }
  *reinterpret_cast<float4*>(db1p + ((size_t)b * gridDim.x + ug) * J + j) =
      acc;
}

}  // namespace

// K8 on one batch chunk (see joint_dlogits_kernel): f, g, b1 with J padded
// to a multiple of 64 (at least 128), w2p W2 packed as
// planes_cuda.pack_w2 packs it, b2 [Vp] fp32, y int32; `stages` ring stages
// (planes_cuda.wgmma_stages); db2p [db2_rows, Vp] fp32, db2_rows at least 8
// a CTA of the grid (one CTA an SM, at most one a tile).  Returns a CUDA
// error code (0 = launched).
extern "C" int loss_bwd_dlogits(const void* f, const void* g, const int* y,
                                const void* b1, const void* w2p,
                                const float* b2, const float* den,
                                const float* occ, const float* gbl,
                                const float* gem, void* dl, void* hb,
                                float* db2p, int B, int T, int U1, int J,
                                int V, int Vp, int ldl, int stages,
                                int blank_own, int db2_rows, void* stream) {
  if (J % KB != 0 || J < 2 * KB || Vp % NV != 0 || V > Vp || ldl < V ||
      ldl % 8 != 0 || stages < 3 || stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  int nsm = 0;
  const cudaError_t e = plan(joint_dlogits_kernel, J, stages, &nsm);
  if (e != cudaSuccess) return (int)e;
  const long long N = (long long)B * T * U1;
  if (N > 0x7fffffff) return (int)cudaErrorInvalidValue;  // int cell index
  const long long ntiles = (N + CELLS - 1) / CELLS;
  const int grid = (int)(ntiles < nsm ? ntiles : nsm);
  if ((long long)grid * WARPS > db2_rows) return (int)cudaErrorInvalidValue;
  joint_dlogits_kernel<<<grid, THREADS, smem_bytes(J, stages),
                         (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)f, (const __nv_bfloat16*)g, y,
      (const __nv_bfloat16*)b1, (const __nv_bfloat16*)w2p, b2, den, occ, gbl,
      gem, (__nv_bfloat16*)dl, (__nv_bfloat16*)hb, db2p, B, T, U1, J, V, Vp,
      ldl, stages, blank_own);
  return launch_status(cudaSuccess);
}

// K9 on one batch chunk: dh [B,T,U1,J] fp32, f [B,T,J], g [B,U1,J], b1 [J]
// bf16 (J a multiple of 4) -> df [B,T,J], dg [B,U1,J] and db1p
// [B,ceil(U1/8),J] fp32, through dgp [B,ceil(T/8),U1,J] fp32 scratch.
extern "C" int loss_bwd_tanh(const float* dh, const void* f, const void* g,
                             const void* b1, float* df, float* dgp, float* dg,
                             float* db1p, int B, int T, int U1, int J,
                             void* stream) {
  const int threads = (J / 4 + 31) / 32 * 32;
  if (J % 4 != 0 || threads > 256) return (int)cudaErrorInvalidValue;
  const int ngroups = (T + TG - 1) / TG;
  dtanh_rows_kernel<<<dim3(ngroups, B), threads, 0, (cudaStream_t)stream>>>(
      dh, (const __nv_bfloat16*)f, (const __nv_bfloat16*)g,
      (const __nv_bfloat16*)b1, df, dgp, T, U1, J);
  const int e = launch_status(cudaSuccess);
  if (e != 0) return e;
  dtanh_cols_kernel<<<dim3((U1 + UG - 1) / UG, B), threads, 0,
                      (cudaStream_t)stream>>>(dgp, dg, db1p, ngroups, U1, J);
  return launch_status(cudaSuccess);
}
