// Projected-LSTM sequence kernels for Hopper (sm_90a): inference (K2) and
// the training forward with residuals (K4): one structure, three designs.
//
// Replaces rnnt_tpu/ops/lstm_pallas.py::_fwd_infer_kernel (launched by
// lstm_seq_infer) and, with RES = true, ::_fwd_kernel (launched by
// _fwd_call from lstm_seq), which also writes the residuals the backward
// needs: z_seq [T, B, 4H] and c_seq [T, B, H], both rounded to the weight
// type.  For t = 0..T-1, with carried h [B, P] and c [B, H]:
//   z   = xp[t] + bias + h @ Wh            [B, 4H], gate order i, g, f, o
//   c   = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   hid = sigmoid(o) * tanh(c)
//   h   = hid @ Wp                         [B, P]  -> h_seq[t]
// xp = x @ Wx is one large product outside (plain torch.matmul), delivered in
// the weight type.  Rounding points match the TPU kernel: h is rounded to the
// weight type before @Wh, hid before @Wp; accumulation and c are fp32.
//
// Bound on the H100: each step needs all of Wh [P, 4H] and Wp [H, P], 13.1 MB
// at the parity width in bf16, for 13.1 MFLOP at B=1.  Read from device
// memory every step that is 3.9 us a step at 3.35 TB/s, so ~10 ms for the
// 2560 encoder steps of a 512-frame request; the 50 MB L2 holds one layer's
// weights, so after the first step they come from L2.  The steps are a
// sequential chain, so at small B the real limit is latency: one step has to
// finish everywhere before the next can start.
//
// Structure: one persistent launch covers the whole sequence.  The grid is
// one block per SM (or fewer: lstm_set_block_cap), launched with
// cudaLaunchCooperativeKernel, so all blocks are co-resident and an
// oversize grid is refused instead of deadlocking at the grid barrier.
// Block k owns a slice of the H hidden units (their four gate columns of
// Wh) and a slice of the P output columns of Wp.  Per step (FMA and MMA;
// LAT replaces the barriers by tagged words):
//   phase A: z for its gate columns from the whole h_prev (global buffer),
//            then c and hid for its units.  c stays in shared memory for the
//            whole sequence; hid goes to a global buffer.
//   grid barrier
//   phase B: its columns of h = hid @ Wp, written to h_seq[t] and the h
//            buffer.
//   grid barrier
// Buffers written during the launch are read through L2 (__ldcg,
// cp.async.cg or ld.relaxed.gpu), never the incoherent L1.  Three designs
// fill this structure; the launcher picks one from the shape's plan.
//
// FMA (lstm_infer_kernel: fp32 K2 and K4, and bf16 outside the other plans):
// the vector operand (h or hid rows) is staged in shared memory, threads
// split each column's dot product over rows, and partial sums reduce
// through shared memory.  A pass takes 4 batch rows (BCH); K4 in bf16 takes
// 8 (train_rows).  The weights are re-read from L2 every pass and the
// exchange is fp32.  fp32 stays here: TF32 tensor cores would break the
// 1e-4 agreement with the plain version.
//
// MMA (lstm_fwd_mma_kernel: bf16 K4, and bf16 K2 above LAT's batch; K2
// writes no z_seq or c_seq), K5's bwd_mma design turned forward:
//  - Before the first step a block copies its Wh columns [P x 4 nu] (unit
//    major: column 4u + gate) and its Wp columns [H x ncb] into shared
//    memory, k-contiguous and zero-padded (col_stride), and nothing reads
//    the weights again: at the parity width on 132 blocks 64 x 656 x 2 =
//    83,968 B and 5 x 2064 x 2 = 20,640 B.
//  - Phase A on mma.sync m16n8k16 (bf16, fp32 accumulation): batch rows as
//    M in passes of up to 64, the 4 nu gate columns as N (8 n8 tiles at the
//    parity width, more on fewer SMs: 9 at 114), all of K = P a warp.  The
//    16 warps split a pass as m-tiles x n-tiles (2 x 8 at B=32), so no sum
//    crosses warps, and the cell update runs from the accumulators: with
//    unit-major columns one shuffle gives a lane all four gates of one
//    (row, unit).
//  - Phase B as K5's: N is the block's P columns (one n8 tile), K = H split
//    over the warps, the partial tiles summed in a fixed order, so a launch
//    is deterministic.
//  - Exchange: h [B, ldp] and hid [B, ldh] are bf16 (exact: both are
//    rounded to bf16 before their products), rows padded to 16 with zeros,
//    streamed through K5's 3-slot cp.async.cg ring (stream_rows).
//  - Off the chain: xp[t+1] for the block's units (4-byte cp.async) is
//    issued after phase A of step t and lands during phase B; the bias is
//    read once.
//  - Phase A's epilogue stages z, c and hid of the pass in the free ring
//    and writes them out row by row, so consecutive threads store
//    consecutive units (4-5% faster than each lane storing its own
//    scattered values, PERF.md).  Four accumulators a tile and half-size
//    chunks of h took another 3-7% off (PERF.md).
//  - The plan (fwd_plan) must fit the opt-in shared memory, with phase B's
//    columns in one n8 tile and at most NTW n-tiles a warp; a shape outside
//    it (e.g. H=3072, P=768 on 132 SMs: 150 KB of Wh slice) runs the FMA
//    design.  The ring takes ~32 KB chunks where the plan has room (B=32 on
//    132 SMs), else ~16 KB.
//
// LAT (lstm_infer_lat_kernel: bf16 K2 at B <= 8, the serving batch): the
// MMA design's resident slices with a step cut down for latency.  At B=1 a
// step is 13.1 MFLOP over 132 blocks, so what it costs is its chain: the K
// of each product is split over all 16 warps, and the exchange is tagged
// words (value and step tag in one 32-bit store) polled straight into the
// MMA fragments, so no grid barrier and no staging pass stands between one
// block's write and another's product.  Details at the kernel.

#include <type_traits>

#include "lstm_common.cuh"

namespace {

// Batch rows a block_dots pass takes: BCH, or train_rows<W>() for K4.
template <typename W, bool RES>
__host__ __device__ constexpr int rows() {
  return RES ? train_rows<W>() : BCH;
}

// Shared memory: reduction [NT*R] + dot outputs [ncmax*R] + staged vector
// rows [R*max(H,P)] + c [B*numax].
inline size_t smem_bytes(int nblk, int B, int H, int P, int R) {
  const int numax = (H + nblk - 1) / nblk;
  const int ncmax = std::max(4 * numax, (P + nblk - 1) / nblk);
  return sizeof(float) * ((size_t)NT * R + (size_t)ncmax * R +
                          (size_t)R * std::max(H, P) + (size_t)B * numax);
}

template <typename W, bool RES>
__global__ void __launch_bounds__(NT)
    lstm_infer_kernel(const W* __restrict__ xp,        // [T, B, 4H]
                      const W* __restrict__ wh,        // [P, 4H]
                      const W* __restrict__ wp,        // [H, P]
                      const W* __restrict__ bias,      // [4H]
                      const float* __restrict__ c0,    // [B, H]
                      float* hbuf,    // [B, P] h rounded to W; h0 at entry
                      float* hidbuf,  // [B, H] hid rounded to W
                      W* __restrict__ hseq,     // [T, B, P]
                      float* __restrict__ cfin,  // [B, H]
                      W* __restrict__ zseq,     // [T, B, 4H] (RES only)
                      W* __restrict__ cseq,     // [T, B, H] (RES only)
                      unsigned int* bar, int T, int B, int H, int P) {
  constexpr int R = rows<W, RES>();
  extern __shared__ float smem[];
  const int nblk = gridDim.x, blk = blockIdx.x;
  const int u0 = slice_begin(blk, H, nblk);
  const int nu = slice_begin(blk + 1, H, nblk) - u0;
  const int j0 = slice_begin(blk, P, nblk);
  const int ncb = slice_begin(blk + 1, P, nblk) - j0;
  const int numax = (H + nblk - 1) / nblk;
  const int ncmax = max(4 * numax, (P + nblk - 1) / nblk);
  float* red = smem;
  float* out = red + NT * R;
  float* xs = out + ncmax * R;
  float* cst = xs + R * max(H, P);
  const int H4 = 4 * H;

  for (int i = threadIdx.x; i < B * nu; i += NT) {
    const int b = i / nu, u = i - b * nu;
    cst[b * numax + u] = c0[(size_t)b * H + u0 + u];
  }
  __syncthreads();

  // local gate column c (gate-major over own units) -> column of Wh
  auto gate_col = [=](int c) {
    const int g = c / nu;
    return g * H + u0 + (c - g * nu);
  };
  auto out_col = [=](int c) { return j0 + c; };
  unsigned int target = 0;

  for (int t = 0; t < T; ++t) {
    // phase A: gates, cell and hid for own units
    for (int b0 = 0; b0 < B; b0 += R) {
      const int nb = min(R, B - b0);
      block_dots<R>(hbuf, P, b0, nb, P, wh, H4, 4 * nu, gate_col, xs, red,
                    out);
      for (int i = threadIdx.x; i < nb * nu; i += NT) {
        const int bb = i / nu, u = i - bb * nu, b = b0 + bb;
        const W* xrow = xp + ((size_t)t * B + b) * H4;
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int colm = g * H + u0 + u;
          z[g] = to_float(xrow[colm]) + to_float(bias[colm]) +
                 out[(g * nu + u) * R + bb];
        }
        const float c = sigmoid(z[2]) * cst[b * numax + u] +
                        sigmoid(z[0]) * tanhf(z[1]);
        cst[b * numax + u] = c;
        if constexpr (RES) {
          W* zrow = zseq + ((size_t)t * B + b) * H4;
#pragma unroll
          for (int g = 0; g < 4; ++g) zrow[g * H + u0 + u] = from_float<W>(z[g]);
          cseq[((size_t)t * B + b) * H + u0 + u] = from_float<W>(c);
        }
        hidbuf[(size_t)b * H + u0 + u] = round_to<W>(sigmoid(z[3]) * tanhf(c));
      }
      __syncthreads();
    }
    grid_barrier(bar, target);

    // phase B: own columns of h = hid @ Wp
    for (int b0 = 0; b0 < B; b0 += R) {
      const int nb = min(R, B - b0);
      block_dots<R>(hidbuf, H, b0, nb, H, wp, P, ncb, out_col, xs, red, out);
      for (int i = threadIdx.x; i < nb * ncb; i += NT) {
        const int bb = i / ncb, c = i - bb * ncb, b = b0 + bb;
        const W hw = from_float<W>(out[c * R + bb]);
        hseq[((size_t)t * B + b) * P + j0 + c] = hw;
        hbuf[(size_t)b * P + j0 + c] = to_float(hw);
      }
      __syncthreads();
    }
    grid_barrier(bar, target);
  }

  for (int i = threadIdx.x; i < B * nu; i += NT) {
    const int b = i / nu, u = i - b * nu;
    cfin[(size_t)b * H + u0 + u] = cst[b * numax + u];
  }
}

// ---- K4 in bf16: resident weight slices, tensor-core step products ----

constexpr int NTW = 4;                   // phase A n8 tiles a warp holds
constexpr int RED_B = NWARP * 16 * 8;    // phase B partial-tile floats

struct FwdPlan {
  int ldp, ldh;    // exchange row strides: P, H padded to 16
  int sa, sb;      // resident column strides: Wh slice (k over P), Wp (over H)
  int numax, ncmax;
  int nta;         // n8 tiles of the Wh slice (4 numax gate columns)
  int xw;          // values a (row, gate) of the xp buffer holds
  int kq;          // chunk scale (slot_values)
  size_t wp, red, bias, c, xp, ring, bytes;  // byte offsets (Wh at 0), total
};

__host__ __device__ inline FwdPlan fwd_plan(int nblk, int B, int H, int P,
                                            int kq) {
  FwdPlan p;
  p.kq = kq;
  p.ldp = round_up(P, 16);
  p.ldh = round_up(H, 16);
  p.sa = col_stride(p.ldp);
  p.sb = col_stride(p.ldh);
  p.numax = (H + nblk - 1) / nblk;
  p.ncmax = (P + nblk - 1) / nblk;
  p.nta = (4 * p.numax + 7) / 8;
  p.xw = round_up(p.numax + 1, 2);
  p.wp = sizeof(bf16) * (size_t)8 * p.nta * p.sa;
  p.red = p.wp + sizeof(bf16) * (size_t)p.ncmax * p.sb;
  p.bias = p.red + sizeof(float) * RED_B;
  p.c = p.bias + sizeof(float) * (size_t)round_up(4 * p.numax, 4);
  p.xp = p.c + (sizeof(float) * (size_t)B * p.numax + 15) / 16 * 16;
  p.ring = p.xp + (sizeof(bf16) * (size_t)B * 4 * p.xw + 15) / 16 * 16;
  p.bytes = p.ring + sizeof(bf16) * (size_t)STAGES * slot_values(kq);
  return p;
}

// Whether the MMA design takes the shape: the bytes fit one block, phase B's
// P columns one n8 tile, phase A's tiles NTW a warp at the largest pass,
// the epilogue's staging the ring, and the xp prefetch's 4-byte copies are
// aligned (H even, xp too).
inline bool fwd_plan_fits(const FwdPlan& p, int B, int H, size_t optin,
                          const void* xp) {
  const int mt = std::min(MT_MAX, (B + 15) / 16), ncol = NWARP / mt;
  return p.bytes <= optin && p.ncmax <= 8 && (p.nta + ncol - 1) / ncol <= NTW
         && 16 * MT_MAX * 6 * p.numax <= STAGES * slot_values(p.kq)
         && H % 2 == 0 && (reinterpret_cast<size_t>(xp) & 3) == 0;
}

// Phase A's product for one pass, N split over warps: rows b0 .. b0+nb of x
// @ ws (nta n8 tiles, every k) on the tensor cores.  Warp w takes m-tile
// w % mt and the n-tiles w / mt, w / mt + ncol, ... (ncol = NWARP / mt),
// so no two warps share an output and nothing is reduced across warps; four
// accumulators a tile (k16 slices s mod 4) quarter the MMA chain.  Then,
// from registers, epi(row, unit, z) once for each row and unit of its
// tiles: the columns are unit-major (4u + gate, gates i, g, f, o), so a
// lane holds gates (i, g) or (f, o) of one unit for rows g and g + 8, and
// one shuffle with lane ^ 1 gives the even lane all four gates of row g,
// the odd lane those of row g + 8.  k fragments as in pass_products.
template <typename Epi>
__device__ __forceinline__ void gates_pass(const bf16* x, int ld, int b0,
                                           int nb, int mt, int kq,
                                           const bf16* ws, int wst, int nta,
                                           bf16* ring, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = 4 * (lane & 3);
  const int ncol = NWARP / mt, m = warp % mt, n0 = warp / mt;
  float acc[4][NTW][4] = {};

  stream_rows(x, ld, b0, nb, mt, kq, ring,
              [&](const bf16* chunk, int xs, int s0, int s1) {
    if (n0 >= ncol) return;
    const bf16* xa = chunk + (m * 16 + g) * xs + t4;
    auto slice = [&](int s, float (&a)[NTW][4]) {
      const int kl = (s - s0) * 16;
      const uint2 lo = *reinterpret_cast<const uint2*>(xa + kl);
      const uint2 hi = *reinterpret_cast<const uint2*>(xa + 8 * xs + kl);
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        const int nt = n0 + i * ncol;
        if (nt < nta) {
          const uint2 w = *reinterpret_cast<const uint2*>(
              ws + (size_t)(nt * 8 + g) * wst + s * 16 + t4);
          mma_bf16_16816(a[i], lo.x, hi.x, lo.y, hi.y, w.x, w.y);
        }
      }
    };
    int s = s0;
    for (; s + 3 < s1; s += 4) {
      slice(s, acc[0]);
      slice(s + 1, acc[1]);
      slice(s + 2, acc[2]);
      slice(s + 3, acc[3]);
    }
    for (; s < s1; ++s) slice(s, acc[0]);
  });
  cp_async_wait<0>();  // the xp prefetch too
  __syncthreads();     // the ring is free again; the xp buffer is visible
  if (n0 >= ncol) return;
#pragma unroll
  for (int i = 0; i < NTW; ++i) {
    const int nt = n0 + i * ncol;
    if (nt < nta) {
      float d[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        d[q] = (acc[0][i][q] + acc[1][i][q]) + (acc[2][i][q] + acc[3][i][q]);
      const bool odd = lane & 1;
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? d[0] : d[2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? d[1] : d[3], 1);
      const float z[4] = {odd ? r0 : d[0], odd ? r1 : d[1], odd ? d[2] : r0,
                          odd ? d[3] : r1};
      epi(m * 16 + g + (odd ? 8 : 0), nt * 2 + ((lane & 3) >> 1), z);
    }
  }
}

// K4 in bf16 (RES) and K2 in bf16 above the LAT design's batch (!RES: no
// z_seq, c_seq; only hid leaves phase A's epilogue).
template <bool RES>
__global__ void __launch_bounds__(NT)
    lstm_fwd_mma_kernel(const bf16* __restrict__ xp,    // [T, B, 4H]
                        const bf16* __restrict__ wh,    // [P, 4H]
                        const bf16* __restrict__ wp,    // [H, P]
                        const bf16* __restrict__ bias,  // [4H]
                        const float* __restrict__ c0,   // [B, H]
                        const float* __restrict__ h0,   // [B, P], bf16 values
                        bf16* hx,     // [B, ldp] h of the step
                        bf16* hidx,   // [B, ldh] hid of the step
                        bf16* __restrict__ hseq,   // [T, B, P]
                        float* __restrict__ cfin,  // [B, H]
                        bf16* __restrict__ zseq,   // [T, B, 4H]
                        bf16* __restrict__ cseq,   // [T, B, H]
                        unsigned int* bar, int T, int B, int H, int P,
                        int kq) {
  extern __shared__ __align__(16) unsigned char smem_fwd[];
  const int nblk = gridDim.x, blk = blockIdx.x;
  const int u0 = slice_begin(blk, H, nblk);
  const int nu = slice_begin(blk + 1, H, nblk) - u0;
  const int j0 = slice_begin(blk, P, nblk);
  const int ncb = slice_begin(blk + 1, P, nblk) - j0;
  const FwdPlan pl = fwd_plan(nblk, B, H, P, kq);
  bf16* wsh = reinterpret_cast<bf16*>(smem_fwd);
  bf16* wsp = reinterpret_cast<bf16*>(smem_fwd + pl.wp);
  float* red = reinterpret_cast<float*>(smem_fwd + pl.red);
  float* bs = reinterpret_cast<float*>(smem_fwd + pl.bias);
  float* cst = reinterpret_cast<float*>(smem_fwd + pl.c);
  bf16* xps = reinterpret_cast<bf16*>(smem_fwd + pl.xp);
  bf16* ring = reinterpret_cast<bf16*>(smem_fwd + pl.ring);
  const int H4 = 4 * H, numax = pl.numax, ncols = 8 * pl.nta;
  // the xp buffer holds columns xb .. of each gate: whole 4-byte pairs
  const int xb = u0 & ~1, npair = (u0 + nu - xb + 1) / 2;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // the weight slices, resident for the whole launch: Wh's columns of own
  // units unit-major (4u + gate; columns past 4 nu zero), Wp's own columns
  for (int i = threadIdx.x; i < pl.ldp * ncols; i += NT) {
    const int k = i / ncols, n = i - k * ncols, u = n >> 2;
    wsh[n * pl.sa + k] = k < P && u < nu
                             ? wh[(size_t)k * H4 + (n & 3) * H + u0 + u]
                             : zero;
  }
  for (int i = threadIdx.x; i < pl.ldh * ncb; i += NT) {
    const int k = i / ncb, c = i - k * ncb;
    wsp[c * pl.sb + k] = k < H ? wp[(size_t)k * P + j0 + c] : zero;
  }
  for (int i = threadIdx.x; i < 4 * nu; i += NT) {
    const int q = i / nu, u = i - q * nu;
    bs[q * numax + u] = to_float(bias[q * H + u0 + u]);
  }
  for (int i = threadIdx.x; i < B * nu; i += NT) {
    const int b = i / nu, u = i - b * nu;
    cst[b * numax + u] = c0[(size_t)b * H + u0 + u];
  }
  // h0 into the exchange (own columns), and the rows' padding, which no
  // step writes
  for (int i = threadIdx.x; i < B * ncb; i += NT) {
    const int b = i / ncb, c = i - b * ncb;
    hx[(size_t)b * pl.ldp + j0 + c] =
        from_float<bf16>(h0[(size_t)b * P + j0 + c]);
  }
  if (blk == 0) {
    const int pp = pl.ldp - P, ph = pl.ldh - H;
    for (int i = threadIdx.x; i < B * pp; i += NT)
      hx[(size_t)(i / pp) * pl.ldp + P + i % pp] = zero;
    for (int i = threadIdx.x; i < B * ph; i += NT)
      hidx[(size_t)(i / ph) * pl.ldh + H + i % ph] = zero;
  }
  // xp[t] of own units into xps [B][4][xw], off the step chain: one group
  auto prefetch_xp = [&](int t) {
    for (int i = threadIdx.x; i < B * 4 * npair; i += NT) {
      const int r = i / npair, p = i - r * npair;  // r = 4 b + gate
      cp_async4(xps + r * pl.xw + 2 * p,
                xp + ((size_t)t * B + (r >> 2)) * H4 + (r & 3) * H + xb +
                    2 * p);
    }
    cp_async_commit();
  };
  prefetch_xp(0);
  unsigned int target = 0;
  grid_barrier(bar, target);

  for (int t = 0; t < T; ++t) {
    // phase A: z = xp[t] + bias + h @ Wh for own units, then the cell
    for (int b0 = 0; b0 < B; b0 += 16 * MT_MAX) {
      const int nb = min(16 * MT_MAX, B - b0), mt = (nb + 15) / 16;
      // h in half-size chunks (kq = 1): the first MMAs start sooner
      gates_pass(hx, pl.ldp, b0, nb, mt, 1, wsh, pl.sa, pl.nta, ring,
                 [&](int r, int u, const float (&acc)[4]) {
        if (r >= nb || u >= nu) return;
        const int b = b0 + r;
        const bf16* xr = xps + b * 4 * pl.xw + (u0 - xb) + u;
        float z[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          z[q] = to_float(xr[q * pl.xw]) + bs[q * numax + u] + acc[q];
        const float c = sigmoid(z[2]) * cst[b * numax + u] +
                        sigmoid(z[0]) * tanhf(z[1]);
        cst[b * numax + u] = c;
        // staged in the free ring: [row][z i, g, f, o, c, hid][unit]
        bf16* st = ring + r * 6 * numax + u;
        if constexpr (RES) {
#pragma unroll
          for (int q = 0; q < 4; ++q) st[q * numax] = from_float<bf16>(z[q]);
          st[4 * numax] = from_float<bf16>(c);
        }
        st[5 * numax] = from_float<bf16>(sigmoid(z[3]) * tanhf(c));
      });
      __syncthreads();
      // the pass's residuals and hid (!RES: hid alone), row by row
      constexpr int nq = RES ? 6 : 1, q0 = 6 - nq;
      for (int i = threadIdx.x; i < nb * nq * nu; i += NT) {
        const int r = i / (nq * nu), k = i - r * nq * nu, q = q0 + k / nu;
        const int u = k - (q - q0) * nu;
        const bf16 v = ring[(r * 6 + q) * numax + u];
        const size_t row = (size_t)t * B + b0 + r;
        if (q < 4)
          zseq[row * H4 + q * H + u0 + u] = v;
        else if (q == 4)
          cseq[row * H + u0 + u] = v;
        else
          hidx[(size_t)(b0 + r) * pl.ldh + u0 + u] = v;
      }
      __syncthreads();  // also: every epilogue has read xps and the ring
    }
    if (t + 1 < T) prefetch_xp(t + 1);  // lands during phase B
    grid_barrier(bar, target);

    // phase B: own columns of h = hid @ Wp
    for (int b0 = 0; ncb > 0 && b0 < B; b0 += 16 * MT_MAX) {
      const int nb = min(16 * MT_MAX, B - b0), mt = (nb + 15) / 16;
      pass_products<1>(hidx, pl.ldh, b0, nb, mt, kq, wsp, pl.sb, ncb, ring,
                       red);
      __syncthreads();
      for (int i = threadIdx.x; i < nb * ncb; i += NT) {
        const int bb = i / ncb, c = i - bb * ncb, b = b0 + bb;
        const bf16 hw = from_float<bf16>(red_sum(red, mt, 8, bb, c));
        hseq[((size_t)t * B + b) * P + j0 + c] = hw;
        hx[(size_t)b * pl.ldp + j0 + c] = hw;
      }
      __syncthreads();
    }
    grid_barrier(bar, target);
  }

  for (int i = threadIdx.x; i < B * nu; i += NT) {
    const int b = i / nu, u = i - b * nu;
    cfin[(size_t)b * H + u0 + u] = cst[b * numax + u];
  }
}

// ---- K2 in bf16 at B <= LAT_MAX_B: the latency-first step (LAT) ----

// A value of the exchange is one 32-bit word: the bf16 bits low, the tag of
// the step that wrote it high, stored with one 32-bit store, so a reader
// that sees the tag sees the value.  Tags run 1 .. 65535 and never 0, the
// value of the words the launcher zeroes.
__device__ __forceinline__ unsigned step_tag(int s) {
  return 1u + (unsigned)(s % 65535);
}
__device__ __forceinline__ unsigned tag_word(bf16 v, unsigned tag) {
  return (tag << 16) | (unsigned)__bfloat16_as_ushort(v);
}
__device__ __forceinline__ void st_word(unsigned* p, unsigned w) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(w)
               : "memory");
}
// Four words from L2 (relaxed, device scope: never a stale L1 line); each
// word is read whole.
__device__ __forceinline__ uint4 ld_words(const unsigned* p) {
  uint4 v;
  asm volatile("ld.relaxed.gpu.global.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}
// Whether the first nv words of v carry `tag` (nv >= 4: all four; nv <= 0:
// none is needed).
__device__ __forceinline__ bool tagged(uint4 v, unsigned tag, int nv) {
  return (nv <= 0 || v.x >> 16 == tag) && (nv <= 1 || v.y >> 16 == tag) &&
         (nv <= 2 || v.z >> 16 == tag) && (nv <= 3 || v.w >> 16 == tag);
}

#ifndef LAT_MAX_B
#define LAT_MAX_B 8  // batch rows of one n8 tile
#endif
constexpr int LAT_G = 4;    // k16 slices whose words a lane polls at once
constexpr int LAT_MT = 6;   // m16 tiles of the Wh slice: 96 rows
constexpr int LAT_UPW = 4;  // hidden units a warp owns in the epilogue

// Diagnostics only (off unless built with -DLSTM_PHASE_TIMERS, as
// kernels/lstm_ab.py can): thread 0 of block 0 adds the cycles since its
// last mark to phase i of the LAT step, in registers, and adds them to
// g_k2_phases at the end of the launch (read back through k2_phases()).
#ifdef LSTM_PHASE_TIMERS
__device__ unsigned long long g_k2_phases[8];
#endif
struct LatTimer {
#ifdef LSTM_PHASE_TIMERS
  long long mark = 0, ph[8] = {};
  __device__ bool mine() const {
    return blockIdx.x == 0 && threadIdx.x == 0;
  }
  __device__ void start() { mark = clock64(); }
  __device__ void at(int i) {
    if (mine()) {
      const long long now = clock64();
      ph[i] += now - mark;
      mark = now;
    }
  }
  __device__ void flush() {
    if (mine())
      for (int i = 0; i < 8; ++i)
        atomicAdd(&g_k2_phases[i], (unsigned long long)ph[i]);
  }
#else
  __device__ void start() {}
  __device__ void at(int) {}
  __device__ void flush() {}
#endif
};

struct LatPlan {
  int ldp, ldh;    // exchange row strides in words: P, H padded to 16
  int sa, sb;      // resident column strides: Wh slice (k over P), Wp (H)
  int numax, ncmax;
  int mta, mtb;    // m16 tiles of the Wh slice (4 numax rows), Wp (ncmax)
  int xw;          // values a (row, gate) of an xp slot holds
  size_t wp, red_a, red_b, c, xp, bytes;  // byte offsets (Wh at 0), total
};

__host__ __device__ inline LatPlan lat_plan(int nblk, int H, int P) {
  LatPlan p;
  p.ldp = round_up(P, 16);
  p.ldh = round_up(H, 16);
  p.sa = col_stride(p.ldp);
  p.sb = col_stride(p.ldh);
  p.numax = (H + nblk - 1) / nblk;
  p.ncmax = (P + nblk - 1) / nblk;
  p.mta = (4 * p.numax + 15) / 16;
  p.mtb = (p.ncmax + 15) / 16;
  p.wp = sizeof(bf16) * (size_t)4 * p.numax * p.sa;
  p.red_a = p.wp + sizeof(bf16) * (size_t)p.ncmax * p.sb;
  p.red_b = p.red_a + sizeof(float) * (size_t)NWARP * p.mta * 128;
  p.c = p.red_b + sizeof(float) * (size_t)NWARP * p.mtb * 128;
  p.xw = round_up(p.numax + 1, 2);
  p.xp = p.c + (sizeof(float) * (size_t)LAT_MAX_B * p.numax + 15) / 16 * 16;
  p.bytes = p.xp + sizeof(bf16) * (size_t)2 * LAT_MAX_B * 4 * p.xw;
  return p;
}

// Whether the LAT design takes the shape: one n8 tile of batch rows; the
// slices, partial tiles and c in one block's shared memory; at most LAT_MT
// m-tiles of Wh and one of Wp; at most 62 units a block (32 xp pairs, a
// lane each); every block owning at least one column of h (a block's reads
// of hid are then witnessed by the h it writes, which keeps one buffer of
// each exchange safe); and the xp prefetch's 4-byte copies aligned (H
// even, xp too).
inline bool lat_plan_fits(const LatPlan& p, int nblk, int B, int H, int P,
                          size_t optin, const void* xp) {
  return B >= 1 && B <= LAT_MAX_B && p.bytes <= optin && p.mta <= LAT_MT &&
         p.mtb == 1 && p.numax <= 62 && P >= nblk && H % 2 == 0 &&
         (reinterpret_cast<size_t>(xp) & 3) == 0;
}

// As grid_barrier: a wait over 2^35 cycles is a fault, not a hang.
__device__ __forceinline__ void lat_watchdog(long long& t0) {
  if (t0 == 0) t0 = clock64();
  if (clock64() - t0 > (1LL << 35)) __trap();
}

// acc += ws[rows m * 16 + g and + 8 of the MT m-tiles, k .. k+3] x (b0,
// b1), with wg = ws + g * wst + the lane's k of slice 0 and ko the slice's
// offset from it (a constant once unrolled), ms = 16 * wst, and rows past
// nrows zero.
template <int MT>
__device__ __forceinline__ void lat_mma(float (&acc)[MT][4], const bf16* wg,
                                        int ms, int nrows, int g, int ko,
                                        unsigned b0, unsigned b1) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const bf16* w = wg + m * ms + ko;
    uint2 a0 = make_uint2(0u, 0u), a1 = make_uint2(0u, 0u);
    if (m * 16 + g < nrows) a0 = *reinterpret_cast<const uint2*>(w);
    if (m * 16 + 8 + g < nrows)
      a1 = *reinterpret_cast<const uint2*>(w + ms / 2);
    mma_bf16_16816(acc[m], a0.x, a1.x, a0.y, a1.y, b0, b1);
  }
}

// One step product on the tensor cores with the weights as the A operand:
// out[r, b] = sum_k ws[r, k] x[b, k] for the nrows rows of ws (column r at
// ws + r * wst, k-contiguous, zero past kvalid) and the B <= 8 rows of x,
// read from the tagged words (row b at words + b * ldw) of the step `tag`.
// Warp w is k-group w: it takes the k16 slices w, w + 16, ... for every
// m-tile, so no two warps poll the same words, and its chain is a few
// slices deep (one accumulator an m-tile, two when MT = 1).  A lane polls
// its words until every one it needs carries the tag (k >= kvalid and rows
// >= B are not read: zero), then the MMAs run.
//  - B = 1: lane l loads the four words at k = 16 s + 4 (l % 4) of slice
//    l / 4 of each group of 8, so one load a lane brings a whole group, and
//    two shuffles a slice hand the values to the lanes of batch row 0.
//  - B > 1: lane (g, t) loads row g at k = 16 s + 4t of each slice, up to
//    LAT_G slices at once, after the group's first slice alone is ready (so
//    a wait polls one slice, not LAT_G).
// The partial tiles go to red [warp][m-tile][16 rows][8 batch rows]; the
// caller synchronises before summing them in warp order.
template <int MT>
__device__ __forceinline__ void tagged_products(
    const bf16* ws, int wst, int nrows, const unsigned* words, int ldw,
    int kvalid, int B, unsigned tag, float* red, int phase, LatTimer& tm) {
  constexpr int NACC = MT == 1 ? 2 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = 4 * (lane & 3);
  const int nsl = (kvalid + 15) / 16;
  const int nw = warp < nsl ? (nsl - warp + NWARP - 1) / NWARP : 0;
  float acc[NACC][MT][4] = {};
  long long t0 = 0;
  const bf16* wg = ws + (size_t)g * wst + warp * 16 + t4;  // slice warp
  const int ms = 16 * wst;
  if (B == 1) {
    for (int i0 = 0; i0 < nw; i0 += 8) {
      const int li = i0 + (lane >> 2);
      const int kl = (warp + NWARP * li) * 16 + t4;  // this lane's load
      const bool mine = li < nw;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (mine) v = ld_words(words + kl);
      while (!__all_sync(0xffffffffu, !mine || tagged(v, tag, kvalid - kl))) {
        lat_watchdog(t0);
        if (mine && !tagged(v, tag, kvalid - kl)) v = ld_words(words + kl);
      }
      tm.at(phase);
      const unsigned p0 = __byte_perm(v.x, v.y, 0x5410);
      const unsigned p1 = __byte_perm(v.z, v.w, 0x5410);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i0 + i < nw) {
          const int src = 4 * i + (lane & 3);
          unsigned b0 = __shfl_sync(0xffffffffu, p0, src);
          unsigned b1 = __shfl_sync(0xffffffffu, p1, src);
          if (g != 0) b0 = b1 = 0u;  // batch rows >= 1
          lat_mma<MT>(acc[i % NACC], wg, ms, nrows, g,
                      NWARP * 16 * (i0 + i), b0, b1);
        }
      }
    }
  } else {
    const bool live = g < B;
    const unsigned* xw = words + (size_t)(live ? g : 0) * ldw + t4;
    for (int i0 = 0; i0 < nw; i0 += LAT_G) {
      const int n = min(LAT_G, nw - i0);
      auto kof = [&](int i) { return (warp + NWARP * (i0 + i)) * 16; };
      uint4 v[LAT_G];
      if (live) v[0] = ld_words(xw + kof(0));
      while (!__all_sync(0xffffffffu,
                         !live || tagged(v[0], tag, kvalid - kof(0) - t4))) {
        lat_watchdog(t0);
        if (live) v[0] = ld_words(xw + kof(0));
      }
#pragma unroll
      for (int i = 1; i < LAT_G; ++i)
        if (live && i < n) v[i] = ld_words(xw + kof(i));
      for (;;) {
        bool ok = true;
#pragma unroll
        for (int i = 1; i < LAT_G; ++i)
          if (live && i < n) ok = ok && tagged(v[i], tag, kvalid - kof(i) - t4);
        if (__all_sync(0xffffffffu, ok)) break;
        lat_watchdog(t0);
#pragma unroll
        for (int i = 1; i < LAT_G; ++i)
          if (live && i < n && !tagged(v[i], tag, kvalid - kof(i) - t4))
            v[i] = ld_words(xw + kof(i));
      }
      tm.at(phase);
#pragma unroll
      for (int i = 0; i < LAT_G; ++i) {
        if (i < n) {
          unsigned b0 = 0u, b1 = 0u;
          if (live) {  // the words' low halves, two bf16 a register
            b0 = __byte_perm(v[i].x, v[i].y, 0x5410);
            b1 = __byte_perm(v[i].z, v[i].w, 0x5410);
          }
          lat_mma<MT>(acc[i % NACC], wg, ms, nrows, g,
                      NWARP * 16 * (i0 + i), b0, b1);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float d[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      d[q] = acc[0][m][q];
      if (NACC == 2) d[q] += acc[NACC - 1][m][q];
    }
    float* o = red + ((warp * MT + m) * 16 + g) * 8 + t4 / 2;
    o[0] = d[0];
    o[1] = d[1];
    o[64] = d[2];
    o[65] = d[3];
  }
  tm.at(phase + 1);
}

// K2 in bf16 for B <= LAT_MAX_B.  The step's critical path is two hops
// through L2 and two short product chains: no grid barrier and no staging
// of the exchange in shared memory.
//  - The slices are resident as in the MMA design, rows as the A operand
//    (Wh unit-major, 4u + gate; Wp's own columns), so the batch rows are N
//    and an n8 tile wastes at most 7/8.  K is split over the 16 warps (at
//    the parity width 2-3 k16 slices a warp for 4 m-tiles in phase A, 8
//    slices for one m-tile in phase B), and the 16 partial tiles are summed
//    in a fixed order, so a launch is deterministic.
//  - The exchange carries its readiness: each value of h [B, ldp] and hid
//    [B, ldh] is a tagged word (tag_word above), polled straight into the
//    MMA's B fragments.  One buffer of each is enough: a block writes h of
//    step t only after reading every block's hid of step t, each written
//    after its block had read all of h of step t - 1, and likewise for hid.
//    h0 enters the exchange as the words of step 0 (tag 1); step t reads
//    h with tag step_tag(t), hid with step_tag(t + 1).
//  - Epilogues by warp: warp w owns units w, w + 16, .. and columns w, w +
//    16, ..; in phase A lane (q, b) = (lane / 8, lane % 8) sums gate q of
//    row b over the 16 partial tiles, adds xp (copied into shared memory
//    with cp.async during the step before) and the bias (in registers),
//    and one shuffle per gate gives lane b the four gates for the cell
//    update; in phase B each quarter of the warp sums 4 partial tiles and
//    two shuffles add the quarters.  c stays in shared memory; h_seq[t] is
//    stored beside the h words.
template <int MTA>  // m16 tiles of the Wh slice (LatPlan::mta)
__global__ void __launch_bounds__(NT)
    lstm_infer_lat_kernel(const bf16* __restrict__ xp,    // [T, B, 4H]
                          const bf16* __restrict__ wh,    // [P, 4H]
                          const bf16* __restrict__ wp,    // [H, P]
                          const bf16* __restrict__ bias,  // [4H]
                          const float* __restrict__ c0,   // [B, H]
                          const float* __restrict__ h0,   // [B, P], bf16 values
                          unsigned* hidw,  // [B, ldh] tagged hid, zeroed
                          unsigned* hw,    // [B, ldp] tagged h, zeroed
                          bf16* __restrict__ hseq,   // [T, B, P]
                          float* __restrict__ cfin,  // [B, H]
                          int T, int B, int H, int P) {
  extern __shared__ __align__(16) unsigned char smem_lat[];
  const int nblk = gridDim.x, blk = blockIdx.x;
  const int u0 = slice_begin(blk, H, nblk);
  const int nu = slice_begin(blk + 1, H, nblk) - u0;
  const int j0 = slice_begin(blk, P, nblk);
  const int ncb = slice_begin(blk + 1, P, nblk) - j0;
  const LatPlan pl = lat_plan(nblk, H, P);
  bf16* wsh = reinterpret_cast<bf16*>(smem_lat);
  bf16* wsp = reinterpret_cast<bf16*>(smem_lat + pl.wp);
  float* red_a = reinterpret_cast<float*>(smem_lat + pl.red_a);
  float* red_b = reinterpret_cast<float*>(smem_lat + pl.red_b);
  float* cst = reinterpret_cast<float*>(smem_lat + pl.c);
  bf16* xps = reinterpret_cast<bf16*>(smem_lat + pl.xp);
  const int H4 = 4 * H, tid = threadIdx.x, numax = pl.numax;
  const int warp = tid >> 5, lane = tid & 31;
  const int lq = lane >> 3, lb = lane & 7;  // epilogue lane: gate, row
  const bf16 zero = __float2bfloat16_rn(0.f);
  // xp[t] of own units into slot t % 2 [row][gate][xw], 4-byte cp.async of
  // whole pairs from xb on: one group, waited for before step t's epilogue
  const int xb = u0 & ~1, npair = (u0 + nu - xb + 1) / 2;
  const int xslot = LAT_MAX_B * 4 * pl.xw;
  auto prefetch_xp = [&](int t) {
    bf16* dst = xps + (t & 1) * xslot + 2 * lane;
    const bf16* src = xp + (size_t)t * B * H4 + xb + 2 * lane;
    if (lane < npair)  // pair lane of rows r = 4 b + gate
      for (int r = warp; r < 4 * B; r += NWARP)
        cp_async4(dst + r * pl.xw, src + (size_t)(r >> 2) * H4 + (r & 3) * H);
    cp_async_commit();
  };
  prefetch_xp(0);

  // h0's own columns into the exchange first: the other blocks wait on them
  for (int i = tid; i < B * ncb; i += NT) {
    const int b = i / ncb, c = i - b * ncb;
    st_word(hw + (size_t)b * pl.ldp + j0 + c,
            tag_word(from_float<bf16>(h0[(size_t)b * P + j0 + c]),
                     step_tag(0)));
  }
  // the weight slices, resident for the whole launch, and c
  for (int i = tid; i < pl.ldp * 4 * nu; i += NT) {
    const int k = i / (4 * nu), n = i - k * 4 * nu;
    wsh[n * pl.sa + k] =
        k < P ? wh[(size_t)k * H4 + (n & 3) * H + u0 + (n >> 2)] : zero;
  }
  for (int i = tid; i < pl.ldh * ncb; i += NT) {
    const int k = i / ncb, c = i - k * ncb;
    wsp[c * pl.sb + k] = k < H ? wp[(size_t)k * P + j0 + c] : zero;
  }
  for (int i = tid; i < B * nu; i += NT) {
    const int b = i / nu, u = i - b * nu;
    cst[b * numax + u] = c0[(size_t)b * H + u0 + u];
  }
  // this lane's gate lq of its units: the bias
  float bq[LAT_UPW];
#pragma unroll
  for (int i = 0; i < LAT_UPW; ++i) {
    const int u = warp + NWARP * i;
    bq[i] = u < nu ? to_float(bias[lq * H + u0 + u]) : 0.f;
  }
  __syncthreads();
  LatTimer tm;
  tm.start();

  for (int t = 0; t < T; ++t) {
    const unsigned tag_h = step_tag(t), tag_n = step_tag(t + 1);
    // phase A: z = xp[t] + bias + h @ Wh for own units, then the cell
    tagged_products<MTA>(wsh, pl.sa, 4 * nu, hw, pl.ldp, P, B, tag_h, red_a,
                         0, tm);
    cp_async_wait<0>();  // xp[t], issued a step ago
    __syncthreads();
    tm.at(2);
    const bf16* xrow = xps + (t & 1) * xslot + (4 * lb + lq) * pl.xw + u0 - xb;
#pragma unroll
    for (int i = 0; i < LAT_UPW; ++i) {
      const int u = warp + NWARP * i;
      if (u < nu) {
        // gate column 4u + lq of the 16 partial tiles, MTA * 128 apart
        const float* ra = red_a + (4 * u + lq) * 8 + lb;
        float z = 0.f;
#pragma unroll
        for (int kg = 0; kg < NWARP; ++kg) z += ra[kg * MTA * 128];
        z += (lb < B ? to_float(xrow[u]) : 0.f) + bq[i];
        const float zi = __shfl_sync(0xffffffffu, z, lb);
        const float zg = __shfl_sync(0xffffffffu, z, 8 + lb);
        const float zf = __shfl_sync(0xffffffffu, z, 16 + lb);
        const float zo = __shfl_sync(0xffffffffu, z, 24 + lb);
        if (lane < B) {  // lq = 0, lb = lane
          float* cp = cst + lane * numax + u;
          const float c = sigmoid(zf) * *cp + sigmoid(zi) * tanhf(zg);
          *cp = c;
          st_word(hidw + (size_t)lane * pl.ldh + u0 + u,
                  tag_word(from_float<bf16>(sigmoid(zo) * tanhf(c)), tag_n));
        }
      }
    }
    if (t + 1 < T) prefetch_xp(t + 1);  // lands during phase B
    tm.at(3);
    // phase B: own columns of h = hid @ Wp
    tagged_products<1>(wsp, pl.sb, ncb, hidw, pl.ldh, H, B, tag_n, red_b, 4,
                       tm);
    __syncthreads();
    tm.at(6);
    if (warp < ncb) {  // column j = warp (ncb <= 16: one m-tile)
      const int j = warp;
      const float* rb = red_b + (4 * lq * 16 + j) * 8 + lb;
      float hs = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) hs += rb[q * 128];
      hs += __shfl_xor_sync(0xffffffffu, hs, 8);
      hs += __shfl_xor_sync(0xffffffffu, hs, 16);
      if (lane < B) {
        const bf16 hv = from_float<bf16>(hs);
        st_word(hw + (size_t)lane * pl.ldp + j0 + j, tag_word(hv, tag_n));
        hseq[((size_t)t * B + lane) * P + j0 + j] = hv;
      }
    }
    tm.at(7);
  }
#pragma unroll
  for (int i = 0; i < LAT_UPW; ++i) {
    const int u = warp + NWARP * i;
    if (u < nu && lane < B)
      cfin[(size_t)lane * H + u0 + u] = cst[lane * numax + u];
  }
  tm.flush();
}

// The design is the plan's, chosen before the launch and never after a
// failed one; lstm_last_design() reports it.  bf16 K2 runs LAT where its
// plan fits (B <= LAT_MAX_B), else, as bf16 K4 does, lstm_fwd_mma_kernel
// where that plan fits; the rest (fp32, and bf16 outside both plans) runs
// the FMA template above.
template <typename W, bool RES>
int launch(const void* xp_, const void* wh_, const void* wp_,
           const void* bias_, const float* c0, float* hbuf, float* hidbuf,
           void* hseq_, float* cfin, void* zseq_, void* cseq_,
           unsigned int* bar, int T, int B, int H, int P, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const W* xp = (const W*)xp_;
  const W* wh = (const W*)wh_;
  const W* wp = (const W*)wp_;
  const W* bias = (const W*)bias_;
  W* hseq = (W*)hseq_;
  W* zseq = (W*)zseq_;
  W* cseq = (W*)cseq_;
  Card card;
  const int err = query_card(card);
  if (err) return err;
  const int nblk = grid_blocks(card, H);
  if constexpr (std::is_same<W, bf16>::value) {
    const float* h0 = hbuf;
    if constexpr (!RES) {
      const LatPlan lp = lat_plan(nblk, H, P);
      if (lat_plan_fits(lp, nblk, B, H, P, card.optin, xp)) {
        unsigned* hidw = reinterpret_cast<unsigned*>(hidbuf);
        unsigned* hw = hidw + (size_t)B * lp.ldh;
        void* args[] = {&xp, &wh,   &wp,   &bias, &c0, &h0, &hidw,
                        &hw, &hseq, &cfin, &T,    &B,  &H,  &P};
        const void* kernels[LAT_MT] = {
            (const void*)lstm_infer_lat_kernel<1>,
            (const void*)lstm_infer_lat_kernel<2>,
            (const void*)lstm_infer_lat_kernel<3>,
            (const void*)lstm_infer_lat_kernel<4>,
            (const void*)lstm_infer_lat_kernel<5>,
            (const void*)lstm_infer_lat_kernel<6>};
        g_last_design = kDesignLat;
        return coop_launch(kernels[lp.mta - 1], nblk, lp.bytes, args, hidw,
                           stream, sizeof(unsigned) * B * (lp.ldh + lp.ldp));
      }
    }
    int kq = fwd_plan(nblk, B, H, P, 2).bytes <= (size_t)card.optin ? 2 : 1;
    const FwdPlan pl = fwd_plan(nblk, B, H, P, kq);
    if (fwd_plan_fits(pl, B, H, card.optin, xp)) {
      bf16* hx = reinterpret_cast<bf16*>(hbuf + round_up(B * P, 4));
      bf16* hidx = reinterpret_cast<bf16*>(hidbuf);
      void* args[] = {&xp,   &wh,   &wp,   &bias, &c0,  &h0, &hx,
                      &hidx, &hseq, &cfin, &zseq, &cseq, &bar, &T,
                      &B,    &H,    &P,    &kq};
      g_last_design = kDesignMma;
      return coop_launch((const void*)lstm_fwd_mma_kernel<RES>, nblk,
                         pl.bytes, args, bar, stream);
    }
  }
  void* args[] = {&xp,   &wh,   &wp,   &bias, &c0, &hbuf, &hidbuf, &hseq,
                  &cfin, &zseq, &cseq, &bar,  &T,  &B,    &H,      &P};
  g_last_design = kDesignFma;
  return coop_launch((const void*)lstm_infer_kernel<W, RES>, nblk,
                     smem_bytes(nblk, B, H, P, rows<W, RES>()), args, bar,
                     stream);
}

}  // namespace

// xp [T, B, 4H], wh [P, 4H], wp [H, P], bias [4H], h_seq [T, B, P] in the
// weight type; c0 [B, H], c_fin [B, H] f32; hbuf f32 holding h0 [B, P]
// (rounded to the weight type) followed, from float round_up(B P, 4), by
// room for B round_up(P, 16) floats; hidbuf f32 scratch of B (round_up(H,
// 16) + round_up(P, 16)) floats; bar one uint32 scratch.  The FMA design
// uses hbuf's first B P floats and hidbuf as [B, H]; the MMA design's bf16
// exchange, the tail of hbuf and the bytes of hidbuf; the LAT design's
// tagged words, all of hidbuf (hid, then h).  Returns a CUDA error code (0 =
// launched); lstm_last_design() then says which design ran.
extern "C" int lstm_infer_f32(const void* xp, const void* wh, const void* wp,
                              const void* bias, const float* c0, float* hbuf,
                              float* hidbuf, void* hseq, float* cfin,
                              unsigned int* bar, int T, int B, int H, int P,
                              void* stream) {
  return launch<float, false>(xp, wh, wp, bias, c0, hbuf, hidbuf, hseq, cfin,
                              nullptr, nullptr, bar, T, B, H, P, stream);
}

extern "C" int lstm_infer_bf16(const void* xp, const void* wh, const void* wp,
                               const void* bias, const float* c0, float* hbuf,
                               float* hidbuf, void* hseq, float* cfin,
                               unsigned int* bar, int T, int B, int H, int P,
                               void* stream) {
  return launch<__nv_bfloat16, false>(xp, wh, wp, bias, c0, hbuf, hidbuf,
                                      hseq, cfin, nullptr, nullptr, bar, T, B,
                                      H, P, stream);
}

// The training forward (K4): as above, and also z_seq [T, B, 4H] and c_seq
// [T, B, H] in the weight type.
extern "C" int lstm_fwd_f32(const void* xp, const void* wh, const void* wp,
                            const void* bias, const float* c0, float* hbuf,
                            float* hidbuf, void* hseq, float* cfin, void* zseq,
                            void* cseq, unsigned int* bar, int T, int B, int H,
                            int P, void* stream) {
  return launch<float, true>(xp, wh, wp, bias, c0, hbuf, hidbuf, hseq, cfin,
                             zseq, cseq, bar, T, B, H, P, stream);
}

extern "C" int lstm_fwd_bf16(const void* xp, const void* wh, const void* wp,
                             const void* bias, const float* c0, float* hbuf,
                             float* hidbuf, void* hseq, float* cfin,
                             void* zseq, void* cseq, unsigned int* bar, int T,
                             int B, int H, int P, void* stream) {
  return launch<__nv_bfloat16, true>(xp, wh, wp, bias, c0, hbuf, hidbuf, hseq,
                                     cfin, zseq, cseq, bar, T, B, H, P,
                                     stream);
}

#ifdef LSTM_PHASE_TIMERS
// Block 0's cycles by phase of the LAT step, summed over launches since the
// last reset (reset != 0 zeroes them); out holds 8 values.
extern "C" int k2_phases(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long z[8] = {};
    return (int)cudaMemcpyToSymbol(g_k2_phases, z, sizeof z);
  }
  return (int)cudaMemcpyFromSymbol(out, g_k2_phases, sizeof(unsigned long long) * 8);
}
#endif
