// Projected-LSTM backward (BPTT) sequence kernel for Hopper (sm_90a): K5.
//
// Replaces rnnt_tpu/ops/lstm_pallas.py::_bwd_kernel (launched by _bwd_call
// from _lstm_seq_bwd).  From the forward's residuals z_seq [T, B, 4H] and
// c_seq [T, B, H] (weight type W) and the output gradient dout [T, B, P]
// (W), for t = T-1..0 with carried dh [B, P] and dc [B, H] (fp32, zero at
// the start):
//   dh_total = dout[t] + dh                  -> dh_total_seq[t] (rounded to W)
//   dhid     = dh_total @ Wp^T               [B, H]  (dh_total rounded to W)
//   i, g, f, o from z[t]; tanh_c = tanh(c[t])
//   dc      += dhid * o * (1 - tanh_c^2)
//   dz       = [dc g i (1-i), dc i (1-g^2), dc c[t-1] f (1-f),
//               dhid tanh_c o (1-o)]        -> dz_seq[t] (rounded to W)
//   dc       = dc * f
//   dh       = dz @ Wh^T                     [B, P]  (dz rounded to W)
// with c[-1] = c0, and finally dh0 = dh, dc0 = dc (fp32).  Wh^T [4H, P] and
// Wp^T [P, H] are transposed copies made by the wrapper.  The weight
// gradients are large products outside the kernel (plain torch.matmul).
//
// What bounds it on the H100: the products are 2 x B x (4H x P + P x H)
// operations a step (0.42 GFLOP at B=32, parity width), 0.4 us of the bf16
// tensor cores; the steps are a sequential chain, and a step needs dh_total
// whole before any dhid and dz whole before any dh, so each step is two
// grid-wide exchanges with a grid barrier after each.  What is left a step
// is the barriers plus the exchange: every block reads the whole dz [B, 4H]
// and dh_total [B, P], 0.55 MB at B=32 in bf16 (73 MB across 132 blocks),
// from L2.
//
// Structure (both types): one persistent cooperative launch (one block per
// SM, grid_barrier from common.cuh).  Block k owns a slice of the H hidden
// units (their four gate columns) and a slice of the P columns.  Before the
// first step each block writes its columns of dh_total for t = T-1; then
// per step:
//   phase A: dhid for its own units from the whole dh_total (a global
//            buffer), then the cell backward with dc carried in shared
//            memory, then dz for its own four gate columns (to dz_seq and a
//            global buffer);
//   grid barrier
//   phase B: its P columns of dz @ Wh^T, which with dout[t-1] become the
//            next step's dh_total (or, at t = 0, dh0);
//   grid barrier
// The kernel writes only its outputs and scratch: its inputs are left
// untouched.
//
// bf16 (bwd_mma): the weight slices stay in shared memory for the whole
// launch, the step products run on the tensor cores, the exchange is bf16.
//  - Before the first step a block copies its columns of Wh^T [4H x ncb]
//    and Wp^T [P x nu] into shared memory, each column's k values
//    contiguous (padded with zeros to a multiple of 16), so an MMA
//    B-fragment is one 8-byte load; nothing reads the weights again.
//  - Products: mma.sync m16n8k16 bf16 with fp32 accumulation.  Batch rows
//    are M, in passes of up to 64 rows (4 m16 tiles; the last tile's rows
//    past B are zero-filled); the block's own columns are N: two n8 tiles
//    for phase A's units (nu <= 16), one for phase B's P columns (ncb <=
//    8), the missing columns zero in registers.  The 16 warps split a pass
//    as mt m-tiles x (16 / mt) groups of k16 slices; the groups' partial
//    tiles sum through shared memory in a fixed order, so a launch is
//    deterministic.  Within each 16-wide k slice, lane t holds the four
//    contiguous values 4t..4t+3 as MMA k indices 2t, 2t+1, 2t+8, 2t+9, for
//    A and B alike: the sum is the same, and every fragment is one 8-byte
//    load.
//  - Exchange: dh_total [B, ldp] and dz [B, ld4] are bf16 (exact: both are
//    rounded to bf16 before their products), rows padded to a multiple of
//    16 with zeros.  A pass streams its rows into a 3-slot shared-memory
//    ring in k-chunks of ~32 KB (~16 KB above B=133) with 16-byte
//    cp.async.cg (L2, which sees the other blocks' writes), two chunks in
//    flight ahead of the MMAs.
//    Measured on one H100 (PERF.md): chunks of 32 KB and 3 slots beat
//    16 KB chunks with 3 or 4 slots by 16-20%; starting each block at
//    another chunk, and loading the cell's residuals before the products,
//    were slower.
//  - Strides keep every 8-byte fragment load of a half-warp on 32 distinct
//    banks: weight columns are padded to 16 mod 64 values, ring rows to
//    chunk + 16 with the chunk a multiple of 32.
// Shared memory (mma_plan), at the parity width (H=2048, P=640) on 132 SMs:
// Wh^T slice 5 x 8208 x 2 = 82,080 B; Wp^T slice 16 x 656 x 2 = 20,992 B;
// partial tiles 16,384 B; dc B x 16 x 4 (6,144 B at B=96); the ring 3 x
// 34,816 = 104,448 B: 230,048 B at B=96, within the 232,448 B a block may
// use (up to B=133).  A larger batch takes slots of half the size (kq = 1,
// 55,296 B; up to B=901).
//
// The FMA design (bwd_fma): block_dots over 4 batch rows a pass (8 in
// bf16), the weights read from L2 once a pass, the exchange in fp32.  fp32
// always runs it: TF32 tensor cores would round the operands to 10 mantissa
// bits and break the 1e-4 agreement with the plain version, and fp32 weight
// slices (204 KB at the parity width) would leave no shared memory to stage
// the exchange.  bf16 runs it for a shape outside the MMA plan (more than
// 16 units or 8 P columns a block, as on fewer than 128 SMs at the parity
// width, or too many bytes): the launcher picks the design from the plan,
// never after a failed launch, and lstm_last_design() reports it.

#include <type_traits>

#include "lstm_common.cuh"

namespace {

// ---- the FMA design (fp32; bf16 outside the MMA plan) ----

// Shared memory: reduction [NT*R] + dot outputs [ncmax*R] + dc [B*numax]
// in fp32, then the staged vector rows [R*max(4H,P)] in the weight type.
// R = train_rows<W>().
template <typename W>
inline size_t smem_bytes(int nblk, int B, int H, int P) {
  constexpr int R = train_rows<W>();
  const int numax = (H + nblk - 1) / nblk;
  const int ncmax = std::max(numax, (P + nblk - 1) / nblk);
  return sizeof(float) * ((size_t)NT * R + (size_t)ncmax * R +
                          (size_t)B * numax) +
         sizeof(W) * (size_t)R * std::max(4 * H, P);
}

template <typename W>
__device__ void bwd_fma(const W* __restrict__ zseq,    // [T, B, 4H]
                        const W* __restrict__ cseq,    // [T, B, H]
                        const float* __restrict__ c0,  // [B, H]
                        const W* __restrict__ dout,    // [T, B, P]
                        const W* __restrict__ whT,     // [4H, P]
                        const W* __restrict__ wpT,     // [P, H]
                        float* dhtot,   // [B, P] dh_total of the step
                        float* dzbuf,   // [B, 4H] dz of the step
                        W* __restrict__ dzseq,   // [T, B, 4H]
                        W* __restrict__ dhtseq,  // [T, B, P]
                        float* __restrict__ dh0,  // [B, P]
                        float* __restrict__ dc0,  // [B, H]
                        unsigned int* bar, int T, int B, int H, int P) {
  constexpr int R = train_rows<W>();
  extern __shared__ float smem[];
  const int nblk = gridDim.x, blk = blockIdx.x;
  const int u0 = slice_begin(blk, H, nblk);
  const int nu = slice_begin(blk + 1, H, nblk) - u0;
  const int j0 = slice_begin(blk, P, nblk);
  const int ncb = slice_begin(blk + 1, P, nblk) - j0;
  const int numax = (H + nblk - 1) / nblk;
  const int ncmax = max(numax, (P + nblk - 1) / nblk);
  float* red = smem;
  float* out = red + NT * R;
  float* dcs = out + ncmax * R;
  W* xs = reinterpret_cast<W*>(dcs + B * numax);
  const int H4 = 4 * H;

  for (int i = threadIdx.x; i < B * nu; i += NT) {
    const int b = i / nu, u = i - b * nu;
    dcs[b * numax + u] = 0.f;
  }
  // dh_total for t = T-1 is dout[T-1] (dh starts at zero)
  for (int i = threadIdx.x; i < B * ncb; i += NT) {
    const int b = i / ncb, c = i - b * ncb;
    const size_t k = ((size_t)(T - 1) * B + b) * P + j0 + c;
    dhtseq[k] = dout[k];
    dhtot[(size_t)b * P + j0 + c] = to_float(dout[k]);
  }
  unsigned int target = 0;
  grid_barrier(bar, target);

  auto unit_col = [=](int c) { return u0 + c; };
  auto out_col = [=](int c) { return j0 + c; };

  for (int t = T - 1; t >= 0; --t) {
    // phase A: dhid, the cell backward and dz for own units
    for (int b0 = 0; b0 < B; b0 += R) {
      const int nb = min(R, B - b0);
      block_dots<R>(dhtot, P, b0, nb, P, wpT, H, nu, unit_col, xs, red, out);
      for (int i = threadIdx.x; i < nb * nu; i += NT) {
        const int bb = i / nu, u = i - bb * nu, b = b0 + bb;
        const int col = u0 + u;
        const W* zrow = zseq + ((size_t)t * B + b) * H4;
        const float ig = sigmoid(to_float(zrow[col]));
        const float gg = tanhf(to_float(zrow[H + col]));
        const float fg = sigmoid(to_float(zrow[2 * H + col]));
        const float og = sigmoid(to_float(zrow[3 * H + col]));
        const float ct = to_float(cseq[((size_t)t * B + b) * H + col]);
        const float cp = t > 0 ? to_float(cseq[((size_t)(t - 1) * B + b) * H + col])
                               : c0[(size_t)b * H + col];
        const float dhid = out[u * R + bb];
        const float th = tanhf(ct);
        const float dc = dcs[b * numax + u] + dhid * og * (1.f - th * th);
        dcs[b * numax + u] = dc * fg;
        const float dz[4] = {dc * gg * ig * (1.f - ig), dc * ig * (1.f - gg * gg),
                             dc * cp * fg * (1.f - fg), dhid * th * og * (1.f - og)};
        W* dzrow = dzseq + ((size_t)t * B + b) * H4;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const W r = from_float<W>(dz[g]);
          dzrow[g * H + col] = r;
          dzbuf[(size_t)b * H4 + g * H + col] = to_float(r);
        }
      }
      __syncthreads();
    }
    grid_barrier(bar, target);

    // phase B: own columns of dh = dz @ Wh^T, then the next dh_total
    for (int b0 = 0; b0 < B; b0 += R) {
      const int nb = min(R, B - b0);
      block_dots<R>(dzbuf, H4, b0, nb, H4, whT, P, ncb, out_col, xs, red, out);
      for (int i = threadIdx.x; i < nb * ncb; i += NT) {
        const int bb = i / ncb, c = i - bb * ncb, b = b0 + bb;
        const float dh = out[c * R + bb];
        if (t > 0) {
          const size_t k = ((size_t)(t - 1) * B + b) * P + j0 + c;
          const W r = from_float<W>(to_float(dout[k]) + dh);
          dhtseq[k] = r;
          dhtot[(size_t)b * P + j0 + c] = to_float(r);
        } else {
          dh0[(size_t)b * P + j0 + c] = dh;
        }
      }
      __syncthreads();
    }
    grid_barrier(bar, target);
  }

  for (int i = threadIdx.x; i < B * nu; i += NT) {
    const int b = i / nu, u = i - b * nu;
    dc0[(size_t)b * H + u0 + u] = dcs[b * numax + u];
  }
}

// ---- bf16: resident weight slices, tensor-core step products ----

constexpr int NA = 2, NB = 1;             // n8 tiles: phase A, phase B
constexpr int RED = NWARP * 16 * 8 * NA;  // partial-tile floats of a pass

struct MmaPlan {
  int ldp, ld4;    // exchange row strides: P, 4H padded to 16
  int sp, sh;      // resident column strides of Wp^T, Wh^T
  int numax, ncmax;
  int kq;          // chunk scale (slot_values)
  size_t wp, red, dc, ring, bytes;  // byte offsets (Wh^T slice at 0), total
};

__host__ __device__ inline MmaPlan mma_plan(int nblk, int B, int H, int P,
                                            int kq) {
  MmaPlan p;
  p.kq = kq;
  p.ldp = round_up(P, 16);
  p.ld4 = round_up(4 * H, 16);
  p.sp = col_stride(p.ldp);
  p.sh = col_stride(p.ld4);
  p.numax = (H + nblk - 1) / nblk;
  p.ncmax = (P + nblk - 1) / nblk;
  p.wp = sizeof(bf16) * (size_t)p.ncmax * p.sh;
  p.red = p.wp + sizeof(bf16) * (size_t)p.numax * p.sp;
  p.dc = p.red + sizeof(float) * RED;
  p.ring = p.dc + (sizeof(float) * (size_t)B * p.numax + 15) / 16 * 16;
  p.bytes = p.ring + sizeof(bf16) * (size_t)STAGES * slot_values(kq);
  return p;
}

__device__ void bwd_mma(const bf16* __restrict__ zseq,    // [T, B, 4H]
                        const bf16* __restrict__ cseq,    // [T, B, H]
                        const float* __restrict__ c0,     // [B, H]
                        const bf16* __restrict__ dout,    // [T, B, P]
                        const bf16* __restrict__ whT,     // [4H, P]
                        const bf16* __restrict__ wpT,     // [P, H]
                        bf16* dhtot,   // [B, ldp] dh_total of the step
                        bf16* dzbuf,   // [B, ld4] dz of the step
                        bf16* __restrict__ dzseq,   // [T, B, 4H]
                        bf16* __restrict__ dhtseq,  // [T, B, P]
                        float* __restrict__ dh0,    // [B, P]
                        float* __restrict__ dc0,    // [B, H]
                        unsigned int* bar, int T, int B, int H, int P,
                        int kq) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int nblk = gridDim.x, blk = blockIdx.x;
  const int u0 = slice_begin(blk, H, nblk);
  const int nu = slice_begin(blk + 1, H, nblk) - u0;
  const int j0 = slice_begin(blk, P, nblk);
  const int ncb = slice_begin(blk + 1, P, nblk) - j0;
  const MmaPlan pl = mma_plan(nblk, B, H, P, kq);
  bf16* wsh = reinterpret_cast<bf16*>(smem_mma);
  bf16* wsp = reinterpret_cast<bf16*>(smem_mma + pl.wp);
  float* red = reinterpret_cast<float*>(smem_mma + pl.red);
  float* dcs = reinterpret_cast<float*>(smem_mma + pl.dc);
  bf16* ring = reinterpret_cast<bf16*>(smem_mma + pl.ring);
  const int H4 = 4 * H, numax = pl.numax;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // the weight slices, resident for the whole launch
  for (int i = threadIdx.x; i < pl.ld4 * ncb; i += NT) {
    const int k = i / ncb, c = i - k * ncb;
    wsh[c * pl.sh + k] = k < H4 ? whT[(size_t)k * P + j0 + c] : zero;
  }
  for (int i = threadIdx.x; i < pl.ldp * nu; i += NT) {
    const int k = i / nu, u = i - k * nu;
    wsp[u * pl.sp + k] = k < P ? wpT[(size_t)k * H + u0 + u] : zero;
  }
  for (int i = threadIdx.x; i < B * nu; i += NT) {
    const int b = i / nu, u = i - b * nu;
    dcs[b * numax + u] = 0.f;
  }
  // the exchange rows' padding, which no step writes
  if (blk == 0) {
    const int pp = pl.ldp - P, p4 = pl.ld4 - H4;
    for (int i = threadIdx.x; i < B * pp; i += NT)
      dhtot[(size_t)(i / pp) * pl.ldp + P + i % pp] = zero;
    for (int i = threadIdx.x; i < B * p4; i += NT)
      dzbuf[(size_t)(i / p4) * pl.ld4 + H4 + i % p4] = zero;
  }
  // dh_total for t = T-1 is dout[T-1] (dh starts at zero)
  for (int i = threadIdx.x; i < B * ncb; i += NT) {
    const int b = i / ncb, c = i - b * ncb;
    const size_t k = ((size_t)(T - 1) * B + b) * P + j0 + c;
    dhtseq[k] = dout[k];
    dhtot[(size_t)b * pl.ldp + j0 + c] = dout[k];
  }
  unsigned int target = 0;
  grid_barrier(bar, target);

  for (int t = T - 1; t >= 0; --t) {
    // phase A: dhid, the cell backward and dz for own units
    for (int b0 = 0; b0 < B; b0 += 16 * MT_MAX) {
      const int nb = min(16 * MT_MAX, B - b0), mt = (nb + 15) / 16;
      pass_products<NA>(dhtot, pl.ldp, b0, nb, mt, kq, wsp, pl.sp, nu, ring,
                        red);
      __syncthreads();
      for (int i = threadIdx.x; i < nb * nu; i += NT) {
        const int bb = i / nu, u = i - bb * nu, b = b0 + bb;
        const int col = u0 + u;
        const bf16* zrow = zseq + ((size_t)t * B + b) * H4;
        const float ig = sigmoid(to_float(zrow[col]));
        const float gg = tanhf(to_float(zrow[H + col]));
        const float fg = sigmoid(to_float(zrow[2 * H + col]));
        const float og = sigmoid(to_float(zrow[3 * H + col]));
        const float ct = to_float(cseq[((size_t)t * B + b) * H + col]);
        const float cp = t > 0 ? to_float(cseq[((size_t)(t - 1) * B + b) * H + col])
                               : c0[(size_t)b * H + col];
        const float dhid = red_sum(red, mt, 8 * NA, bb, u);
        const float th = tanhf(ct);
        const float dc = dcs[b * numax + u] + dhid * og * (1.f - th * th);
        dcs[b * numax + u] = dc * fg;
        const float dz[4] = {dc * gg * ig * (1.f - ig), dc * ig * (1.f - gg * gg),
                             dc * cp * fg * (1.f - fg), dhid * th * og * (1.f - og)};
        bf16* dzrow = dzseq + ((size_t)t * B + b) * H4;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bf16 r = from_float<bf16>(dz[q]);
          dzrow[q * H + col] = r;
          dzbuf[(size_t)b * pl.ld4 + q * H + col] = r;
        }
      }
      __syncthreads();
    }
    grid_barrier(bar, target);

    // phase B: own columns of dh = dz @ Wh^T, then the next dh_total
    for (int b0 = 0; ncb > 0 && b0 < B; b0 += 16 * MT_MAX) {
      const int nb = min(16 * MT_MAX, B - b0), mt = (nb + 15) / 16;
      pass_products<NB>(dzbuf, pl.ld4, b0, nb, mt, kq, wsh, pl.sh, ncb, ring,
                        red);
      __syncthreads();
      for (int i = threadIdx.x; i < nb * ncb; i += NT) {
        const int bb = i / ncb, c = i - bb * ncb, b = b0 + bb;
        const float dh = red_sum(red, mt, 8 * NB, bb, c);
        if (t > 0) {
          const size_t k = ((size_t)(t - 1) * B + b) * P + j0 + c;
          const bf16 r = from_float<bf16>(to_float(dout[k]) + dh);
          dhtseq[k] = r;
          dhtot[(size_t)b * pl.ldp + j0 + c] = r;
        } else {
          dh0[(size_t)b * P + j0 + c] = dh;
        }
      }
      __syncthreads();
    }
    grid_barrier(bar, target);
  }

  for (int i = threadIdx.x; i < B * nu; i += NT) {
    const int b = i / nu, u = i - b * nu;
    dc0[(size_t)b * H + u0 + u] = dcs[b * numax + u];
  }
}

// The two designs' kernels (both names hold "lstm_bwd_kernel", which the
// profiles match).
template <typename W>
__global__ void __launch_bounds__(NT)
    lstm_bwd_kernel_fma(const W* __restrict__ zseq, const W* __restrict__ cseq,
                        const float* __restrict__ c0, const W* __restrict__ dout,
                        const W* __restrict__ whT, const W* __restrict__ wpT,
                        float* dhtot, float* dzbuf, W* __restrict__ dzseq,
                        W* __restrict__ dhtseq, float* __restrict__ dh0,
                        float* __restrict__ dc0, unsigned int* bar, int T,
                        int B, int H, int P) {
  bwd_fma<W>(zseq, cseq, c0, dout, whT, wpT, dhtot, dzbuf, dzseq, dhtseq, dh0,
             dc0, bar, T, B, H, P);
}

__global__ void __launch_bounds__(NT)
    lstm_bwd_kernel_mma(const bf16* __restrict__ zseq,
                        const bf16* __restrict__ cseq,
                        const float* __restrict__ c0,
                        const bf16* __restrict__ dout,
                        const bf16* __restrict__ whT,
                        const bf16* __restrict__ wpT, bf16* dhtot, bf16* dzbuf,
                        bf16* __restrict__ dzseq, bf16* __restrict__ dhtseq,
                        float* __restrict__ dh0, float* __restrict__ dc0,
                        unsigned int* bar, int T, int B, int H, int P, int kq) {
  bwd_mma(zseq, cseq, c0, dout, whT, wpT, dhtot, dzbuf, dzseq, dhtseq, dh0,
          dc0, bar, T, B, H, P, kq);
}

// Picks the design from the plan: bf16 runs bwd_mma where its shared-memory
// plan fits one block (at most 16 units and 8 P columns a block, and the
// bytes), else bwd_fma, as fp32 always does.
template <typename W>
int launch(const void* zseq, const void* cseq, const float* c0,
           const void* dout, const void* whT, const void* wpT, void* dhtot,
           void* dzbuf, void* dzseq, void* dhtseq, float* dh0, float* dc0,
           unsigned int* bar, int T, int B, int H, int P, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const W* z = (const W*)zseq;
  const W* c = (const W*)cseq;
  const W* d = (const W*)dout;
  const W* wh = (const W*)whT;
  const W* wp = (const W*)wpT;
  W* dz = (W*)dzseq;
  W* dht = (W*)dhtseq;
  Card card;
  const int err = query_card(card);
  if (err) return err;
  const int nblk = grid_blocks(card, H);
  if constexpr (std::is_same<W, bf16>::value) {
    int kq = mma_plan(nblk, B, H, P, 2).bytes <= (size_t)card.optin ? 2 : 1;
    const MmaPlan pl = mma_plan(nblk, B, H, P, kq);
    if (pl.numax <= 8 * NA && pl.ncmax <= 8 * NB &&
        pl.bytes <= (size_t)card.optin) {
      bf16* dht_x = (bf16*)dhtot;
      bf16* dz_x = (bf16*)dzbuf;
      void* args[] = {&z,   &c,   &c0,  &d,  &wh, &wp, &dht_x, &dz_x, &dz,
                      &dht, &dh0, &dc0, &bar, &T, &B,  &H,     &P,    &kq};
      g_last_design = kDesignMma;
      return coop_launch((const void*)lstm_bwd_kernel_mma, nblk, pl.bytes,
                         args, bar, stream);
    }
  }
  float* dht_x = (float*)dhtot;
  float* dz_x = (float*)dzbuf;
  void* args[] = {&z,   &c,   &c0,  &d,  &wh, &wp, &dht_x, &dz_x, &dz,
                  &dht, &dh0, &dc0, &bar, &T, &B,  &H,     &P};
  g_last_design = kDesignFma;
  return coop_launch((const void*)lstm_bwd_kernel_fma<W>, nblk,
                     smem_bytes<W>(nblk, B, H, P), args, bar, stream);
}

}  // namespace

// zseq [T,B,4H], cseq [T,B,H], dout [T,B,P], whT [4H,P], wpT [P,H], dzseq
// [T,B,4H], dhtseq [T,B,P] in the weight type; c0 [B,H], dh0 [B,P], dc0
// [B,H] f32; bar one uint32 scratch.  Scratch dhtot and dzbuf: f32 [B,P]
// and [B,4H] for the FMA design; bf16 [B, round_up(P,16)] and [B,
// round_up(4H,16)] for the MMA design (lstm_bwd_bf16 where its plan fits;
// 4 bytes a padded value hold either).  Returns a CUDA error code (0 =
// launched); lstm_last_design() then says which design ran.
extern "C" int lstm_bwd_f32(const void* zseq, const void* cseq,
                            const float* c0, const void* dout,
                            const void* whT, const void* wpT, void* dhtot,
                            void* dzbuf, void* dzseq, void* dhtseq,
                            float* dh0, float* dc0, unsigned int* bar, int T,
                            int B, int H, int P, void* stream) {
  return launch<float>(zseq, cseq, c0, dout, whT, wpT, dhtot, dzbuf, dzseq,
                       dhtseq, dh0, dc0, bar, T, B, H, P, stream);
}

extern "C" int lstm_bwd_bf16(const void* zseq, const void* cseq,
                             const float* c0, const void* dout,
                             const void* whT, const void* wpT, void* dhtot,
                             void* dzbuf, void* dzseq, void* dhtseq,
                             float* dh0, float* dc0, unsigned int* bar, int T,
                             int B, int H, int P, void* stream) {
  return launch<bf16>(zseq, cseq, c0, dout, whT, wpT, dhtot, dzbuf, dzseq,
                      dhtseq, dh0, dc0, bar, T, B, H, P, stream);
}
