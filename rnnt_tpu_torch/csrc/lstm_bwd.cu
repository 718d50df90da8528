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
// whole before any dhid and dz whole before any dh, so each step has
// grid-wide exchanges with a grid barrier after each.  What is left a step
// is the barriers plus the bytes the exchanges move through L2.
//
// Structure (all designs): one persistent cooperative launch (one block
// per SM at most, grid_barrier from common.cuh).  Block k owns a slice of
// the H hidden units (their four gate columns) and a slice of the P
// columns.  Before the first step each block writes its columns of
// dh_total for t = T-1; then per step:
//   phase A: dhid for its own units from the whole dh_total (a global
//            buffer), then the cell backward with dc carried in shared
//            memory, then dz for its own four gate columns;
//   phase B: dh = dz @ Wh^T, which with dout[t-1] becomes the next step's
//            dh_total (or, at t = 0, dh0), with grid barriers between.
// The kernel writes only its outputs and scratch: its inputs are left
// untouched.
//
// bf16 (bwd_cluster): resident weight slices, both products on the tensor
// cores, and phase B split over K across thread-block clusters.
//  - Phase A: before the first step a block copies its columns of Wp^T
//    [P x nu] into shared memory, each column's k values contiguous
//    (padded with zeros to a multiple of 16), so an MMA B-fragment is one
//    8-byte load.  mma.sync m16n8k16 bf16 with fp32 accumulation: batch
//    rows are M, in passes of up to 64 rows (4 m16 tiles; rows past B are
//    zero-filled); the block's units are N, two n8 tiles (nu <= 16), the
//    missing columns zero in registers.  The 16 warps split a pass as mt
//    m-tiles x (16 / mt) groups of k16 slices; the groups' partial tiles
//    sum through shared memory in a fixed order.  Within each 16-wide k
//    slice, lane t holds the four contiguous values 4t..4t+3 as MMA k
//    indices 2t, 2t+1, 2t+8, 2t+9, for A and B alike: the sum is the same,
//    and every fragment is one 8-byte load.  dh_total [B, ldp] is bf16
//    (exact: it is rounded to bf16 before its product), rows padded to a
//    multiple of 16 with zeros; a pass streams its rows into a 3-slot ring
//    in k-chunks of ~32 KB (kq = 2; ~16 KB, kq = 1, where the plan leaves
//    no room) with 16-byte cp.async.cg (L2, which sees the other blocks'
//    writes), two chunks in flight ahead of the MMAs.  Strides keep every
//    8-byte fragment load of a half-warp on 32 distinct banks: weight
//    columns are padded to 16 mod 64 values, ring rows to chunk + 16.
//  - Clusters: the grid is cut into G clusters of c blocks (c = 4, 2 or
//    1).  A cluster owns its blocks' units, so the c x 4 x nu columns of dz
//    they produce in phase A: phase B contracts over those columns only,
//    and the cluster's product is an fp32 partial sum of the whole dh
//    [B, P].
//  - Phase A writes dz into the block's own shared-memory tile [B, kp]
//    (and dz_seq); a cluster barrier (barrier.cluster arrive.release /
//    wait.acquire) follows.  Phase B copies the cluster's c tiles from
//    distributed shared memory (ld.shared::cluster) into its own shared
//    memory, 64 batch rows a pass, and multiplies them on mma.sync by its
//    resident Wh^T rows of those columns, restricted to its own P / c
//    output columns; the fp32 accumulators go straight to a global partial
//    buffer laid out by the block that will reduce them, [reducer][cluster]
//    [column][batch row padded to 4], so each reducer reads one contiguous
//    run, in float4s.
//  - Grid barrier; then each block sums the G partials of its own P
//    columns in a fixed order (so a launch is deterministic), adds
//    dout[t-1] and writes dh_total (bf16) or dh0; grid barrier.  So a step
//    has two grid barriers and one cluster barrier.
//  - Bytes a step through L2: G partials [B, P] written and read (8 B P G),
//    plus phase A's read of dh_total by every block (2 B P nblk), where
//    reading dz whole in every block would move 2 B (4H + P) nblk.  At the
//    parity width (H=2048, P=640) and B=96 on 132 blocks, c = 2: 16.2 +
//    16.2 + 16.2 MB against 224 MB.  Split-K moves fewer bytes wherever P <
//    c H, as at every width the configurations run.
//  - Choosing c (cluster_choice): the largest c whose co-resident clusters
//    (cudaOccupancyMaxActiveClusters at the plan's shared memory) cover a
//    grid, a multiple of c, that keeps at most 16 units a block, where the
//    plan fits the shared memory.  An H100 SXM holds 30 clusters of 4 and
//    66 of 2 at these plans (PERF.md): at the parity width c = 4 would
//    leave 18 units a block on 120 blocks, so c = 2 runs on 132; at H = P =
//    640, c = 4 runs on 120.  Where no c fits, bf16 runs the FMA design.
//    The launch is cudaLaunchKernelExC with the cluster-dimension and
//    cooperative attributes.
//  - Shared memory (cluster_plan), at the parity width on 132 blocks, c =
//    2: Wh^T slice 320 columns x 144 (128 k values padded) x 2 = 92,160 B;
//    Wp^T slice 16 x 656 x 2 = 20,992 B; phase A's partial tiles 16,384 B;
//    dc B x 16 x 4; the dz tile B x 64 x 2; the partial offsets of the 320
//    columns 1,280 B; the ring at half-size slots (kq = 1) 55,296 B, which
//    phase B's gathered rows (64 x 144 x 2 = 18,432 B) reuse, as the
//    reduction's sums reuse the partial tiles: 204,544 B at B=96, 216,832 B
//    at B=160.  Full-size slots (kq = 2, 104,448 B) would not fit.
//  - Measured on one H100 (PERF.md): of the step at B=96 the L2-bound
//    phases take ~60% (phase A's dh_total stream, the partial stores, the
//    reduction), the barriers ~25%.  c = 4 on 120 blocks was 6% slower
//    than c = 2 on 132 (the cell backward of 18 units a block and three
//    remote tiles to gather), and 3-block clusters do not cover 132 SMs.
//    In the ring, chunks of 32 KB and 3 slots beat 16 KB chunks with 3 or
//    4 slots by 16-20%.
//
// The FMA design (bwd_fma): block_dots over 4 batch rows a pass (8 in
// bf16), the weights read from L2 once a pass, the exchange in fp32.  fp32
// always runs it: TF32 tensor cores would round the operands to 10 mantissa
// bits and break the 1e-4 agreement with the plain version, and fp32 weight
// slices (204 KB at the parity width) would leave no shared memory to stage
// the exchange.  bf16 runs it for a shape outside the cluster plan (more
// than 16 units a block, as on fewer than 128 SMs at the parity width, or
// too many bytes): the launcher picks the design from the plan, never after
// a failed launch, and lstm_last_design() reports it (lstm_last_cluster()
// the cluster size of a cluster launch).

#include <mutex>
#include <type_traits>
#include <vector>

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

constexpr int NA = 2;                     // n8 tiles of phase A
constexpr int RED = NWARP * 16 * 8 * NA;  // partial-tile floats of a pass

// Set-up of the bf16 design: the block's Wp^T columns resident
// (k contiguous, zero past P), dc zeroed, and its columns of dh_total for t
// = T-1, which is dout[T-1] (dh starts at zero); block 0 zeroes the padding
// of dh_total's rows, which no step writes.
__device__ __forceinline__ void setup_a(const bf16* __restrict__ dout,
                                        const bf16* __restrict__ wpT,
                                        bf16* dhtot, bf16* __restrict__ dhtseq,
                                        bf16* wsp, int sp, float* dcs,
                                        int numax, int ldp, int T, int B,
                                        int H, int P, int u0, int nu, int j0,
                                        int ncb) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < ldp * nu; i += NT) {
    const int k = i / nu, u = i - k * nu;
    wsp[u * sp + k] = k < P ? wpT[(size_t)k * H + u0 + u] : zero;
  }
  for (int i = threadIdx.x; i < B * nu; i += NT) {
    const int b = i / nu, u = i - b * nu;
    dcs[b * numax + u] = 0.f;
  }
  if (blockIdx.x == 0) {
    const int pp = ldp - P;
    for (int i = threadIdx.x; i < B * pp; i += NT)
      dhtot[(size_t)(i / pp) * ldp + P + i % pp] = zero;
  }
  for (int i = threadIdx.x; i < B * ncb; i += NT) {
    const int b = i / ncb, c = i - b * ncb;
    const size_t k = ((size_t)(T - 1) * B + b) * P + j0 + c;
    dhtseq[k] = dout[k];
    dhtot[(size_t)b * ldp + j0 + c] = dout[k];
  }
}

// Phase A of step t in the bf16 design: dhid for the block's units (at
// most 8 NA) from the whole dh_total, the cell backward with dc carried in
// shared memory, and dz (rounded to bf16) to dz_seq and to the block's dz
// tile dzt [B, kp] (gate q of unit u at column q nu + u); mark(0) after
// each pass's products, mark(1) after its cell backward.
template <typename Mark>
__device__ __forceinline__ void phase_a(const bf16* __restrict__ zseq,
                                        const bf16* __restrict__ cseq,
                                        const float* __restrict__ c0,
                                        const bf16* dhtot, int ldp,
                                        bf16* __restrict__ dzseq, int t,
                                        int B, int H, int u0, int nu,
                                        int numax, int kq, const bf16* wsp,
                                        int sp, bf16* ring, float* red,
                                        float* dcs, bf16* dzt, int kp,
                                        Mark mark) {
  const int H4 = 4 * H;
  for (int b0 = 0; b0 < B; b0 += 16 * MT_MAX) {
    const int nb = min(16 * MT_MAX, B - b0), mt = (nb + 15) / 16;
    pass_products<NA>(dhtot, ldp, b0, nb, mt, kq, wsp, sp, nu, ring, red);
    __syncthreads();
    mark(0);
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
        dzt[b * kp + q * nu + u] = r;
      }
    }
    __syncthreads();
    mark(1);
  }
}

// ---- bf16, split-K phase B across thread-block clusters ----

constexpr int kDesignCluster = 3;  // lstm_last_design() of bwd_cluster
constexpr int UMAX = 8 * NA;       // units a block phase A takes at most
constexpr int NBC = 5;             // n8 tiles a warp accumulates at once
constexpr int RS = 4;              // threads that split one reduced float4
constexpr int RB = 8;              // partials a thread loads at once
static int g_last_cluster = 0;     // c of the last cluster launch

struct ClusterPlan {
  int c;             // blocks a cluster
  int ldp;           // dh_total row stride: P padded to 16
  int kp;            // dz columns a block's tile holds: 4 numax padded to 16
  int sw, sp;        // resident column strides: Wh^T (c kp values), Wp^T
  int numax, ncmax;  // units a block; P columns a block reduces
  int npc, nca;      // P columns a block multiplies (P / c), rounded to 8
  int xg;            // row stride of the gathered dz (16 mod 32 values)
  int kq;            // ring chunk scale (slot_values)
  size_t wp, red, dc, dzt, off, ring, bytes;  // byte offsets (Wh^T at 0)
  int bp;            // batch rows of the partial buffer: B padded to 4
  size_t part;       // floats of the partial buffer: nblk x G x ncmax x bp
};

__host__ __device__ inline ClusterPlan cluster_plan(int nblk, int c, int B,
                                                    int H, int P, int kq) {
  ClusterPlan p;
  p.c = c;
  p.kq = kq;
  p.ldp = round_up(P, 16);
  p.numax = (H + nblk - 1) / nblk;
  p.ncmax = (P + nblk - 1) / nblk;
  p.kp = round_up(4 * p.numax, c > 1 ? 8 : 16);  // c kp: k16 slices
  p.sw = round_up(c * p.kp, 32) + 16;  // 16 or 48 mod 64: conflict-free
  p.sp = col_stride(p.ldp);
  p.npc = (P + c - 1) / c;
  p.nca = round_up(p.npc, 8);
  p.xg = round_up(c * p.kp, 32) + 16;
  p.wp = sizeof(bf16) * (size_t)p.nca * p.sw;
  p.red = p.wp + sizeof(bf16) * (size_t)p.numax * p.sp;
  p.dc = p.red + sizeof(float) * RED;
  p.dzt = p.dc + (sizeof(float) * (size_t)B * p.numax + 15) / 16 * 16;
  p.off = p.dzt + sizeof(bf16) * (size_t)B * p.kp;
  p.ring = p.off + (sizeof(int) * (size_t)p.nca + 15) / 16 * 16;
  const int ring = STAGES * slot_values(kq), gathered = 16 * MT_MAX * p.xg;
  p.bytes = p.ring + sizeof(bf16) * (size_t)(ring > gathered ? ring : gathered);
  p.bp = round_up(B, 4);
  p.part = (size_t)nblk * (nblk / c) * p.ncmax * p.bp;
  return p;
}

// Diagnostics only (off unless built with -DLSTM_PHASE_TIMERS, as
// kernels/lstm_ab.py can): thread 0 of block 0 adds the cycles since its
// last mark to phase i of the cluster design's step, and adds them to
// g_k5_phases at the end of the launch (read back through k5_phases()).
#ifdef LSTM_PHASE_TIMERS
__device__ unsigned long long g_k5_phases[8];
#endif
struct K5Timer {
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
        atomicAdd(&g_k5_phases[i], (unsigned long long)ph[i]);
  }
#else
  __device__ void start() {}
  __device__ void at(int) {}
  __device__ void flush() {}
#endif
};

__device__ __forceinline__ int cluster_reg_id() {
  unsigned v;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(v));
  return (int)v;
}
__device__ __forceinline__ int cluster_reg_rank() {
  unsigned v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v));
  return (int)v;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// 16 bytes at shared address `a` (of this block) in block `rank` of the
// cluster.
__device__ __forceinline__ uint4 ld_peer16(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(r)
               : "memory");
  return v;
}

__device__ void bwd_cluster(const bf16* __restrict__ zseq,  // [T, B, 4H]
                            const bf16* __restrict__ cseq,  // [T, B, H]
                            const float* __restrict__ c0,   // [B, H]
                            const bf16* __restrict__ dout,  // [T, B, P]
                            const bf16* __restrict__ whT,   // [4H, P]
                            const bf16* __restrict__ wpT,   // [P, H]
                            bf16* dhtot,  // [B, ldp] dh_total of the step
                            float* part,  // partial sums (plan.part floats)
                            bf16* __restrict__ dzseq,   // [T, B, 4H]
                            bf16* __restrict__ dhtseq,  // [T, B, P]
                            float* __restrict__ dh0,    // [B, P]
                            float* __restrict__ dc0,    // [B, H]
                            unsigned int* bar, int T, int B, int H, int P,
                            int c, int kq) {
  extern __shared__ __align__(16) unsigned char smem_cl[];
  const int nblk = gridDim.x, G = nblk / c;
  const int q = cluster_reg_id(), rank = cluster_reg_rank();
  const int blk = q * c + rank;  // the block's units and columns by cluster
  const int u0 = slice_begin(blk, H, nblk);
  const int nu = slice_begin(blk + 1, H, nblk) - u0;
  const int j0 = slice_begin(blk, P, nblk);
  const int ncb = slice_begin(blk + 1, P, nblk) - j0;
  const int jc0 = slice_begin(rank, P, c);
  const int npc = slice_begin(rank + 1, P, c) - jc0;
  const ClusterPlan pl = cluster_plan(nblk, c, B, H, P, kq);
  bf16* wsh = reinterpret_cast<bf16*>(smem_cl);
  bf16* wsp = reinterpret_cast<bf16*>(smem_cl + pl.wp);
  float* red = reinterpret_cast<float*>(smem_cl + pl.red);
  float* dcs = reinterpret_cast<float*>(smem_cl + pl.dc);
  bf16* dzt = reinterpret_cast<bf16*>(smem_cl + pl.dzt);
  int* poff = reinterpret_cast<int*>(smem_cl + pl.off);
  bf16* ring = reinterpret_cast<bf16*>(smem_cl + pl.ring);
  const int kp = pl.kp, kc = c * kp, ncmax = pl.ncmax;
  const bf16 zero = __float2bfloat16_rn(0.f);
  const unsigned dzt_a = smem_u32(dzt);
  K5Timer tm;

  // Wh^T rows of the cluster's dz columns (block p's tile at k = p kp +
  // gate nu_p + unit), the block's P / c columns, zero elsewhere
  for (int p = 0; p < c; ++p) {
    const int up = slice_begin(q * c + p, H, nblk);
    const int nup = slice_begin(q * c + p + 1, H, nblk) - up;
    for (int i = threadIdx.x; i < kp * pl.nca; i += NT) {
      const int kl = i / pl.nca, n = i - kl * pl.nca;
      bf16 v = zero;
      if (kl < 4 * nup && n < npc) {
        const int gate = kl / nup;
        v = whT[(size_t)(gate * H + up + kl - gate * nup) * P + jc0 + n];
      }
      wsh[n * pl.sw + p * kp + kl] = v;
    }
  }
  // where column n's partial sums go: [reducer][cluster][column][batch row]
  for (int n = threadIdx.x; n < npc; n += NT) {
    const int col = jc0 + n;
    const int k = (int)(((long long)(col + 1) * nblk - 1) / P);
    poff[n] = ((k * G + q) * ncmax + col - slice_begin(k, P, nblk)) * pl.bp;
  }
  for (int i = threadIdx.x; i < B * kp; i += NT) dzt[i] = zero;
  setup_a(dout, wpT, dhtot, dhtseq, wsp, pl.sp, dcs, pl.numax, pl.ldp, T, B,
          H, P, u0, nu, j0, ncb);
  unsigned int target = 0;
  grid_barrier(bar, target);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = 4 * (lane & 3);
  const int ntl = pl.nca / 8, pieces = kp / 8;
  const int bp = pl.bp, items = ncb * bp / 4;  // float4s of the reduction
  const int ns = max(1, min(RS, NT / max(items, 1)));
  tm.start();
  for (int t = T - 1; t >= 0; --t) {
    phase_a(zseq, cseq, c0, dhtot, pl.ldp, dzseq, t, B, H, u0, nu, pl.numax,
            kq, wsp, pl.sp, ring, red, dcs, dzt, kp,
            [&](int i) { tm.at(i); });
    cluster_sync();
    tm.at(2);

    // phase B: the cluster's partial dh for the block's P / c columns
    for (int b0 = 0; b0 < B; b0 += 16 * MT_MAX) {
      const int nb = min(16 * MT_MAX, B - b0), mt = (nb + 15) / 16;
      for (int i = threadIdx.x; i < 16 * mt * c * pieces; i += NT) {
        const int r = i / (c * pieces), pc = i - r * (c * pieces);
        const int p = pc / pieces, k = pc - p * pieces;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < nb)
          v = ld_peer16(dzt_a + 2 * ((b0 + r) * kp + 8 * k), p);
        *reinterpret_cast<uint4*>(ring + r * pl.xg + p * kp + 8 * k) = v;
      }
      __syncthreads();
      tm.at(3);
      // warps: mt m16 tiles x nng groups of the n8 tiles; a warp's A
      // fragment serves NBC n8 tiles at a time
      const int nng = NWARP / mt, m = warp % mt, ng = warp / mt;
      if (ng < nng) {
        const int tb1 = (ng + 1) * ntl / nng;
        const bf16* xa = ring + (m * 16 + g) * pl.xg + t4;
        for (int tb = ng * ntl / nng; tb < tb1; tb += NBC) {
          float acc[NBC][4] = {};
          for (int s = 0; s < kc / 16; ++s) {
            const uint2 lo = *reinterpret_cast<const uint2*>(xa + s * 16);
            const uint2 hi =
                *reinterpret_cast<const uint2*>(xa + 8 * pl.xg + s * 16);
#pragma unroll
            for (int j = 0; j < NBC; ++j) {
              if (tb + j < tb1) {
                const uint2 w = *reinterpret_cast<const uint2*>(
                    wsh + (size_t)((tb + j) * 8 + g) * pl.sw + s * 16 + t4);
                mma_bf16_16816(acc[j], lo.x, hi.x, lo.y, hi.y, w.x, w.y);
              }
            }
          }
          // to the partial buffer: [reducer][cluster][column][batch row]
#pragma unroll
          for (int j = 0; j < NBC; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = (tb + j) * 8 + t4 / 2 + e, r = m * 16 + g;
              if (tb + j >= tb1 || n >= npc) continue;
              float* dst = part + poff[n] + b0;
              if (r < nb) dst[r] = acc[j][e];
              if (r + 8 < nb) dst[r + 8] = acc[j][2 + e];
            }
          }
        }
      }
      __syncthreads();
      tm.at(4);
    }
    grid_barrier(bar, target);
    tm.at(5);

    // the block's P columns: the G partials, then the next dh_total.  The
    // ns threads of 4 batch rows of a column each sum every ns-th partial
    // from their first, RB float4 loads in flight; their sums meet in red
    // in order.
    for (int i = threadIdx.x; i < ns * items; i += NT) {
      const int s = i / items, it = i - s * items;
      const float4* src = reinterpret_cast<const float4*>(
                              part + (size_t)blk * G * ncmax * bp) + it;
      float4 dh = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q0 = s; q0 < G; q0 += RB * ns) {
        float4 v[RB];
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const int qq = q0 + j * ns;
          v[j] = qq < G ? __ldcg(src + (size_t)qq * ncmax * bp / 4)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          dh.x += v[j].x;
          dh.y += v[j].y;
          dh.z += v[j].z;
          dh.w += v[j].w;
        }
      }
      reinterpret_cast<float4*>(red)[i] = dh;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < items * 4; i += NT) {
      const int it = i / 4, cc = it / (bp / 4);
      const int b = (it - cc * (bp / 4)) * 4 + (i & 3);
      if (b >= B) continue;
      float dh = 0.f;
      for (int s = 0; s < ns; ++s) dh += red[(s * items + it) * 4 + (i & 3)];
      if (t > 0) {
        const size_t k = ((size_t)(t - 1) * B + b) * P + j0 + cc;
        const bf16 r = from_float<bf16>(to_float(dout[k]) + dh);
        dhtseq[k] = r;
        dhtot[(size_t)b * pl.ldp + j0 + cc] = r;
      } else {
        dh0[(size_t)b * P + j0 + cc] = dh;
      }
    }
    tm.at(6);
    grid_barrier(bar, target);
    tm.at(7);
  }
  tm.flush();

  for (int i = threadIdx.x; i < B * nu; i += NT) {
    const int b = i / nu, u = i - b * nu;
    dc0[(size_t)b * H + u0 + u] = dcs[b * pl.numax + u];
  }
}

// The two designs' kernels (every name holds "lstm_bwd_kernel", which the
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
    lstm_bwd_kernel_cluster(const bf16* __restrict__ zseq,
                            const bf16* __restrict__ cseq,
                            const float* __restrict__ c0,
                            const bf16* __restrict__ dout,
                            const bf16* __restrict__ whT,
                            const bf16* __restrict__ wpT, bf16* dhtot,
                            float* part, bf16* __restrict__ dzseq,
                            bf16* __restrict__ dhtseq, float* __restrict__ dh0,
                            float* __restrict__ dc0, unsigned int* bar, int T,
                            int B, int H, int P, int c, int kq) {
  bwd_cluster(zseq, cseq, c0, dout, whT, wpT, dhtot, part, dzseq, dhtseq, dh0,
              dc0, bar, T, B, H, P, c, kq);
}

// The cluster design's shape on the current card: c = 0 where none fits.
struct ClusterChoice {
  int c, nblk, kq;
  int clusters[3];  // co-resident clusters at c = 4, 2, 1 (-1: not asked)
};

// Raises the cluster kernel's dynamic shared-memory limit on the current
// device to at least `bytes`, calling cudaFuncSetAttribute only when the
// limit must grow, as coop_launch does for the FMA design: a launch
// then makes no host call beyond the memset and the launch itself.
inline int raise_cluster_smem(size_t bytes) {
  constexpr int kDevs = 64;
  static size_t set[kDevs] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kDevs && set[dev] >= bytes) return 0;
  e = cudaFuncSetAttribute((const void*)lstm_bwd_kernel_cluster,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < kDevs) set[dev] = bytes;
  return (int)e;
}

inline cudaLaunchAttribute cluster_dim(int c) {
  cudaLaunchAttribute a;
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = c;
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = 1;
  return a;
}

// The largest c in {4, 2, 1} whose co-resident clusters, at the plan's
// shared memory, cover a grid of at most one block an SM (and the cap), a
// multiple of c, with at most UMAX units a block (and the reduction's sums
// within red); kq = 2 where that plan fits, else 1; c = 0 where no c fits.
// Choices are kept by device, cap and shape: the occupancy query runs once
// for each.
inline int cluster_choice(const Card& card, int B, int H, int P,
                          ClusterChoice& out) {
  struct Kept {
    int dev, cap, B, H, P;
    ClusterChoice ch;
  };
  static std::mutex lock;
  static std::vector<Kept> kept;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> hold(lock);
  for (const Kept& k : kept)
    if (k.dev == dev && k.cap == g_block_cap && k.B == B && k.H == H &&
        k.P == P) {
      out = k.ch;
      return 0;
    }
  ClusterChoice ch = {0, 0, 0, {-1, -1, -1}};
  const int cs[3] = {4, 2, 1};
  for (int ci = 0; ci < 3 && ch.c == 0; ++ci) {
    const int c = cs[ci];
    int nblk = grid_blocks(card, H) / c * c;
    while (nblk >= c) {
      int kq = 2;
      ClusterPlan pl = cluster_plan(nblk, c, B, H, P, kq);
      if (pl.bytes > (size_t)card.optin)
        pl = cluster_plan(nblk, c, B, H, P, kq = 1);
      if (pl.numax > UMAX || (long long)pl.ncmax * pl.bp > RED ||
          pl.bytes > (size_t)card.optin)
        break;
      const int err = raise_cluster_smem(pl.bytes);
      if (err) return err;
      cudaLaunchAttribute at = cluster_dim(c);
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(nblk);
      cfg.blockDim = dim3(NT);
      cfg.dynamicSmemBytes = pl.bytes;
      cfg.attrs = &at;
      cfg.numAttrs = 1;
      int n = 0;
      e = cudaOccupancyMaxActiveClusters(
          &n, (const void*)lstm_bwd_kernel_cluster, &cfg);
      if (e != cudaSuccess) return (int)e;
      ch.clusters[ci] = n;
      if (n * c >= nblk) {
        ch.c = c;
        ch.nblk = nblk;
        ch.kq = kq;
        break;
      }
      nblk = n * c;  // fewer blocks: more units each, so plan again
    }
  }
  kept.push_back({dev, g_block_cap, B, H, P, ch});
  out = ch;
  return 0;
}

// Picks the design (bf16: cluster where a c fits, else FMA; fp32: FMA) and
// launches it, or refuses with cudaErrorInvalidValue where dzbuf holds
// fewer bytes than the design needs (lstm_bwd_plan()'s scratch bytes).
template <typename W>
int launch(const void* zseq, const void* cseq, const float* c0,
           const void* dout, const void* whT, const void* wpT, void* dhtot,
           void* dzbuf, void* dzseq, void* dhtseq, float* dh0, float* dc0,
           unsigned int* bar, int T, int B, int H, int P, void* stream_,
           size_t dzbuf_bytes) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const W* z = (const W*)zseq;
  const W* c = (const W*)cseq;
  const W* d = (const W*)dout;
  const W* wh = (const W*)whT;
  const W* wp = (const W*)wpT;
  W* dz = (W*)dzseq;
  W* dht = (W*)dhtseq;
  Card card;
  int err = query_card(card);
  if (err) return err;
  if constexpr (std::is_same<W, bf16>::value) {
    ClusterChoice ch;
    err = cluster_choice(card, B, H, P, ch);
    if (err) return err;
    if (ch.c > 0) {
      const ClusterPlan pl = cluster_plan(ch.nblk, ch.c, B, H, P, ch.kq);
      if (dzbuf_bytes < sizeof(float) * pl.part)
        return (int)cudaErrorInvalidValue;
      bf16* dht_x = (bf16*)dhtot;
      float* part = (float*)dzbuf;
      int cl = ch.c, kqc = ch.kq;
      void* args[] = {&z,   &c,   &c0,  &d,  &wh, &wp, &dht_x, &part, &dz,
                      &dht, &dh0, &dc0, &bar, &T, &B,  &H,     &P,    &cl,
                      &kqc};
      err = raise_cluster_smem(pl.bytes);
      if (err) return err;
      const cudaError_t e = cudaMemsetAsync(bar, 0, sizeof(unsigned), stream);
      if (e != cudaSuccess) return (int)e;
      cudaLaunchAttribute at[2] = {cluster_dim(ch.c), {}};
      at[1].id = cudaLaunchAttributeCooperative;
      at[1].val.cooperative = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(ch.nblk);
      cfg.blockDim = dim3(NT);
      cfg.dynamicSmemBytes = pl.bytes;
      cfg.stream = stream;
      cfg.attrs = at;
      cfg.numAttrs = 2;
      g_last_design = kDesignCluster;
      g_last_cluster = ch.c;
      return launch_status(cudaLaunchKernelExC(
          &cfg, (const void*)lstm_bwd_kernel_cluster, args));
    }
  }
  if (dzbuf_bytes < sizeof(float) * (size_t)B * 4 * H)
    return (int)cudaErrorInvalidValue;
  const int nblk = grid_blocks(card, H);
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
// [B,H] f32; bar one uint32 scratch.  Scratch dhtot: f32 [B,P] (FMA) or
// bf16 [B, round_up(P,16)] (4 bytes a padded value hold both); dzbuf,
// dzbuf_bytes long: f32 [B,4H] (FMA) or the cluster design's fp32 partial
// sums, whose bytes lstm_bwd_plan() gives.  Returns a CUDA error code (0 =
// launched; cudaErrorInvalidValue where dzbuf is too small);
// lstm_last_design() then says which design ran.
extern "C" int lstm_bwd_f32(const void* zseq, const void* cseq,
                            const float* c0, const void* dout,
                            const void* whT, const void* wpT, void* dhtot,
                            void* dzbuf, void* dzseq, void* dhtseq,
                            float* dh0, float* dc0, unsigned int* bar, int T,
                            int B, int H, int P, void* stream,
                            size_t dzbuf_bytes) {
  return launch<float>(zseq, cseq, c0, dout, whT, wpT, dhtot, dzbuf, dzseq,
                       dhtseq, dh0, dc0, bar, T, B, H, P, stream,
                       dzbuf_bytes);
}

extern "C" int lstm_bwd_bf16(const void* zseq, const void* cseq,
                             const float* c0, const void* dout,
                             const void* whT, const void* wpT, void* dhtot,
                             void* dzbuf, void* dzseq, void* dhtseq,
                             float* dh0, float* dc0, unsigned int* bar, int T,
                             int B, int H, int P, void* stream,
                             size_t dzbuf_bytes) {
  return launch<bf16>(zseq, cseq, c0, dout, whT, wpT, dhtot, dzbuf, dzseq,
                      dhtseq, dh0, dc0, bar, T, B, H, P, stream, dzbuf_bytes);
}

// The plan of a bf16 launch at (B, H, P) on the current device and block
// cap, into out[8]: the design (lstm_last_design()'s numbering), the
// cluster size c (0 outside the cluster design), the grid, the ring's kq
// (0 outside the cluster design), the shared memory a block, the bytes
// dzbuf needs, and the co-resident clusters found at c = 4 and at c = 2
// (-1 where not asked).  Returns a CUDA error code.
extern "C" int lstm_bwd_plan(int B, int H, int P, long long* out) {
  Card card;
  int err = query_card(card);
  if (err) return err;
  ClusterChoice ch;
  err = cluster_choice(card, B, H, P, ch);
  if (err) return err;
  if (ch.c > 0) {
    const ClusterPlan pl = cluster_plan(ch.nblk, ch.c, B, H, P, ch.kq);
    out[0] = kDesignCluster;
    out[2] = ch.nblk;
    out[3] = ch.kq;
    out[4] = (long long)pl.bytes;
    out[5] = (long long)(sizeof(float) * pl.part);
  } else {
    const int nblk = grid_blocks(card, H);
    out[0] = kDesignFma;
    out[2] = nblk;
    out[3] = 0;
    out[4] = (long long)smem_bytes<bf16>(nblk, B, H, P);
    out[5] = 4LL * B * 4 * H;
  }
  out[1] = ch.c;
  out[6] = ch.clusters[0];
  out[7] = ch.clusters[1];
  return 0;
}

// The cluster size of this library's last cluster-design launch.
extern "C" int lstm_last_cluster() { return g_last_cluster; }

#ifdef LSTM_PHASE_TIMERS
// Block 0's cycles by phase of the cluster design's step, summed over
// launches since the last reset (reset != 0 zeroes them); out holds 8
// values, named by k5_phase_names().
extern "C" int k5_phases(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long z[8] = {};
    return (int)cudaMemcpyToSymbol(g_k5_phases, z, sizeof z);
  }
  return (int)cudaMemcpyFromSymbol(out, g_k5_phases,
                                   sizeof(unsigned long long) * 8);
}
extern "C" const char* k5_phase_names() {
  return "A products,A epilogue,cluster barrier,B gather,B products,"
         "B barrier,reduction,R barrier";
}
#endif
