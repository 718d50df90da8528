// Transducer beam search as one persistent kernel for Hopper (sm_90a).
//
// Replaces rnnt_tpu/ops/beam_pallas.py::_beam_kernel (launched by
// beam_search_encoded_pallas): the whole K-beam "modified" search over every
// encoder frame in one launch, with the semantics of
// rnnt_tpu_torch/decode/beam.py (its plain version).  Per frame t, with
// N = B*K hypothesis rows (row n = utterance n / K, hypothesis n % K):
//   joint of the beam -> log-probs; settled = beam scores + blank
//   E times:
//     label moves: per utterance, top-K over its K x (V-1) extensions
//       (blank 0 is never a label; rows at the length cap L are NEG);
//       append the label, advance every prediction-net layer
//     joint of the advanced set -> log-probs; advanced + blank
//     merge: an advanced row whose tokens over [0, len) equal a settled
//       row's (same utterance, same length, both alive) adds its mass to
//       that row by logaddexp and is killed (Graves 2012 prefix sums)
//     settled = top-K over settled | advanced
//   beam = settled; frames at or past an utterance's length keep its beam.
// Ties go to the lowest index: label moves over the flat [K, V] layout
// (parent row, then label, as jax.lax.top_k orders decode/beam.py), the pool
// over [settled | advanced] (the XLA search's concatenation).  The Pallas
// kernel breaks label ties lane-first and pool ties row-first; the orders
// differ only on exactly equal live scores.  Dead hypotheses score NEG
// (-1e30, and NEG plus any log-prob is NEG in fp32); they never merge.
//
// Rounding points follow the TPU kernel: fj = enc_t @ W1 + b1 and
// g = pred @ W1 in fp32, tanh(fj + g) rounded to the weight type, @ W2 + b2
// and the log-softmax in fp32; a layer's z = x @ Wx + h @ Wh + bias with x
// and h in the weight type and fp32 sums, c in fp32, hid rounded, h_new =
// hid @ Wp in fp32, LayerNorm of the unrounded h_new, the state keeping
// h_new rounded.
//
// Bound on the H100, at the parity width (pred net 2 x 2048/640, embedding
// 500, joint 640, V = 4096) in bf16: the inputs are mostly the decode-side
// weights, ~55 MB, read once in 16 us at 3.35 TB/s; the operations are
// ~1.24 GFLOP a frame at B = 1, K = 4, E = 6 (seven joints, six two-layer
// advances of four rows), 0.32 ms for 256 frames at 989 TFLOP/s.  This
// kernel re-reads the weights for every product: (1 + E) x 6 MB of joint
// plus E x 45 MB of prediction net, ~0.3 GB a frame, and the 50 MB L2 holds
// only part of that, so streaming the weights costs ~90 us a frame.  The
// steps form a dependent chain of ~7E + 3 grid-wide phases a frame, so at
// small B the real limit is latency: barriers, round trips to L2 and the
// per-phase weight stream.
//
// Design: one persistent launch covers the whole search, as K2 covers a
// sequence.  The grid is one block per SM (checked against
// cudaOccupancyMaxActiveBlocksPerMultiprocessor) and launched with
// cudaLaunchCooperativeKernel.  Block k owns a slice of the H hidden units
// (their four gate columns of Wx and Wh), of the P columns of Wp, of the J
// columns of W1, of the V columns of W2 and of the L token positions.  The
// hypothesis sets live in a workspace the wrapper allocates, in three
// rotating copies (expanding, settled, and the one being written), each with
// scores, lengths, tokens [N, L], pred_out and c/h per layer; buffers written
// during the launch are read with __ldcg (L2).  A frame:
//   F0 fj of each utterance (kept in shared memory) and tanh(fj + g) of the
//      beam (J slice) | F1 logits (V slice), per-row partial max and sum-exp |
//   then E times:
//   F2 per-row logsumexp from the partials; each block's top-K candidates
//      per utterance over its V slice |
//   F3 every block merges all blocks' candidates redundantly (no barrier),
//      appends the labels (its L slice) and runs the first layer's gates
//      (H slice) | Wp (P slice) | the next layers alike |
//   F4 LayerNorm from whole rows, the joint's tanh (J slice) | logits |
//   F5 logsumexp, blank settle, prefix merge and the pool's top-K, all
//      redundantly per block, then each block gathers the winners' slices
//      into the new settled set; the next expansion's F2 follows at once.
// That is 7 barriers an expansion and 7E + 3 a frame.  Column slices come in
// groups of 8 (H, P, J and V must be multiples of 8), so that every weight
// load is one 16-byte vector.  Within a block, vector rows are staged in
// shared memory and block_dots_vec splits each vector column's dot products
// over threads; per-utterance selections run one warp per utterance with
// shuffles, the prefix comparisons one warp per pair of rows.
//
// F3's products have two designs, chosen by the wrapper's plan before the
// launch (ops/beam_cuda.stream_plan) and reported by beam_last_design():
//  - FMA (fp32, and bf16 outside the plan): block_dots_vec over Wx, Wh and
//    Wp in place, as every other phase reads its weights.
//  - Streamed (bf16 at N = B K <= 16, a ring in shared memory): the
//    wrapper packs each layer's gate columns ([Wx; Wh], unit-major 4u + g)
//    and Wp columns once into per-block runs in the order the warps read
//    them (the packed layout, below).  Each warp streams its own k16
//    slices through a ring of 2 slots with 1D bulk copies (TMA,
//    cp.async.bulk + mbarrier), issuing the next chunk as soon as one is
//    consumed, across layers and into the next expansion: so the slices of
//    the next advance land while the block is in F4, F5 and F2, marked
//    evict-first in L2.  The products run on the FMA units, K split over
//    the 16 warps (a layer's x slices on warps 0-7, its h slices on 8-15,
//    so z = (x @ Wx + h @ Wh) + bias as the reference sums it), lane r
//    taking rows r and r + 32 of the slice (Wp's 8 rows: 4 lanes a row)
//    against the hypothesis rows staged in bf16; the warps' partial sums
//    are added in warp order in the cell update.
//    (mma.sync ran the products 2% faster, but its accumulation, which
//    truncates inside each instruction, moved a 15 s search's picks off
//    the reference's: PERF.md.)  The 7E + 3 barriers, the joint and the
//    selections are the FMA design's.  Its pace at the 15 s search is set
//    by the staging's L2 round trips and the L1 the ring leaves for the
//    kernel's stack (PERF.md).

#include <climits>
#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MAXL = 4;  // prediction-net layers the launcher takes
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Dims {
  int B, T, K, L, E, merge, V, P, J, D, H, nl;
};

template <typename W>
struct Args {
  const W* enc;        // [T, B, P]
  const int* enc_len;  // [B]
  const W* embed;      // [V, D]
  const W *w1, *b1, *w2, *b2;  // [P, J], [J], [J, V], [V]
  const float* init_pred;      // [N, P] rounded to W
  const W *wx[MAXL], *wh[MAXL], *bias[MAXL], *wp[MAXL], *ln_s[MAXL],
      *ln_b[MAXL];
  const float *init_c[MAXL], *init_h[MAXL];  // [N, H], [N, P] (h rounded)
  // the streamed advance (slots > 0): each layer's packed gate and Wp
  // slices (the packed layout, below), ring slots a warp
  const __nv_bfloat16 *pk_g[MAXL], *pk_p[MAXL];
  int slots;
  int* tok_out;     // [B, L]
  int* len_out;     // [B]
  float* sc_out;    // [B, K]
  float* ws;        // workspace, carve() words
  unsigned int* bar;
  // [nblk, N_PHASES] or null: each block's time a phase (the TIMED kernel)
  unsigned long long* phase_ns;
  // null, or the search's trace [T * E * 2, N]: the picks (label moves as
  // parent hypothesis * V + label, pool winners as the pool index) and their
  // scores of every selection, frame by frame, labels before the pool
  int* tr_idx;
  float* tr_val;
  Dims d;
};

// Phases of a block's timeline that `phase_ns` accumulates (nanoseconds of
// %globaltimer, thread 0 of each block into its own row), in the order of
// the frame.
enum Phase {
  PH_FJ_JOINT,     // F0: fj and the beam's joint hidden
  PH_LOGITS,       // F1 and F4: logits and partial sums
  PH_LSE,          // logsumexp (and the beam's blank settle)
  PH_CANDIDATES,   // F2
  PH_CHOOSE,       // F3: merge the candidates, the advanced set's tokens
  PH_GATES,        // F3: every layer's gates and cell (x @ Wx + h @ Wh)
  PH_PROJ,         // F3: every layer's hid @ Wp
  PH_JOINT,        // F4: LayerNorm and the advanced set's joint hidden
  PH_MERGE,        // F5: blank settle, prefix merge, pool top-K
  PH_GATHER,       // F5: the winners into the new settled set
  PH_BARRIER,      // waiting at grid barriers
  // F3 of the streamed advance (gates and proj are then its products):
  PH_STAGE,        // the products' rows into xb
  PH_RING_WAIT,    // waiting for weight chunks (thread 0: warp 0's)
  PH_WARP_SYNC,    // after its products, waiting for the other warps'
  PH_CELL,         // summing the warps' partial sums: cell update, h_new
  N_PHASES
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One set of N hypotheses.
struct HypSet {
  float* score;
  int* len;
  int* tok;    // [N, L]
  float* pred;  // [N, P] rounded to W
  float* c[MAXL];  // [N, H]
  float* h[MAXL];  // [N, P] rounded to W
};

struct Work {
  HypSet set[3];
  float *ssc0, *hj, *logits, *pmax, *psum, *cand_sc, *hid, *hnew;
  int* cand_idx;
};

struct Carver {
  float* base;
  size_t off;
  __host__ __device__ float* take(size_t n) {
    float* p = base ? base + off : nullptr;
    off += n;
    return p;
  }
  // the next take starts at a multiple of `words`
  __host__ __device__ void align(size_t words) {
    off = (off + words - 1) / words * words;
  }
};

// Carves the workspace (4-byte words; int buffers reinterpret theirs) into
// `w`; returns its size in words.  base == nullptr only counts.
__host__ __device__ inline size_t carve(float* base, const Dims& d, int nblk,
                                        Work* w) {
  Carver cv{base, 0};
  const size_t N = (size_t)d.B * d.K;
  for (int s = 0; s < 3; ++s) {
    HypSet& h = w->set[s];
    h.score = cv.take(N);
    h.len = (int*)cv.take(N);
    h.tok = (int*)cv.take(N * d.L);
    h.pred = cv.take(N * d.P);
    for (int l = 0; l < d.nl; ++l) {
      h.c[l] = cv.take(N * d.H);
      h.h[l] = cv.take(N * d.P);
    }
  }
  w->ssc0 = cv.take(N);
  w->hj = cv.take(N * d.J);
  w->logits = cv.take(N * d.V);
  w->pmax = cv.take((size_t)nblk * N);
  w->psum = cv.take((size_t)nblk * N);
  w->cand_sc = cv.take((size_t)nblk * N);
  w->cand_idx = (int*)cv.take((size_t)nblk * N);
  w->hid = cv.take(N * d.H);
  w->hnew = cv.take(N * d.P);
  return cv.off;
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Column slices are cut in groups of SLICE columns (whole 16-byte vectors of
// either weight type); H, P, J and V are multiples of SLICE.
constexpr int SLICE = 8;

__host__ __device__ inline int slice8(int i, int n, int parts) {
  return slice_begin(i, n / SLICE, parts) * SLICE;
}

// Widest slice of n columns a block owns.
__host__ __device__ inline int slice_max(int n, int nblk) {
  return cdiv(n / SLICE, nblk) * SLICE;
}

// Widest column slice of any product a block owns.
__host__ __device__ inline int ncmax(const Dims& d, int nblk) {
  int m = 4 * slice_max(d.H, nblk);
  m = m > slice_max(d.P, nblk) ? m : slice_max(d.P, nblk);
  m = m > slice_max(d.J, nblk) ? m : slice_max(d.J, nblk);
  return m > slice_max(d.V, nblk) ? m : slice_max(d.V, nblk);
}

// Utterances whose candidates one block merges at a time (F3).
__host__ __device__ inline int cand_group(const Dims& d) {
  return d.B < 8 ? d.B : 8;
}

// A block's shared memory.
struct Smem {
  float *red, *out, *xs, *xs2, *fj, *lg, *cand_sc, *stat;
  // per row (N): logsumexp, chosen label moves' scores, pool winners'
  // scores, best matching advanced score of a settled row, blank-settled
  // advanced scores, expanding scores, settled scores
  float *lse, *wsc, *zsc, *msc, *bsc, *xsc, *ssc;
  // per row: chosen label moves' parent rows and labels, pool winners
  // (e < K settled row e, else advanced row e - K), advanced row merged
  // away, expanding, settled and advanced lengths
  int *par, *lab, *zsrc, *kil, *xlen, *slen, *ylen;
  int *cand_idx;
  int* eq;  // [N, K]: settled row n matches advanced row k of its utterance
  // the streamed advance only: the product's hypothesis rows in bf16 [N,
  // xb_stride], each warp's ring slots and their mbarriers
  __nv_bfloat16* xb;
  unsigned long long* mbar;
  unsigned char* ring;
};

// ---- the streamed advance (bf16): layout of the packed weight slices ----
//
// Every product of the advance, a layer's gates (rows: gate columns 4u + g
// of the units, k: x padded to 16 then h padded to 16) and its Wp (rows: P
// columns, k: H padded to 16), is cut by rows into the blocks' slices and
// by k into k16 slices.  A block's slice of a product is one contiguous
// run: its k16 slices in warp order (dealt to the warps as warp_share below
// says; all of warp 0's first), each slice its rows in order, 16 bf16 values
// (32 bytes) a row.  Block b's run starts after those of the blocks
// before it: at (4 u0 / 8) x nsl x 128 values for the gates, (p0 / 8) x nsl
// x 128 for Wp (nsl: the product's k16 slices).  ops/beam_cuda.pack_layer
// writes it; each warp streams its own slices through its own ring of
// `slots` slots of slot_bytes.
constexpr int NWARP = NT / 32;
constexpr int HALF = 256;   // bytes of 8 rows of a k16 slice
constexpr int MAXR = 64;    // rows of a block's slice of a product
constexpr int MAXN = 16;    // hypothesis rows N = B K

__host__ __device__ inline int r16(int n) { return (n + 15) / 16 * 16; }

// k of layer l's gate product: x (din padded to 16), then h (P padded).
__host__ __device__ inline int gate_k(const Dims& d, int l) {
  return r16(l == 0 ? d.D : d.P) + r16(d.P);
}

// Bytes of a ring slot: a k16 slice of the widest slice of any product.
__host__ __device__ inline int slot_bytes(const Dims& d, int nblk) {
  const int g = 4 * slice_max(d.H, nblk), p = slice_max(d.P, nblk);
  return (g > p ? g : p) / 8 * HALF;
}

// Row stride (bf16 values) of the staged hypothesis rows: the widest k of
// any product (gates or Wp) rounded to 64, plus 16, so that successive rows
// do not start on the same banks (the unpadded stride ran the 15 s search
// 2% slower on the H100, PERF.md).
__host__ __device__ inline int xb_stride(const Dims& d) {
  int k = r16(d.H);
  for (int l = 0; l < d.nl && l < 2; ++l) k = k > gate_k(d, l) ? k : gate_k(d, l);
  return (k + 63) / 64 * 64 + 16;
}

// A product's k16 slices come in one segment (Wp's k) or two (a layer's x,
// then its h).  The warps are dealt evenly to the segments, and within one
// the lw-th of its ws warps takes the slices lw, lw + ws, ...: so a layer's
// z sums x @ Wx (warps 0-7) and h @ Wh (warps 8-15) apart and adds them,
// as the reference does.  A warp's share: its first slice and stride, its
// slice count, and the position of its first slice in warp order (the
// packed run holds warp 0's slices first, then warp 1's, ...).
struct Share {
  int s0, step, cnt, first;
};
__host__ __device__ inline Share warp_share(int seg0, int seg1, int w) {
  const int ws = seg1 > 0 ? NWARP / 2 : NWARP, sg = w / ws, lw = w % ws;
  const int n = sg ? seg1 : seg0, base = sg ? seg0 : 0, r = n % ws;
  Share sh;
  sh.s0 = base + lw;
  sh.step = ws;
  sh.cnt = lw < n ? (n - lw + ws - 1) / ws : 0;
  sh.first = base + lw * (n / ws) + (lw < r ? lw : r);
  return sh;
}

// Whether the streamed advance takes the shape, shared memory aside: at
// most MAXN hypothesis rows and MAXR rows a block's slice of a product (two
// a lane), whole 16-byte vectors a block; the 16 warps' partial sums then
// fit in red.
__host__ __device__ inline bool stream_shape_ok(const Dims& d, int nblk) {
  return d.B * d.K <= MAXN && 4 * slice_max(d.H, nblk) <= MAXR &&
         slice_max(d.P, nblk) <= MAXR && d.H % SLICE == 0 &&
         d.P % SLICE == 0 &&
         (size_t)NWARP * MAXR * MAXN <= (size_t)NT * SLICE * BCH;
}

// Carves shared memory (4-byte words) into `s`; returns its size in words.
// slots > 0: the streamed advance's layout (no xs2, xs without H; the
// staged rows, mbarriers and ring after the rest).
__host__ __device__ inline size_t carve_smem(float* base, const Dims& d,
                                             int nblk, int slots, Smem* s) {
  Carver cv{base, 0};
  const size_t N = (size_t)d.B * d.K;
  int kx = d.D > d.P ? d.D : d.P;
  if (slots == 0) kx = kx > d.H ? kx : d.H;
  kx = kx > d.J ? kx : d.J;
  const size_t ncand = (size_t)cand_group(d) * nblk * d.K;
  s->red = cv.take((size_t)NT * SLICE * BCH);
  s->out = cv.take((size_t)ncmax(d, nblk) * BCH);
  s->xs = cv.take((size_t)BCH * kx);
  s->xs2 = slots == 0 ? cv.take((size_t)BCH * d.P) : nullptr;
  s->fj = cv.take((size_t)d.B * slice_max(d.J, nblk));
  s->lg = cv.take(N * slice_max(d.V, nblk));
  s->cand_sc = cv.take(ncand);
  s->cand_idx = (int*)cv.take(ncand);
  s->stat = cv.take(2 * BCH);
  float** fl[] = {&s->lse, &s->wsc, &s->zsc, &s->msc, &s->bsc, &s->xsc,
                  &s->ssc};
  for (float** p : fl) *p = cv.take(N);
  int** in[] = {&s->par, &s->lab, &s->zsrc, &s->kil, &s->xlen, &s->slen,
                &s->ylen};
  for (int** p : in) *p = (int*)cv.take(N);
  s->eq = (int*)cv.take(N * d.K);
  s->xb = nullptr;
  s->mbar = nullptr;
  s->ring = nullptr;
  if (slots > 0) {
    cv.align(4);
    s->xb = (__nv_bfloat16*)cv.take(N * xb_stride(d) / 2);
    cv.align(2);
    s->mbar = (unsigned long long*)cv.take((size_t)2 * NWARP * slots);
    cv.align(32);
    s->ring = (unsigned char*)cv.take((size_t)NWARP * slots *
                                      slot_bytes(d, nblk) / 4);
  }
  return cv.off;
}

// C bf16 values at p (C = 4, 8 or 16; p aligned to 2C bytes, at most 16)
// as floats, in 8- or 16-byte loads.
template <int C>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p,
                                          float (&o)[C]) {
  constexpr int V = C == 4 ? 1 : C / 8;  // loads
  constexpr int W = C == 4 ? 2 : 4;      // bf16 pairs a load
#pragma unroll
  for (int q = 0; q < V; ++q) {
    unsigned u[4];
    if (W == 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      u[0] = v.x;
      u[1] = v.y;
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(p + 8 * q);
      u[0] = v.x;
      u[1] = v.y;
      u[2] = v.z;
      u[3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
      o[q * 2 * W + 2 * i] = f.x;
      o[q * 2 * W + 2 * i + 1] = f.y;
    }
  }
}

// Bulk copies (common.cuh) mark the weight slices evict-first in L2: each
// slice is read once an expansion, and 45 MB of them would otherwise push
// the joint's weights, the workspace and the code out of the 50 MB L2
// (without the hint the 15 s search ran 25% slower on the H100, PERF.md).

// Selection order: higher score first, then the lower index.
__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// The best (score, index) over the warp, in every lane.
__device__ __forceinline__ void warp_best(float& s, int& i) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float s2 = __shfl_xor_sync(FULL, s, o);
    const int i2 = __shfl_xor_sync(FULL, i, o);
    if (better(s2, i2, s, i)) {
      s = s2;
      i = i2;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float mx = fmaxf(a, b), mn = fminf(a, b);
  return mx + log1pf(expf(mn - mx));
}

// Weights load as 16-byte vectors of N elements.
template <typename W>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

// out[c * BCH + bb] = sum_k xs[bb * K + k] * w[k * ldw + col(c)] for the
// nvec * VEC local columns c and bb < nb, with the vector rows `xs` in shared
// memory; `accumulate` adds to out instead.  Local columns come in vectors
// of VEC: vector vc covers columns vcol(vc) .. vcol(vc) + VEC - 1, read with
// one 16-byte load a k.  Threads split each vector's dot products over k and
// the partial sums reduce through shared memory `red` [NT * SLICE * BCH].
template <typename W, typename VCol>
__device__ void block_dots_vec(const float* xs, int nb, int K,
                               const W* __restrict__ w, int ldw, int nvec,
                               VCol vcol, float* red, float* out,
                               bool accumulate = false) {
  constexpr int VEC = Vec<W>::N;
  for (int vbase = 0; vbase < nvec; vbase += NT) {
    const int nc = min(NT, nvec - vbase);
    const int n_ks = NT / nc;
    const int vc = threadIdx.x % nc, ks = threadIdx.x / nc;
    if (ks < n_ks) {
      float acc[BCH][VEC];
#pragma unroll
      for (int bb = 0; bb < BCH; ++bb)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[bb][v] = 0.f;
      const W* wc = w + vcol(vbase + vc);
#pragma unroll 4
      for (int k = ks; k < K; k += n_ks) {
        float wv[VEC];
        Vec<W>::load(wc + (size_t)k * ldw, wv);
#pragma unroll
        for (int bb = 0; bb < BCH; ++bb) {
          if (bb < nb) {
            const float x = xs[bb * K + k];
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[bb][v] = fmaf(x, wv[v], acc[bb][v]);
          }
        }
      }
#pragma unroll
      for (int bb = 0; bb < BCH; ++bb)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          red[((ks * nc + vc) * VEC + v) * BCH + bb] = acc[bb][v];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nc * VEC * BCH; i += NT) {
      const int cv = i / BCH, bb = i - cv * BCH;
      float sum = 0.f;
      for (int q = 0; q < n_ks; ++q) sum += red[(q * nc * VEC + cv) * BCH + bb];
      float* o = out + (vbase * VEC + cv) * BCH + bb;
      *o = accumulate ? *o + sum : sum;
    }
    __syncthreads();
  }
}

// xs[bb * K + k] = get(bb, k) for bb < nb, k < K.
template <typename Get>
__device__ __forceinline__ void stage(float* xs, int nb, int K, Get get) {
  for (int i = threadIdx.x; i < nb * K; i += NT) {
    const int bb = i / K;
    xs[i] = get(bb, i - bb * K);
  }
  __syncthreads();
}

// xs rows bb < nb: LayerNorm (eps 1e-3) of hnew rows n0 + bb, rounded to W.
template <typename W>
__device__ void stage_ln(float* xs, float* stat, const float* hnew, int n0,
                         int nb, int P, const W* sc, const W* bi) {
  stage(xs, nb, P, [&](int bb, int k) {
    return __ldcg(hnew + (size_t)(n0 + bb) * P + k);
  });
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < nb) {
    const float* x = xs + warp * P;
    float s = 0.f;
    for (int k = lane; k < P; k += 32) s += x[k];
    const float mean = warp_sum(s) / P;
    float q = 0.f;
    for (int k = lane; k < P; k += 32) q += (x[k] - mean) * (x[k] - mean);
    const float var = warp_sum(q) / P;
    if (lane == 0) {
      stat[2 * warp] = mean;
      stat[2 * warp + 1] = rsqrtf(var + 1e-3f);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb * P; i += NT) {
    const int bb = i / P, k = i - bb * P;
    xs[i] = round_to<W>((xs[i] - stat[2 * bb]) * stat[2 * bb + 1] *
                            to_float(sc[k]) +
                        to_float(bi[k]));
  }
  __syncthreads();
}

// dst[n * ld + k] = get(n, k) rounded to T, for n < rows, k < kc.  (Each
// thread's loads one at a time: batching 16 of them before the stores ran
// slower on the H100, PERF.md.)
template <typename T, typename Get>
__device__ __forceinline__ void stage_rows(T* dst, int ld, int rows, int kc,
                                           Get get) {
  for (int i = threadIdx.x; i < rows * kc; i += NT) {
    const int n = i / kc, k = i - n * kc;
    dst[(size_t)n * ld + k] = from_float<T>(get(n, k));
  }
}

// dst[n * ld + k] = src(n)[k] for k < kvalid, zero up to kc, rounded to T,
// for n < rows: rows of fp32 (kvalid and kc multiples of 4) read with one
// 16-byte load a 4 values where every row is 16-byte aligned (`aligned`;
// at K = 4 every workspace buffer is), else one value a load.
template <typename T, typename Src>
__device__ __forceinline__ void stage_f32_rows(T* dst, int ld, int rows,
                                               int kc, int kvalid, bool aligned,
                                               Src src) {
  if (!aligned) {
    stage_rows(dst, ld, rows, kc, [&](int n, int k) {
      return k < kvalid ? __ldcg(src(n) + k) : 0.f;
    });
    return;
  }
  const int q4 = kc / 4;
  for (int i = threadIdx.x; i < rows * q4; i += NT) {
    const int n = i / q4, k = 4 * (i - n * q4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < kvalid) v = __ldcg(reinterpret_cast<const float4*>(src(n) + k));
    T* o = dst + (size_t)n * ld + k;
    o[0] = from_float<T>(v.x);
    o[1] = from_float<T>(v.y);
    o[2] = from_float<T>(v.z);
    o[3] = from_float<T>(v.w);
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// xb rows n0 .. n0+nb, k < kx: the LayerNorm (eps 1e-3) of hnew rows n0 ..
// n0+nb, rounded to bf16, zero from P on (stage_ln's arithmetic, written to
// xb); xs and stat are scratch.
template <typename W>
__device__ void stage_ln_xb(__nv_bfloat16* xb, int xstr, int kx, float* xs,
                            float* stat, const float* hnew, int n0, int nb,
                            int P, const W* sc, const W* bi) {
  stage_f32_rows(xs, P, nb, P, P, aligned16(hnew), [&](int bb) {
    return hnew + (size_t)(n0 + bb) * P;
  });
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < nb) {
    const float* x = xs + warp * P;
    float s = 0.f;
    for (int k = lane; k < P; k += 32) s += x[k];
    const float mean = warp_sum(s) / P;
    float q = 0.f;
    for (int k = lane; k < P; k += 32) q += (x[k] - mean) * (x[k] - mean);
    const float var = warp_sum(q) / P;
    if (lane == 0) {
      stat[2 * warp] = mean;
      stat[2 * warp + 1] = rsqrtf(var + 1e-3f);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb * kx; i += NT) {
    const int bb = i / kx, k = i - bb * kx;
    xb[(size_t)(n0 + bb) * xstr + k] = from_float<__nv_bfloat16>(
        k < P ? round_to<W>((xs[bb * P + k] - stat[2 * bb]) * stat[2 * bb + 1] *
                                to_float(sc[k]) +
                            to_float(bi[k]))
              : 0.f);
  }
  __syncthreads();
}

// STREAM (bf16 only): the advance's products on streamed weight slices
// (see the kernel's F3).  TIMED: thread 0 of every block keeps its phase
// totals in registers and adds them to its row of a.phase_ns at the end (a
// diagnostic build of the same code; the serving path launches the untimed
// one).
template <typename W, bool STREAM, bool TIMED>
__global__ void __launch_bounds__(NT) beam_kernel(const Args<W> a) {
  extern __shared__ __align__(128) float smem[];
  const Dims d = a.d;
  const int nblk = gridDim.x, blk = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, nwarp = NT / 32;
  const int B = d.B, K = d.K, N = d.B * d.K, L = d.L, V = d.V, P = d.P,
            J = d.J, D = d.D, H = d.H, H4 = 4 * d.H;
  Work w;
  carve(a.ws, d, nblk, &w);
  Smem s;
  carve_smem(smem, d, nblk, STREAM ? a.slots : 0, &s);
  float* const red = s.red;
  float* const out = s.out;
  float* const xs = s.xs;

  // this block's slices
  const int u0 = slice8(blk, H, nblk);
  const int nu = slice8(blk + 1, H, nblk) - u0;
  const int p0 = slice8(blk, P, nblk);
  const int np = slice8(blk + 1, P, nblk) - p0;
  const int j0 = slice8(blk, J, nblk);
  const int nj = slice8(blk + 1, J, nblk) - j0;
  const int v0 = slice8(blk, V, nblk);
  const int nv = slice8(blk + 1, V, nblk) - v0;
  const int q0 = slice_begin(blk, L, nblk);
  const int nq = slice_begin(blk + 1, L, nblk) - q0;
  const int jmax = slice_max(J, nblk), vmax = slice_max(V, nblk);
  constexpr int VEC = Vec<W>::N;

  // first column of each product's vector vc: gate vectors run gate-major
  // over the own units
  auto gate_col = [=](int vc) {
    const int g = vc / (nu / VEC);
    return g * H + u0 + (vc - g * (nu / VEC)) * VEC;
  };
  auto p_col = [=](int vc) { return p0 + vc * VEC; };
  auto j_col = [=](int vc) { return j0 + vc * VEC; };
  auto v_col = [=](int vc) { return v0 + vc * VEC; };
  unsigned int target = 0;
  unsigned long long t_mark = TIMED ? globaltimer() : 0ull;
  unsigned long long ph_ns[N_PHASES] = {};
  // the time since the last mark goes to phase `ph` (TIMED only); `ph` is a
  // constant at every call, so ph_ns stays in registers
  auto mark = [&](int ph) {
    if (TIMED && tid == 0) {
      const unsigned long long now = globaltimer();
      ph_ns[ph] += now - t_mark;
      t_mark = now;
    }
  };
  auto barrier = [&](int ph) {
    mark(ph);
    grid_barrier(a.bar, target);
    mark(PH_BARRIER);
  };

  // tanh(fj + pred @ W1) of N rows into hj (own J slice).  pred rows come
  // from `src` (a set's pred_out), or with src == nullptr from the
  // LayerNorm of hnew with the last layer's parameters, whose own P slice
  // is then written to `dst` (the new set's pred_out).
  auto joint_hidden = [&](const float* src, float* dst) {
    for (int n0 = 0; n0 < N; n0 += BCH) {
      const int nb = min(BCH, N - n0);
      if (src != nullptr) {
        stage(xs, nb, P, [&](int bb, int k) {
          return __ldcg(src + (size_t)(n0 + bb) * P + k);
        });
      } else {
        stage_ln(xs, s.stat, w.hnew, n0, nb, P, a.ln_s[d.nl - 1],
                 a.ln_b[d.nl - 1]);
        for (int i = tid; i < nb * np; i += NT) {
          const int bb = i / np, c = i - bb * np;
          dst[(size_t)(n0 + bb) * P + p0 + c] = xs[bb * P + p0 + c];
        }
      }
      block_dots_vec(xs, nb, P, a.w1, J, nj / VEC, j_col, red, out);
      for (int i = tid; i < nb * nj; i += NT) {
        const int bb = i / nj, c = i - bb * nj, n = n0 + bb;
        w.hj[(size_t)n * J + j0 + c] = round_to<W>(
            tanhf(s.fj[(n / K) * jmax + c] + out[c * BCH + bb]));
      }
      __syncthreads();
    }
  };

  // logits (own V slice) of the rows in hj, kept in shared memory (lg) and
  // global memory, with per-row partial max and sum of exp over the slice.
  auto logits_phase = [&]() {
    for (int n0 = 0; n0 < N; n0 += BCH) {
      const int nb = min(BCH, N - n0);
      stage(xs, nb, J, [&](int bb, int k) {
        return __ldcg(w.hj + (size_t)(n0 + bb) * J + k);
      });
      block_dots_vec(xs, nb, J, a.w2, V, nv / VEC, v_col, red, out);
      for (int i = tid; i < nb * nv; i += NT) {
        const int bb = i / nv, c = i - bb * nv;
        const float x = out[c * BCH + bb] + to_float(a.b2[v0 + c]);
        s.lg[(n0 + bb) * vmax + c] = x;
        w.logits[(size_t)(n0 + bb) * V + v0 + c] = x;
      }
      __syncthreads();
      if (warp < nb) {
        const float* x = s.lg + (n0 + warp) * vmax;
        float m = -INFINITY;
        for (int c = lane; c < nv; c += 32) m = fmaxf(m, x[c]);
        m = warp_max(m);
        float sum = 0.f;
        for (int c = lane; c < nv; c += 32) sum += expf(x[c] - m);
        sum = warp_sum(sum);
        if (lane == 0) {
          w.pmax[(size_t)blk * N + n0 + warp] = m;
          w.psum[(size_t)blk * N + n0 + warp] = sum;
        }
      }
      __syncthreads();
    }
  };

  // per-row logsumexp of the logits from every block's partials, one warp
  // a row
  auto row_lse = [&]() {
    for (int n = warp; n < N; n += nwarp) {
      float m = -INFINITY;
      for (int q = lane; q < nblk; q += 32)
        m = fmaxf(m, __ldcg(w.pmax + (size_t)q * N + n));
      m = warp_max(m);
      float sum = 0.f;
      for (int q = lane; q < nblk; q += 32) {
        const float pm = __ldcg(w.pmax + (size_t)q * N + n);
        if (pm > -INFINITY)
          sum += __ldcg(w.psum + (size_t)q * N + n) * expf(pm - m);
      }
      sum = warp_sum(sum);
      if (lane == 0) s.lse[n] = m + logf(sum);
    }
    __syncthreads();
  };

  // this block's top-K label moves of each utterance over its V slice,
  // from the expanding set's lengths and scores and the logits in lg
  auto label_candidates = [&](const HypSet& X) {
    for (int n = tid; n < N; n += NT) {
      s.xlen[n] = __ldcg(X.len + n);
      s.xsc[n] = __ldcg(X.score + n);
    }
    __syncthreads();
    for (int b = warp; b < B; b += nwarp) {
      float ps = INFINITY;
      int pi = -1;
      for (int r = 0; r < K; ++r) {
        float bsv = -INFINITY;
        int bi = INT_MAX;
        for (int i = lane; i < K * nv; i += 32) {
          const int k = i / nv, c = i - k * nv, v = v0 + c;
          if (v == 0) continue;  // blank is never a label
          const int n = b * K + k;
          const float sc = s.xlen[n] >= L
                               ? NEG
                               : s.xsc[n] + (s.lg[n * vmax + c] - s.lse[n]);
          const int f = k * V + v;
          if (better(ps, pi, sc, f) && better(sc, f, bsv, bi)) {
            bsv = sc;
            bi = f;
          }
        }
        warp_best(bsv, bi);
        if (lane == 0) {
          w.cand_sc[((size_t)blk * B + b) * K + r] = bsv;
          w.cand_idx[((size_t)blk * B + b) * K + r] = bi;
        }
        ps = bsv;
        pi = bi;
      }
    }
  };

  // every block's candidates -> each utterance's top-K label moves (par,
  // lab, wsc), G utterances at a time, one warp each
  auto choose_labels = [&]() {
    const int G = cand_group(d);
    for (int g0 = 0; g0 < B; g0 += G) {
      const int ng = min(G, B - g0);
      for (int i = tid; i < ng * nblk * K; i += NT) {
        const int gb = i / (nblk * K), rest = i - gb * nblk * K;
        const int q = rest / K;
        const size_t o = ((size_t)q * B + g0 + gb) * K + (rest - q * K);
        s.cand_sc[i] = __ldcg(w.cand_sc + o);
        s.cand_idx[i] = __ldcg(w.cand_idx + o);
      }
      __syncthreads();
      for (int gb = warp; gb < ng; gb += nwarp) {
        const int b = g0 + gb;
        const float* cs = s.cand_sc + gb * nblk * K;
        const int* ci = s.cand_idx + gb * nblk * K;
        float ps = INFINITY;
        int pi = -1;
        for (int r = 0; r < K; ++r) {
          float bsv = -INFINITY;
          int bi = INT_MAX;
          for (int i = lane; i < nblk * K; i += 32)
            if (better(ps, pi, cs[i], ci[i]) && better(cs[i], ci[i], bsv, bi)) {
              bsv = cs[i];
              bi = ci[i];
            }
          warp_best(bsv, bi);
          if (lane == 0) {
            const int n = b * K + r;
            s.par[n] = b * K + bi / V;
            s.lab[n] = bi % V;
            s.wsc[n] = bsv;
          }
          ps = bsv;
          pi = bi;
        }
      }
      __syncthreads();
    }
  };

  // blank-settle the advanced set Y, merge it into the settled set S (scores
  // ssc), and pick each utterance's top-K of the pool into zsrc / zsc
  auto settle_merge_pool = [&](const HypSet& S, const float* ssc,
                               const HypSet& Y, int t) {
    for (int n = tid; n < N; n += NT) {
      s.bsc[n] = s.wsc[n] + (__ldcg(w.logits + (size_t)n * V) - s.lse[n]);
      s.ssc[n] = __ldcg(ssc + n);
      s.slen[n] = __ldcg(S.len + n);
      s.ylen[n] = __ldcg(Y.len + n);
    }
    __syncthreads();
    // one warp per (settled row, advanced row) pair of an utterance
    for (int pr = warp; pr < N * K; pr += nwarp) {
      const int ni = pr / K, b = ni / K, nj = b * K + pr % K;
      const int li = s.slen[ni];
      bool eq = d.merge && t < a.enc_len[b] && li == s.ylen[nj] &&
                s.ssc[ni] > NEG / 2 && s.bsc[nj] > NEG / 2;
      if (eq) {
        bool mism = false;
        for (int pos = lane; pos < li; pos += 32)
          mism |= __ldcg(S.tok + (size_t)ni * L + pos) !=
                  __ldcg(Y.tok + (size_t)nj * L + pos);
        eq = !__any_sync(FULL, mism);
      }
      if (lane == 0) s.eq[pr] = eq;
    }
    __syncthreads();
    // settled row n takes the best matching advanced mass; a matched
    // advanced row is killed
    for (int n = tid; n < N; n += NT) {
      const int b = n / K, k = n % K;
      float m = NEG;
      int kill = 0;
      for (int j = 0; j < K; ++j) {
        if (s.eq[n * K + j]) m = fmaxf(m, s.bsc[b * K + j]);
        kill |= s.eq[(b * K + j) * K + k];
      }
      s.msc[n] = m;
      s.kil[n] = kill;
    }
    __syncthreads();
    for (int b = warp; b < B; b += nwarp) {
      const bool alive = t < a.enc_len[b];
      float ps = INFINITY;
      int pi = -1;
      for (int r = 0; r < K; ++r) {
        const int n = b * K + r;
        if (!alive) {  // frames past the utterance keep its beam
          if (lane == 0) {
            s.zsrc[n] = r;
            s.zsc[n] = s.ssc[n];
          }
          continue;
        }
        float bsv = -INFINITY;
        int bi = INT_MAX;
        for (int e2 = lane; e2 < 2 * K; e2 += 32) {
          float sc;
          if (e2 < K) {
            const int m = b * K + e2;
            sc = s.msc[m] > NEG / 2 ? logaddexp(s.ssc[m], s.msc[m])
                                    : s.ssc[m];
          } else {
            const int m = b * K + e2 - K;
            sc = s.kil[m] ? NEG : s.bsc[m];
          }
          if (better(ps, pi, sc, e2) && better(sc, e2, bsv, bi)) {
            bsv = sc;
            bi = e2;
          }
        }
        warp_best(bsv, bi);
        if (lane == 0) {
          s.zsrc[n] = bi;
          s.zsc[n] = bsv;
        }
        ps = bsv;
        pi = bi;
      }
    }
    __syncthreads();
  };

  // block 0 writes selection `sel` of the trace, if asked: row n's pick
  // idx(n) and its score val[n]
  auto trace = [&](size_t sel, auto idx, const float* val) {
    if (a.tr_idx != nullptr && blk == 0)
      for (int n = tid; n < N; n += NT) {
        a.tr_idx[sel * N + n] = idx(n);
        a.tr_val[sel * N + n] = val[n];
      }
  };

  // ---- the streamed advance (STREAM): each warp's ring of weight chunks ----
  // Per expansion the products run in the order gates of layer 0, its Wp,
  // gates of layer 1, ..., and each warp streams its own k16 slices of them
  // in that order, wrapping to the next expansion, through `slots` slots
  // of sbytes: a chunk is as many whole slices of a product as fill a slot.
  // Lane 0 issues chunk q into slot q % slots as soon as chunk q - slots
  // has been consumed, so the next expansion's first chunks land while the
  // block is at the barriers and the selection phases.
  const int slots = STREAM ? a.slots : 0;
  const int sbytes = slot_bytes(d, nblk), xstr = xb_stride(d);
  const int nprod = 2 * d.nl;
  struct Prod {
    const __nv_bfloat16* src;  // the block's run
    int seg0, seg1, nh;        // k16 slices of each segment, 8-row halves
  };
  auto prod = [&](int pi) -> Prod {
    const int l = pi >> 1;
    if ((pi & 1) == 0) {
      const int sx = r16(l == 0 ? D : P) / 16, sh = r16(P) / 16;
      return {a.pk_g[l] + (size_t)(u0 / 2) * (sx + sh) * 128, sx, sh, nu / 2};
    }
    const int nsl = r16(H) / 16;
    return {a.pk_p[l] + (size_t)(p0 / 8) * nsl * 128, nsl, 0, np / 8};
  };
  auto chunks = [&](const Prod& pr) {  // this warp's chunks of a product
    return pr.nh == 0 ? 0
                      : cdiv(warp_share(pr.seg0, pr.seg1, warp).cnt,
                             sbytes / (pr.nh * HALF));
  };
  int q_cons = 0, q_iss = 0, pi_iss = 0, c_iss = 0, total = 0;
  // the next chunk of this warp's sequence into the slot it goes to
  auto issue = [&]() {
    if (q_iss >= total) return;
    while (c_iss >= chunks(prod(pi_iss))) {
      c_iss = 0;
      pi_iss = pi_iss + 1 == nprod ? 0 : pi_iss + 1;
    }
    const Prod pr = prod(pi_iss);
    const Share sh = warp_share(pr.seg0, pr.seg1, warp);
    const int cpc = sbytes / (pr.nh * HALF), i0 = c_iss * cpc;
    const int cnt = min(cpc, sh.cnt - i0);
    if (lane == 0) {
      const int slot = warp * slots + q_iss % slots;
      // the slot's last reads (generic proxy) before the copy's writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_load(s.ring + (size_t)slot * sbytes,
                pr.src + (size_t)(sh.first + i0) * pr.nh * 128,
                (unsigned)(cnt * pr.nh * HALF), s.mbar + slot, true);
    }
    ++c_iss;
    ++q_iss;
  };
  // This warp's share of product pi: its k16 slices times every hypothesis
  // row n of the staged rows xb (bf16, zero past N), summed in fp32 FMAs
  // over k in order, as the reference's fp32 products round; the partial
  // sums go to red [warp][MAXR rows][N].  A slice of more than 8 rows takes
  // rows lane and lane + 32, all 16 k; one of at most 8 (Wp's) takes row
  // lane % 8 on 4 lanes, 4 k each, summed by shuffles at the end.  The
  // caller's red_sum adds the warps' sums in warp order after the
  // __syncthreads that products ends with.
  auto products = [&](int pi) {
    const Prod pr = prod(pi);
    const int R = 8 * pr.nh;
    auto run = [&](auto rpl_c, auto kpl_c, auto mn_c) {
      constexpr int RPL = decltype(rpl_c)::value;  // rows a lane
      constexpr int KPL = decltype(kpl_c)::value;  // k of a slice a lane
      constexpr int MN = decltype(mn_c)::value;    // most hypothesis rows
      constexpr int KC = KPL < 8 ? KPL : 8;        // k a load
      constexpr int RL = 32 * KPL / 16;            // rows the warp covers
      const int rl = lane % RL, kq = lane / RL * KPL;
      float acc[RPL][MN] = {};
      if (pr.nh > 0) {
        const int cpc = sbytes / (pr.nh * HALF);
        const Share sh = warp_share(pr.seg0, pr.seg1, warp);
        for (int i0 = 0; i0 < sh.cnt; i0 += cpc) {
          const int slot = warp * slots + q_cons % slots;
          if (pi & 1)
            mark(PH_PROJ);
          else
            mark(PH_GATES);
          mbar_wait(s.mbar + slot, (q_cons / slots) & 1);
          mark(PH_RING_WAIT);
          const __nv_bfloat16* cb =
              reinterpret_cast<const __nv_bfloat16*>(s.ring +
                                                     (size_t)slot * sbytes);
          const int cnt = min(cpc, sh.cnt - i0);
          for (int i = 0; i < cnt; ++i) {
            const int k0 = (sh.s0 + sh.step * (i0 + i)) * 16 + kq;
#pragma unroll
            for (int kc = 0; kc < KPL; kc += KC) {
              float wv[RPL][KC];
#pragma unroll
              for (int rr = 0; rr < RPL; ++rr) {
                const int r = rl + RL * rr;
                if (r < R)
                  load_bf16<KC>(cb + ((size_t)i * R + r) * 16 + kq + kc,
                                wv[rr]);
                else
#pragma unroll
                  for (int j = 0; j < KC; ++j) wv[rr][j] = 0.f;
              }
#pragma unroll
              for (int n = 0; n < MN; ++n) {
                if (n < N) {
                  float xv[KC];
                  load_bf16<KC>(s.xb + (size_t)n * xstr + k0 + kc, xv);
#pragma unroll
                  for (int rr = 0; rr < RPL; ++rr)
#pragma unroll
                    for (int j = 0; j < KC; ++j)
                      acc[rr][n] = fmaf(wv[rr][j], xv[j], acc[rr][n]);
                }
              }
            }
          }
          __syncwarp();  // every lane's reads of the slot are done
          ++q_cons;
          issue();
        }
      }
#pragma unroll
      for (int rr = 0; rr < RPL; ++rr)
#pragma unroll
        for (int n = 0; n < MN; ++n)
          if (n < N) {
            float v = acc[rr][n];
#pragma unroll
            for (int o = RL; o < 32; o <<= 1)
              v += __shfl_xor_sync(FULL, v, o);
            if (lane < RL && rl + RL * rr < R)
              red[((size_t)warp * MAXR + rl + RL * rr) * N + n] = v;
          }
    };
    using I1 = std::integral_constant<int, 1>;
    using I2 = std::integral_constant<int, 2>;
    using I4 = std::integral_constant<int, 4>;
    using I16 = std::integral_constant<int, 16>;
    if (R > 8) {
      if (N <= 4)
        run(I2{}, I16{}, I4{});  // B = 1: 8 accumulators a lane
      else
        run(I2{}, I16{}, I16{});
    } else {
      if (N <= 4)
        run(I1{}, I4{}, I4{});
      else
        run(I1{}, I4{}, I16{});
    }
    if (pi & 1)
      mark(PH_PROJ);
    else
      mark(PH_GATES);
    __syncthreads();
    mark(PH_WARP_SYNC);
  };
  // row r (of the block's product rows), hypothesis row n of the sum of
  // warps q0 .. q1-1's partial sums, in warp order
  auto red_sum = [&](int r, int n, int q0, int q1) {
    float z = 0.f;
    for (int q = q0; q < q1; ++q) z += red[((size_t)q * MAXR + r) * N + n];
    return z;
  };
  if constexpr (STREAM) {
    if (lane == 0) {
      for (int i = 0; i < slots; ++i) mbar_init(s.mbar + warp * slots + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
  }

  // ---- the beam starts from the wrapper's initial state, in set 0 ----
  {
    const HypSet& s0 = w.set[0];
    for (int i = tid; i < N * nq; i += NT) {
      const int n = i / nq;
      s0.tok[(size_t)n * L + q0 + (i - n * nq)] = 0;
    }
    for (int i = tid; i < N * np; i += NT) {
      const int n = i / np;
      const size_t o = (size_t)n * P + p0 + (i - n * np);
      s0.pred[o] = a.init_pred[o];
      for (int l = 0; l < d.nl; ++l) s0.h[l][o] = a.init_h[l][o];
    }
    for (int i = tid; i < N * nu; i += NT) {
      const int n = i / nu;
      const size_t o = (size_t)n * H + u0 + (i - n * nu);
      for (int l = 0; l < d.nl; ++l) s0.c[l][o] = a.init_c[l][o];
    }
    if (blk == 0)
      for (int n = tid; n < N; n += NT) {
        s0.score[n] = n % K == 0 ? 0.f : NEG;
        s0.len[n] = 0;
      }
  }
  int tmax = 0;  // frames past every utterance's length change nothing
  for (int b = 0; b < B; ++b) tmax = max(tmax, min(d.T, a.enc_len[b]));
  if constexpr (STREAM) {  // the first chunks, in flight from here on
    int per_exp = 0;
    for (int pi = 0; pi < nprod; ++pi) per_exp += chunks(prod(pi));
    total = per_exp * tmax * d.E;
    for (int i = 0; i < slots; ++i) issue();
  }
  grid_barrier(a.bar, target);
  mark(PH_BARRIER);

  int bs = 0;  // the set holding the beam
  for (int t = 0; t < tmax; ++t) {
    // ---- F0: fj of each utterance, then the beam's joint hidden ----
    for (int b0 = 0; b0 < B; b0 += BCH) {
      const int nb = min(BCH, B - b0);
      stage(xs, nb, P, [&](int bb, int k) {
        return to_float(a.enc[((size_t)t * B + b0 + bb) * P + k]);
      });
      block_dots_vec(xs, nb, P, a.w1, J, nj / VEC, j_col, red, out);
      for (int i = tid; i < nb * nj; i += NT) {
        const int bb = i / nj, c = i - bb * nj;
        s.fj[(b0 + bb) * jmax + c] =
            out[c * BCH + bb] + to_float(a.b1[j0 + c]);
      }
      __syncthreads();
    }
    joint_hidden(w.set[bs].pred, nullptr);
    barrier(PH_FJ_JOINT);
    // ---- F1 ----
    logits_phase();
    barrier(PH_LOGITS);
    row_lse();
    // settle the beam in place with its blank move (into ssc0)
    if (blk == 0)
      for (int n = tid; n < N; n += NT) {
        const float sc = __ldcg(w.set[bs].score + n);
        w.ssc0[n] = t < a.enc_len[n / K]
                        ? sc + (__ldcg(w.logits + (size_t)n * V) - s.lse[n])
                        : sc;
      }
    mark(PH_LSE);

    int xi = bs, si = bs;  // expanding and settled sets
    const float* ssc = w.ssc0;  // settled scores
    for (int e = 0; e < d.E; ++e) {
      const HypSet& X = w.set[xi];
      // ---- F2 ----
      label_candidates(X);
      barrier(PH_CANDIDATES);

      // ---- F3: the advanced set Y ----
      const int yi = (xi != 0 && si != 0) ? 0 : ((xi != 1 && si != 1) ? 1 : 2);
      const HypSet& Y = w.set[yi];
      choose_labels();
      const size_t sel = ((size_t)t * d.E + e) * 2;
      if (blk == 0)
        for (int n = tid; n < N; n += NT) {
          Y.score[n] = s.wsc[n];
          Y.len[n] = __ldcg(X.len + s.par[n]) + (s.wsc[n] > NEG / 2 ? 1 : 0);
        }
      trace(sel, [&](int n) { return (s.par[n] % K) * V + s.lab[n]; }, s.wsc);
      for (int i = tid; i < N * nq; i += NT) {
        const int n = i / nq, pos = q0 + (i - n * nq), p = s.par[n];
        const int slot = min(__ldcg(X.len + p), L - 1);
        Y.tok[(size_t)n * L + pos] =
            pos == slot ? s.lab[n] : __ldcg(X.tok + (size_t)p * L + pos);
      }
      mark(PH_CHOOSE);
      // prediction-net layers of the advanced set
      for (int l = 0; l < d.nl; ++l) {
        if constexpr (STREAM) {
          // the rows [x | h] of every hypothesis in bf16, zero-padded to
          // the packed k: x the label's embedding (layer 0) or the
          // LayerNorm of the last layer's h_new, h the parent's state
          const int kx = r16(l == 0 ? D : P), kh = r16(P);
          if (l == 0) {
            stage_rows(s.xb, xstr, N, kx, [&](int n, int k) {
              return k < D ? to_float(a.embed[(size_t)s.lab[n] * D + k]) : 0.f;
            });
          } else {
            for (int n0 = 0; n0 < N; n0 += BCH)
              stage_ln_xb(s.xb, xstr, kx, xs, s.stat, w.hnew, n0,
                          min(BCH, N - n0), P, a.ln_s[l - 1], a.ln_b[l - 1]);
          }
          stage_f32_rows(s.xb + kx, xstr, N, kh, P, aligned16(X.h[l]),
                         [&](int n) { return X.h[l] + (size_t)s.par[n] * P; });
          __syncthreads();
          mark(PH_STAGE);
          // thread n * nu + u owns unit u of row n (N nu <= 256 in the
          // plan): its parent's c and the bias, loaded before the products
          const int n = tid / max(nu, 1), u = tid - n * nu;
          const bool own = nu > 0 && n < N;
          float cpar = 0.f, bz[4] = {};
          if (own) {
            cpar = __ldcg(X.c[l] + (size_t)s.par[n] * H + u0 + u);
#pragma unroll
            for (int g = 0; g < 4; ++g)
              bz[g] = to_float(a.bias[l][g * H + u0 + u]);
          }
          products(2 * l);
          if (own) {
            float z[4];
#pragma unroll
            for (int g = 0; g < 4; ++g)  // (x @ Wx + h @ Wh) + bias
              z[g] = (red_sum(4 * u + g, n, 0, NWARP / 2) +
                      red_sum(4 * u + g, n, NWARP / 2, NWARP)) +
                     bz[g];
            const float c = sigmoid(z[2]) * cpar + sigmoid(z[0]) * tanhf(z[1]);
            Y.c[l][(size_t)n * H + u0 + u] = c;
            w.hid[(size_t)n * H + u0 + u] =
                round_to<W>(sigmoid(z[3]) * tanhf(c));
          }
          barrier(PH_CELL);
          if (np > 0) {  // block-uniform: blocks without Wp columns skip
            stage_f32_rows(s.xb, xstr, N, r16(H), H, aligned16(w.hid),
                           [&](int n) { return w.hid + (size_t)n * H; });
            __syncthreads();
            mark(PH_STAGE);
            products(2 * l + 1);
            for (int i = tid; i < N * np; i += NT) {
              const int n = i / np, c = i - n * np;
              const float hv = red_sum(c, n, 0, NWARP);
              const size_t o = (size_t)n * P + p0 + c;
              w.hnew[o] = hv;
              Y.h[l][o] = round_to<W>(hv);
            }
          }
          barrier(PH_CELL);
          continue;
        }
        // the FMA design: block_dots_vec over the weights in place
        const int din = l == 0 ? D : P;
        for (int n0 = 0; n0 < N; n0 += BCH) {
          const int nb = min(BCH, N - n0);
          if (l == 0) {
            stage(xs, nb, D, [&](int bb, int k) {
              return to_float(a.embed[(size_t)s.lab[n0 + bb] * D + k]);
            });
          } else {
            stage_ln(xs, s.stat, w.hnew, n0, nb, P, a.ln_s[l - 1],
                     a.ln_b[l - 1]);
          }
          stage(s.xs2, nb, P, [&](int bb, int k) {
            return __ldcg(X.h[l] + (size_t)s.par[n0 + bb] * P + k);
          });
          block_dots_vec(xs, nb, din, a.wx[l], H4, 4 * nu / VEC, gate_col,
                         red, out);
          block_dots_vec(s.xs2, nb, P, a.wh[l], H4, 4 * nu / VEC, gate_col,
                         red, out, true);
          for (int i = tid; i < nb * nu; i += NT) {
            const int bb = i / nu, u = i - bb * nu, n = n0 + bb;
            float z[4];
#pragma unroll
            for (int g = 0; g < 4; ++g)
              z[g] = out[(g * nu + u) * BCH + bb] +
                     to_float(a.bias[l][g * H + u0 + u]);
            const float c =
                sigmoid(z[2]) *
                    __ldcg(X.c[l] + (size_t)s.par[n] * H + u0 + u) +
                sigmoid(z[0]) * tanhf(z[1]);
            Y.c[l][(size_t)n * H + u0 + u] = c;
            w.hid[(size_t)n * H + u0 + u] =
                round_to<W>(sigmoid(z[3]) * tanhf(c));
          }
          __syncthreads();
        }
        barrier(PH_GATES);
        for (int n0 = 0; n0 < N; n0 += BCH) {
          const int nb = min(BCH, N - n0);
          stage(xs, nb, H, [&](int bb, int k) {
            return __ldcg(w.hid + (size_t)(n0 + bb) * H + k);
          });
          block_dots_vec(xs, nb, H, a.wp[l], P, np / VEC, p_col, red, out);
          for (int i = tid; i < nb * np; i += NT) {
            const int bb = i / np, c = i - bb * np;
            const size_t o = (size_t)(n0 + bb) * P + p0 + c;
            w.hnew[o] = out[c * BCH + bb];
            Y.h[l][o] = round_to<W>(out[c * BCH + bb]);
          }
          __syncthreads();
        }
        barrier(PH_PROJ);
      }

      // ---- F4: joint of the advanced set ----
      joint_hidden(nullptr, Y.pred);
      barrier(PH_JOINT);
      logits_phase();
      barrier(PH_LOGITS);
      row_lse();
      mark(PH_LSE);

      // ---- F5: blank settle, prefix merge, pool top-K, gather ----
      const HypSet& S = w.set[si];
      settle_merge_pool(S, ssc, Y, t);
      trace(sel + 1, [&](int n) { return s.zsrc[n]; }, s.zsc);
      mark(PH_MERGE);
      const int zi = (si != 0 && yi != 0) ? 0 : ((si != 1 && yi != 1) ? 1 : 2);
      const HypSet& Z = w.set[zi];
      auto src_set = [&](int n) -> const HypSet& {
        return s.zsrc[n] < K ? S : Y;
      };
      auto src_row = [&](int n) { return (n / K) * K + s.zsrc[n] % K; };
      if (blk == 0)
        for (int n = tid; n < N; n += NT) {
          Z.score[n] = s.zsc[n];
          Z.len[n] = s.zsrc[n] < K ? s.slen[src_row(n)] : s.ylen[src_row(n)];
        }
      for (int i = tid; i < N * nq; i += NT) {
        const int n = i / nq, pos = q0 + (i - n * nq);
        Z.tok[(size_t)n * L + pos] =
            __ldcg(src_set(n).tok + (size_t)src_row(n) * L + pos);
      }
      for (int i = tid; i < N * np; i += NT) {
        const int n = i / np, c = p0 + (i - n * np);
        const HypSet& sr = src_set(n);
        const size_t o = (size_t)src_row(n) * P + c;
        Z.pred[(size_t)n * P + c] = __ldcg(sr.pred + o);
        for (int l = 0; l < d.nl; ++l)
          Z.h[l][(size_t)n * P + c] = __ldcg(sr.h[l] + o);
      }
      for (int i = tid; i < N * nu; i += NT) {
        const int n = i / nu, u = u0 + (i - n * nu);
        const HypSet& sr = src_set(n);
        for (int l = 0; l < d.nl; ++l)
          Z.c[l][(size_t)n * H + u] =
              __ldcg(sr.c[l] + (size_t)src_row(n) * H + u);
      }
      xi = yi;
      si = zi;
      ssc = Z.score;
      mark(PH_GATHER);
    }
    bs = si;
    barrier(PH_GATHER);
  }

  if (blk == 0) {
    const HypSet& s0 = w.set[bs];
    for (int i = tid; i < B * L; i += NT) {
      const int b = i / L;
      a.tok_out[i] = __ldcg(s0.tok + (size_t)b * K * L + (i - b * L));
    }
    for (int b = tid; b < B; b += NT) a.len_out[b] = __ldcg(s0.len + b * K);
    for (int n = tid; n < N; n += NT) a.sc_out[n] = __ldcg(s0.score + n);
  }
  if (TIMED && tid == 0)
    for (int i = 0; i < N_PHASES; ++i)
      a.phase_ns[(size_t)blk * N_PHASES + i] += ph_ns[i];
}

// Grid size: one block per SM.
int grid_blocks(int* nblk) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(nblk, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

Dims dims_of(const int* v) {
  return Dims{v[0], v[1], v[2], v[3], v[4],  v[5],
              v[6], v[7], v[8], v[9], v[10], v[11]};
}

// The design of the last launch: 0 = FMA, 1 = the streamed advance.
int g_last_design = 0;

// dims[12] asks for the design (0 FMA, 1 streamed), dims[13] its ring slots
// a warp.  The wrapper's plan chose them (ops/beam_cuda.stream_plan); the
// launcher refuses a streamed launch that the card cannot take (fp32, a
// shape outside stream_shape_ok, missing packed slices, a ring past the
// shared memory) instead of running another design.
template <typename W>
int launch(void* const* ptrs, const int* dims, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  Args<W> a;
  a.d = dims_of(dims);
  if (a.d.nl < 1 || a.d.nl > MAXL || a.d.K < 1 || a.d.L < 1 || a.d.V < 2 ||
      a.d.H % SLICE || a.d.P % SLICE || a.d.J % SLICE || a.d.V % SLICE)
    return (int)cudaErrorInvalidValue;
  a.enc = (const W*)ptrs[0];
  a.enc_len = (const int*)ptrs[1];
  a.embed = (const W*)ptrs[2];
  a.w1 = (const W*)ptrs[3];
  a.b1 = (const W*)ptrs[4];
  a.w2 = (const W*)ptrs[5];
  a.b2 = (const W*)ptrs[6];
  a.init_pred = (const float*)ptrs[7];
  for (int l = 0; l < MAXL; ++l) {
    void* const* q = ptrs + 8 + 8 * l;
    a.wx[l] = (const W*)q[0];
    a.wh[l] = (const W*)q[1];
    a.bias[l] = (const W*)q[2];
    a.wp[l] = (const W*)q[3];
    a.ln_s[l] = (const W*)q[4];
    a.ln_b[l] = (const W*)q[5];
    a.init_c[l] = (const float*)q[6];
    a.init_h[l] = (const float*)q[7];
    a.pk_g[l] = (const __nv_bfloat16*)ptrs[48 + 2 * l];
    a.pk_p[l] = (const __nv_bfloat16*)ptrs[49 + 2 * l];
  }
  a.tok_out = (int*)ptrs[40];
  a.len_out = (int*)ptrs[41];
  a.sc_out = (float*)ptrs[42];
  a.ws = (float*)ptrs[43];
  a.bar = (unsigned int*)ptrs[44];
  a.phase_ns = (unsigned long long*)ptrs[45];
  a.tr_idx = (int*)ptrs[46];
  a.tr_val = (float*)ptrs[47];
  const bool streamed = dims[12] == 1;
  a.slots = streamed ? dims[13] : 0;

  int dev = 0, coop = 0, nblk = 0, per_sm = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const int ge = grid_blocks(&nblk);
  if (ge != 0) return ge;
  Smem sm;
  const size_t smem =
      carve_smem(nullptr, a.d, nblk, a.slots, &sm) * sizeof(float);
  const bool timed = a.phase_ns != nullptr;
  void (*kernel)(Args<W>) =
      timed ? beam_kernel<W, false, true> : beam_kernel<W, false, false>;
  if (streamed) {
    if constexpr (!std::is_same<W, __nv_bfloat16>::value) {
      return (int)cudaErrorInvalidValue;
    } else {
      bool ok = a.slots >= 1 && stream_shape_ok(a.d, nblk) &&
                smem <= (size_t)optin;
      for (int l = 0; l < a.d.nl; ++l)
        ok = ok && a.pk_g[l] != nullptr && a.pk_p[l] != nullptr &&
             ((size_t)a.pk_g[l] | (size_t)a.pk_p[l]) % 16 == 0;
      if (!ok) return (int)cudaErrorInvalidValue;
      kernel = timed ? beam_kernel<W, true, true> : beam_kernel<W, true, false>;
    }
  } else if (dims[12] != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaMemsetAsync(a.bar, 0, sizeof(unsigned int), stream);
  if (e != cudaSuccess) return (int)e;
  g_last_design = streamed ? 1 : 0;
  void* args[] = {&a};
  return launch_status(cudaLaunchCooperativeKernel(
      (void*)kernel, dim3(nblk), dim3(NT), args, smem, stream));
}

}  // namespace

// The design of this library's last launch: 0 = FMA, 1 = the streamed
// advance (chosen before the launch, never after a failed one).
extern "C" int beam_last_design() { return g_last_design; }

// Columns of a row of phase_ns: the phases of enum Phase.
extern "C" int beam_phase_count() { return N_PHASES; }

// The current device's SMs (the grid's blocks) and the shared memory a
// block may opt in to, into out[0] and out[1].  Returns a CUDA error code.
extern "C" int beam_card(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(out + 1,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// dims: B, T, K, L, E, merge, V, P, J, D, H, n_layers.  Writes the number of
// 4-byte workspace words the search needs on the current device to *words.
extern "C" int beam_workspace_words(const int* dims, long long* words) {
  int nblk = 0;
  const int e = grid_blocks(&nblk);
  if (e != 0) return e;
  Work w;
  *words = (long long)carve(nullptr, dims_of(dims), nblk, &w);
  return 0;
}

// ptrs (56): enc [T, B, P], enc_len [B] i32, embed [V, D], w1 [P, J],
// b1 [J], w2 [J, V], b2 [V], init_pred [N, P] f32; then for each of 4 layer
// slots (unused past n_layers): wx [Din, 4H], wh [P, 4H], bias [4H],
// wp [H, P], ln_scale [P], ln_bias [P], init_c [N, H] f32, init_h [N, P]
// f32; then tokens [B, L] i32, lengths [B] i32, scores [B, K] f32, the
// workspace, one uint32 barrier counter, null or a zeroed uint64
// [grid blocks, N_PHASES] to which each block adds its nanoseconds in each
// phase (Phase; the grid is one block per SM), and
// null or the trace's int32 picks and fp32 scores, [T * E * 2, B, K] each;
// then for each of the 4 layer slots the packed gate and Wp slices of the
// streamed advance (bf16, 16-byte aligned; null for the FMA design).
// Weights in the kernel's type.  dims (14): as beam_workspace_words', then
// the design (0 FMA, 1 streamed) and the streamed design's ring slots a
// warp.  Returns a CUDA error code (0 = launched).
extern "C" int beam_search_f32(void* const* ptrs, const int* dims,
                               void* stream) {
  return launch<float>(ptrs, dims, stream);
}

extern "C" int beam_search_bf16(void* const* ptrs, const int* dims,
                                void* stream) {
  return launch<__nv_bfloat16>(ptrs, dims, stream);
}
