// RNN-T lattice kernel for Hopper (sm_90a): alpha, beta and the total
// log-likelihood from the blank/emit coefficient planes.
//
// Replaces rnnt_tpu/ops/rnnt_loss_pallas.py::_lattice_kernel (launched by
// lattice_scan_pallas).  For one batch row with planes b, e [T, U+1]:
//   alpha[t,u] = logaddexp(alpha[t-1,u] + b[t-1,u], alpha[t,u-1] + e[t,u-1])
//   beta[t,u]  = logaddexp(b[t,u] + beta[t+1,u], e[t,u] + beta[t,u+1])
// with alpha[0,0] = 0, the row below t = T_b - 1 replaced by the terminal row
// (0 at u = U_b, log 0 elsewhere), and ll = beta[0,0].  log 0 is -1e30 and
// logaddexp stays finite at NEG + NEG.
//
// Bound on the H100: the planes are read once and alpha/beta written once,
// 4 x B x T x (U+1) x 4 bytes (4.3 MB at B=32, T'=128, U+1=65: 1.3 us at
// 3.35 TB/s); the work is ~10 operations a cell and direction.  The real
// limit is the chain of T dependent rows a direction, each a linear
// recurrence in the log semiring along u: x[j] = c[j] (+) (w[j] (x) x[j-1])
// (x[j+1] for beta), (+) = logaddexp, (x) = +.
//
// Two designs.  Each row is solved in three parts: every thread folds its
// run of q consecutive positions, in scan order, into one (c, w) composite;
// a doubling scan runs over the composites (the TPU kernel's order of
// combination); then each position of the run is found from the value
// before the run (the previous thread's scanned value).  The run's last
// position in scan order takes the scanned value itself.  At q = 1 the fold
// and the walk are empty and the order of combination is the TPU kernel's
// (and the reference scans'), so the two agree to rounding; at q > 1 a run
// is combined sequentially.
//
// warp (U+1 <= 32 x WARP_Q_MAX = 256, every driven path): one warp a (batch
// row, direction), 2B single-warp blocks, so alpha and beta run side by side
// and the serial chain is T rows, not 2T.  Lane l owns positions l q ..
// l q + q - 1, q = ceil((U+1) / 32), and keeps the fold's prefix composites,
// so the walk is q - 1 independent logaddexps from the previous lane's value;
// the scan over the 32 composites is five __shfl_up_sync (alpha) or
// __shfl_down_sync (beta) steps, with no shared memory and no barrier.  The
// previous row stays in registers (q values a lane), so nothing is read back
// from alpha or beta on the chain; their rows are stored and never waited
// on.  Each lane copies the b, e values of its own positions PF - 1 = 7 rows
// ahead into a ring in shared memory (4-byte cp.async, one group a row), so
// the loads are off the chain.  The kernel is instantiated at each q from 1
// to 8, so a run is straight-line code.  A row's chain is q - 1 + 5 + 1
// logaddexps and six shuffle rounds, so the warp design works in base 2
// (inputs scaled by log2 e as they are read, outputs by ln 2 as they are
// written) on the MUFU's approximate exp2 and log2: each logaddexp is six
// dependent operations and adds an absolute error below 1e-6, against
// values of 1e2 - 1e3 here.

// block (U+1 > 256): one block per batch row, the next power of two >= U+1
// threads (at most 1024), runs of ceil((U+1) / block) positions a thread,
// the doubling scan through shared memory (log2 of the block steps, two
// barriers each); alpha and then beta in one launch.

#include "common.cuh"

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// x[u] = logaddexp(c[u], w[u] + x[u - DIR]) over the block's lanes (x of a
// lane outside the block is log 0).  Doubling: each step folds in the lanes
// s further away, whose (c, w) are exchanged through cs, ws.
template <int DIR>
__device__ float row_scan(float c, float w, float* cs, float* ws) {
  const int n = blockDim.x, u = threadIdx.x;
  for (int s = 1; s < n; s *= 2) {
    cs[u] = c;
    ws[u] = w;
    __syncthreads();
    const int src = u - DIR * s;
    const bool in = src >= 0 && src < n;
    const float cp = in ? cs[src] : NEG;
    const float wp = in ? ws[src] : 0.f;
    __syncthreads();
    c = logaddexp(c, w + cp);
    w += wp;
  }
  return c;
}

// The value before this thread's run in scan order: the scanned value x of
// the previous thread (log 0 for the first).
template <int DIR>
__device__ float run_prefix(float x, float* cs) {
  const int n = blockDim.x, u = threadIdx.x;
  cs[u] = x;
  __syncthreads();
  const int src = u - DIR;
  const float p = src >= 0 && src < n ? cs[src] : NEG;
  __syncthreads();
  return p;
}

// One row of a direction: fold the run's q positions (k-th in scan order,
// coefficients from cw(k, c, w)) into one composite, scan the composites,
// and, for q > 1, walk the run to store all but its last position through
// put(k, x).  Returns the scanned value of the run's last position.
template <int DIR, typename CW, typename Put>
__device__ float solve_row(int q, CW cw, Put put, float* cs, float* ws) {
  float c, w;
  cw(0, c, w);
  for (int k = 1; k < q; ++k) {
    float ck, wk;
    cw(k, ck, wk);
    c = logaddexp(ck, wk + c);
    w += wk;
  }
  const float last = row_scan<DIR>(c, w, cs, ws);
  if (q > 1) {
    float x = run_prefix<DIR>(last, cs);
    for (int k = 0; k < q - 1; ++k) {
      float ck, wk;
      cw(k, ck, wk);
      x = logaddexp(ck, wk + x);
      put(k, x);
    }
  }
  return last;
}

// RUNS = false is the U+1 <= block case (q = 1), compiled without the runs'
// code so that it runs as fast as one position a thread always did.
template <bool RUNS>
__global__ void lattice_kernel(const float* __restrict__ b,  // [B, T, U1]
                               const float* __restrict__ e,  // [B, T, U1]
                               const int* __restrict__ fl,   // [B]
                               const int* __restrict__ yl,   // [B]
                               float* __restrict__ alpha,    // [B, T, U1]
                               float* __restrict__ beta,     // [B, T, U1]
                               float* __restrict__ ll,       // [B]
                               int T, int U1) {
  extern __shared__ float smem[];
  float* cs = smem;
  float* ws = smem + blockDim.x;
  const int q = RUNS ? (U1 + blockDim.x - 1) / blockDim.x : 1;
  const int j0 = threadIdx.x * q;  // the run: positions j0 .. j0 + q - 1
  const size_t row = (size_t)blockIdx.x * T * U1;

  // alpha: row t from row t-1 and the label steps e[t, j-1]; scan order is
  // j0 + k, the run's last position j0 + q - 1 is carried in `a`
  float a = NEG;
  for (int t = 0; t < T; ++t) {
    const size_t off = row + (size_t)t * U1;
    auto cw = [&](int k, float& c, float& w) {
      const int j = j0 + k;
      const bool lane = j < U1;
      if (t == 0)
        c = j == 0 ? 0.f : NEG;
      else
        c = (k == q - 1 ? a : lane ? alpha[off - U1 + j] : NEG) +
            (lane ? b[off - U1 + j] : NEG);
      w = (j >= 1 && j <= U1) ? e[off + j - 1] : NEG;
    };
    auto put = [&](int k, float x) {
      if (j0 + k < U1) alpha[off + j0 + k] = x;
    };
    a = solve_row<1>(q, cw, put, cs, ws);
    if (j0 + q - 1 < U1) alpha[off + j0 + q - 1] = a;
  }

  // beta: walked back from t = T-1, the terminal row injected at T_b - 1;
  // scan order is j0 + q - 1 - k, the run's first position j0 is carried
  // in `x`
  const int last = fl[blockIdx.x] - 1, yb = yl[blockIdx.x];
  float x = NEG;
  for (int t = T - 1; t >= 0; --t) {
    const size_t off = row + (size_t)t * U1;
    auto cw = [&](int k, float& c, float& w) {
      const int j = j0 + q - 1 - k;
      const bool lane = j < U1;
      float below;  // beta[t+1, j], or the terminal row
      if (t == last)
        below = j == yb ? 0.f : NEG;
      else if (k == q - 1)
        below = x;
      else
        below = t < T - 1 && lane ? beta[off + U1 + j] : NEG;
      c = (lane ? b[off + j] : NEG) + below;
      w = lane ? e[off + j] : NEG;
    };
    auto put = [&](int k, float v) {
      if (j0 + q - 1 - k < U1) beta[off + j0 + q - 1 - k] = v;
    };
    x = solve_row<-1>(q, cw, put, cs, ws);
    if (j0 < U1) beta[off + j0] = x;
  }
  if (threadIdx.x == 0) ll[blockIdx.x] = x;
}


// ---- the warp design ----

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_Q_MAX = 8;  // positions a lane: U+1 <= 256
constexpr int PF = 8;          // ring slots: b, e of PF - 1 rows ahead
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// logaddexp in base 2 (values scaled by log2 e): max + log2(1 + 2^-|a-b|)
// on the MUFU's approximate exp2 and log2, six dependent operations.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lae2(float a, float b) {
  return fmaxf(a, b) + lg2(1.f + ex2(-fabsf(a - b)));
}

// One row of a direction in the warp design.  c, w hold the lane's run in
// scan order (k = 0 .. Q-1).  The run is folded into the composites of its
// prefixes, (Cf[k], Wf[k]) for positions 0..k; the run's composites are
// scanned across the warp (DIR = 1: from lane 0 up; DIR = -1: from lane 31
// down); then every position k < Q-1 is Cf[k] (+) (Wf[k] (x) v), v the
// previous lane's scanned value, all at once, and the last is the scanned
// value itself.  x receives the run's values in scan order; returns the
// scanned value of its last position.
template <int DIR, int Q>
__device__ __forceinline__ float warp_row(const float (&c)[Q],
                                          const float (&w)[Q], float (&x)[Q]) {
  const int lane = threadIdx.x;
  float Cf[Q], Wf[Q];
  Cf[0] = c[0];
  Wf[0] = w[0];
#pragma unroll
  for (int k = 1; k < Q; ++k) {
    Cf[k] = lae2(c[k], w[k] + Cf[k - 1]);
    Wf[k] = Wf[k - 1] + w[k];
  }
  float C = Cf[Q - 1], W = Wf[Q - 1];
#pragma unroll
  for (int s = 1; s < 32; s *= 2) {
    const float cp = DIR > 0 ? __shfl_up_sync(FULL, C, s)
                             : __shfl_down_sync(FULL, C, s);
    const float wp = DIR > 0 ? __shfl_up_sync(FULL, W, s)
                             : __shfl_down_sync(FULL, W, s);
    if (DIR > 0 ? lane >= s : lane + s < 32) {
      C = lae2(C, W + cp);
      W += wp;
    }
  }
  float v = DIR > 0 ? __shfl_up_sync(FULL, C, 1) : __shfl_down_sync(FULL, C, 1);
  if (lane == (DIR > 0 ? 0 : 31)) v = NEG;
#pragma unroll
  for (int k = 0; k < Q - 1; ++k) x[k] = lae2(Cf[k], Wf[k] + v);
  x[Q - 1] = C;
  return C;
}

// One direction of one batch row, a warp: DIR = 1 alpha, DIR = -1 beta (and
// ll).  Lane l's run is positions j0 = l Q .. j0 + Q - 1; in scan order k
// alpha takes them upwards (j = j0 + k) and beta downwards (j = j0 + Q-1-k).
// Step i solves row t = i (alpha) or T - 1 - i (beta).  Each lane copies
// the b, e values of its own positions PF - 1 steps ahead into a ring in
// shared memory (cp.async, one group a step) and reads back only its own,
// so no barrier is needed.
template <int DIR, int Q>
__device__ __forceinline__ void walk(const float* __restrict__ b,
                                     const float* __restrict__ e, int last,
                                     int yb, float* __restrict__ out,
                                     float* __restrict__ ll, int T, int U1,
                                     float (&ring)[PF][2][Q][32]) {
  const int lane = threadIdx.x, j0 = lane * Q;
  auto pos = [&](int k) { return DIR > 0 ? j0 + k : j0 + Q - 1 - k; };
  // alpha's row t takes b[t-1, j] and e[t, j-1]; beta's b[t, j], e[t, j]
  auto issue = [&](int i) {
    const int t = DIR > 0 ? i : T - 1 - i, slot = i % PF;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int j = pos(k);
      const bool in = i < T && j < U1;
      const bool bin = in && (DIR < 0 || t >= 1);
      const bool ein = in && (DIR < 0 || j >= 1);
      cp_async_ca<4>(&ring[slot][0][k][lane],
                     bin ? b + (size_t)(DIR > 0 ? t - 1 : t) * U1 + j : b,
                     bin);
      cp_async_ca<4>(&ring[slot][1][k][lane],
                     ein ? e + (size_t)t * U1 + (DIR > 0 ? j - 1 : j) : e,
                     ein);
    }
    cp_async_commit();
  };
  float prev[Q], c[Q], w[Q], x = NEG;  // prev: the row before, scan order
#pragma unroll
  for (int k = 0; k < Q; ++k) prev[k] = NEG;
  for (int i = 0; i < PF - 1; ++i) issue(i);
  for (int i = 0; i < T; ++i) {
    issue(i + PF - 1);  // into the slot read at step i - 1
    cp_async_wait<PF - 1>();
    const int t = DIR > 0 ? i : T - 1 - i, slot = i % PF;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int j = pos(k);
      const bool in = j < U1;
      const float bv = in ? LOG2E * ring[slot][0][k][lane] : NEG;
      w[k] = in && (DIR < 0 || j >= 1) ? LOG2E * ring[slot][1][k][lane] : NEG;
      if (DIR > 0)
        c[k] = t == 0 ? (j == 0 ? 0.f : NEG) : prev[k] + bv;
      else
        c[k] = bv + (t == last ? (j == yb ? 0.f : NEG)
                     : t < T - 1 ? prev[k] : NEG);
    }
    x = warp_row<DIR>(c, w, prev);
    float* row = out + (size_t)t * U1;
#pragma unroll
    for (int k = 0; k < Q; ++k)
      if (pos(k) < U1) row[pos(k)] = LN2 * prev[k];
  }
  cp_async_wait<0>();
  if (DIR < 0 && lane == 0) *ll = LN2 * x;  // beta[0, 0]: lane 0's last
}

// Block 2r walks alpha of batch row r, block 2r + 1 its beta and ll.
template <int Q>
__global__ void __launch_bounds__(32)
    lattice_warp_kernel(const float* __restrict__ b,  // [B, T, U1]
                        const float* __restrict__ e,  // [B, T, U1]
                        const int* __restrict__ fl,   // [B]
                        const int* __restrict__ yl,   // [B]
                        float* __restrict__ alpha,    // [B, T, U1]
                        float* __restrict__ beta,     // [B, T, U1]
                        float* __restrict__ ll,       // [B]
                        int T, int U1) {
  __shared__ float ring[PF][2][Q][32];  // b, e by slot, scan order, lane
  const int r = blockIdx.x >> 1;
  const size_t base = (size_t)r * T * U1;
  if ((blockIdx.x & 1) == 0)
    walk<1, Q>(b + base, e + base, -1, 0, alpha + base, nullptr, T, U1, ring);
  else
    walk<-1, Q>(b + base, e + base, fl[r] - 1, yl[r], beta + base, ll + r, T,
                U1, ring);
}

int last_design = -1;  // 0 warp, 1 block: the design of the last launch

}  // namespace

// b, e, alpha, beta [B, T, U1] f32 contiguous; fl, yl [B] int32; ll [B] f32.
// Returns a CUDA error code (0 = launched).
extern "C" int rnnt_lattice(const float* b, const float* e, const int* fl,
                            const int* yl, float* alpha, float* beta,
                            float* ll, int B, int T, int U1, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (U1 <= 32 * WARP_Q_MAX) {
    void (*const kernels[])(const float*, const float*, const int*,
                            const int*, float*, float*, float*, int, int) = {
        lattice_warp_kernel<1>, lattice_warp_kernel<2>, lattice_warp_kernel<3>,
        lattice_warp_kernel<4>, lattice_warp_kernel<5>, lattice_warp_kernel<6>,
        lattice_warp_kernel<7>, lattice_warp_kernel<8>};
    auto kernel = kernels[(U1 + 31) / 32 - 1];
    kernel<<<2 * B, 32, 0, s>>>(b, e, fl, yl, alpha, beta, ll, T, U1);
    last_design = 0;
  } else {
    int n = 32;
    while (n < U1 && n < 1024) n *= 2;
    auto kernel = U1 > n ? lattice_kernel<true> : lattice_kernel<false>;
    kernel<<<B, n, 2 * n * sizeof(float), s>>>(b, e, fl, yl, alpha, beta, ll,
                                               T, U1);
    last_design = 1;
  }
  return launch_status(cudaSuccess);
}

// The design of the last launch: 0 warp, 1 block.
extern "C" int lattice_last_design() { return last_design; }
