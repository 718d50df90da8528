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
// limit is the chain of 2T dependent rows.
//
// Design: one block per batch row.  The block is the next power of two >=
// U+1 (at least 32 threads, at most 1024), and each thread owns a run of
// q = ceil((U+1) / block) consecutive label positions (q = 1 up to U+1 =
// 1024).  Each time row is a linear recurrence in the log semiring along u,
// solved in three parts: each thread folds its run, in scan order, into one
// (c, w) composite; the same doubling scan as the TPU kernel runs over the
// composites (log2 of the block steps, the two operands exchanged through
// shared memory); then, for q > 1, each thread walks its run again from the
// value before it (the previous thread's scanned value) to write every
// position.  The run's last position in scan order takes the scanned value
// itself and is carried in a register to the next row; the others are read
// back from the row this thread wrote.  At q = 1 the fold and the walk are
// empty and the order of combination is the TPU kernel's (and the reference
// scans'), so the two agree to rounding; at q > 1 a run is combined
// sequentially.  A doubling scan needs T x log2(block) barriers of cheap
// work where an anti-diagonal wavefront needs T + U dependent steps with one
// barrier each.  alpha and beta are walked in one launch, one after the
// other.  Shared memory is two floats a thread, whatever U+1 is.

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

}  // namespace

// b, e, alpha, beta [B, T, U1] f32 contiguous; fl, yl [B] int32; ll [B] f32.
// Returns a CUDA error code (0 = launched).
extern "C" int rnnt_lattice(const float* b, const float* e, const int* fl,
                            const int* yl, float* alpha, float* beta,
                            float* ll, int B, int T, int U1, void* stream) {
  int n = 32;
  while (n < U1 && n < 1024) n *= 2;
  auto kernel = U1 > n ? lattice_kernel<true> : lattice_kernel<false>;
  kernel<<<B, n, 2 * n * sizeof(float), (cudaStream_t)stream>>>(
      b, e, fl, yl, alpha, beta, ll, T, U1);
  return launch_status(cudaSuccess);
}
