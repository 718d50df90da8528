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
// Design: one block per batch row, one thread per label position (the block
// is the next power of two >= U+1, at least 32 threads).  Each time row is a
// linear recurrence in the log semiring along u; it is solved by the same
// doubling scan as the TPU kernel (log2 of the block steps, the two operands
// exchanged through shared memory), not an anti-diagonal wavefront: a
// wavefront needs T + U dependent steps with one barrier each, where the row
// scan needs T x log2(U+1) barriers of cheap work, and it keeps the TPU
// kernel's (and the reference scans') order of combination, so the two agree
// to rounding.  alpha and beta are walked in one launch, one after the other.

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
  const int u = threadIdx.x;
  const bool lane = u < U1;
  const size_t row = (size_t)blockIdx.x * T * U1;

  // alpha: row t from row t-1 and the label steps e[t, u-1]
  float a = NEG;
  for (int t = 0; t < T; ++t) {
    const size_t off = row + (size_t)t * U1;
    float c;
    if (t == 0)
      c = u == 0 ? 0.f : NEG;
    else
      c = a + (lane ? b[off - U1 + u] : NEG);
    const float w = (u >= 1 && u <= U1) ? e[off + u - 1] : NEG;
    a = row_scan<1>(c, w, cs, ws);
    if (lane) alpha[off + u] = a;
  }

  // beta: walked back from t = T-1, the terminal row injected at T_b - 1
  const int last = fl[blockIdx.x] - 1;
  const float term = u == yl[blockIdx.x] ? 0.f : NEG;
  float x = NEG;
  for (int t = T - 1; t >= 0; --t) {
    const size_t off = row + (size_t)t * U1;
    if (t == last) x = term;
    const float c = (lane ? b[off + u] : NEG) + x;
    const float w = lane ? e[off + u] : NEG;
    x = row_scan<-1>(c, w, cs, ws);
    if (lane) beta[off + u] = x;
  }
  if (u == 0) ll[blockIdx.x] = x;
}

}  // namespace

// b, e, alpha, beta [B, T, U1] f32 contiguous; fl, yl [B] int32; ll [B] f32.
// Returns a CUDA error code (0 = launched).
extern "C" int rnnt_lattice(const float* b, const float* e, const int* fl,
                            const int* yl, float* alpha, float* beta,
                            float* ll, int B, int T, int U1, void* stream) {
  int n = 32;
  while (n < U1) n *= 2;
  if (n > 1024) return (int)cudaErrorInvalidValue;
  lattice_kernel<<<B, n, 2 * n * sizeof(float), (cudaStream_t)stream>>>(
      b, e, fl, yl, alpha, beta, ll, T, U1);
  return launch_status(cudaSuccess);
}
