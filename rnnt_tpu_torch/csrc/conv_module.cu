// The Conformer's convolution module between its two pointwise products,
// for Hopper (sm_90a): kernels K10 (forward) and K11 (backward).
//
// They replace no TPU kernel: the JAX package has no Conformer.  They take
// the place of the port's plain chain in models/conformer.py's ConvModule
// (GLU, the padding mask, a transposed and padded copy, PyTorch's native
// depthwise Conv1d kernels, the masked BatchNorm in fp32 passes, Swish, and
// each of these again in autograd's backward).  The module routes to them
// for bf16 CUDA tensors whose BatchNorm statistics are the rank's own
// (ops/conv_module_cuda.py `fits`, which raises for a bf16 CUDA module the
// kernels do not take: D not a multiple of CT, K > KMAX, or eval with a
// gradient asked for); `conv_module_launches_by_path` in
// models/conformer.py counts the calls.  Layout [B, T, C], channels
// contiguous, no transposes.  u = pw1's output [B, T, 2D] bf16; a = u[:,
// :D] sigma(u[:, D:]), zero at padded frames (valid[b, t] == 0) and outside [0, T);
// y[t] = bias + sum_k w[k] a[t + k - (K - 1) / 2] (K / 2 frames of zeros
// after, (K - 1) / 2 before); BatchNorm over the valid frames; s = silu(z),
// z = y A + Bs with A = gamma / sqrt(var + eps), Bs = beta - mean A.
//
// K10, training: conv_fwd_kernel (a block = CT channels of one utterance's
//   chunk of TPC tiles of TT frames: GLU and mask computed once a frame into
//   a ring of fp32 rows in shared memory with the kernel's halo, the K taps
//   and the bias in fp32, y stored once in bf16, and the block's partial
//   sums of y and y^2 over its valid frames), bn_stats_kernel (those
//   partials summed in a fixed order into mean, E[y^2] - mean^2, the affine
//   map and the updated running statistics), bn_swish_kernel (s from y, one
//   pass).  Eval: conv_fwd_kernel<true> takes the running statistics and
//   writes s directly.
// K11: bwd_sums_kernel (dz = ds silu'(z) recomputed from y; partial sums of
//   dz and dz yhat over every frame), bwd_reduce_kernel (dgamma, dbeta and
//   the coefficients of dy = P dz - m (Q + yhat R)), conv_bwd_kernel (per
//   chunk, rings of dy and a with their halos recomputed from ds, y and u;
//   da[t] = sum_k w[k] dy[t - k + (K - 1) / 2]; GLU's backward and the mask
//   into du [B, T, 2D] bf16; dW and db as the block's partial sums),
//   dw_reduce_kernel (those partials summed in a fixed order, in bf16).
// The taps and dW's frames run in unrolled groups of TG = 8 (weights zero
// past K, rings of TT + KMAX - 1 rows zero past TT + K - 1), so that a group
// reads each ring row once into registers: the instructions the blocks
// execute, not the bytes, hold the kernels above their bound below.
// Every value between a load and a store is fp32; y, s and du are rounded
// to bf16 where the plain chain rounds them.  No fp32 [B, T, D] tensor is
// written.  Determinism: no float atomics; every sum has a fixed order
// (warps in order within a block, then the blocks' partial rows in order).
//
// Bound on the H100: bytes.  At B=64, T=400, D=512, K=32 the module's
// depthwise taps are 0.84 GFLOP forward (fp32 FMAs, ~13 us at 67 TFLOP/s),
// while K10 reads u (4 B a value of a), writes and reads y and writes s
// (10 B in all) and K11 reads ds and y twice, u once and writes du (16 B):
// 341 MB a call, ~0.10 ms at 3.35 TB/s.

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

// (ops/conv_module_cuda.py's CT, TT, TPC, KMAX)
constexpr int CT = 64;               // channels a block
constexpr int CP = CT / 2;           // channel pairs: a warp's lanes
constexpr int TT = 64;               // frames a tile
constexpr int TPC = 4;               // tiles a chunk (a block's frames)
constexpr int CHUNK = TT * TPC;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FPW = TT / WARPS;      // frames a warp computes in a tile
constexpr int KMAX = 32;             // the longest kernel
constexpr int RING = TT + KMAX - 1;  // rows of a ring (frames and halo)
constexpr int KPT = KMAX / WARPS;    // dW's taps a warp in conv_bwd_kernel
constexpr int ROWGROUPS = THREADS / (CT / 8);  // bwd_sums_kernel's rows
constexpr float MOMENTUM = 0.99f;    // models.lstm.BatchNorm's

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const bf162* h = reinterpret_cast<const bf162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  bf162* h = reinterpret_cast<bf162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float silu(float z) { return z / (1.f + expf(-z)); }

// silu'(z) = sigma(z) (1 + z (1 - sigma(z))), as PyTorch's silu_backward.
__device__ __forceinline__ float dsilu(float z) {
  const float sg = sigmoid(z);
  return sg * (1.f + z * (1.f - sg));
}

// Rows [r0, r1) of a ring whose row r is frame tbase + r: GLU of u at the
// block's CT channels in fp32, zero at padded frames and outside [0, T).
__device__ void load_glu_rows(float* ring, const bf16* __restrict__ u,
                              const unsigned char* __restrict__ valid, int b,
                              int T, int D, int c0, int tbase, int r0,
                              int r1) {
  constexpr int V = CT / 8;  // 16-byte vectors a row and half
  const int n = (r1 - r0) * V;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = r0 + i / V, j = i % V;
    const int t = tbase + r;
    float a[8];
    if (t >= 0 && t < T && valid[(size_t)b * T + t]) {
      const bf16* row = u + ((size_t)b * T + t) * 2 * D + c0 + 8 * j;
      float x1[8], x2[8];
      unpack8(load16(row), x1);
      unpack8(load16(row + D), x2);
#pragma unroll
      for (int q = 0; q < 8; ++q) a[q] = x1[q] * sigmoid(x2[q]);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) a[q] = 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(ring + r * CT + 8 * j);
    dst[0] = make_float4(a[0], a[1], a[2], a[3]);
    dst[1] = make_float4(a[4], a[5], a[6], a[7]);
  }
}

// Moves a ring's last K - 1 rows to its first (K - 1 <= TT: the two ranges
// do not overlap).  Between two barriers.
__device__ void shift_rows(float* ring, int K) {
  float4* r4 = reinterpret_cast<float4*>(ring);
  const int n = (K - 1) * CT / 4;
  for (int i = threadIdx.x; i < n; i += THREADS) r4[i] = r4[i + TT * CT / 4];
}

// The taps in groups of TG: a kernel of K taps runs KP = K rounded up to
// TG, its weights zero past K and its rings' rows past TT + K - 1 zero.
constexpr int TG = 8;
__host__ __device__ constexpr int padded(int K) { return (K + TG - 1) / TG * TG; }

// acc[f] += sum_k w_s[k] ring[i0 + f + k] over one channel pair (cp), f <
// FPW, k < KP in order: a group of TG taps reads FPW + TG - 1 rows once.
__device__ __forceinline__ void taps(const float2* ring, const float2* w2,
                                     int KP, int i0, int cp,
                                     float2 (&acc)[FPW]) {
  for (int k0 = 0; k0 < KP; k0 += TG) {
    float2 win[FPW + TG - 1];
#pragma unroll
    for (int f = 0; f < FPW + TG - 1; ++f) win[f] = ring[(i0 + k0 + f) * CP + cp];
#pragma unroll
    for (int k = 0; k < TG; ++k) {
      const float2 wk = w2[(k0 + k) * CP + cp];
#pragma unroll
      for (int f = 0; f < FPW; ++f) {
        acc[f].x = fmaf(wk.x, win[f + k].x, acc[f].x);
        acc[f].y = fmaf(wk.y, win[f + k].y, acc[f].y);
      }
    }
  }
}

// w [D, K] bf16 -> w_s [KP, CT] fp32 (tap-major) for the block's channels,
// taps reversed if REV, zero past K.
template <bool REV>
__device__ void load_taps(float* w_s, const bf16* __restrict__ w, int c0,
                          int K) {
  const int KP = padded(K);
  for (int i = threadIdx.x; i < KP * CT; i += THREADS) {
    const int k = i / CT, c = i % CT;
    w_s[i] = k < K ? __bfloat162float(w[(size_t)(c0 + c) * K + (REV ? K - 1 - k : k)]) : 0.f;
  }
}

// Zeroes a ring's rows [TT + K - 1, RING).
__device__ void zero_pad_rows(float* ring, int K) {
  const int n = (KMAX - K) * CT;
  for (int i = threadIdx.x; i < n; i += THREADS) ring[(TT + K - 1) * CT + i] = 0.f;
}

constexpr size_t FWD_SMEM =
    sizeof(float) * (RING * CT + KMAX * CT) + sizeof(float4) * WARPS * CP;
static_assert(FWD_SMEM <= 48 * 1024, "conv_fwd_kernel's shared memory");

// K10's first pass (EVAL = false) or its eval form (EVAL = true: s from
// the running statistics, no sums).  Grid (chunks, D / CT, B).  part
// [B * chunks, 2, D]: the block's sums of y and y^2 over its valid frames.
template <bool EVAL>
__global__ void __launch_bounds__(THREADS)
    conv_fwd_kernel(const bf16* __restrict__ u,
                    const unsigned char* __restrict__ valid,
                    const bf16* __restrict__ w, const bf16* __restrict__ bias,
                    const bf16* __restrict__ gamma,
                    const bf16* __restrict__ beta,
                    const float* __restrict__ rmean,
                    const float* __restrict__ rvar, float eps,
                    bf16* __restrict__ out, float* __restrict__ part, int T,
                    int D, int K) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* w_s = ring + RING * CT;
  float4* red = reinterpret_cast<float4*>(w_s + KMAX * CT);
  const int chunk = blockIdx.x, c0 = blockIdx.y * CT, b = blockIdx.z;
  const int cp = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = c0 + 2 * cp, PL = (K - 1) / 2;
  load_taps<false>(w_s, w, c0, K);
  zero_pad_rows(ring, K);
  const float2 bia = __bfloat1622float2(*reinterpret_cast<const bf162*>(bias + c));
  float2 A = {0.f, 0.f}, Bs = {0.f, 0.f};
  if (EVAL) {
    const float2 g = __bfloat1622float2(*reinterpret_cast<const bf162*>(gamma + c));
    const float2 be = __bfloat1622float2(*reinterpret_cast<const bf162*>(beta + c));
    A.x = rsqrtf(rvar[c] + eps) * g.x;
    A.y = rsqrtf(rvar[c + 1] + eps) * g.y;
    Bs.x = be.x - rmean[c] * A.x;
    Bs.y = be.y - rmean[c + 1] * A.y;
  }
  const float2* ring2 = reinterpret_cast<const float2*>(ring);
  const float2* w2 = reinterpret_cast<const float2*>(w_s);
  float2 sx = {0.f, 0.f}, sxx = {0.f, 0.f};
  const int tc0 = chunk * CHUNK;
  const int tiles = min(TPC, (T - tc0 + TT - 1) / TT);
  for (int tile = 0; tile < tiles; ++tile) {
    const int t0 = tc0 + tile * TT;
    if (tile == 0) {
      load_glu_rows(ring, u, valid, b, T, D, c0, t0 - PL, 0, TT + K - 1);
    } else {
      __syncthreads();
      shift_rows(ring, K);
      __syncthreads();
      load_glu_rows(ring, u, valid, b, T, D, c0, t0 - PL, K - 1, TT + K - 1);
    }
    __syncthreads();
    float2 acc[FPW];
#pragma unroll
    for (int f = 0; f < FPW; ++f) acc[f] = bia;
    taps(ring2, w2, padded(K), warp * FPW, cp, acc);
#pragma unroll
    for (int f = 0; f < FPW; ++f) {
      const int t = t0 + warp * FPW + f;
      if (t >= T) break;
      const size_t off = ((size_t)b * T + t) * D + c;
      const bf162 yb = __floats2bfloat162_rn(acc[f].x, acc[f].y);
      const float2 yr = __bfloat1622float2(yb);
      if (EVAL) {
        *reinterpret_cast<bf162*>(out + off) = __floats2bfloat162_rn(
            silu(fmaf(yr.x, A.x, Bs.x)), silu(fmaf(yr.y, A.y, Bs.y)));
      } else {
        *reinterpret_cast<bf162*>(out + off) = yb;
        if (valid[(size_t)b * T + t]) {
          sx.x += yr.x;
          sx.y += yr.y;
          sxx.x = fmaf(yr.x, yr.x, sxx.x);
          sxx.y = fmaf(yr.y, yr.y, sxx.y);
        }
      }
    }
  }
  if (EVAL) return;
  red[warp * CP + cp] = make_float4(sx.x, sx.y, sxx.x, sxx.y);
  __syncthreads();
  if (warp == 0) {
    float4 s = red[cp];
    for (int g = 1; g < WARPS; ++g) {
      const float4 r = red[g * CP + cp];
      s.x += r.x;
      s.y += r.y;
      s.z += r.z;
      s.w += r.w;
    }
    const size_t row = (size_t)b * gridDim.x + chunk;
    *reinterpret_cast<float2*>(part + (2 * row) * D + c) = make_float2(s.x, s.y);
    *reinterpret_cast<float2*>(part + (2 * row + 1) * D + c) = make_float2(s.z, s.w);
  }
}

// Sums of columns (col0 + lane, col0 + lane + ld) of rows [0, rows) of
// part (row stride `stride`), warps over rows r = warp + WARPS i, then the
// warps in order: valid in warp 0.
__device__ __forceinline__ float2 rows_sum2(const float* __restrict__ part,
                                            int rows, size_t stride, int col,
                                            int ld, float2 (*red)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float2 s = {0.f, 0.f};
  for (int r = warp; r < rows; r += WARPS) {
    s.x += part[r * stride + col];
    s.y += part[r * stride + col + ld];
  }
  red[warp][lane] = s;
  __syncthreads();
  float2 t = red[0][lane];
  for (int g = 1; g < WARPS; ++g) {
    t.x += red[g][lane].x;
    t.y += red[g][lane].y;
  }
  return t;
}

// K10's statistics: grid D / 32.  stats [6, D]: mean, var, rstd, A, Bs,
// the count of valid frames; new_mean, new_var [D].
__global__ void __launch_bounds__(THREADS)
    bn_stats_kernel(const float* __restrict__ part, int rows,
                    const unsigned char* __restrict__ valid, int BT,
                    const bf16* __restrict__ gamma,
                    const bf16* __restrict__ beta,
                    const float* __restrict__ rmean,
                    const float* __restrict__ rvar, float eps,
                    float* __restrict__ stats, float* __restrict__ new_mean,
                    float* __restrict__ new_var, int D) {
  __shared__ float2 red[WARPS][32];
  __shared__ int count;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  int n = 0;
  for (int i = threadIdx.x; i < BT; i += THREADS) n += valid[i] != 0;
  atomicAdd(&count, n);  // integers: the total does not depend on the order
  const int c = blockIdx.x * 32 + (threadIdx.x & 31);
  const float2 s = rows_sum2(part, rows, 2 * (size_t)D, c, D, red);
  if (threadIdx.x >= 32) return;
  const float nf = (float)count;
  const float mean = s.x / nf;
  const float var = s.y / nf - mean * mean;
  const float rstd = rsqrtf(var + eps);
  const float A = rstd * __bfloat162float(gamma[c]);
  stats[c] = mean;
  stats[D + c] = var;
  stats[2 * D + c] = rstd;
  stats[3 * D + c] = A;
  stats[4 * D + c] = __bfloat162float(beta[c]) - mean * A;
  stats[5 * D + c] = nf;
  new_mean[c] = MOMENTUM * rmean[c] + 0.01f * mean;
  new_var[c] = MOMENTUM * rvar[c] + 0.01f * var;
}

// K10's second pass: s = silu(y A + Bs), 8 values a thread.
__global__ void __launch_bounds__(THREADS)
    bn_swish_kernel(const bf16* __restrict__ y,
                    const float* __restrict__ stats, bf16* __restrict__ s,
                    long long nvec, int D) {
  const float* A = stats + 3 * D;
  const float* Bs = stats + 4 * D;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < nvec;
       i += (long long)gridDim.x * THREADS) {
    const int c = (int)((i * 8) % D);
    float x[8], a[8], bs[8];
    unpack8(load16(y + i * 8), x);
    *reinterpret_cast<float4*>(a) = *reinterpret_cast<const float4*>(A + c);
    *reinterpret_cast<float4*>(a + 4) = *reinterpret_cast<const float4*>(A + c + 4);
    *reinterpret_cast<float4*>(bs) = *reinterpret_cast<const float4*>(Bs + c);
    *reinterpret_cast<float4*>(bs + 4) = *reinterpret_cast<const float4*>(Bs + c + 4);
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = silu(fmaf(x[q], a[q], bs[q]));
    *reinterpret_cast<uint4*>(s + i * 8) = pack8(x);
  }
}

// K11's first pass: grid (chunks, D / CT, B).  part [B * chunks, 2, D]: the
// block's sums of dz and dz yhat over every frame of its chunk.
__global__ void __launch_bounds__(THREADS, 3)
    bwd_sums_kernel(const bf16* __restrict__ ds, const bf16* __restrict__ y,
                    const float* __restrict__ stats, float* __restrict__ part,
                    int T, int D) {
  __shared__ float red[2][ROWGROUPS][CT];
  const int chunk = blockIdx.x, c0 = blockIdx.y * CT, b = blockIdx.z;
  const int j = threadIdx.x % (CT / 8), rg = threadIdx.x / (CT / 8);
  const int c = c0 + 8 * j;
  float mean[8], rstd[8], A[8], Bs[8], g[8], h[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    mean[q] = stats[c + q];
    rstd[q] = stats[2 * D + c + q];
    A[q] = stats[3 * D + c + q];
    Bs[q] = stats[4 * D + c + q];
    g[q] = h[q] = 0.f;
  }
  const int t1 = min(T, (chunk + 1) * CHUNK);
  for (int t = chunk * CHUNK + rg; t < t1; t += ROWGROUPS) {
    const size_t off = ((size_t)b * T + t) * D + c;
    float d[8], x[8];
    unpack8(load16(ds + off), d);
    unpack8(load16(y + off), x);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float dz = d[q] * dsilu(fmaf(x[q], A[q], Bs[q]));
      g[q] += dz;
      h[q] = fmaf(dz, (x[q] - mean[q]) * rstd[q], h[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    red[0][rg][8 * j + q] = g[q];
    red[1][rg][8 * j + q] = h[q];
  }
  __syncthreads();
  if (threadIdx.x < 2 * CT) {
    const int which = threadIdx.x / CT, cc = threadIdx.x % CT;
    float s = red[which][0][cc];
    for (int r = 1; r < ROWGROUPS; ++r) s += red[which][r][cc];
    const size_t row = (size_t)b * gridDim.x + chunk;
    part[(2 * row + which) * D + c0 + cc] = s;
  }
}

// K11's statistics: grid D / 32.  dgamma = sum dz yhat, dbeta = sum dz
// (bf16, the parameters' type); coef [3, D]: P = rstd gamma, Q = P dbeta /
// n, R = P dgamma / n, so that dy = P dz - m (Q + yhat R).
__global__ void __launch_bounds__(THREADS)
    bwd_reduce_kernel(const float* __restrict__ part, int rows,
                      const float* __restrict__ stats,
                      const bf16* __restrict__ gamma,
                      bf16* __restrict__ dgamma, bf16* __restrict__ dbeta,
                      float* __restrict__ coef, int D) {
  __shared__ float2 red[WARPS][32];
  const int c = blockIdx.x * 32 + (threadIdx.x & 31);
  const float2 s = rows_sum2(part, rows, 2 * (size_t)D, c, D, red);
  if (threadIdx.x >= 32) return;
  const float n = stats[5 * D + c];
  const float P = stats[2 * D + c] * __bfloat162float(gamma[c]);
  coef[c] = P;
  coef[D + c] = P * s.x / n;
  coef[2 * D + c] = P * s.y / n;
  dbeta[c] = __float2bfloat16_rn(s.x);
  dgamma[c] = __float2bfloat16_rn(s.y);
}

constexpr size_t BWD_SMEM = sizeof(float) * (2 * RING * CT + KMAX * CT + 7 * CT);

// Rows [r0, r1) of the dy ring, row r = frame tbase + r: dy = P dz - m (Q +
// yhat R) from ds and y, zero outside [0, T).  ch: the block's mean, rstd,
// A, Bs, P, Q, R, CT each.
__device__ void load_dy_rows(float* ring, const bf16* __restrict__ ds,
                             const bf16* __restrict__ y,
                             const unsigned char* __restrict__ valid,
                             const float* ch, int b, int T, int D, int c0,
                             int tbase, int r0, int r1) {
  constexpr int V = CT / 8;
  const int n = (r1 - r0) * V;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = r0 + i / V, j = i % V;
    const int t = tbase + r;
    float dy[8];
    if (t >= 0 && t < T) {
      const size_t off = ((size_t)b * T + t) * D + c0 + 8 * j;
      const float m = valid[(size_t)b * T + t] ? 1.f : 0.f;
      float d[8], x[8];
      unpack8(load16(ds + off), d);
      unpack8(load16(y + off), x);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int cc = 8 * j + q;
        const float dz = d[q] * dsilu(fmaf(x[q], ch[2 * CT + cc], ch[3 * CT + cc]));
        const float yh = (x[q] - ch[cc]) * ch[CT + cc];
        dy[q] = ch[4 * CT + cc] * dz - m * fmaf(yh, ch[6 * CT + cc], ch[5 * CT + cc]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) dy[q] = 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(ring + r * CT + 8 * j);
    dst[0] = make_float4(dy[0], dy[1], dy[2], dy[3]);
    dst[1] = make_float4(dy[4], dy[5], dy[6], dy[7]);
  }
}

// K11's second pass: grid (chunks, D / CT, B).  The dy ring's row r is frame
// t0 - K / 2 + r, the a ring's frame t0 - (K - 1) / 2 + r.  Warp w owns taps
// [KPT w, KPT (w + 1)) of dW.  part [B * chunks, D K + D]: the block's dW
// (c K + k) and db sums.
__global__ void __launch_bounds__(THREADS)
    conv_bwd_kernel(const bf16* __restrict__ ds, const bf16* __restrict__ y,
                    const bf16* __restrict__ u,
                    const unsigned char* __restrict__ valid,
                    const bf16* __restrict__ w,
                    const float* __restrict__ stats,
                    const float* __restrict__ coef, bf16* __restrict__ du,
                    float* __restrict__ part, int T, int D, int K) {
  extern __shared__ float4 smem4[];
  float* dy_s = reinterpret_cast<float*>(smem4);
  float* a_s = dy_s + RING * CT;
  float* w_s = a_s + RING * CT;
  float* ch = w_s + KMAX * CT;
  const int chunk = blockIdx.x, c0 = blockIdx.y * CT, b = blockIdx.z;
  const int cp = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = c0 + 2 * cp, PL = (K - 1) / 2, PR = K / 2;
  load_taps<true>(w_s, w, c0, K);
  zero_pad_rows(dy_s, K);
  zero_pad_rows(a_s, K);
  for (int i = threadIdx.x; i < CT; i += THREADS) {
    ch[i] = stats[c0 + i];
    ch[CT + i] = stats[2 * D + c0 + i];
    ch[2 * CT + i] = stats[3 * D + c0 + i];
    ch[3 * CT + i] = stats[4 * D + c0 + i];
    ch[4 * CT + i] = coef[c0 + i];
    ch[5 * CT + i] = coef[D + c0 + i];
    ch[6 * CT + i] = coef[2 * D + c0 + i];
  }
  __syncthreads();
  const float2* dy2 = reinterpret_cast<const float2*>(dy_s);
  const float2* a2 = reinterpret_cast<const float2*>(a_s);
  const float2* w2 = reinterpret_cast<const float2*>(w_s);
  const int k0 = warp * KPT;
  float2 dw[KPT], db = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < KPT; ++j) dw[j] = make_float2(0.f, 0.f);
  const int tc0 = chunk * CHUNK;
  const int tiles = min(TPC, (T - tc0 + TT - 1) / TT);
  for (int tile = 0; tile < tiles; ++tile) {
    const int t0 = tc0 + tile * TT;
    const int r0 = tile == 0 ? 0 : K - 1;
    if (tile > 0) {
      __syncthreads();
      shift_rows(dy_s, K);
      shift_rows(a_s, K);
      __syncthreads();
    }
    load_dy_rows(dy_s, ds, y, valid, ch, b, T, D, c0, t0 - PR, r0, TT + K - 1);
    load_glu_rows(a_s, u, valid, b, T, D, c0, t0 - PL, r0, TT + K - 1);
    __syncthreads();
    // da, GLU's backward and the mask for the warp's FPW frames
    float2 da[FPW];
#pragma unroll
    for (int f = 0; f < FPW; ++f) da[f] = make_float2(0.f, 0.f);
    taps(dy2, w2, padded(K), warp * FPW, cp, da);
#pragma unroll
    for (int f = 0; f < FPW; ++f) {
      const int t = t0 + warp * FPW + f;
      if (t >= T) break;
      const size_t off = ((size_t)b * T + t) * 2 * D + c;
      bf162 o1 = __floats2bfloat162_rn(0.f, 0.f), o2 = o1;
      if (valid[(size_t)b * T + t]) {
        const float2 u1 = __bfloat1622float2(*reinterpret_cast<const bf162*>(u + off));
        const float2 u2 = __bfloat1622float2(*reinterpret_cast<const bf162*>(u + off + D));
        const float sx = sigmoid(u2.x), sy = sigmoid(u2.y);
        o1 = __floats2bfloat162_rn(da[f].x * sx, da[f].y * sy);
        o2 = __floats2bfloat162_rn(da[f].x * u1.x * sx * (1.f - sx),
                                   da[f].y * u1.y * sy * (1.f - sy));
      }
      *reinterpret_cast<bf162*>(du + off) = o1;
      *reinterpret_cast<bf162*>(du + off + D) = o2;
    }
    // dW[k] += dy[t] a[t + k - PL] over the tile's frames (dy ring row i +
    // PR, a ring row i + k), TG frames at a time; the warps' taps k >= K
    // are summed and never stored
#pragma unroll 1
    for (int i = 0; i < TT; i += TG) {
      float2 win[KPT + TG - 1];
#pragma unroll
      for (int j = 0; j < KPT + TG - 1; ++j) win[j] = a2[(i + k0 + j) * CP + cp];
#pragma unroll
      for (int ii = 0; ii < TG; ++ii) {
        const float2 d = dy2[(i + ii + PR) * CP + cp];
        if (warp == 0) {
          db.x += d.x;
          db.y += d.y;
        }
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          dw[j].x = fmaf(d.x, win[ii + j].x, dw[j].x);
          dw[j].y = fmaf(d.y, win[ii + j].y, dw[j].y);
        }
      }
    }
  }
  // the block's dW and db through shared memory, stored row-contiguous
  __syncthreads();
  float* o = a_s;  // CT K + CT <= (TT + K - 1) CT floats
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    if (k0 + j < K) {
      o[(2 * cp) * K + k0 + j] = dw[j].x;
      o[(2 * cp + 1) * K + k0 + j] = dw[j].y;
    }
  }
  if (warp == 0) {
    o[CT * K + 2 * cp] = db.x;
    o[CT * K + 2 * cp + 1] = db.y;
  }
  __syncthreads();
  const size_t row = (size_t)b * gridDim.x + chunk;
  float* prow = part + row * (size_t)D * (K + 1);
  for (int i = threadIdx.x; i < CT * K; i += THREADS) prow[(size_t)c0 * K + i] = o[i];
  for (int i = threadIdx.x; i < CT; i += THREADS) prow[(size_t)D * K + c0 + i] = o[CT * K + i];
}

// K11's last step: dW [D, K] and db [D] (bf16) from the partial rows of
// conv_bwd_kernel, a column a lane, rows in a fixed order.  Grid
// ceil((D K + D) / 32).
__global__ void __launch_bounds__(THREADS)
    dw_reduce_kernel(const float* __restrict__ part, int rows, int DK, int D,
                     bf16* __restrict__ dw, bf16* __restrict__ db) {
  __shared__ float red[WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int M = DK + D, col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < M)
    for (int r = warp; r < rows; r += WARPS) s += part[(size_t)r * M + col];
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || col >= M) return;
  float t = red[0][lane];
  for (int g = 1; g < WARPS; ++g) t += red[g][lane];
  if (col < DK)
    dw[col] = __float2bfloat16_rn(t);
  else
    db[col - DK] = __float2bfloat16_rn(t);
}

// conv_bwd_kernel's dynamic shared memory above 48 KB, granted once a
// device.
constexpr int MAX_DEVICES = 64;
bool bwd_smem_set[MAX_DEVICES];

cudaError_t allow_bwd_smem() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (bwd_smem_set[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(conv_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)BWD_SMEM);
  if (e == cudaSuccess) bwd_smem_set[dev] = true;
  return e;
}

bool bad_shape(int B, int T, int D, int K) {
  return B < 1 || T < 1 || D < CT || D % CT != 0 || K < 1 || K > KMAX ||
         (long long)B * T * 2 * D > 0x7fffffffLL;
}

}  // namespace

extern "C" int conv_module_chunk_frames() { return CHUNK; }

// K10.  Training (training != 0): u [B, T, 2D], valid [B, T] bytes, w [D,
// K], bias, gamma, beta [D] bf16, rmean, rvar [D] fp32 -> y, s [B, T, D]
// bf16, stats [6, D], new_mean, new_var [D] fp32, through part [B chunks,
// 2, D] fp32.  Eval: s only (y, part, stats, new_* unused).
extern "C" int conv_module_fwd(const void* u, const void* valid,
                               const void* w, const void* bias,
                               const void* gamma, const void* beta,
                               const float* rmean, const float* rvar,
                               float eps, void* y, void* s, float* part,
                               float* stats, float* new_mean, float* new_var,
                               int B, int T, int D, int K, int training,
                               void* stream) {
  if (bad_shape(B, T, D, K)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nch = (T + CHUNK - 1) / CHUNK;
  const dim3 grid(nch, D / CT, B);
  if (!training) {
    conv_fwd_kernel<true><<<grid, THREADS, FWD_SMEM, st>>>(
        (const bf16*)u, (const unsigned char*)valid, (const bf16*)w,
        (const bf16*)bias, (const bf16*)gamma, (const bf16*)beta, rmean, rvar,
        eps, (bf16*)s, nullptr, T, D, K);
    return launch_status(cudaSuccess);
  }
  conv_fwd_kernel<false><<<grid, THREADS, FWD_SMEM, st>>>(
      (const bf16*)u, (const unsigned char*)valid, (const bf16*)w,
      (const bf16*)bias, (const bf16*)gamma, (const bf16*)beta, rmean, rvar,
      eps, (bf16*)y, part, T, D, K);
  int err = launch_status(cudaSuccess);
  if (err != 0) return err;
  bn_stats_kernel<<<D / 32, THREADS, 0, st>>>(
      part, B * nch, (const unsigned char*)valid, B * T, (const bf16*)gamma,
      (const bf16*)beta, rmean, rvar, eps, stats, new_mean, new_var, D);
  err = launch_status(cudaSuccess);
  if (err != 0) return err;
  const long long nvec = (long long)B * T * D / 8;
  bn_swish_kernel<<<(unsigned)((nvec + THREADS - 1) / THREADS), THREADS, 0,
                    st>>>((const bf16*)y, stats, (bf16*)s, nvec, D);
  return launch_status(cudaSuccess);
}

// K11: ds [B, T, D] bf16 (s's gradient), u, valid, w as K10, y and stats
// from K10, gamma -> du [B, T, 2D], dw [D, K], db, dgamma, dbeta [D] bf16,
// through part1 [B chunks, 2, D], coef [3, D] and part2 [B chunks, D K + D]
// fp32.
extern "C" int conv_module_bwd(const void* ds, const void* u,
                               const void* valid, const void* w,
                               const void* y, const float* stats,
                               const void* gamma, float* part1, float* coef,
                               float* part2, void* du, void* dw, void* db,
                               void* dgamma, void* dbeta, int B, int T, int D,
                               int K, void* stream) {
  if (bad_shape(B, T, D, K)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nch = (T + CHUNK - 1) / CHUNK;
  const dim3 grid(nch, D / CT, B);
  bwd_sums_kernel<<<grid, THREADS, 0, st>>>((const bf16*)ds, (const bf16*)y,
                                            stats, part1, T, D);
  int err = launch_status(cudaSuccess);
  if (err != 0) return err;
  bwd_reduce_kernel<<<D / 32, THREADS, 0, st>>>(
      part1, B * nch, stats, (const bf16*)gamma, (bf16*)dgamma, (bf16*)dbeta,
      coef, D);
  err = launch_status(cudaSuccess);
  if (err != 0) return err;
  const cudaError_t e = allow_bwd_smem();
  if (e != cudaSuccess) return (int)e;
  conv_bwd_kernel<<<grid, THREADS, BWD_SMEM, st>>>(
      (const bf16*)ds, (const bf16*)y, (const bf16*)u,
      (const unsigned char*)valid, (const bf16*)w, stats, coef, (bf16*)du,
      part2, T, D, K);
  err = launch_status(cudaSuccess);
  if (err != 0) return err;
  const int M = D * K + D;
  dw_reduce_kernel<<<(M + 31) / 32, THREADS, 0, st>>>(
      part2, B * nch, D * K, D, (bf16*)dw, (bf16*)db);
  return launch_status(cudaSuccess);
}
