// Log-mel frontend kernel for Hopper (sm_90a): an FFT in shared memory on
// the CUDA cores, its butterflies in fp64.
//
// Replaces rnnt_tpu/ops/features_pallas.py::_frontend_kernel (launched by
// log_mel_frontend).  Computes, for every STFT frame f of `audio` (tf.signal
// framing, no centering):
//   X = rfft(hann * frame_f, nfft)          [K = nfft/2 + 1 bins]
//   out[f] = log(|X| @ MEL + 1e-6)          [M mel bins]
// The caller subtracts the per-feature mean and stacks frames.
//
// Bound on the H100: the function needs about 14 kFLOP a frame at the parity
// geometry (L=400, nfft=512, K=257, M=80): a real 512-point FFT (~11.5 k),
// window, magnitude, the sparse mel filters (470 weights) and the log.  At
// 67 TFLOP/s fp32 that is below the time to move audio in and log-mel out
// (4 + 2 bytes per sample over 3.35 TB/s), so the function is bound by
// bytes; a launch of a few frames is bound by its latency.  No TF32 or bf16:
// the TPU kernel runs its matmuls at HIGHEST precision because the log
// amplifies rounding at near-silent bins.  For the same reason the FFT's
// butterflies and the real-FFT split run in fp64: an fp32 radix-2 FFT errs
// by ~eps * log2(n) of the frame's peak magnitude in every bin, and in a
// spectral null of a low mel bin (one or two FFT bins wide) the log turns
// that into an error above the 2e-4 the port holds the frontend to (see
// tests/test_torch_frontend_fft.py).  In fp64 what is left is the fp32
// inputs' rounding (window product, twiddle table).
//
// Design: one warp a frame, up to 8 frames a block, so a 1498-frame request
// spreads over ~190 blocks and a 7-frame stream chunk over 7 warps.  The
// block loads its audio span, (frames - 1) * hop + L samples, once into
// shared memory with coalesced asynchronous copies (cp.async, all in flight
// at once), beside the twiddle table, the Hann window (both built by the
// host in float64 and rounded to fp32: no sin or cos in the kernel) and the
// mel tables.  Each warp then, in its own shared-memory slice:
//   1. packs its windowed frame (zero-padded from L to nfft) as n = nfft/2
//      complex points z[m] = x[2m] + i x[2m+1], stored at bit-reversed m;
//   2. runs log2(n) radix-2 decimation-in-time stages in place, in fp64
//      on the fp32 table values (stage s
//      pairs i and i + 2^s, twiddle exp(-2 pi i p / 2^(s+1)) = tw[p n/2^s],
//      gathered per stage side by side so that no stage's reads of it
//      collide in a bank), a __syncwarp between stages;
//   3. splits the packed spectrum Z into the real one (fp64, the
//      magnitudes rounded to fp32): for k <= n/2,
//      Xe = (Z[k] + conj Z[n-k]) / 2, Xo = -i (Z[k] - conj Z[n-k]) / 2,
//      t = tw[k] Xo, |X[k]| = |Xe + t| and |X[n-k]| = |Xe - t|;
//   4. sums each mel bin over its nonzero weights only (first bin, count and
//      packed weights from the host, staged in shared memory with the rest,
//      ascending bin order) and takes the log.
// Lanes write the mel bins of a frame side by side (coalesced).  Shared
// memory is sized at launch: any nfft from 64 to 4096, any frame length up
// to nfft, any hop (fewer frames a block when a span would not fit).

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int MAX_FRAMES = 8;  // frames (warps) a block
constexpr int NFFT_MIN = 64, NFFT_MAX = 4096;
constexpr size_t SMEM_MAX = 232448;  // a block's shared memory on the H100

// Shared memory layout, in floats: the split's twiddles [2n], the stages'
// twiddles [2n], per warp the packed spectrum [n double2 = 4n], then the
// window [L, even], the mel weights [nnz, even] and their index [3M, even],
// the span [(fpb - 1) hop + L, even] and per warp the magnitudes [n + 1,
// even].  The spectra start 16-byte aligned (n >= 32), every other part
// 8-byte aligned.
__host__ __device__ inline long long even(long long v) {
  return (v + 1) & ~1LL;
}
__host__ __device__ inline long long span_floats(int fpb, int L, int hop) {
  return even((long long)(fpb - 1) * hop + L);
}
__host__ __device__ inline int warp_floats(int n) { return 4 * n + (n + 2); }
__host__ __device__ inline long long table_floats(int n, int L, int nnz,
                                                  int M) {
  return 4LL * n + even(L) + even(nnz) + even(3LL * M);
}

// LOG2N = log2(nfft / 2), a template parameter so that every loop over
// the points has a fixed trip count and unrolls.
template <int LOG2N>
__global__ void __launch_bounds__(32 * MAX_FRAMES)
    frontend_fft_kernel(const float* __restrict__ audio,
                        const float* __restrict__ win,  // [L]
                        const float2* __restrict__ tw,  // [n]
                        const int* __restrict__ mel_idx,  // [3, M]
                        const float* __restrict__ mel_w,  // [nnz]
                        float* __restrict__ out,          // [n_frames, M]
                        int n_frames, int L, int hop, int M, int nnz) {
  extern __shared__ double2 smem_d[];
  constexpr int n = 1 << LOG2N;  // complex points: nfft / 2
  const int fpb = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f0 = blockIdx.x * fpb;
  const int nf = min(fpb, n_frames - f0);

  float2* tws = reinterpret_cast<float2*>(smem_d);  // [n] exp(-2 pi i t /
                                                    // nfft), for the split
  float2* stw = tws + n;  // [n] stage s's twiddle p at 2^s + p
  double2* bufs = reinterpret_cast<double2*>(stw + n);  // [fpb][n]
  float* wins = reinterpret_cast<float*>(bufs + (size_t)fpb * n);
  float* mws = wins + even(L);
  int* mis = reinterpret_cast<int*>(mws + even(nnz));
  float* span = reinterpret_cast<float*>(mis) + even(3LL * M);
  double2* buf = bufs + (size_t)warp * n;  // [n] packed spectrum
  float* mag = span + span_floats(fpb, L, hop) +
               (size_t)warp * even(n + 1);  // [n + 1] |X|

  // every table and the span by asynchronous copies, all in flight at once
  const long long a0 = (long long)f0 * hop;
  const int S = (nf - 1) * hop + L;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    cp_async_ca<8>(tws + i, tw + i);
    // stage s = floor(log2 i) reads its twiddles side by side (no bank
    // conflicts): exp(-2 pi i p / 2^(s+1)) = tw[p n / 2^s]
    const int st = 31 - __clz(max(i, 1)), pp = i - (1 << st);
    cp_async_ca<8>(stw + i, tw + pp * (n >> st));
  }
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    cp_async_ca<4>(wins + i, win + i);
  for (int i = threadIdx.x; i < nnz; i += blockDim.x)
    cp_async_ca<4>(mws + i, mel_w + i);
  for (int i = threadIdx.x; i < 3 * M; i += blockDim.x)
    cp_async_ca<4>(mis + i, mel_idx + i);
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    cp_async_ca<4>(span + i, audio + a0 + i);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (warp >= nf) return;

  // 1. windowed frame, packed in pairs, at bit-reversed positions
  const float* fr = span + warp * hop;
#pragma unroll
  for (int r = 0; r < n / 32; ++r) {
    const int m = lane + 32 * r, k = 2 * m;
    const float x0 = k < L ? fr[k] * wins[k] : 0.f;
    const float x1 = k + 1 < L ? fr[k + 1] * wins[k + 1] : 0.f;
    buf[__brev(m) >> (32 - LOG2N)] = make_double2(x0, x1);
  }
  __syncwarp();

  // 2. radix-2 stages in place, fp64
#pragma unroll
  for (int s = 0; s < LOG2N; ++s) {
    const int half = 1 << s;
#pragma unroll
    for (int r = 0; r < (n / 2 + 31) / 32; ++r) {
      const int b = lane + 32 * r;
      if (b >= n / 2) break;  // n = 32: half the lanes
      const int p = b & (half - 1);
      const int i = ((b - p) << 1) + p, j = i + half;
      const float2 wf = stw[half + p];
      const double wr = wf.x, wi = wf.y;
      const double2 u = buf[i], v = buf[j];
      const double tr = v.x * wr - v.y * wi, ti = v.x * wi + v.y * wr;
      buf[i] = make_double2(u.x + tr, u.y + ti);
      buf[j] = make_double2(u.x - tr, u.y - ti);
    }
    __syncwarp();
  }

  // 3. the real spectrum's magnitudes, bins k and n - k together (fp64)
#pragma unroll
  for (int r = 0; r < (n / 2 + 32) / 32; ++r) {
    const int k = lane + 32 * r;
    if (k > n / 2) break;
    const double2 a = buf[k], c = buf[(n - k) & (n - 1)];
    const double er = 0.5 * (a.x + c.x), ei = 0.5 * (a.y - c.y);
    const double orr = 0.5 * (a.y + c.y), oi = -0.5 * (a.x - c.x);
    const float2 wf = tws[k];
    const double wr = wf.x, wi = wf.y;
    const double tr = orr * wr - oi * wi, ti = orr * wi + oi * wr;
    const double pr = er + tr, pi = ei + ti, mr = er - tr, mi = ei - ti;
    mag[k] = (float)sqrt(pr * pr + pi * pi);
    if (2 * k != n) mag[n - k] = (float)sqrt(mr * mr + mi * mi);
  }
  __syncwarp();

  // 4. sparse mel filters, then the log
  float* o = out + (size_t)(f0 + warp) * M;
  for (int m = lane; m < M; m += 32) {
    const int lo = mis[m], cnt = mis[M + m], off = mis[2 * M + m];
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < cnt; ++i) acc = fmaf(mag[lo + i], mws[off + i], acc);
    o[m] = logf(acc + 1e-6f);
  }
}

}  // namespace

// audio [>= (n_frames-1)*hop + L] f32, win [L] f32, tw [nfft/2] complex f32
// (exp(-2 pi i t / nfft)), mel_idx [3, M] int32 (each mel bin's first
// spectral bin, count, offset into mel_w), mel_w [nnz] f32 -> out
// [n_frames, M] f32, nnz = mel_w's length.  Returns a CUDA error code
// (0 = launched);
// cudaErrorInvalidValue for a geometry outside the design (nfft not a power
// of two in [64, 4096], L outside [1, nfft], hop or M below 1).
extern "C" int frontend_log_mel_fft(const float* audio, const float* win,
                                    const float* tw, const int* mel_idx,
                                    const float* mel_w, float* out,
                                    int n_frames, int L, int hop, int nfft,
                                    int M, int nnz, void* stream) {
  if (n_frames <= 0) return 0;
  if (nfft < NFFT_MIN || nfft > NFFT_MAX || L < 1 || L > nfft || hop < 1 ||
      M < 1 || nnz < 0)
    return (int)cudaErrorInvalidValue;
  int log2n = 5;  // nfft = 64
  while ((2 << log2n) < nfft) ++log2n;
  if (nfft != (2 << log2n)) return (int)cudaErrorInvalidValue;
  void (*const kernels[])(const float*, const float*, const float2*,
                          const int*, const float*, float*, int, int, int,
                          int, int) = {
      frontend_fft_kernel<5>, frontend_fft_kernel<6>, frontend_fft_kernel<7>,
      frontend_fft_kernel<8>, frontend_fft_kernel<9>, frontend_fft_kernel<10>,
      frontend_fft_kernel<11>};
  const auto kernel = kernels[log2n - 5];
  const int n = nfft / 2;
  int fpb = std::min(MAX_FRAMES, n_frames);
  size_t smem = 0;
  for (;; fpb = (fpb + 1) / 2) {
    smem = sizeof(float) * (size_t)(table_floats(n, L, nnz, M) +
                                    span_floats(fpb, L, hop) +
                                    (long long)fpb * warp_floats(n));
    if (smem <= SMEM_MAX || fpb == 1) break;
  }
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n_frames + fpb - 1) / fpb;
  kernel<<<blocks, 32 * fpb, smem, (cudaStream_t)stream>>>(
      audio, win, reinterpret_cast<const float2*>(tw), mel_idx, mel_w, out,
      n_frames, L, hop, M, nnz);
  return launch_status(cudaSuccess);
}
