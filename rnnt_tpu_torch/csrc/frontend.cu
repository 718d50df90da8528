// Log-mel frontend kernel for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces rnnt_tpu/ops/features_pallas.py::_frontend_kernel (launched by
// log_mel_frontend).  Computes, for every STFT frame f of `audio`:
//   re = frame_f @ C,  im = frame_f @ S     (C, S: [L, K] DFT matrices with
//                                            the periodic Hann window folded in)
//   mag = sqrt(re^2 + im^2)                 [K = nfft/2 + 1 bins]
//   out[f] = log(mag @ MEL + 1e-6)          [M mel bins]
// The caller subtracts the per-feature mean and stacks frames.
//
// Bound on the H100: the function needs about 14 kFLOP a frame at the parity
// geometry (L=400, nfft=512, K=257, M=80): a real 512-point FFT (~11.5 k),
// window, magnitude, the sparse mel filters (470 weights) and the log.  At
// 67 TFLOP/s fp32 that is below the time to move audio in and log-mel out
// (4 + 2 bytes per sample over 3.35 TB/s), so the function is bound by bytes.
// This kernel does the DFT as two dense products, about 0.45 MFLOP a frame,
// some 30 times the FFT's work: simple and exact in fp32, and still far from
// the bound (an FFT in shared memory is later work).  fp32 throughout on
// purpose: the TPU kernel runs its matmuls at HIGHEST precision because the
// log amplifies DFT rounding noise at near-silent bins, so TF32 or bf16
// tensor cores are not used here.
//
// Design: a block takes FT consecutive frames and reads them straight from
// `audio` by index into shared memory (overlapping frames need no chunk
// views).  Each thread owns one DFT bin and keeps FT real and FT imaginary
// accumulators in registers: per sample row k it loads C[k, bin] and
// S[k, bin] once (coalesced across the warp, L2-resident after the first
// block) and reuses them for FT frames read from shared memory as
// broadcasts.  Magnitudes go to shared memory; then each thread computes
// (frame, mel) outputs against the [K, M] filterbank and applies the log.
// The ragged last tile masks frames past the end.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int FT = 16;  // frames per block

__global__ void frontend_kernel(const float* __restrict__ audio,
                                const float* __restrict__ cosm,
                                const float* __restrict__ sinm,
                                const float* __restrict__ melm,
                                float* __restrict__ out, int n_frames, int L,
                                int hop, int K, int M) {
  extern __shared__ float smem[];
  float* fr = smem;            // [FT][L] frames
  float* mag = smem + FT * L;  // [FT][K] magnitudes
  const int f0 = blockIdx.x * FT;
  const int nf = min(FT, n_frames - f0);

  for (int i = threadIdx.x; i < FT * L; i += blockDim.x) {
    const int f = i / L, k = i - f * L;
    fr[i] = f < nf ? audio[(long long)(f0 + f) * hop + k] : 0.f;
  }
  __syncthreads();

  for (int bin = threadIdx.x; bin < K; bin += blockDim.x) {
    float re[FT], im[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) re[f] = im[f] = 0.f;
    for (int k = 0; k < L; ++k) {
      const float c = cosm[(long long)k * K + bin];
      const float s = sinm[(long long)k * K + bin];
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        const float x = fr[f * L + k];
        re[f] = fmaf(x, c, re[f]);
        im[f] = fmaf(x, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < FT; ++f)
      mag[f * K + bin] = sqrtf(re[f] * re[f] + im[f] * im[f]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nf * M; i += blockDim.x) {
    const int f = i / M, m = i - f * M;
    float s = 0.f;
    for (int b = 0; b < K; ++b) s = fmaf(mag[f * K + b], melm[b * M + m], s);
    out[(long long)(f0 + f) * M + m] = logf(s + 1e-6f);
  }
}

}  // namespace

// audio [>= (n_frames-1)*hop + L] f32, cosm/sinm [L, K] f32, melm [K, M] f32
// -> out [n_frames, M] f32.  Returns a CUDA error code (0 = launched).
extern "C" int frontend_log_mel(const float* audio, const float* cosm,
                                const float* sinm, const float* melm,
                                float* out, int n_frames, int L, int hop,
                                int K, int M, void* stream) {
  if (n_frames <= 0) return 0;
  const int threads = std::min(1024, (K + 31) / 32 * 32);
  const size_t smem = sizeof(float) * (size_t)FT * (L + K);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n_frames + FT - 1) / FT;
  frontend_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      audio, cosm, sinm, melm, out, n_frames, L, hop, K, M);
  return launch_status(cudaSuccess);
}
