// Projected-LSTM sequence kernels for Hopper (sm_90a): inference (K2) and
// the training forward with residuals (K4), one template.
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
// Design: one persistent launch covers the whole sequence.  The grid is one
// block per SM (checked against cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// and launched with cudaLaunchCooperativeKernel, so all blocks are
// co-resident and an oversize grid is refused instead of deadlocking at the
// grid barrier.  Block k owns a slice of the H hidden units (their four gate
// columns of Wh) and a slice of the P output columns of Wp.  Per step:
//   phase A: z for its gate columns from the whole h_prev (global buffer),
//            then c and hid for its units.  c stays in shared memory for the
//            whole sequence; hid goes to a global buffer.
//   grid barrier
//   phase B: its columns of h = hid @ Wp, written to h_seq[t] and the h
//            buffer.
//   grid barrier
// Within a block, the vector operand (h or hid rows) is staged in shared
// memory, threads split each column's dot product over rows, and partial
// sums reduce through shared memory.  A pass takes 4 batch rows (BCH); the
// training forward in bf16 takes 8 (train_rows), halving the passes, and so
// the weight re-reads, of a step at B >= 8.  Buffers written during the
// launch are read with __ldcg (L2, not the incoherent L1).  Weights are
// re-read from memory (L2) every pass; pinning each block's Wh slice in
// shared memory and wgmma are later work.

#include <algorithm>

#include "common.cuh"

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
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  // one block per SM keeps the grid barrier cheap; never more than H blocks
  const int nblk = std::min(sms, H);
  const size_t smem = smem_bytes(nblk, B, H, P, rows<W, RES>());
  auto kernel = lstm_infer_kernel<W, RES>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaMemsetAsync(bar, 0, sizeof(unsigned int), stream);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&xp,   &wh,   &wp,   &bias, &c0, &hbuf, &hidbuf, &hseq,
                  &cfin, &zseq, &cseq, &bar, &T,  &B,    &H,      &P};
  return launch_status(cudaLaunchCooperativeKernel(
      (void*)kernel, dim3(nblk), dim3(NT), args, smem, stream));
}

}  // namespace

// xp [T, B, 4H], wh [P, 4H], wp [H, P], bias [4H], h_seq [T, B, P] in the
// weight type; c0 [B, H], c_fin [B, H] f32; hbuf [B, P] f32 holding h0 (rounded
// to the weight type), hidbuf [B, H] f32 scratch, bar one uint32 scratch.
// Returns a CUDA error code (0 = launched).
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
