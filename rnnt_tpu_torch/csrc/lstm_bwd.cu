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
// Bound on the H100: like the forward, each step needs all of Wh and Wp
// (13.1 MB in bf16 at the parity width) and the steps are a sequential
// chain; at B=32 the products are 2 x 32 x (4H x P + P x H) = 0.42 GFLOP a
// step.
//
// Design: the forward kernel's structure reversed, one persistent
// cooperative launch (one block per SM, grid_barrier from common.cuh).
// Block k owns a slice of the H hidden units (their four gate columns) and
// a slice of the P columns.  Before the first step each block writes its
// columns of dh_total for t = T-1; then per step:
//   phase A: dhid for its own units from the whole dh_total (a global
//            buffer), then the cell backward with dc carried in shared
//            memory, then dz for its own four gate columns (to dz_seq and a
//            global buffer);
//   grid barrier
//   phase B: its P columns of dz @ Wh^T, which with dout[t-1] become the
//            next step's dh_total (or, at t = 0, dh0);
//   grid barrier
// The products reuse block_dots: the vector rows are staged in shared memory
// in the weight type (exact: dh_total and dz are rounded to it), 8 rows a
// pass in bf16 and 4 in fp32 (train_rows), the weights read from L2 once a
// pass.  The kernel writes only its outputs and scratch: its inputs are
// left untouched.

#include <algorithm>

#include "common.cuh"

namespace {

// Shared memory: reduction [NT*R] + dot outputs [ncmax*R] + dc [B*numax]
// in fp32, then the staged vector rows [R*max(4H,P)] in the weight type
// (dh_total and dz are rounded to it before their products, so the staged
// copy is exact).  R = train_rows<W>().
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
__global__ void __launch_bounds__(NT)
    lstm_bwd_kernel(const W* __restrict__ zseq,    // [T, B, 4H]
                    const W* __restrict__ cseq,    // [T, B, H]
                    const float* __restrict__ c0,  // [B, H]
                    const W* __restrict__ dout,    // [T, B, P]
                    const W* __restrict__ whT,     // [4H, P]
                    const W* __restrict__ wpT,     // [P, H]
                    float* dhtot,   // [B, P] dh_total of the step, rounded to W
                    float* dzbuf,   // [B, 4H] dz of the step, rounded to W
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

template <typename W>
int launch(const void* zseq, const void* cseq, const float* c0,
           const void* dout, const void* whT, const void* wpT, float* dhtot,
           float* dzbuf, void* dzseq, void* dhtseq, float* dh0, float* dc0,
           unsigned int* bar, int T, int B, int H, int P, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const W* z = (const W*)zseq;
  const W* c = (const W*)cseq;
  const W* d = (const W*)dout;
  const W* wh = (const W*)whT;
  const W* wp = (const W*)wpT;
  W* dz = (W*)dzseq;
  W* dht = (W*)dhtseq;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const int nblk = std::min(sms, H);
  const size_t smem = smem_bytes<W>(nblk, B, H, P);
  auto kernel = lstm_bwd_kernel<W>;
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
  void* args[] = {&z,   &c,   &c0,  &d,  &wh, &wp, &dhtot, &dzbuf, &dz,
                  &dht, &dh0, &dc0, &bar, &T, &B,  &H,     &P};
  return launch_status(cudaLaunchCooperativeKernel(
      (void*)kernel, dim3(nblk), dim3(NT), args, smem, stream));
}

}  // namespace

// zseq [T,B,4H], cseq [T,B,H], dout [T,B,P], whT [4H,P], wpT [P,H], dzseq
// [T,B,4H], dhtseq [T,B,P] in the weight type; c0 [B,H], dh0 [B,P], dc0
// [B,H] f32; dhtot [B,P] and dzbuf [B,4H] f32 scratch; bar one uint32
// scratch.  Returns a CUDA error code (0 = launched).
extern "C" int lstm_bwd_f32(const void* zseq, const void* cseq,
                            const float* c0, const void* dout,
                            const void* whT, const void* wpT, float* dhtot,
                            float* dzbuf, void* dzseq, void* dhtseq,
                            float* dh0, float* dc0, unsigned int* bar, int T,
                            int B, int H, int P, void* stream) {
  return launch<float>(zseq, cseq, c0, dout, whT, wpT, dhtot, dzbuf, dzseq,
                       dhtseq, dh0, dc0, bar, T, B, H, P, stream);
}

extern "C" int lstm_bwd_bf16(const void* zseq, const void* cseq,
                             const float* c0, const void* dout,
                             const void* whT, const void* wpT, float* dhtot,
                             float* dzbuf, void* dzseq, void* dhtseq,
                             float* dh0, float* dc0, unsigned int* bar, int T,
                             int B, int H, int P, void* stream) {
  return launch<__nv_bfloat16>(zseq, cseq, c0, dout, whT, wpT, dhtot, dzbuf,
                               dzseq, dhtseq, dh0, dc0, bar, T, B, H, P,
                               stream);
}
