// Shared helpers for the port's CUDA kernels (one shared library per .cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Each library exports this so its Python wrapper can word a CUDA error.
extern "C" const char* rnnt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Load a weight element as float.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round a float to the weight type (round to nearest even), and back.
template <typename W>
__device__ __forceinline__ W from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename W>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<W>(v));
}

// The error of the launch just made, or of an earlier asynchronous one.
static inline int launch_status(cudaError_t launch) {
  if (launch != cudaSuccess) return static_cast<int>(launch);
  return static_cast<int>(cudaGetLastError());
}

// ---- persistent cooperative kernels (lstm_infer.cu, beam_search.cu) ----

constexpr int NT = 512;  // threads per block
constexpr int BCH = 4;   // vector rows per pass of block_dots

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Grid-wide barrier on a counter zeroed before the launch.  `target` counts
// the arrivals this block waits for; it grows by gridDim.x per barrier.  A
// wait of more than 2^35 clock cycles (over 10 s) can only be a fault, so it
// traps: the launch then fails with an error instead of hanging the card.
__device__ __forceinline__ void grid_barrier(unsigned int* bar,
                                             unsigned int& target) {
  __threadfence();
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    atomicAdd(bar, 1u);
    const long long t0 = clock64();
    while (*(volatile unsigned int*)bar < target) {
      if (clock64() - t0 > (1LL << 35)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// out[c * R + bb] = sum_k src[(b0 + bb) * lds + k] * w[k * ldw + col(c)]
// for c < ncols, bb < nb <= R (R rows a pass, BCH unless a kernel asks for
// more).  `src` was written during this launch: its rows are staged once
// into shared memory `xs` (of type X: float, or the weight type when the
// rows hold values already rounded to it) with L2 loads, so the inner loop
// issues only weight loads.  Threads split each column's dot product over
// k, and the partial sums reduce through shared memory `red` [NT * R].
template <int R = BCH, typename W, typename Col, typename X>
__device__ void block_dots(const float* src, int lds, int b0, int nb, int K,
                           const W* __restrict__ w, int ldw, int ncols,
                           Col col, X* xs, float* red, float* out) {
  for (int i = threadIdx.x; i < nb * K; i += NT) {
    const int bb = i / K, k = i - bb * K;
    xs[bb * K + k] = from_float<X>(__ldcg(src + (size_t)(b0 + bb) * lds + k));
  }
  __syncthreads();
  for (int cbase = 0; cbase < ncols; cbase += NT) {
    const int nc = min(NT, ncols - cbase);
    const int n_ks = NT / nc;
    const int c = threadIdx.x % nc, ks = threadIdx.x / nc;
    if (ks < n_ks) {
      float acc[R];
#pragma unroll
      for (int bb = 0; bb < R; ++bb) acc[bb] = 0.f;
      const W* wc = w + col(cbase + c);
#pragma unroll 8
      for (int k = ks; k < K; k += n_ks) {
        const float wv = to_float(wc[(size_t)k * ldw]);
#pragma unroll
        for (int bb = 0; bb < R; ++bb)
          if (bb < nb) acc[bb] = fmaf(to_float(xs[bb * K + k]), wv, acc[bb]);
      }
#pragma unroll
      for (int bb = 0; bb < R; ++bb) red[(ks * nc + c) * R + bb] = acc[bb];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nc * R; i += NT) {
      const int cc = i / R, bb = i - cc * R;
      float sum = 0.f;
      for (int q = 0; q < n_ks; ++q) sum += red[(q * nc + cc) * R + bb];
      out[(cbase + cc) * R + bb] = sum;
    }
    __syncthreads();
  }
}

// Rows a block_dots pass takes in the training LSTM kernels (K4, K5): 8 in
// bf16, whose staged rows are half the bytes; BCH in fp32.
template <typename W>
__host__ __device__ constexpr int train_rows() {
  return sizeof(W) == 2 ? 2 * BCH : BCH;
}

// First index of part i when n items are cut into `parts` near-equal parts.
__host__ __device__ inline int slice_begin(int i, int n, int parts) {
  return (int)((long long)i * n / parts);
}

// ---- asynchronous copies and warp-level tensor-core products (sm_80+) ----

// 16-byte copy from global to shared memory through L2 only (.cg), so it
// sees what other blocks wrote before a grid barrier.  With src_bytes = 0
// it reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src,
                                           int src_bytes) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// BYTES-byte copy (4, 8 or 16) from global to shared memory through L1
// (.ca); with in = false it reads nothing and writes zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* smem_dst, const void* src,
                                            bool in = true) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(BYTES), "r"(in ? BYTES : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a b on the tensor cores, one warp: a 16x16 bf16 (row-major), b 16x8
// bf16 (column-major), d 16x8 fp32, in the PTX ISA's m16n8k16 fragments
// (lane = 4 * g + t): a0 rows g, k 2t..2t+1; a1 row g+8, the same k; a2
// and a3 the same rows at k + 8; b0 k 2t..2t+1 of column g, b1 k + 8;
// d rows g (d0, d1) and g+8 (d2, d3), columns 2t and 2t+1.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], unsigned a0,
                                               unsigned a1, unsigned a2,
                                               unsigned a3, unsigned b0,
                                               unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---- bulk asynchronous copies (TMA, 1D) with mbarrier completion (sm_90) ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* b,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}
// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; the barrier's phase completes when they land.
// Issued by one thread: it arrives on the barrier expecting the bytes.
// With `evict_first` the lines are marked evict-first in L2, for a stream
// read once that would otherwise push what is reused out of L2.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* b,
                                          bool evict_first) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
  if (evict_first) {
    unsigned long long pol;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(pol));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(b)), "l"(pol)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(b))
        : "memory");
  }
}
__device__ __forceinline__ bool mbar_done(unsigned long long* b,
                                          unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return ok != 0;
}
// Waits for the barrier's phase of parity `parity` to complete; as
// grid_barrier, a wait over 2^35 cycles is a fault and traps.
__device__ __forceinline__ void mbar_wait(unsigned long long* b,
                                          unsigned parity) {
  if (mbar_done(b, parity)) return;
  const long long t0 = clock64();
  while (!mbar_done(b, parity))
    if (clock64() - t0 > (1LL << 35)) __trap();
}
