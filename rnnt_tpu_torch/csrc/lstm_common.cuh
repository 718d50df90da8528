// Shared by the two LSTM libraries (lstm_infer.cu: K2, K4; lstm_bwd.cu: K5):
// the grid's block cap, the report of the design a launch ran, the
// cooperative launch, and the pieces of the bf16 tensor-core design (the
// exchange ring and the m16n8k16 passes).
#pragma once

#include <algorithm>

#include "common.cuh"

// ---- grid size and the design report ----

constexpr int kDesignFma = 0;  // block_dots on the FMA units, fp32 exchange
constexpr int kDesignMma = 1;  // resident weights, mma.sync, bf16 exchange
constexpr int kDesignLat = 2;  // resident weights, tagged exchange (K2, B <= 8)

static int g_block_cap = 0;    // 0: one block per SM
static int g_last_design = kDesignFma;

// Caps the grid of this library's later launches at `cap` blocks (0: one
// block per SM), so one card can run a kernel as a card with fewer SMs
// would.  Returns 0.
extern "C" int lstm_set_block_cap(int cap) {
  g_block_cap = cap > 0 ? cap : 0;
  return 0;
}

// The design of this library's last launch: 0 = FMA, 1 = MMA, 2 = LAT.
extern "C" int lstm_last_design() { return g_last_design; }

struct Card {
  int sms, optin;  // SMs, opt-in shared memory a block may use
};

inline int query_card(Card& c) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&c.optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  return coop ? 0 : (int)cudaErrorNotSupported;
}

// One block per SM keeps the grid barrier cheap; never more than H blocks
// (each owns at least one hidden unit), nor more than the cap.
inline int grid_blocks(const Card& c, int H) {
  const int n = std::min(c.sms, H);
  return g_block_cap > 0 ? std::min(n, g_block_cap) : n;
}

// Launches a persistent cooperative kernel (nblk blocks of NT threads, smem
// bytes of dynamic shared memory) after zeroing zero_bytes at `zero`: its
// grid-barrier counter, or the LAT design's tagged exchange words.  A grid
// that cannot be co-resident is refused by cudaLaunchCooperativeKernel,
// never run.  The shared-memory attribute is set once per kernel, device
// and size (it holds for the process), which keeps a one-step launch short.
inline int coop_launch(const void* kernel, int nblk, size_t smem,
                       void** args, void* zero, cudaStream_t stream,
                       size_t zero_bytes = sizeof(unsigned int)) {
  cudaError_t e;
  if (smem > 48 * 1024) {
    struct Set {
      const void* kernel;
      int dev;
      size_t smem;
    };
    constexpr int kSets = 64;
    static Set sets[kSets];
    static int nsets = 0;
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    bool set = false;
    for (int i = 0; i < nsets && !set; ++i)
      set = sets[i].kernel == kernel && sets[i].dev == dev &&
            sets[i].smem >= smem;
    if (!set) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      if (nsets < kSets) sets[nsets++] = {kernel, dev, smem};
    }
  }
  e = cudaMemsetAsync(zero, 0, zero_bytes, stream);
  if (e != cudaSuccess) return (int)e;
  return launch_status(cudaLaunchCooperativeKernel(kernel, dim3(nblk),
                                                   dim3(NT), args, smem,
                                                   stream));
}

// ---- bf16: resident weight slices, tensor-core step products ----

// 4-byte copy from global to shared memory (.ca: for inputs that no block
// writes during the launch).
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

using bf16 = __nv_bfloat16;

constexpr int NWARP = NT / 32;  // 16 warps a block
constexpr int MT_MAX = 4;       // m16 tiles a pass: 64 batch rows
constexpr int STAGES = 3;       // ring slots (2 chunks in flight)

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// Values a ring slot holds: 64 rows of 128 kq + 16 (kq = 2, or 1 where the
// shared memory of a plan leaves no room for kq = 2).
__host__ __device__ constexpr int slot_values(int kq) {
  return 16 * MT_MAX * (128 * kq + 16);
}
// k values of one ring chunk when a pass has mt m-tiles: a multiple of 32
// (the row stride, chunk + 16, is 16 mod 32 values) that fits a slot.
__device__ constexpr int chunk_k(int mt, int kq) {
  return kq * (mt == 1 ? 512 : mt == 2 ? 256 : mt == 3 ? 160 : 128);
}
// Column stride of a resident weight slice of kp (a multiple of 16) values.
__host__ __device__ constexpr int col_stride(int kp) {
  return round_up(kp, 64) + 16;
}

// Streams rows b0 .. b0+nb of x [*, ld] (a global bf16 buffer written during
// the launch; ld a multiple of 16) through the shared-memory ring in
// k-chunks, two in flight ahead of the consumer, with 16-byte cp.async.cg
// (L2, which sees the other blocks' writes).  Rows past nb up to 16 mt are
// zero-filled.  For each chunk, in order and with every thread's copies
// landed, it calls consume(rows, xs, s0, s1): the chunk's row 0 at `rows`,
// row stride xs, holding the k16 slices s0 .. s1-1 (slice s at local k
// (s - s0) * 16).  The caller synchronises before the ring is reused.
template <typename Consume>
__device__ __forceinline__ void stream_rows(const bf16* x, int ld, int b0,
                                            int nb, int mt, int kq,
                                            bf16* ring, Consume consume) {
  const int kc = chunk_k(mt, kq), xs = kc + 16, rows = 16 * mt;
  const int slot = slot_values(kq);
  const int nchunks = (ld + kc - 1) / kc;

  auto issue = [&](int c) {
    if (c < nchunks) {
      const int k0 = c * kc, pieces = min(kc, ld - k0) / 8;
      bf16* dst = ring + (c % STAGES) * slot;
      for (int i = threadIdx.x; i < rows * pieces; i += NT) {
        const int r = i / pieces, p = i - r * pieces;
        const bool live = r < nb;
        cp_async16(dst + r * xs + p * 8,
                   x + (size_t)(b0 + (live ? r : 0)) * ld + k0 + p * 8,
                   live ? 16 : 0);
      }
    }
    cp_async_commit();  // empty groups keep the count uniform
  };

  for (int c = 0; c < STAGES - 1; ++c) issue(c);
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c has landed (this thread's part)
    __syncthreads();              // everyone's; chunk c-1's slot is free
    issue(c + STAGES - 1);
    consume(ring + (c % STAGES) * slot, xs, c * kc / 16,
            min(ld, (c + 1) * kc) / 16);
  }
}

// One pass of a step product on the tensor cores, K split over warps: the
// partial tiles of x[b0 .. b0+nb, 0:ld] @ ws[:, 0 : 8 NTL] (ws column n at
// ws + n * wst, columns >= ncols zero) go to red [nkg][16 mt][8 NTL], nkg =
// NWARP / mt.  Warp w takes m-tile w % mt and every nkg-th k16 slice from
// w / mt.  Within each 16-wide k slice, lane t holds the four contiguous
// values 4t..4t+3 as MMA k indices 2t, 2t+1, 2t+8, 2t+9, for A and B
// alike: the sum is the same, and every fragment is one 8-byte load.  The
// caller synchronises before reading red.
template <int NTL>
__device__ __forceinline__ void pass_products(const bf16* x, int ld, int b0,
                                              int nb, int mt, int kq,
                                              const bf16* ws, int wst,
                                              int ncols, bf16* ring,
                                              float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = 4 * (lane & 3);
  const int nkg = NWARP / mt, m = warp % mt, kg = warp / mt;
  const int rows = 16 * mt;
  float acc[NTL][4] = {};

  stream_rows(x, ld, b0, nb, mt, kq, ring,
              [&](const bf16* chunk, int xs, int s0, int s1) {
    if (kg >= nkg) return;
    const bf16* xa = chunk + (m * 16 + g) * xs + t4;
    for (int s = s0 + (kg + nkg - s0 % nkg) % nkg; s < s1; s += nkg) {
      const int kl = (s - s0) * 16;
      const uint2 lo = *reinterpret_cast<const uint2*>(xa + kl);
      const uint2 hi = *reinterpret_cast<const uint2*>(xa + 8 * xs + kl);
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        const int n = nt * 8 + g;
        const uint2 w = *reinterpret_cast<const uint2*>(
            ws + (size_t)(n < ncols ? n : 0) * wst + s * 16 + t4);
        mma_bf16_16816(acc[nt], lo.x, hi.x, lo.y, hi.y,
                       n < ncols ? w.x : 0u, n < ncols ? w.y : 0u);
      }
    }
  });
  if (kg < nkg) {
    constexpr int NW = 8 * NTL;
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      float* o = red + (kg * rows + m * 16 + g) * NW + nt * 8 + t4 / 2;
      o[0] = acc[nt][0];
      o[1] = acc[nt][1];
      o[8 * NW] = acc[nt][2];
      o[8 * NW + 1] = acc[nt][3];
    }
  }
}

// Row r, column n of a pass's product: its nkg partial tiles in order.
__device__ __forceinline__ float red_sum(const float* red, int mt, int nw,
                                         int r, int n) {
  const int nkg = NWARP / mt, rows = 16 * mt;
  float s = 0.f;
  for (int q = 0; q < nkg; ++q) s += red[(q * rows + r) * nw + n];
  return s;
}
