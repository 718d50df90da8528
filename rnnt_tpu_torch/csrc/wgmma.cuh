// The WGMMA tile machinery of the joint kernels: K6's planes
// (joint_planes.cu) and K8's dlogits (joint_loss_bwd.cu) share it.
//
// A persistent grid of one CTA an SM walks tiles of CELLS consecutive
// lattice cells.  Its threads are two consumer warpgroups, each owning 64
// cells of the tile, and a producer warpgroup, one thread of which streams
// W2's packed tiles by TMA bulk copies into a ring of 3-4 stages (setmaxnreg
// hands the rest of its registers to the consumers).  A consumer builds the
// tanh tile of its 64 cells once in shared memory (rounded to bf16, in the
// 128-byte-swizzled K-major layout), then runs chunk after chunk of NV
// columns on `wgmma.mma_async` m64n128k16 with fp32 accumulators, two
// accumulator sets alternating: a chunk's epilogue runs while the next
// chunk's first k-blocks are in flight.  The kernel supplies the epilogue
// (K6: the online logsumexp; K8: dlogits and db2).
//
// W2 arrives packed (`pack_w2_kernel` in joint_planes.cu;
// `ops/planes_cuda.pack_w2` is its plain version): the padded [Jp, Vp]
// matrix transposed and cut into [NV v x KB k] tiles in the order the
// consumers read them (V chunk, then k-block), each row already swizzled,
// so every ring stage is one contiguous 1D bulk copy.
#pragma once

#include "common.cuh"

namespace {
namespace wg {

constexpr int CELLS = 128;   // cells a tile: two m64 halves
constexpr int KB = 64;       // k of a W2 tile and of an h k-block (128 bytes)
constexpr int NV = 128;      // V columns a chunk: the wgmma's n
constexpr int STAGE_BYTES = NV * KB * 2;  // one ring stage, 16 KB
constexpr int HBLK_BYTES = CELLS * KB * 2;  // one k-block of the h tile
constexpr int MAX_STAGES = 4;
constexpr int CONSUMERS = 2;  // warpgroups
// + the producer's warpgroup: ptxas sizes registers by whole warpgroups, so
// a lone producer warp would cap every thread at 168; instead the producer
// warpgroup gives its registers to the consumers (setmaxnreg)
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ALIGN = 1024;  // a 128-byte swizzle atom: 8 rows of 128 bytes
constexpr int BAR_BYTES = 2 * MAX_STAGES * 8;  // full[] and empty[]
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory a CTA takes for a padded J (a multiple of KB) and a ring of
// `stages` W2 tiles; the wrapper's plan (`planes_cuda.wgmma_stages`) is the
// same sum.
inline size_t smem_bytes(int J, int stages) {
  return (size_t)ALIGN + (size_t)(J / KB) * HBLK_BYTES +
         (size_t)stages * STAGE_BYTES + BAR_BYTES;
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: rows of 64 bf16 (128 bytes), 8-row groups 1024 bytes apart (the
// stride byte offset), the leading byte offset unused by this layout.  The
// operand starts at a 1024-byte boundary; the k16 steps inside its 128-byte
// rows add 32 bytes (2 in the address field) to the start.
__device__ __forceinline__ unsigned long long desc128(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) |
         (1ull << 16) |                       // leading byte offset
         ((unsigned long long)(1024 >> 4) << 32) |  // stride byte offset
         (1ull << 62);                        // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// d (+)= A[64 x 16] B[16 x 128] for the warpgroup, bf16 in, fp32 out; a and
// b are descriptors; accumulate != 0 adds to d, else overwrites it.  Thread
// t of the warpgroup holds d[4j + e] at row 16 (t / 32) + (t % 32) / 4 + 8
// (e / 2), column 8 j + 2 (t % 4) + e % 2.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 unsigned long long a,
                                                 unsigned long long b,
                                                 int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The warpgroup's 64 rows of the tile's h, times one W2 tile (ring stage at
// `b_addr`): k-block kb of h, four k16 steps.
__device__ __forceinline__ void kblock_product(float (&d)[64], unsigned a_addr,
                                               unsigned b_addr, int kb) {
  wgmma_fence();
  const unsigned long long a = desc128(a_addr), b = desc128(b_addr);
#pragma unroll
  for (int k = 0; k < KB / 16; ++k)
    wgmma_m64n128k16(d, a + 2 * k, b + 2 * k, kb > 0 || k > 0);
  wgmma_commit();
}

// 2^x on the special function unit; results below 2^-126 flush to zero,
// which no sum of exponentials here can notice (its largest term is 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The shared memory of a CTA: the h tile [J/KB][CELLS][KB], the ring
// [stages][NV][KB] and its barriers, from a 1024-byte boundary.
struct Smem {
  unsigned char* hs;
  unsigned char* ring;
  unsigned long long* full;
  unsigned long long* empty;
};
__device__ __forceinline__ Smem carve(unsigned char* raw, int J, int stages) {
  Smem s;
  s.hs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(raw) + ALIGN - 1) & ~(size_t)(ALIGN - 1));
  s.ring = s.hs + (size_t)(J / KB) * HBLK_BYTES;
  s.full = reinterpret_cast<unsigned long long*>(s.ring +
                                                 (size_t)stages * STAGE_BYTES);
  s.empty = s.full + MAX_STAGES;
  return s;
}
// Thread 0 initialises the ring's barriers; every thread then waits.
__device__ __forceinline__ void init_ring(const Smem& sm, int stages) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warpgroup: one thread streams W2's `nsteps` tiles (every
// V chunk's k-blocks) for each tile of cells this CTA walks.
__device__ __forceinline__ void produce_w2(const Smem& sm,
                                           const __nv_bfloat16* __restrict__ w2p,
                                           int ntiles, int nsteps, int stages) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
  if (threadIdx.x != CONSUMERS * 128) return;
  int s = 0;
  unsigned ph = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    for (int i = 0; i < nsteps; ++i) {
      mbar_wait(&sm.empty[s], ph ^ 1);
      // no L2 hint: every CTA re-reads W2 (5.24 MB at the parity width),
      // which should stay in L2
      bulk_load(sm.ring + (size_t)s * STAGE_BYTES,
                w2p + (size_t)i * (NV * KB), STAGE_BYTES, &sm.full[s], false);
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
  }
}

// h of warpgroup wgi's 64 cells of the tile at cell n0, rounded to bf16,
// into the swizzled K-major layout: row m's chunk c (k 8c .. 8c + 7) of
// k-block c / 8 at 16-byte position (c % 8) ^ (m % 8) of the row.  Thread t
// takes rows t / 16 + 8 i and their chunks t % 16 + 16 k: 16 threads read
// 256 contiguous bytes of f and g, and 8 of them fill one 128-byte row of a
// k-block, conflict-free.  Rows past the last cell are zero.  With STORE_H
// each live row is also written to hb [N, J] in global memory.
template <bool STORE_H>
__device__ __forceinline__ void build_h(const __nv_bfloat16* __restrict__ f,
                                        const __nv_bfloat16* __restrict__ g,
                                        const __nv_bfloat16* __restrict__ b1,
                                        unsigned char* hs,
                                        __nv_bfloat16* __restrict__ hb,
                                        long long n0, long long N, int T,
                                        int U1, int J, int wgi, int t) {
  const int nch = J / 8;  // 16-byte chunks of an h row
  for (int m = wgi * 64 + t / 16; m < wgi * 64 + 64; m += 8) {
    const int n = (int)(n0 + m);
    const bool live = n < N;
    const int bt = n / U1, u = n - bt * U1, b = bt / T;
    const __nv_bfloat16* fr = f + (size_t)bt * J;
    const __nv_bfloat16* gr = g + ((size_t)b * U1 + u) * J;
    unsigned char* hrow = hs + m * 128;
#pragma unroll 4
    for (int c = t % 16; c < nch; c += 16) {
      uint4 out = make_uint4(0, 0, 0, 0);
      if (live) {
        const uint4 fv = __ldg(reinterpret_cast<const uint4*>(fr + 8 * c));
        const uint4 gv = __ldg(reinterpret_cast<const uint4*>(gr + 8 * c));
        const uint4 bv = __ldg(reinterpret_cast<const uint4*>(b1 + 8 * c));
        const __nv_bfloat162* fp =
            reinterpret_cast<const __nv_bfloat162*>(&fv);
        const __nv_bfloat162* gp =
            reinterpret_cast<const __nv_bfloat162*>(&gv);
        const __nv_bfloat162* bp =
            reinterpret_cast<const __nv_bfloat162*>(&bv);
        __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(fp[e]);
          const float2 bb = __bfloat1622float2(gp[e]);
          const float2 cc = __bfloat1622float2(bp[e]);
          op[e] = __floats2bfloat162_rn(tanhf(a.x + bb.x + cc.x),
                                        tanhf(a.y + bb.y + cc.y));
        }
        if (STORE_H)
          *reinterpret_cast<uint4*>(hb + (size_t)n * J + 8 * c) = out;
      }
      *reinterpret_cast<uint4*>(hrow + (size_t)(c / 8) * HBLK_BYTES +
                                ((c % 8) ^ (m % 8)) * 16) = out;
    }
  }
  // the generic-proxy stores, visible to wgmma's reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// What a consumer just finished, for a kernel's phase timers (`mark`).
enum TileMark { TM_W2_WAIT, TM_PRODUCTS, TM_EPILOGUE };

// A consumer's ring position: the stage of its next step and of its next
// release, and the phase it waits for.
struct Ring {
  int s = 0, rel = 0;
  unsigned ph = 0;
};

// A consumer warpgroup's products of one tile: step i = (chunk v, k-block
// kb) waits for its stage, issues its four wgmmas into chunk v's
// accumulator set (`cur`), then with at most two groups in flight releases
// the stage of step i - 2; at kb = 1 chunk v - 1 is complete and
// epi(its set, v - 1) runs while chunk v's first two k-blocks do.  Chunks go
// in pairs, so each set is a fixed set of registers in each of the two loop
// bodies.  The epilogue only reads the accumulators: a write would be a
// non-wgmma definition of registers that the other set's wgmmas, in flight
// meanwhile, could share a pipeline stage with, and ptxas then serialises
// every wgmma.  mark(m) follows each wait, product and epilogue (a kernel's
// phase timers).  Ends with every stage of the tile released and the last
// chunk's epilogue run.
template <typename Epi, typename Mark>
__device__ __forceinline__ void tile_products(const Smem& sm, Ring& rg,
                                              float (&acc0)[64],
                                              float (&acc1)[64], int nkb,
                                              int nvc, int stages, int wgi,
                                              int t, Epi&& epi, Mark&& mark) {
  const unsigned a_base = smem_u32(sm.hs) + wgi * 64 * 128;
  const unsigned ring_base = smem_u32(sm.ring);
  const int nsteps = nkb * nvc;
  int i = 0;
  auto chunk = [&](float(&cur)[64], const float(&prev)[64], int v) {
    for (int kb = 0; kb < nkb; ++kb, ++i) {
      mbar_wait(&sm.full[rg.s], rg.ph);
      mark(TM_W2_WAIT);
      kblock_product(cur, a_base + kb * HBLK_BYTES,
                     ring_base + rg.s * STAGE_BYTES, kb);
      if (++rg.s == stages) {
        rg.s = 0;
        rg.ph ^= 1;
      }
      wgmma_wait<2>();
      mark(TM_PRODUCTS);
      if (i >= 2) {
        if (t == 0) mbar_arrive(&sm.empty[rg.rel]);
        if (++rg.rel == stages) rg.rel = 0;
      }
      if (kb == 1 && v > 0) {
        epi(prev, v - 1);
        mark(TM_EPILOGUE);
      }
    }
  };
  for (int v = 0; v < nvc; v += 2) {
    chunk(acc0, acc1, v);
    if (v + 1 < nvc) chunk(acc1, acc0, v + 1);
  }
  wgmma_wait<0>();
  mark(TM_PRODUCTS);
  for (int k = nsteps < 2 ? nsteps : 2; k > 0; --k) {
    if (t == 0) mbar_arrive(&sm.empty[rg.rel]);
    if (++rg.rel == stages) rg.rel = 0;
  }
  if ((nvc - 1) & 1)
    epi(acc1, nvc - 1);
  else
    epi(acc0, nvc - 1);
}

// The card's SMs and the opt-in shared memory a block may use, checked
// against a launch's need; sets the kernel's dynamic shared memory.
template <typename K>
inline cudaError_t plan(K kernel, int J, int stages, int* nsm) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(nsm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes(J, stages);
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace wg
}  // namespace
