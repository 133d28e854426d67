// S4, the load-pattern probe: how fast one CTA stages a channel's per-ms
// window into shared memory, millisecond after millisecond, as B1 walks it.
//
// Replaces: scripts/dma_probe.py::kernel (a (C, win_pk + 128) int32 slab
// per ms, double-buffered), scripts/dma_probe2.py and dma_probe3.py (one
// 1-D copy per channel from the capture view, double-buffered) and
// scripts/dma_probe4.py::kernel (a depth-4 DMA pipeline), which probed the
// TPU's DMA engine for the megakernel's frame fetch.  What they measure
// is computed here, not their Mosaic layout: one CTA per channel walks r
// ms in order; at ms j it brings the window of ``win`` int8 samples at
// byte 4*starts_w[c] + j*spc of the capture on chip and writes the exact
// int64 sum of its bytes to sums[j, c].  The patterns:
//   kDirect   — B1/B3's loads: thread-strided byte loads from global
//               memory, no staging (the baseline);
//   kCpAsync  — 16-byte cp.async.cg copies into shared memory, kDepth
//               buffers in flight (dma_probe.py / dma_probe2/3.py at 2,
//               dma_probe4.py at 4);
//   kBulk     — one 1-D TMA bulk copy per ms (cp.async.bulk ... complete_tx
//               on an mbarrier), kDepth buffers in flight.
// The staged patterns copy from the 16-byte aligned-down window start
// (4*starts_w[c] is 4-byte aligned only) and sum from the lead offset.
//
// What bounds it on the H100: one CTA of 512 threads per channel, 8 of 132
// SMs at C = 8: the latency of a window's loads, not HBM bandwidth.  The
// byte sum is the same work in every pattern (one byte per thread per
// step, from global memory or shared memory), so the differences are the
// staging.
//
// Shared memory: one window is ~38.3 KB at the reference front end, so
// depth 2 needs ~77 KB and depth 4 ~153 KB of dynamic shared memory, above
// the 48 KB default: the launcher opts in with cudaFuncSetAttribute.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDirect = 0;
constexpr int kCpAsync = 1;
constexpr int kBulk = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the CTA's exact sum of one int per thread, valid in thread 0; ends in a
// barrier, so the shared buffers may be refilled after it
__device__ __forceinline__ long long block_sum(int v, long long* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long t = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < kWarps; ++i) t += red[i];
  __syncthreads();
  return t;
}

__device__ __forceinline__ int sum_bytes(const int8_t* src, int win) {
  int v = 0;
  for (int k = threadIdx.x; k < win; k += kThreads) v += src[k];
  return v;
}

// 16-byte aligned-down start and copy size of window (j, c)
struct Span {
  long long src;  // aligned byte offset in the capture
  int lead;       // window start - src, 0..12
  int bytes;      // multiple of 16, <= slot
};

__device__ __forceinline__ Span span_of(long long start_b, int j, int spc, int win) {
  const long long off = start_b + static_cast<long long>(j) * spc;
  Span s;
  s.src = off & ~15LL;
  s.lead = static_cast<int>(off - s.src);
  s.bytes = (s.lead + win + 15) & ~15;
  return s;
}

__device__ __forceinline__ void start_cp_async(const int8_t* cap, const Span& s,
                                               unsigned char* buf) {
  for (int i = threadIdx.x * 16; i < s.bytes; i += kThreads * 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(buf + i)),
                 "l"(cap + s.src + i)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// thread 0 only
__device__ __forceinline__ void start_bulk(const int8_t* cap, const Span& s,
                                           unsigned char* buf, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // after the reads of the last use
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(s.bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(buf)), "l"(cap + s.src), "r"(s.bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wait_bar(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// sums[j * n_ch + c]; ``slot``: bytes of one staged buffer
template <int kPattern, int kDepth>
__global__ void __launch_bounds__(kThreads)
dma_probe_kernel(const int8_t* __restrict__ cap, const long long* __restrict__ starts_w,
                 long long* __restrict__ sums, int r, int n_ch, int win, int spc, int slot) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ long long red[kWarps];
  __shared__ __align__(8) uint64_t bars[kDepth];
  const int c = blockIdx.x;
  const long long start_b = 4 * starts_w[c];

  if constexpr (kPattern == kDirect) {
    for (int j = 0; j < r; ++j) {
      const long long t =
          block_sum(sum_bytes(cap + start_b + static_cast<long long>(j) * spc, win), red);
      if (threadIdx.x == 0) sums[static_cast<long long>(j) * n_ch + c] = t;
    }
  } else if constexpr (kPattern == kCpAsync) {
    for (int d = 0; d < kDepth - 1; ++d) {
      if (d < r) start_cp_async(cap, span_of(start_b, d, spc, win), stage + d * slot);
      else asm volatile("cp.async.commit_group;" ::: "memory");
    }
    for (int j = 0; j < r; ++j) {
      const int jn = j + kDepth - 1;
      if (jn < r) start_cp_async(cap, span_of(start_b, jn, spc, win), stage + (jn % kDepth) * slot);
      else asm volatile("cp.async.commit_group;" ::: "memory");  // keep the group count
      asm volatile("cp.async.wait_group %0;" ::"n"(kDepth - 1) : "memory");
      __syncthreads();
      const Span s = span_of(start_b, j, spc, win);
      const int8_t* src = reinterpret_cast<const int8_t*>(stage + (j % kDepth) * slot) + s.lead;
      const long long t = block_sum(sum_bytes(src, win), red);
      if (threadIdx.x == 0) sums[static_cast<long long>(j) * n_ch + c] = t;
    }
  } else {
    if (threadIdx.x == 0) {
      for (int d = 0; d < kDepth; ++d)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bars + d))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int d = 0; d < kDepth - 1 && d < r; ++d)
        start_bulk(cap, span_of(start_b, d, spc, win), stage + d * slot, bars + d);
    }
    __syncthreads();
    for (int j = 0; j < r; ++j) {
      const int jn = j + kDepth - 1;
      if (threadIdx.x == 0 && jn < r)
        start_bulk(cap, span_of(start_b, jn, spc, win), stage + (jn % kDepth) * slot,
                   bars + jn % kDepth);
      wait_bar(bars + j % kDepth, static_cast<uint32_t>((j / kDepth) & 1));
      const Span s = span_of(start_b, j, spc, win);
      const int8_t* src = reinterpret_cast<const int8_t*>(stage + (j % kDepth) * slot) + s.lead;
      const long long t = block_sum(sum_bytes(src, win), red);
      if (threadIdx.x == 0) sums[static_cast<long long>(j) * n_ch + c] = t;
    }
  }
}

template <int kPattern, int kDepth>
int launch(const void* cap, const void* starts_w, void* sums, int r, int n_ch, int win,
           int spc, void* stream) {
  const int slot = (win + 16 + 15) & ~15;
  const int smem = kPattern == kDirect ? 0 : kDepth * slot;
  auto kernel = dma_probe_kernel<kPattern, kDepth>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_ch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(cap), static_cast<const long long*>(starts_w),
      static_cast<long long*>(sums), r, n_ch, win, spc, slot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cap: int8 capture, 16-byte aligned, holding every staged span (the
// wrapper checks); starts_w: (n_ch,) int64 word offsets of ms 0; sums:
// (r, n_ch) int64.  pattern 0 direct (depth ignored), 1 cp.async, 2 bulk;
// depth 2 or 4.
extern "C" int sg_dma_probe(int pattern, int depth, const void* cap, const void* starts_w,
                            void* sums, int r, int n_ch, int win, int spc, void* stream) {
  if (r <= 0 || n_ch <= 0 || win <= 0) return 0;
  if (pattern == kDirect) return launch<kDirect, 1>(cap, starts_w, sums, r, n_ch, win, spc, stream);
  if (pattern == kCpAsync && depth == 2)
    return launch<kCpAsync, 2>(cap, starts_w, sums, r, n_ch, win, spc, stream);
  if (pattern == kCpAsync && depth == 4)
    return launch<kCpAsync, 4>(cap, starts_w, sums, r, n_ch, win, spc, stream);
  if (pattern == kBulk && depth == 2)
    return launch<kBulk, 2>(cap, starts_w, sums, r, n_ch, win, spc, stream);
  if (pattern == kBulk && depth == 4)
    return launch<kBulk, 4>(cap, starts_w, sums, r, n_ch, win, spc, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
