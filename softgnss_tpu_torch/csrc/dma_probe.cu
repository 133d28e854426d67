// S4, the load-pattern probe: how fast a channel's per-ms window comes on
// chip, millisecond after millisecond, at B1's geometry: one thread-block
// cluster of kN CTAs per channel, rank q on its slice of every window.
//
// Replaces: scripts/dma_probe.py::kernel (a (C, win_pk + 128) int32 slab
// per ms, double-buffered), scripts/dma_probe2.py and dma_probe3.py (one
// 1-D copy per channel from the capture view, double-buffered) and
// scripts/dma_probe4.py::kernel (a depth-4 DMA pipeline), which probed the
// TPU's DMA engine for the megakernel's frame fetch.  What they measure
// is computed here, not their Mosaic layout: for each of r ms in order,
// the window of ``win`` int8 samples at byte 4*starts_w[c] + j*spc of the
// capture is brought on chip and the exact int64 sum of its bytes is
// written to sums[j, c]; window bytes outside the capture read as zero, as
// build_frames.cu fills them, so the wrapper needs no look at the starts
// (a host check of them would synchronise every call).
//
// Design (dma_probe_kernel<kPattern, kDepth, kN>).  Channel c is the
// cluster of CTAs c*kN .. c*kN + kN-1 (a 1-D grid of C*kN CTAs, cluster
// dimension kN, launched by cudaLaunchKernelEx; 16 is a non-portable
// size), as B1 runs (track_block.cu).  Rank q owns the window bytes
// [q*chunk, (q+1)*chunk) clipped to [0, win), ``chunk`` = win/kN rounded
// up to 16 bytes (megakernel.rank_chunk / rank_slices, B1's split).  The
// rank reads its slice of window j as the vectors [v0, v1) of the
// capture's 16-byte grid that hold it: the window start is only 4-byte
// aligned (lead 0, 4, 8 or 12 at the reference front end; any lead is
// taken), so the first and last vector are shared with the neighbouring
// slice or window, and their bytes outside [4*starts_w[c] + j*spc + lo,
// .. + hi) are masked to zero (as correlate_ms.cu cuts B4's window): each
// byte counts once at any alignment.  A vector's 16 bytes are summed by
// four dp4a (signed bytes times 1).  The patterns:
//   kDirect   — 16-byte read-only global loads (ld.global.nc.v4), no
//               staging and no CTA barrier per ms: warp w takes ms w,
//               w + warps, ... (the ms sums do not feed each other), its
//               lanes stride the rank's vectors, and a shuffle tree gives
//               the rank's partial of the ms;
//   kCpAsync  — 16-byte cp.async.cg copies of the rank's vectors into
//               shared memory, kDepth buffers in flight (dma_probe.py /
//               dma_probe2/3.py at 2, dma_probe4.py at 4);
//   kBulk     — one 1-D TMA bulk copy of the rank's vectors per ms
//               (cp.async.bulk ... complete_tx on an mbarrier), kDepth
//               buffers in flight: at kN = 16, depth 2, B1's staging.
// The staged patterns keep a buffer per ms in flight and one CTA barrier
// per ms (every thread has read ms j - 1's buffer before it is refilled);
// their warps add their partials into the ms's int64 slot by shared
// atomics (integers: exact in any order).  Each rank keeps its r int64
// partials in shared memory; ONE cluster barrier at the end of the launch,
// rank 0 reads the kN ranks' partials through distributed shared memory in
// rank order and writes sums, and a last barrier keeps the peers resident
// while it reads.  B1's per-ms handoff of the partials is what S5 ``acc``
// measures, not this probe.
//
// The launch plan (kN, threads per CTA, chunk, slot bytes, dynamic shared
// memory) is made in Python alone (scripts/dma_probe.py ``dma_plan``);
// sg_dma_probe launches with it and only refuses a plan past the kernel's
// limits.
//
// What bounds it on the H100: the window bytes, 19.6 MB per call at C = 8,
// r = 64 (2.5 MB of them unique capture bytes, the rest L2 hits of
// overlapping windows), spread over C*kN CTAs: at kN = 16, 128 CTAs, on
// every SM.  What is left is the launch of the clusters and the latency of
// a few dependent loads per warp and ms.
//
// The first design (one CTA of 512 threads per channel, thread-strided
// byte loads from global memory and a CTA sum with two barriers per ms; 8
// of 132 SMs busy at C = 8) lost every timing to ``direct`` and was
// deleted.
//
// Shared memory: one slot is chunk + 16 bytes (38 336 at kN = 1 at the
// reference front end), so a staged pattern takes kDepth slots plus the
// r partials; above 48 KB the launcher opts in with cudaFuncSetAttribute.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;       // launch bounds of dma_probe_kernel
constexpr int kMaxSmem = 232448;        // dynamic shared memory a CTA can use
constexpr int kDirect = 0;
constexpr int kCpAsync = 1;
constexpr int kBulk = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// One rank's part of window (j, c): the capture bytes [a, b) it sums, read
// as the 16-byte vectors [v0, v0 + nvec) of the capture that hold them
struct Slice {
  long long a;
  long long b;
  long long v0;
  int nvec;
};

__device__ __forceinline__ Slice slice_of(long long start_b, int j, int spc, int lo, int hi,
                                          long long n_cap) {
  const long long off = start_b + static_cast<long long>(j) * spc;
  Slice s;
  s.a = max(off + lo, 0LL);  // bytes outside the capture read as zero
  s.b = min(off + hi, n_cap);
  s.v0 = s.a >> 4;
  s.nvec = s.b > s.a ? static_cast<int>(((s.b + 15) >> 4) - s.v0) : 0;
  return s;
}

// bytes [l, h) of a little-endian 32-bit word
__device__ __forceinline__ uint32_t byte_mask(int l, int h) {
  l = min(max(l, 0), 4);
  h = min(max(h, 0), 4);
  if (h <= l) return 0u;
  return static_cast<uint32_t>(((1ull << (8 * h)) - 1ull) ^ ((1ull << (8 * l)) - 1ull));
}

// the sum of the bytes of capture vector q (bytes [16 q, 16 q + 16)) that
// lie in [a, b): interior vectors take four dp4a, edge vectors mask first
__device__ __forceinline__ int vec_sum(uint4 v, long long q, long long a, long long b) {
  const long long base = 16 * q;
  constexpr int kOnes = 0x01010101;
  if (base >= a && base + 16 <= b) {
    int t = __dp4a(static_cast<int>(v.x), kOnes, 0);
    t = __dp4a(static_cast<int>(v.y), kOnes, t);
    t = __dp4a(static_cast<int>(v.z), kOnes, t);
    return __dp4a(static_cast<int>(v.w), kOnes, t);
  }
  const int l = static_cast<int>(min(max(a - base, 0LL), 16LL));
  const int h = static_cast<int>(min(max(b - base, 0LL), 16LL));
  int t = __dp4a(static_cast<int>(v.x & byte_mask(l, h)), kOnes, 0);
  t = __dp4a(static_cast<int>(v.y & byte_mask(l - 4, h - 4)), kOnes, t);
  t = __dp4a(static_cast<int>(v.z & byte_mask(l - 8, h - 8)), kOnes, t);
  return __dp4a(static_cast<int>(v.w & byte_mask(l - 12, h - 12)), kOnes, t);
}

__device__ __forceinline__ void start_cp_async(const int8_t* cap, const Slice& s,
                                               unsigned char* buf) {
  for (int i = threadIdx.x; i < s.nvec; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(buf + 16 * i)),
                 "l"(cap + 16 * (s.v0 + i))
                 : "memory");
}

// thread 0 only: stage the slice's vectors into ``buf``, completion counted
// on ``bar`` (an empty slice only arrives, so the phase still completes)
__device__ __forceinline__ void start_bulk(const int8_t* cap, const Slice& s,
                                           unsigned char* buf, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // after the reads of the last use
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(16 * s.nvec)
               : "memory");
  if (s.nvec > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(buf)), "l"(cap + 16 * s.v0), "r"(16 * s.nvec), "r"(smem_addr(bar))
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

// the staged slot's vectors summed by the CTA, added into ``part``
__device__ __forceinline__ void sum_staged(const unsigned char* buf, const Slice& s,
                                           long long* part) {
  const uint4* v = reinterpret_cast<const uint4*>(buf);
  int t = 0;
  for (int i = threadIdx.x; i < s.nvec; i += blockDim.x) t += vec_sum(v[i], s.v0 + i, s.a, s.b);
  t = warp_sum(t);
  if ((threadIdx.x & 31) == 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(part),
              static_cast<unsigned long long>(static_cast<long long>(t)));
}

// sums[j * n_ch + c]; ``chunk``: window bytes per rank; ``slot``: bytes of
// one staging buffer (chunk + 16); dynamic shared memory: kDepth slots
// (staged patterns), then the rank's r int64 partials
template <int kPattern, int kDepth, int kN>
__global__ void __launch_bounds__(kMaxThreads)
dma_probe_kernel(const int8_t* __restrict__ cap, long long n_cap,
                 const long long* __restrict__ starts_w, long long* __restrict__ sums, int r,
                 int n_ch, int win, int spc, int chunk, int slot) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t bars[kDepth];
  constexpr bool kStaged = kPattern != kDirect;
  long long* part = reinterpret_cast<long long*>(stage + (kStaged ? kDepth * slot : 0));
  const int c = blockIdx.x / kN;
  const int rank = static_cast<int>(blockIdx.x % kN);  // the 1-D cluster's block rank
  const int tid = threadIdx.x;
  const long long start_b = 4 * starts_w[c];
  const int lo = min(rank * chunk, win);
  const int hi = min(lo + chunk, win);
  auto slice = [&](int j) { return slice_of(start_b, j, spc, lo, hi, n_cap); };

  if constexpr (kPattern == kDirect) {
    const uint4* vcap = reinterpret_cast<const uint4*>(cap);
    const int warp = tid >> 5, lane = tid & 31;
    for (int j = warp; j < r; j += static_cast<int>(blockDim.x >> 5)) {
      const Slice s = slice(j);
      int t = 0;
#pragma unroll 4
      for (int i = lane; i < s.nvec; i += 32) {
        const long long q = s.v0 + i;
        t += vec_sum(__ldg(vcap + q), q, s.a, s.b);
      }
      t = warp_sum(t);
      if (lane == 0) part[j] = t;
    }
  } else if constexpr (kPattern == kCpAsync) {
    for (int j = tid; j < r; j += blockDim.x) part[j] = 0;
    for (int d = 0; d < kDepth - 1; ++d) {
      if (d < r) start_cp_async(cap, slice(d), stage + d * slot);
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
    for (int j = 0; j < r; ++j) {
      asm volatile("cp.async.wait_group %0;" ::"n"(kDepth - 2) : "memory");  // ms j: this thread's
      __syncthreads();  // ms j landed for every thread; ms j - 1's slot is free
      const int jn = j + kDepth - 1;
      if (jn < r) start_cp_async(cap, slice(jn), stage + (jn % kDepth) * slot);
      asm volatile("cp.async.commit_group;" ::: "memory");  // keep the group count
      sum_staged(stage + (j % kDepth) * slot, slice(j), part + j);
    }
  } else {
    if (tid == 0) {
      for (int d = 0; d < kDepth; ++d)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bars + d))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int d = 0; d < kDepth - 1 && d < r; ++d)
        start_bulk(cap, slice(d), stage + d * slot, bars + d);
    }
    for (int j = tid; j < r; j += blockDim.x) part[j] = 0;
    for (int j = 0; j < r; ++j) {
      __syncthreads();  // the barriers are set up; every thread has read ms j - 1's slot
      const int jn = j + kDepth - 1;
      if (tid == 0 && jn < r)
        start_bulk(cap, slice(jn), stage + (jn % kDepth) * slot, bars + jn % kDepth);
      wait_bar(bars + j % kDepth, static_cast<uint32_t>((j / kDepth) & 1));
      sum_staged(stage + (j % kDepth) * slot, slice(j), part + j);
    }
  }

  if constexpr (kN > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's partials are written
    if (rank == 0) {
      for (int j = tid; j < r; j += blockDim.x) {
        long long t = 0;
#pragma unroll
        for (int q = 0; q < kN; ++q) t += *cluster.map_shared_rank(part + j, q);
        sums[static_cast<long long>(j) * n_ch + c] = t;
      }
    }
    cluster.sync();  // peers stay resident while rank 0 reads their partials
  } else {
    __syncthreads();
    for (int j = tid; j < r; j += blockDim.x) sums[static_cast<long long>(j) * n_ch + c] = part[j];
  }
}

template <int kPattern, int kDepth, int kN>
int launch(const void* cap, long long n_cap, const void* starts_w, void* sums, int r, int n_ch,
           int win, int spc, int threads, int chunk, int slot, int smem, void* stream) {
  auto kernel = dma_probe_kernel<kPattern, kDepth, kN>;
  const long long need = (kPattern == kDirect ? 0LL : static_cast<long long>(kDepth) * slot) +
                         8LL * r;
  if (threads < 32 || threads > kMaxThreads || threads % 32 || chunk <= 0 || chunk % 16 ||
      static_cast<long long>(chunk) * kN < win || slot < chunk + 16 || slot % 16 ||
      smem < need || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (kN > 8) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(static_cast<unsigned>(n_ch * kN));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kN;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = kN > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<const int8_t*>(cap), n_cap,
                         static_cast<const long long*>(starts_w), static_cast<long long*>(sums),
                         r, n_ch, win, spc, chunk, slot);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// kN from its runtime value: 1, 2, 4, 8 or 16
#define SG_BY_KN(KN, CALL)                                   \
  switch (KN) {                                              \
    case 1: { constexpr int kN = 1; return CALL; }           \
    case 2: { constexpr int kN = 2; return CALL; }           \
    case 4: { constexpr int kN = 4; return CALL; }           \
    case 8: { constexpr int kN = 8; return CALL; }           \
    case 16: { constexpr int kN = 16; return CALL; }         \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

// cap: (n_cap,) int8 capture, 16-byte aligned; window bytes outside it
// read as zero, and a 16-byte vector read holds a capture byte, so it lies
// in the capture's allocation; starts_w: (n_ch,) int64 word offsets of ms
// 0; sums: (r, n_ch) int64.  pattern 0 direct (depth 1), 1 cp.async, 2
// bulk (depth 2 or 4); at the plan of scripts/dma_probe.py ``dma_plan``:
// ``kn`` CTAs per channel in one cluster, ``threads`` per CTA, ``chunk``
// window bytes per rank, ``slot`` bytes per staging buffer, ``smem`` bytes
// of dynamic shared memory.  cudaErrorInvalidValue for a plan past the
// kernel's limits.
extern "C" int sg_dma_probe(int pattern, int depth, int kn, int threads, int chunk, int slot,
                            int smem, const void* cap, long long n_cap, const void* starts_w,
                            void* sums, int r, int n_ch, int win, int spc, void* stream) {
  if (r <= 0 || n_ch <= 0 || win <= 0) return 0;
#define SG_LAUNCH(P, D)                                                                       \
  SG_BY_KN(kn, (launch<P, D, kN>(cap, n_cap, starts_w, sums, r, n_ch, win, spc, threads, chunk, \
                                 slot, smem, stream)))
  if (pattern == kDirect && depth == 1) SG_LAUNCH(kDirect, 1)
  if (pattern == kCpAsync && depth == 2) SG_LAUNCH(kCpAsync, 2)
  if (pattern == kCpAsync && depth == 4) SG_LAUNCH(kCpAsync, 4)
  if (pattern == kBulk && depth == 2) SG_LAUNCH(kBulk, 2)
  if (pattern == kBulk && depth == 4) SG_LAUNCH(kBulk, 4)
#undef SG_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
