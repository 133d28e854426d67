// B2, the per-ms frames builder.
//
// Replaces: softgnss_tpu/track/megakernel.py::_builder_kernel (launched by
// megakernel.build_frames).  That kernel gathers each channel's per-ms
// window of the int32 capture view into an HBM frames array with 128-word
// DMA slabs and sliding lane rolls, because TPU DMAs are lane-tile aligned.
//
// What it computes:
//   frames[j, c, i] = cap[starts[c] + j*spc_w + i]  for i < win_w,
// and 0 for a word before the capture start or past its end (those
// samples lie outside every channel's true ms span once track()'s length
// check has passed; the zero fill replaces the JAX pre-slice clipping).
//
// What bounds it on the H100: memory traffic.  It writes r*C*win_w words
// (~19.6 MB per 64-ms block at the reference front end, 8 channels) and
// must read the capture words some frame holds once (~2.5 MB): 6.6 us at
// 3.35 TB/s.  The capture span of a block is cold in L2 when B2 reaches it
// (the main path walks the capture once, in order); the frames stay in L2
// for B1, which reads them next.  On the card a contiguous fill_ of the
// frames' bytes alone takes ~8.5 us, and every byte read through L2 adds
// to the stores' time, so the design reads each capture word once per
// column group, not once per channel.
//
// Design (build_frames_bulk_kernel<kUnion>, the main path's).  One CTA per
// (ms j, column group g): the columns [g*group_w, (g+1)*group_w) of the
// frames of ms j of EVERY channel, so that every CTA writes the same
// C*group_w words; the plan gives about one CTA per SM at r = 64.  With
// kUnion the hull of the C channels' source words for those columns (from
// the smallest start's first column to the largest start's last: the
// channels' code phases lie within one code period, so ~spc_w + group_w
// words) is staged into shared memory ONCE, by up to kMaxParts 1-D TMA
// bulk copies (cp.async.bulk ... complete_tx, each part on its own
// mbarrier) that thread 0 issues at the start; once they have landed the
// whole CTA writes each channel's columns from it.  A hull wider than the
// buffer (starts further apart), or no kUnion, stages each channel's
// columns on their own, as many per round as the buffer holds, a CTA
// barrier between rounds.  No slot is reused on the hull path, so no CTA
// barrier follows a burst of stores there: on the card such a barrier
// waits for the stores to drain, and a ring reused behind one cost more
// than the copies saved.  The host never looks at the starts (a look
// would synchronise every call): each CTA takes their extremes itself.
//
// The copy stages the 16-byte aligned superset of the hull's words that
// lie inside the capture ([0, n_words): the bulk copy has no out-of-bounds
// fill and needs 16-byte aligned addresses and sizes); the capture view is
// only 4-byte aligned, so the ABSOLUTE address is aligned down, and every
// 16-byte line of the copy holds a capture word, so it stays inside the
// capture's allocation.  Words outside the capture are written as 0 from
// registers.  The frame words are written as int4 (st.global.v4, the
// default write-back policy: B1 reads them next) where the destination is
// 16-byte aligned, each built from the two aligned int4s of the buffer
// that hold it at the frame's word shift, with a scalar head and tail
// (win_w need not be a multiple of 4).  megakernel.frames_plan makes the
// launch plan (groups, buffer, parts, threads, dynamic shared memory);
// megakernel.frames_walk is this kernel's walk in Python, which the CPU
// tests replay.
//
// build_frames_direct_kernel (sg_build_frames_direct, scripts/
// builder_time.py's ``direct``) is the same CTAs without the staging: each
// int4 from two 16-byte read-only loads of the capture, the channels'
// overlapping windows then hitting in L1.
//
// build_frames_vec4_kernel (sg_build_frames_vec4) is a 16-byte variant of
// B2's first design (one CTA of 256 threads per (ms, channel), one 4-byte
// load and store per thread and iteration, which lost every timing to the
// bulk design and was deleted), the counterpart of scripts/builder_time.py's
// roll-width variants (``_builder_var``): each thread stores one int4 of
// the frame.  Frame
// (j, c) starts at word starts[c] + j*spc_w, which is 4-byte aligned only,
// so the kernel copies a scalar head up to the frame's first 16-byte
// boundary and a scalar tail, and builds each int4 of the body from the
// two aligned int4s of the capture that hold it (the shift is the same for
// the whole frame).  An int4 whose source leaves the capture is copied
// word by word with the zero fill, so the variant is bit-equal to the
// plain version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t word_at(const int32_t* __restrict__ cap, long long n_words,
                                           long long s) {
  return (s >= 0 && s < n_words) ? cap[s] : 0;
}

// needs cap and frames 16-byte aligned (the wrapper checks cap; frames is
// a fresh allocation)
__global__ void __launch_bounds__(kThreads)
build_frames_vec4_kernel(const int32_t* __restrict__ cap, long long n_words,
                         const long long* __restrict__ starts,
                         int32_t* __restrict__ frames, int n_ch, int win_w,
                         long long spc_w) {
  const int j = blockIdx.x;
  const int c = blockIdx.y;
  const long long base = starts[c] + static_cast<long long>(j) * spc_w;
  const long long d0 = (static_cast<long long>(j) * n_ch + c) * win_w;
  int32_t* out = frames + d0;
  const int head = min(static_cast<int>((4 - (d0 & 3)) & 3), win_w);
  const int n4 = (win_w - head) >> 2;
  for (int i = threadIdx.x; i < head; i += kThreads) out[i] = word_at(cap, n_words, base + i);
  for (int i = head + 4 * n4 + threadIdx.x; i < win_w; i += kThreads)
    out[i] = word_at(cap, n_words, base + i);

  const long long s0 = base + head;        // source word of the body's first word
  const long long a0 = s0 >> 2;            // its aligned int4 (floor, any sign)
  const int sh = static_cast<int>(s0 & 3);
  const long long n4_cap = n_words >> 2;   // whole int4s inside the capture
  const int4* cap4 = reinterpret_cast<const int4*>(cap);
  int4* out4 = reinterpret_cast<int4*>(out + head);
  for (int q = threadIdx.x; q < n4; q += kThreads) {
    const long long a = a0 + q;
    int4 v;
    if (a >= 0 && a + (sh != 0) < n4_cap) {
      const int4 lo = __ldg(cap4 + a);
      if (sh == 0) {
        v = lo;
      } else {
        const int4 hi = __ldg(cap4 + a + 1);
        v = sh == 1 ? make_int4(lo.y, lo.z, lo.w, hi.x)
          : sh == 2 ? make_int4(lo.z, lo.w, hi.x, hi.y)
                    : make_int4(lo.w, hi.x, hi.y, hi.z);
      }
    } else {  // at a capture edge: word by word, zero outside
      const long long s = s0 + 4LL * q;
      v = make_int4(word_at(cap, n_words, s), word_at(cap, n_words, s + 1),
                    word_at(cap, n_words, s + 2), word_at(cap, n_words, s + 3));
    }
    out4[q] = v;
  }
}

}  // namespace

// --- the bulk design ------------------------------------------------------

namespace {

constexpr int kBulkMaxThreads = 1024;
constexpr int kMaxParts = 16;           // bulk copies (mbarriers) of one hull
constexpr int kMaxSmem = 232448;        // an H100 CTA's dynamic shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void expect_bytes(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A staged span of source words: [v0, v1) of the capture (the words of
// [lo, hi) inside it) at buffer word ``off`` + ``lead`` on, copied from the
// 16-byte aligned ``copy`` (``bytes``, a multiple of 16).
struct Span {
  long long v0, v1;
  int lead, bytes;
  const int32_t* copy;
};

__device__ __forceinline__ Span span_of(const int32_t* cap, long long n_words, long long lo,
                                        long long hi) {
  Span sp;
  sp.v0 = max(lo, 0LL);
  sp.v1 = max(min(hi, n_words), sp.v0);
  if (sp.v1 > sp.v0) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(cap + sp.v0);
    const uintptr_t b = a & ~static_cast<uintptr_t>(15);
    const uintptr_t e = (reinterpret_cast<uintptr_t>(cap + sp.v1) + 15) & ~static_cast<uintptr_t>(15);
    sp.lead = static_cast<int>((a - b) >> 2);
    sp.bytes = static_cast<int>(e - b);
    sp.copy = reinterpret_cast<const int32_t*>(b);
  } else {
    sp.lead = 0;
    sp.bytes = 0;
    sp.copy = cap;
  }
  return sp;
}

// the four words from buffer word o on, o = 4 * (o >> 2) + sh
__device__ __forceinline__ int4 shifted(const int4* b4, int o, int sh) {
  const int4 x = b4[o >> 2];
  if (sh == 0) return x;
  const int4 y = b4[(o >> 2) + 1];
  return sh == 1 ? make_int4(x.y, x.z, x.w, y.x)
       : sh == 2 ? make_int4(x.z, x.w, y.x, y.y)
                 : make_int4(x.w, y.x, y.y, y.z);
}

// Write columns [g_lo, g_hi) of frame (j, d) (its first word at ``dst0``),
// whose source words start at sd + g_lo and lie in span ``sp`` staged at
// buffer word ``off``: the 16-byte aligned destination words as int4, each
// built from the two aligned int4s of the buffer that hold it at the
// frame's word shift, a scalar head and tail around them, 0 for a word
// outside the capture; the CTA's threads take every blockDim.x-th int4.
__device__ __forceinline__ void write_cols(const Span& sp, const int32_t* buf, int off,
                                           int32_t* __restrict__ frames, long long dst0,
                                           long long sd, int g_lo, int g_hi) {
  const int len = g_hi - g_lo;
  const long long a = sd + g_lo;                           // source of column g_lo
  int32_t* out = frames + dst0 + g_lo;
  const int head = min(static_cast<int>((4 - ((dst0 + g_lo) & 3)) & 3), len);
  const int n4 = (len - head) >> 2;
  auto word = [&](long long s) -> int32_t {
    return (s >= sp.v0 && s < sp.v1) ? buf[off + (s - sp.v0) + sp.lead] : 0;
  };
  if (threadIdx.x < head) out[threadIdx.x] = word(a + threadIdx.x);
  const int t0 = head + 4 * n4;
  if (threadIdx.x < len - t0) out[t0 + threadIdx.x] = word(a + t0 + threadIdx.x);
  const long long sb = a + head;                           // source of the first int4
  const int sh = static_cast<int>((sb - sp.v0 + sp.lead) & 3);
  int4* out4 = reinterpret_cast<int4*>(out + head);
  const int4* b4 = reinterpret_cast<const int4*>(buf + off);
  for (int q = threadIdx.x; q < n4; q += blockDim.x) {
    const long long s = sb + 4LL * q;
    out4[q] = (s >= sp.v0 && s + 4 <= sp.v1)
                  ? shifted(b4, static_cast<int>(s - sp.v0) + sp.lead, sh)
                  : make_int4(word(s), word(s + 1), word(s + 2), word(s + 3));
  }
}

// dynamic shared memory of a launch: the staging buffer, the mbarriers and
// the starts
__host__ __device__ constexpr long long bulk_smem(int n_ch, int buf_w) {
  return 4LL * buf_w + 8LL * kMaxParts + 8LL * n_ch;
}

// CTA (g, j): columns [g*group_w, (g+1)*group_w) of the frames of ms j of
// every channel.  With kUnion, when the hull of the channels' source words
// for these columns (from the smallest start's first column to the
// largest start's last) fits in the buffer's ``buf_w`` words, it is
// staged once, by up to kMaxParts bulk copies of about ``part_w`` words,
// each completing on its own mbarrier, and once all have landed every
// channel's columns are written from it by the whole CTA.  Otherwise (or without kUnion) each channel's columns
// are staged on their own, as many channels per round as the buffer
// holds, a CTA barrier between rounds (the barrier waits for the round's
// stores to drain, so the hull path has none).
template <bool kUnion>
__global__ void __launch_bounds__(kBulkMaxThreads)
build_frames_bulk_kernel(const int32_t* __restrict__ cap, long long n_words,
                         const long long* __restrict__ starts, int32_t* __restrict__ frames,
                         int n_ch, int win_w, long long spc_w, int group_w, int buf_w,
                         int part_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_min, s_max;
  int32_t* buf = reinterpret_cast<int32_t*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 4LL * buf_w);
  long long* st = reinterpret_cast<long long*>(bars + kMaxParts);
  const int j = blockIdx.y;
  const int g_lo = blockIdx.x * group_w, g_hi = min(g_lo + group_w, win_w);
  const long long base = static_cast<long long>(j) * spc_w;
  for (int c = threadIdx.x; c < n_ch; c += blockDim.x) st[c] = starts[c];
  __syncthreads();
  if (threadIdx.x == 0) {
    long long lo = st[0], hi = st[0];
    for (int c = 1; c < n_ch; ++c) {
      lo = min(lo, st[c]);
      hi = max(hi, st[c]);
    }
    s_min = lo;
    s_max = hi;
    for (int k = 0; k < kMaxParts; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bars + k))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long long h_lo = s_min + base + g_lo, h_hi = s_max + base + g_hi;
  if (kUnion && h_hi - h_lo + 8 <= buf_w) {
    const Span sp = span_of(cap, n_words, h_lo, h_hi);
    const int want = (sp.bytes / 4 + part_w - 1) / part_w;
    const int parts = max(1, min(want, kMaxParts));
    const int pb = ((sp.bytes / parts + 15) / 16) * 16;    // bytes per part, the last shorter
    if (threadIdx.x == 0)
      for (int k = 0; k < parts; ++k) {
        const int bytes = max(min(pb, sp.bytes - k * pb), 0);
        expect_bytes(bars + k, bytes);
        if (bytes > 0)
          bulk_copy(buf + k * (pb / 4), reinterpret_cast<const char*>(sp.copy) + k * pb, bytes,
                    bars + k);
      }
    for (int k = 0; k < parts; ++k) wait_bar(bars + k, 0);
    for (int d = 0; d < n_ch; ++d)
      write_cols(sp, buf, 0, frames, (static_cast<long long>(j) * n_ch + d) * win_w,
                 st[d] + base, g_lo, g_hi);
    return;
  }
  const int stride = ((g_hi - g_lo + 8 + 3) / 4) * 4;      // buffer words per channel
  const int per_round = buf_w / stride;
  for (int c0 = 0, round = 0; c0 < n_ch; c0 += per_round, ++round) {
    const int c1 = min(c0 + per_round, n_ch);
    if (round > 0) __syncthreads();                        // every thread has read the buffer
    if (threadIdx.x == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      int total = 0;
      for (int c = c0; c < c1; ++c) total += span_of(cap, n_words, st[c] + base + g_lo,
                                                     st[c] + base + g_hi).bytes;
      expect_bytes(bars, total);
      for (int c = c0; c < c1; ++c) {
        const Span sp = span_of(cap, n_words, st[c] + base + g_lo, st[c] + base + g_hi);
        if (sp.bytes > 0) bulk_copy(buf + (c - c0) * stride, sp.copy, sp.bytes, bars);
      }
    }
    wait_bar(bars, static_cast<uint32_t>(round & 1));
    for (int c = c0; c < c1; ++c)
      write_cols(span_of(cap, n_words, st[c] + base + g_lo, st[c] + base + g_hi), buf,
                 (c - c0) * stride, frames, (static_cast<long long>(j) * n_ch + c) * win_w,
                 st[c] + base, g_lo, g_hi);
  }
}

// S3's ``direct`` variant: the bulk design's units (CTA (g, j), columns
// [g*group_w, (g+1)*group_w) of every channel's frame of ms j), each int4
// built from two 16-byte read-only loads of the capture (ld.global.nc, the
// channels' overlapping windows then hit in L1) in place of the staged
// hull; words at a capture edge one by one, 0 outside.  Needs cap 16-byte
// aligned (the wrapper checks).
__global__ void __launch_bounds__(kBulkMaxThreads)
build_frames_direct_kernel(const int32_t* __restrict__ cap, long long n_words,
                           const long long* __restrict__ starts, int32_t* __restrict__ frames,
                           int n_ch, int win_w, long long spc_w, int group_w) {
  const int j = blockIdx.y;
  const int g_lo = blockIdx.x * group_w, g_hi = min(g_lo + group_w, win_w);
  const int len = g_hi - g_lo;
  const int4* cap4 = reinterpret_cast<const int4*>(cap);
  const long long n4_cap = n_words >> 2;                   // whole int4s inside the capture
  for (int d = 0; d < n_ch; ++d) {
    const long long dst0 = (static_cast<long long>(j) * n_ch + d) * win_w + g_lo;
    const long long a = starts[d] + static_cast<long long>(j) * spc_w + g_lo;
    int32_t* out = frames + dst0;
    const int head = min(static_cast<int>((4 - (dst0 & 3)) & 3), len);
    const int n4 = (len - head) >> 2;
    const int t0 = head + 4 * n4;
    if (threadIdx.x < head) out[threadIdx.x] = word_at(cap, n_words, a + threadIdx.x);
    if (threadIdx.x < len - t0) out[t0 + threadIdx.x] = word_at(cap, n_words, a + t0 + threadIdx.x);
    const long long s0 = a + head;
    const long long a0 = s0 >> 2;                          // its aligned int4 (floor, any sign)
    const int sh = static_cast<int>(s0 & 3);
    int4* out4 = reinterpret_cast<int4*>(out + head);
    for (int q = threadIdx.x; q < n4; q += blockDim.x) {
      const long long v = a0 + q;
      int4 x;
      if (v >= 0 && v + (sh != 0) < n4_cap) {
        const int4 lo = __ldg(cap4 + v);
        if (sh == 0) {
          x = lo;
        } else {
          const int4 hi = __ldg(cap4 + v + 1);
          x = sh == 1 ? make_int4(lo.y, lo.z, lo.w, hi.x)
            : sh == 2 ? make_int4(lo.z, lo.w, hi.x, hi.y)
                      : make_int4(lo.w, hi.x, hi.y, hi.z);
        }
      } else {
        const long long s = s0 + 4LL * q;
        x = make_int4(word_at(cap, n_words, s), word_at(cap, n_words, s + 1),
                      word_at(cap, n_words, s + 2), word_at(cap, n_words, s + 3));
      }
      out4[q] = x;
    }
  }
}

}  // namespace

// the 16-byte variant: a grid of (r, n_ch) CTAs of kThreads threads; cap
// and frames 16-byte aligned (the wrapper checks cap)
extern "C" int sg_build_frames_vec4(const void* cap, long long n_words,
                                    const void* starts, void* frames, int r,
                                    int n_ch, int win_w, long long spc_w,
                                    void* stream) {
  if (r <= 0 || n_ch <= 0 || win_w <= 0) return 0;
  const dim3 grid(r, n_ch);
  build_frames_vec4_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cap), n_words,
      static_cast<const long long*>(starts), static_cast<int32_t*>(frames),
      n_ch, win_w, spc_w);
  return static_cast<int>(cudaGetLastError());
}

// the bulk design at a plan of megakernel.frames_plan: ``unite`` selects
// kUnion; a grid of (ceil(win_w / group_w), r) CTAs of ``threads`` threads,
// a staging buffer of ``buf_w`` words (at least group_w + 8 rounded up to
// 4) in ``smem_bytes`` of dynamic shared memory (at least bulk_smem);
// returns cudaErrorInvalidValue for a plan past the kernel's limits, a
// capture not 4-byte aligned or frames not 16-byte aligned
extern "C" int sg_build_frames_bulk(const void* cap, long long n_words, const void* starts,
                                    void* frames, int r, int n_ch, int win_w, long long spc_w,
                                    int unite, int group_w, int buf_w, int part_w, int threads,
                                    int smem_bytes, void* stream) {
  if (r <= 0 || n_ch <= 0 || win_w <= 0) return 0;
  if (group_w < 1 || buf_w < ((min(group_w, win_w) + 8 + 3) / 4) * 4 || buf_w % 4 != 0 ||
      part_w < 16 || threads < 32 || threads > kBulkMaxThreads || threads % 32 != 0 ||
      r > 65535 || smem_bytes > kMaxSmem || smem_bytes < bulk_smem(n_ch, buf_w) ||
      (reinterpret_cast<uintptr_t>(cap) & 3) != 0 || (reinterpret_cast<uintptr_t>(frames) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const int32_t*, long long, const long long*, int32_t*, int, int, long long, int,
                 int, int) = unite ? build_frames_bulk_kernel<true> : build_frames_bulk_kernel<false>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((win_w + group_w - 1) / group_w, r);
  kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cap), n_words, static_cast<const long long*>(starts),
      static_cast<int32_t*>(frames), n_ch, win_w, spc_w, group_w, buf_w, part_w);
  return static_cast<int>(cudaGetLastError());
}

// S3's direct variant at the bulk design's groups: a grid of
// (ceil(win_w / group_w), r) CTAs of ``threads`` threads; cap 16-byte
// aligned (else cudaErrorInvalidValue)
extern "C" int sg_build_frames_direct(const void* cap, long long n_words, const void* starts,
                                      void* frames, int r, int n_ch, int win_w, long long spc_w,
                                      int group_w, int threads, void* stream) {
  if (r <= 0 || n_ch <= 0 || win_w <= 0) return 0;
  if (group_w < 1 || threads < 32 || threads > kBulkMaxThreads || threads % 32 != 0 ||
      r > 65535 || (reinterpret_cast<uintptr_t>(cap) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(frames) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((win_w + group_w - 1) / group_w, r);
  build_frames_direct_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cap), n_words, static_cast<const long long*>(starts),
      static_cast<int32_t*>(frames), n_ch, win_w, spc_w, group_w);
  return static_cast<int>(cudaGetLastError());
}
