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
// What bounds it on the H100: device-memory bandwidth.  It moves r*C*win_w
// words twice (read + write): ~19.6 MB each way per 64-ms block at the
// reference front end, a few microseconds at 3.35 TB/s.
//
// Design: global loads are byte-addressable here, so no slab alignment or
// roll is needed — one CTA per (ms, channel) copies its window with
// consecutive threads on consecutive words (coalesced 128-byte rows).
//
// build_frames_vec4_kernel is the 16-byte variant, the counterpart of
// scripts/builder_time.py's roll-width variants (``_builder_var``): each
// thread stores one int4 of the frame.  Frame (j, c) starts at word
// starts[c] + j*spc_w, which is 4-byte aligned only, so the kernel copies
// a scalar head up to the frame's first 16-byte boundary and a scalar
// tail, and builds each int4 of the body from the two aligned int4s of
// the capture that hold it (the shift is the same for the whole frame).
// An int4 whose source leaves the capture is copied word by word with the
// zero fill, so the variant is bit-equal to the one-word kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
build_frames_kernel(const int32_t* __restrict__ cap, long long n_words,
                    const long long* __restrict__ starts,
                    int32_t* __restrict__ frames, int n_ch, int win_w,
                    long long spc_w) {
  const int j = blockIdx.x;
  const int c = blockIdx.y;
  const long long base = starts[c] + static_cast<long long>(j) * spc_w;
  int32_t* out = frames + (static_cast<long long>(j) * n_ch + c) * win_w;
  for (int i = threadIdx.x; i < win_w; i += kThreads) {
    const long long s = base + i;
    out[i] = (s >= 0 && s < n_words) ? cap[s] : 0;
  }
}

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

extern "C" int sg_build_frames(const void* cap, long long n_words,
                               const void* starts, void* frames, int r,
                               int n_ch, int win_w, long long spc_w,
                               void* stream) {
  if (r <= 0 || n_ch <= 0 || win_w <= 0) return 0;
  const dim3 grid(r, n_ch);
  build_frames_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cap), n_words,
      static_cast<const long long*>(starts), static_cast<int32_t*>(frames),
      n_ch, win_w, spc_w);
  return static_cast<int>(cudaGetLastError());
}

// the 16-byte variant; arguments as sg_build_frames
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
