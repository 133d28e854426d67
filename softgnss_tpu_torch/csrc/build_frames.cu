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
