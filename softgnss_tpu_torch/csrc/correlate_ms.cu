// B4, the per-ms correlator: the six E/P/L sums of one millisecond for all
// channels; the loop filters run outside it (torch, track/scan.py).
//
// Replaces: softgnss_tpu/track/pallas_kernel.py::_kernel (launched by
// pallas_kernel.fused_correlate_ms from scan._frame_ms_pallas).  For each
// active channel c it sums over the code period k in [0, blk[c]):
//   x      = capture[ptr[c] + k]                      (int8, 0 outside)
//   counts = carr_phase[c] + w[c]*k  (mod 2^32)  -> turns -> sin/cos
//   tq     = rem[c] + step[c]*k      (Q40 chips) -> E/P/L chips of the
//            padded code at ceil(tq -/+ half) and ceil(tq)
// and returns [i_e, i_p, i_l, q_e, q_p, q_l] as float32.  This is
// scan._correlate_gather over [ptr, ptr+blk), the math of B1's sample loop.
// The TPU kernel's base-2^16 phase digits, hb_span map, one-hot code
// contraction and packed int16/int32 frame are Mosaic workarounds
// (no int64, slow gathers): CUDA has int64, and the code lookup is a
// shared-memory read.  The samples are read straight from the device
// capture, so no frame exists that a span could overflow.
//
// What bounds it on the H100: one ms of one channel is ~38k samples
// (~60 integer/float ops each) — a few microseconds of work for the card,
// less than a launch costs.  The route that calls it is host-bound.
//
// Design (simple and right first): a millisecond carries no recurrence, so
// one channel's samples spread over n_cta CTAs (grid (n_cta, C), 256
// threads, consecutive threads on consecutive samples, a CTA-strided loop
// that covers any blk).  Each CTA reduces its six float64 partial sums by
// warp shuffles and shared memory in a fixed order into a scratch row; a
// second kernel adds the n_cta rows of each channel in order and rounds
// once to float32.  Every order is fixed, and the float64 accumulation of
// the float32 products makes the float32 result agree with the plain
// version's to the last bit (bar a float64 sum within ~1e-16 of a float32
// rounding boundary).  Inactive channels write zeros and read nothing.
//
// Stage ablation (the counterpart of scripts/pallas_ablate.py's
// ``make_fn``, which stripped the TPU kernel stage by stage):
// ``kStage`` strips the partial kernel at compile time.  kNoop launches
// both kernels and writes zero partials; kCarrier loads the samples and
// runs the carrier NCO and both sin_turns, I/Q sums into i_p and q_p;
// kPhase adds the Q40 code phase and the three chip indices, summed as
// integers into i_e (early), i_l (late) and q_e (prompt), with no lookup;
// kFull is B4.  The per-ms route launches the kFull instantiation
// (sg_correlate_ms), and sg_correlate_ms_stage(kFull) launches that same
// instantiation.
//
// Numerics as track_block.cu: built with -fmad=false; the sine polynomial
// coefficients are the float32 values of signals.nco.sin_turns.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 1025;
constexpr long long kCodeOne = 1LL << 40;

// stages of the ablation (see the header)
constexpr int kNoop = 0;
constexpr int kCarrier = 1;
constexpr int kPhase = 2;
constexpr int kFull = 3;

__device__ __forceinline__ float sin_turns(float x) {
  x = x - floorf(x + 0.5f);
  x = (x > 0.25f) ? 0.5f - x : x;
  x = (x < -0.25f) ? -0.5f - x : x;
  const float t2 = x * x;
  return x * (0x1.921fb6p+2f
              + t2 * (-0x1.4abbcep+5f
                      + t2 * (0x1.466bc6p+6f
                              + t2 * (-0x1.32d2ccp+6f
                                      + t2 * 0x1.507834p+5f))));
}

__device__ __forceinline__ int chip_index(long long q) {
  const long long c = (q + (kCodeOne - 1)) >> 40;  // arithmetic shift: ceil
  return static_cast<int>(c < 0 ? 0 : (c > 1024 ? 1024 : c));
}

// partial[(c * n_cta + b) * 6 + f]: CTA b's float64 sum f of channel c
template <int kStage>
__global__ void __launch_bounds__(kThreads)
correlate_partial_kernel(const int8_t* __restrict__ cap, long long n_cap,
                         const long long* __restrict__ ptr,
                         const int32_t* __restrict__ carr_phase,
                         const int32_t* __restrict__ carr_w,
                         const long long* __restrict__ rem,
                         const long long* __restrict__ step,
                         const long long* __restrict__ blk,
                         const float* __restrict__ code_pads,
                         const uint8_t* __restrict__ active, long long half_q,
                         double* __restrict__ partial) {
  const int b = blockIdx.x;
  const int n_cta = gridDim.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  if (!active[c]) return;  // the reduce kernel writes the zeros
  if constexpr (kStage == kNoop) {
    if (tid < 6) partial[(static_cast<long long>(c) * n_cta + b) * 6 + tid] = 0.0;
    return;
  }

  __shared__ float pad[kPad];
  __shared__ double red[6][kWarps];
  if constexpr (kStage == kFull) {
    for (int i = tid; i < kPad; i += kThreads) pad[i] = code_pads[c * kPad + i];
    __syncthreads();
  }

  const long long p0 = ptr[c], rem0 = rem[c], st = step[c], n = blk[c];
  const unsigned int cp = static_cast<unsigned int>(carr_phase[c]);
  const unsigned int w = static_cast<unsigned int>(carr_w[c]);
  double ie = 0.0, ip = 0.0, il = 0.0, qe = 0.0, qp = 0.0, ql = 0.0;
  const long long stride = static_cast<long long>(n_cta) * kThreads;
  for (long long k = static_cast<long long>(b) * kThreads + tid; k < n; k += stride) {
    const long long s = p0 + k;
    if (s < 0 || s >= n_cap) continue;  // outside the capture: a zero sample
    const float x = static_cast<float>(cap[s]);
    const unsigned int counts = cp + w * static_cast<unsigned int>(k);
    const float turns = __int_as_float(static_cast<int>(0x3F800000u | (counts >> 9))) - 1.0f;
    const float ib = sin_turns(turns) * x;
    const float qb = sin_turns(turns + 0.25f) * x;
    if constexpr (kStage == kCarrier) {
      ip += static_cast<double>(ib);
      qp += static_cast<double>(qb);
    } else if constexpr (kStage == kPhase) {
      const long long tq = rem0 + st * k;
      ie += static_cast<double>(chip_index(tq - half_q));
      qe += static_cast<double>(chip_index(tq));
      il += static_cast<double>(chip_index(tq + half_q));
      ip += static_cast<double>(ib);
      qp += static_cast<double>(qb);
    } else {
      const long long tq = rem0 + st * k;
      const float e = pad[chip_index(tq - half_q)];
      const float pr = pad[chip_index(tq)];
      const float l = pad[chip_index(tq + half_q)];
      ie += static_cast<double>(e * ib);
      ip += static_cast<double>(pr * ib);
      il += static_cast<double>(l * ib);
      qe += static_cast<double>(e * qb);
      qp += static_cast<double>(pr * qb);
      ql += static_cast<double>(l * qb);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ie += __shfl_down_sync(0xffffffffu, ie, off);
    ip += __shfl_down_sync(0xffffffffu, ip, off);
    il += __shfl_down_sync(0xffffffffu, il, off);
    qe += __shfl_down_sync(0xffffffffu, qe, off);
    qp += __shfl_down_sync(0xffffffffu, qp, off);
    ql += __shfl_down_sync(0xffffffffu, ql, off);
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) {
    red[0][warp] = ie;
    red[1][warp] = ip;
    red[2][warp] = il;
    red[3][warp] = qe;
    red[4][warp] = qp;
    red[5][warp] = ql;
  }
  __syncthreads();
  if (tid < 6) {
    double t = 0.0;
    for (int i = 0; i < kWarps; ++i) t += red[tid][i];
    partial[(static_cast<long long>(c) * n_cta + b) * 6 + tid] = t;
  }
}

// out[c * 6 + f] = float32(sum over b, in order, of partial[c, b, f])
__global__ void correlate_reduce_kernel(const double* __restrict__ partial,
                                        const uint8_t* __restrict__ active,
                                        int n_cta, float* __restrict__ out) {
  const int c = blockIdx.x;
  const int f = threadIdx.x;
  if (f >= 6) return;
  double t = 0.0;
  if (active[c]) {
    const double* row = partial + static_cast<long long>(c) * n_cta * 6 + f;
    for (int b = 0; b < n_cta; ++b) t += row[b * 6];
  }
  out[c * 6 + f] = static_cast<float>(t);
}

}  // namespace

namespace {

template <int kStage>
int launch(const void* cap, long long n_cap, const void* ptr, const void* carr_phase,
           const void* carr_w, const void* rem, const void* step, const void* blk,
           const void* code_pads, const void* active, long long half_q, int n_ch,
           int n_cta, void* partial, void* out, void* stream) {
  if (n_ch <= 0 || n_cta <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  correlate_partial_kernel<kStage><<<dim3(n_cta, n_ch), kThreads, 0, s>>>(
      static_cast<const int8_t*>(cap), n_cap, static_cast<const long long*>(ptr),
      static_cast<const int32_t*>(carr_phase), static_cast<const int32_t*>(carr_w),
      static_cast<const long long*>(rem), static_cast<const long long*>(step),
      static_cast<const long long*>(blk), static_cast<const float*>(code_pads),
      static_cast<const uint8_t*>(active), half_q, static_cast<double*>(partial));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  correlate_reduce_kernel<<<n_ch, 32, 0, s>>>(
      static_cast<const double*>(partial), static_cast<const uint8_t*>(active), n_cta,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cap: (n_cap,) int8 capture; ptr, rem, step, blk: (n_ch,) int64;
// carr_phase, carr_w: (n_ch,) int32; code_pads: (n_ch, 1025) float32;
// active: (n_ch,) bool, one byte of 0 or 1; partial: (n_ch, n_cta, 6) float64 scratch;
// out: (n_ch, 6) float32.  Two launches on ``stream``.
extern "C" int sg_correlate_ms(const void* cap, long long n_cap, const void* ptr,
                               const void* carr_phase, const void* carr_w,
                               const void* rem, const void* step, const void* blk,
                               const void* code_pads, const void* active,
                               long long half_q, int n_ch, int n_cta,
                               void* partial, void* out, void* stream) {
  return launch<kFull>(cap, n_cap, ptr, carr_phase, carr_w, rem, step, blk, code_pads,
                       active, half_q, n_ch, n_cta, partial, out, stream);
}

// B4 stripped to ``stage`` (0 kNoop, 1 kCarrier, 2 kPhase, 3 kFull: the
// very instantiation sg_correlate_ms launches); arguments as sg_correlate_ms
extern "C" int sg_correlate_ms_stage(int stage, const void* cap, long long n_cap,
                                     const void* ptr, const void* carr_phase,
                                     const void* carr_w, const void* rem,
                                     const void* step, const void* blk,
                                     const void* code_pads, const void* active,
                                     long long half_q, int n_ch, int n_cta,
                                     void* partial, void* out, void* stream) {
#define SG_STAGE(S)                                                                  \
  launch<S>(cap, n_cap, ptr, carr_phase, carr_w, rem, step, blk, code_pads, active, \
            half_q, n_ch, n_cta, partial, out, stream)
  switch (stage) {
    case kNoop: return SG_STAGE(kNoop);
    case kCarrier: return SG_STAGE(kCarrier);
    case kPhase: return SG_STAGE(kPhase);
    case kFull: return SG_STAGE(kFull);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SG_STAGE
}
