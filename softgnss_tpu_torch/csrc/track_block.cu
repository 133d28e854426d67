// B1, the block tracker: r milliseconds of DLL/PLL tracking for all
// channels in one launch, the loop state carried inside the kernel, one
// thread-block cluster of kN CTAs per channel.
//
// Replaces: softgnss_tpu/track/megakernel.py::_kernel (fused=False,
// launched by megakernel._mega_call) together with mega_track_segment and
// mega_finalize.  It computes what softgnss_tpu/track/scan.py computes per
// ms with the 'gather' correlator (_frame_ms + _correlate_gather +
// _filters_and_outputs), over frames from build_frames.cu:
//   step = rint(code_freq/fs * 2^40), blk = ceil((1023*2^40 - rem)/step),
//   o = ptr - (fb0 + j*spc); for k in [0, blk): sample frames[j, c, o+k],
//   carrier u32 NCO counts cp + w*k -> turns (mantissa trick) -> sin/cos
//   polynomial, code Q40 phase rem + step*k -> E/P/L chips of the padded
//   code, six sums of float32 products; then the float64 Costas PLL, FLL assist,
//   normalised DLL, carrier-aided DLL and pdi_ms accumulate-and-hold, the
//   state update (frozen for inactive channels) and typed per-ms outputs.
// The TPU kernel's 16-bit digit arithmetic, f32 filters with polynomial
// atan, row packing and lane tables are Mosaic workarounds: CUDA has
// native int64 and float64, and a shared-memory gather is cheap here.
//
// What bounds it on the H100: latency, twice a ms.  The millisecond
// recurrence is sequential (each ms's NCO rates come from the last ms's
// filters), and one ms of one channel is only ~38k samples.  Every ms pays
// in series the step of the CTA reduction, the handoff of the ranks'
// partials and the float64 filters (atan, sqrt, divides) up to the next
// ms's NCO steps, ~1.4 us; and the sample loop, which has only a few words
// a thread and 8 warps an SM, so it issues well below the SM's rate (~70
// instructions a sample).  At 8 channels of 8 CTAs (the cells) the loop is
// about three fifths of a ms at the reference front end.  Each cluster
// wants SMs of its own: an H100 gives that to 7 clusters of 16 CTAs, and a
// cluster sharing SMs takes a quarter to a third longer, so the wrapper
// launches the largest size whose clusters all get SMs of their own.
//
// Design.  Channel c is the cluster of CTAs c*kN .. c*kN + kN-1 (a 1-D
// grid of C*kN CTAs, cluster dimension kN, launched by cudaLaunchKernelEx);
// the cluster stays resident for the whole block of ms.
//   * Work split by window index: rank q owns the window bytes
//     [q*chunk, (q+1)*chunk) clipped to [0, win) (``chunk`` = win/kN rounded
//     up to 16 bytes, megakernel.rank_chunk), masked to the ms's true span
//     [o, o+blk) and, for B3, to the capture.  Sample idx of the window is
//     k = idx - o of the ms, so the NCO counts are those of the one-CTA loop.
//   * A rank's bytes do not depend on o or blk, so it stages them ahead: one
//     TMA bulk copy (cp.async.bulk, completion on an mbarrier) per ms into a
//     double buffer in shared memory, ms j+2 issued while ms j+1 is in flight
//     and ms j is summed.
//   * The sample loop: thread t takes window word lo/4 + t, then every
//     n_thr-th, four samples a step, the next word loaded while this one is
//     summed and the bytes of an edge word outside [lo, hi) masked to zero
//     (a zero sample adds nothing).  The carrier counts and the Q40 code
//     phase (less one) of a word's first sample advance by addition over
//     the thread's stride.  Per sample: the sine and cosine in float32
//     (sin_turns_unit), each product with the sample converted to float64
//     once, and the six sums as fused adds of a chip (+-1 or 0, a float64
//     table) times one of the two: exact products, so the sums of adding
//     each float32 product converted.  The chips: on the short path (a
//     spacing of half a chip, every chip of the ms inside the table) E and
//     P from the phase's high word and L the entry after E, no clamp; else
//     three clamped lookups of the phase and the phase -/+ h.
//   * Reduction in a fixed order: float64 per thread, warp shuffles, then
//     lane f < 6 of warp 0 sums f over the CTA's warps in order into this
//     rank's 6-double partial.
//   * Handoff by a one-sided all-to-all push, no cluster barrier per ms:
//     every rank keeps an inbox in its own shared memory, ``part[2][kN][6]``
//     (slot j & 1) with one mbarrier per slot.  Warp 0 stores the partial
//     into row ``rank`` of every rank's slot (st.async, 16 bytes a store,
//     the bytes completing on that rank's slot barrier); each rank arms its
//     own slot for kN*48 bytes and waits on it by parity, and lane f sums
//     f over the rows in rank order 0..kN-1, rounded once to float32.  A
//     peer pushes ms j+2 into slot j & 1 only after this rank pushed ms
//     j+1, which it does only after reading ms j there: the slots need no
//     barrier.  One cluster barrier after the barriers' set-up, and one at
//     the end, keep each rank's shared memory alive while peers push.
//   * The float64 filters run as two chains side by side, each by the
//     same operations in the same order as one thread would (built with
//     -fmad=false): warp 0 takes the carrier, its lanes 0 and 1 the PLL's
//     and the FLL's atan as one instruction stream, lane 0 the NCO update
//     and the next ms's carrier step; warp 1's lane 0 the code: the DLL's
//     magnitudes and divide, the next ms's code step and block length
//     (``blk`` from a float64 quotient corrected by exact int64 products).
//     Both warps sum the inbox themselves, so they share no barrier but
//     the CTA's at the top of the next ms (and, for the carrier-aided DLL
//     alone, a named barrier that hands warp 1 the new carrier frequency).
//     Every rank runs the filters itself: the ranks have the same inputs
//     and code, so they carry the same loop state and nothing is broadcast.
//     Only rank 0 writes the per-ms outputs and the final state.
//   * Inactive channels: the whole cluster takes the early exit (rank 0
//     writes the frozen state and the zeros); no rank waits on a peer that
//     skipped.
// kN = 1 is the one-CTA design of the first port: no cluster, each thread
// loads its words straight from global memory (B3 prefetching the next
// window into L2), two CTA barriers per ms; warps 0 and 1 sum the CTA's
// warps themselves and run the same two filter chains.  Threads per CTA are a launch
// argument (up to 512); the code table lives in shared memory.
//
// B3, the fused block tracker, is the same kernel reading each ms window
// straight from the capture (track_block_kernel<true, ...>): it replaces
// megakernel.py::_kernel(fused=True) (launched by _mega_call_fused), which
// runs B2's slab-DMA prologue inside B1 so that no HBM frames array exists.
// Here frame (j, c) is simply the capture's int32 words from
// starts_w[c] + j*spc/4 on, zero outside the capture as build_frames.cu
// fills them, so B3 is bit-equal to B2 followed by B1 at the same kN (same
// loop order, the same zeros) and saves the frames array's write and read
// (~39 MB per 64-ms block at the reference front end).
//
// Stage ablation (the counterpart of scripts/mega_vmem_bisect.py's
// ``kern``, which built B1 stage by stage on the TPU): ``kStage`` strips
// the sample loop at compile time.  kFilters runs no sample loop (the
// per-ms blk/o step, the barriers and the push, the filter step and the
// output writes); kLoad adds the staging and the sample loads, summed into i_p;
// kCarrier adds the carrier NCO and both sin_turns, I/Q sums into i_p and
// q_p; kFull is B1.  Every stage but kFull runs open loop: the filters run
// and are written out, but the state keeps its block-input carr_freq and
// code_freq, so each stage reads the windows kFull reads and garbage sums
// steer nothing.  sg_track_block_stage(kFull, kN) launches the very
// instantiation sg_track_block(kN) launches.
//
// Numerics: build with -fmad=false so every float operation rounds as the
// plain PyTorch version's does (no contraction; the one fused add is the
// explicit, exact one above); the sine coefficients are the float32 values
// of softgnss_tpu.signals.nco.sin_turns, as hex literals.  The float64
// accumulation makes each float32 sum independent of the order it is
// taken in, so kernel and plain version agree to the last bit except where
// a float64 sum lies within ~1e-16 of a float32 rounding boundary
// (scan._correlate_gather).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kPad = 1025;
constexpr double kTwoPi = 6.283185307179586;

// stages of the ablation (see the header)
constexpr int kFilters = 0;
constexpr int kLoad = 1;
constexpr int kCarrier = 2;
constexpr int kFull = 3;

struct Params {
  double fs;
  double code_freq_basis;
  double intermediate_freq;
  double pll_a;      // tau2/tau1 (PLL)
  double pll_b;      // pdi/tau1 (PLL)
  double dll_a;      // tau2/tau1 (DLL)
  double dll_b;      // pdi/tau1 (DLL)
  double fll_gain;   // 4*Bn*pdi
  double fll_div;    // 2*pi*pdi
  double aid_ratio;  // code_freq_basis / l1_freq
  long long code_len_q;
  long long half_q;
  int pdi_ms;
  int fll_on;
  int aided;
  int spc;
  int win;           // samples per frame (4 * words)
  int r;
  int n_ch;
  int chunk;         // window bytes per rank, a multiple of 16
  int slot;          // bytes of one staging buffer: chunk + 16
};

// sin_turns (x - floorf(x + 0.5f), then the two folds and the polynomial)
// for x in [0, 1.25], where the carrier's turns and turns + 0.25f lie: there
// floorf(x + 0.5f) is 0 or 1, so a comparison gives it, and each fold,
// (x > 0.25f) ? 0.5f - x : x and (x < -0.25f) ? -0.5f - x : x, is the min
// or max of the two (the subtraction is exact where it is taken, and
// rounds to the far side of +-0.25 where it is not).  The same float32
// values, on the FMA and ALU pipes instead of the conversion pipe.
__device__ __forceinline__ float sin_turns_unit(float x) {
  x = x - ((x + 0.5f >= 1.0f) ? 1.0f : 0.0f);
  x = fminf(x, 0.5f - x);
  x = fmaxf(x, -0.5f - x);
  const float t2 = x * x;
  return x * (0x1.921fb6p+2f
              + t2 * (-0x1.4abbcep+5f
                      + t2 * (0x1.466bc6p+6f
                              + t2 * (-0x1.32d2ccp+6f
                                      + t2 * 0x1.507834p+5f))));
}

// The padded code's chip at Q40 phase q + 1: pad[clamp(ceil((q + 1) /
// 2^40), 0, 1024)], the ceil taken as the floor of q (an arithmetic shift)
// plus one, and the one as the table's offset.
__device__ __forceinline__ double chip(const double* pad, long long q) {
  const int c = static_cast<int>(q >> 40);
  return pad[1 + min(max(c, -1), 1023)];
}

// The spacing of the short path: half a chip, Q40
constexpr long long kHalfChip = 1LL << 39;

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// floor_div(a, b), the same integer, without the emulated int64 division
// where a and b are exact in float64 and b > 0 (a code step always is):
// the float64 quotient's floor is the true floor or one above it, and one
// exact int64 product decides which
__device__ __forceinline__ long long floor_div_pos(long long a, long long b) {
  constexpr long long kExact = 1LL << 53;
  if (b <= 0 || b >= kExact || a >= kExact || a <= -kExact) return floor_div(a, b);
  long long q = static_cast<long long>(floor(static_cast<double>(a) / static_cast<double>(b)));
  if (q * b > a) --q;
  return q;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of ``p``'s counterpart in CTA ``rank``
__device__ __forceinline__ uint32_t cluster_addr(const void* p, unsigned rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// arm the current phase of a local mbarrier of count 1: expect ``bytes``
// and arrive
__device__ __forceinline__ void arm(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
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

// One rank's bytes of one ms window: the window samples [lo, hi) that lie
// in the source (the rank's slice, clipped for B3 to the capture), read as
// the 16-byte aligned span [base, base + bytes) of global memory.  Every
// 16-byte line of the span holds a source byte, so the span stays inside
// the source's allocation.  Sample idx sits at staged byte idx + off.
struct Span {
  const int8_t* base;
  int bytes;
  int off;
};

__device__ __forceinline__ Span span_of(const int8_t* win8, int lo, int hi) {
  Span s;
  if (hi <= lo) {
    s.base = win8;
    s.bytes = 0;
    s.off = 0;
    return s;
  }
  const uintptr_t a = reinterpret_cast<uintptr_t>(win8 + lo);
  const uintptr_t b = (a & ~static_cast<uintptr_t>(15));
  const uintptr_t e = (reinterpret_cast<uintptr_t>(win8 + hi) + 15) & ~static_cast<uintptr_t>(15);
  s.base = reinterpret_cast<const int8_t*>(b);
  s.bytes = static_cast<int>(e - b);
  s.off = static_cast<int>(a - b) - lo;
  return s;
}

// thread 0: stage ``s`` into ``buf``, completion counted on ``bar`` (an
// empty span only arrives, so the phase still completes)
__device__ __forceinline__ void start_bulk(const Span& s, unsigned char* buf, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // after the reads of the last use
  arm(bar, static_cast<uint32_t>(s.bytes));
  if (s.bytes > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(buf)), "l"(s.base), "r"(s.bytes), "r"(smem_addr(bar))
        : "memory");
}

constexpr unsigned kAll = 0xffffffffu;
constexpr uint32_t kRowBytes = 6 * sizeof(double);  // one rank's partial of one ms

// One rank's inbox: row q of slot s holds rank q's partial of the ms j
// with j & 1 == s; bar[s] completes once all kN rows have landed.
template <int kN>
struct __align__(16) Inbox {
  double part[2][kN][6];
  uint64_t bar[2];
};

// store (lo, hi) at the shared::cluster address ``dst`` (16-byte aligned),
// the 16 bytes completing on the mbarrier at ``bar`` in the same CTA
__device__ __forceinline__ void push2(uint32_t dst, double lo, double hi, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b64 [%0], {%1, %2}, [%3];"
      ::"r"(dst), "l"(__double_as_longlong(lo)), "l"(__double_as_longlong(hi)), "r"(bar)
      : "memory");
}

// State layouts (stride n_ch):
//   si  int64 [4]: ptr, code_rem_q, ms, carr_phase (int32 value)
//   sf  f64   [6]: carr_freq, code_freq, carr_nco, carr_err, code_nco, code_err
//   sa  f32   [8]: acc_i_e, acc_i_p, acc_i_l, acc_q_e, acc_q_p, acc_q_l, fll_ip, fll_qp
// Outputs, (r, n_ch) planes:
//   abs_sample int64; of64 [7]: sample_frac, code_freq, carr_freq, dll_discr,
//   dll_discr_filt, pll_discr, pll_discr_filt; of32 [6]: i_p, i_e, i_l, q_e, q_p, q_l
// kFused = false: ``src`` is the (r, n_ch, win/4) frames array of
// build_frames.cu.  kFused = true: ``src`` is the capture's (n_words,) int32
// word view and frame (j, c) starts at word starts_w[c] + j*spc/4.
// ``active`` is a (n_ch,) bool tensor: one byte of 0 or 1 per channel.
// (launch bounds with a minimum of one CTA per SM: without it ptxas caps
// the one-CTA instantiations at 64 registers and spills)
template <bool kFused, int kStage, int kN>
__global__ void __launch_bounds__(kMaxThreads, 1)
track_block_kernel(const int32_t* __restrict__ src, long long n_words,
                   const long long* __restrict__ starts_w,
                   const long long* __restrict__ fb0,
                   const float* __restrict__ code_pads,
                   const double* __restrict__ carr_basis,
                   const uint8_t* __restrict__ active,
                   const long long* __restrict__ si_in,
                   const double* __restrict__ sf_in,
                   const float* __restrict__ sa_in,
                   long long* __restrict__ si_out,
                   double* __restrict__ sf_out,
                   float* __restrict__ sa_out,
                   long long* __restrict__ abs_sample,
                   double* __restrict__ of64, float* __restrict__ of32,
                   long long* __restrict__ ovf, const Params p) {
  constexpr bool kStaged = kN > 1 && kStage >= kLoad;
  const int c = blockIdx.x / kN;
  const int rank = static_cast<int>(blockIdx.x % kN);  // the 1-D cluster's block rank
  const int n_ch = p.n_ch;
  const int tid = threadIdx.x;
  const int n_thr = blockDim.x;
  const long long plane = static_cast<long long>(p.r) * n_ch;

  if (!active[c]) {  // the whole cluster: frozen state, zero outputs, frames never read
    if (rank != 0) return;
    if (tid == 0) {
      for (int f = 0; f < 4; ++f) si_out[f * n_ch + c] = si_in[f * n_ch + c];
      for (int f = 0; f < 6; ++f) sf_out[f * n_ch + c] = sf_in[f * n_ch + c];
      for (int f = 0; f < 8; ++f) sa_out[f * n_ch + c] = sa_in[f * n_ch + c];
      ovf[c] = 0;
    }
    for (int j = tid; j < p.r; j += n_thr) {
      const long long o = static_cast<long long>(j) * n_ch + c;
      abs_sample[o] = 0;
      for (int f = 0; f < 7; ++f) of64[f * plane + o] = 0.0;
      for (int f = 0; f < 6; ++f) of32[f * plane + o] = 0.0f;
    }
    return;
  }

  extern __shared__ __align__(128) unsigned char stage[];  // kStaged: two slots of p.slot bytes
  __shared__ double pad[kPad];  // the code row as doubles: +-1 (or 0 for an idle PRN)
  __shared__ double red[6][kMaxWarps];
  __shared__ Inbox<kN> box;  // kN > 1: every rank's partial of ms j, in slot j & 1
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ long long s_rem, s_step;
  __shared__ unsigned int s_cp, s_w;
  __shared__ int s_o, s_blk;
  __shared__ double s_cfreq;  // ms j's carrier frequency, for the carrier-aided DLL

  for (int i = tid; i < kPad; i += n_thr) pad[i] = static_cast<double>(code_pads[c * kPad + i]);

  const int win_w = p.win / 4;
  const int8_t* src8 = reinterpret_cast<const int8_t*>(src);
  // first word of window j, and its samples [lo, hi) that lie inside the
  // source: all of it for B1; for B3 the part inside the capture (the rest
  // reads as zero, as build_frames.cu fills it)
  auto window_word = [&](int j) -> long long {
    return kFused ? starts_w[c] + static_cast<long long>(j) * (p.spc / 4)
                  : (static_cast<long long>(j) * n_ch + c) * win_w;
  };
  auto src_lo = [&](long long w0) -> int {
    return kFused ? static_cast<int>(min(max(-4 * w0, 0LL), static_cast<long long>(p.win))) : 0;
  };
  auto src_hi = [&](long long w0, int lo) -> int {
    return kFused ? static_cast<int>(max(min(4 * (n_words - w0), static_cast<long long>(p.win)),
                                         static_cast<long long>(lo)))
                  : p.win;
  };
  // this rank's slice of every window
  const int lo_r = min(rank * p.chunk, p.win);
  const int hi_r = min(lo_r + p.chunk, p.win);
  auto span_at = [&](int j) -> Span {
    const long long w0 = window_word(j);
    const int lo = src_lo(w0);
    return span_of(src8 + 4 * w0, max(lo_r, lo), min(hi_r, src_hi(w0, lo)));
  };

  if (tid == 0) {
    if constexpr (kStaged) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bars)) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bars + 1)) : "memory");
    }
    if constexpr (kN > 1) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(box.bar)) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(box.bar + 1))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int s = 0; s < 2 && s < p.r; ++s) arm(box.bar + s, kN * kRowBytes);  // ms 0 and 1
    }
    if constexpr (kStaged) {
      for (int j = 0; j < 2 && j < p.r; ++j) start_bulk(span_at(j), stage + j * p.slot, bars + j);
    }
  }
  // every rank's inbox armed before a peer pushes into it
  if constexpr (kN > 1) cg::this_cluster().sync();

  // The loop state.  The carrier's lives in thread 0; the code's in the
  // code thread (warp 1's lane 0, or thread 0 where the CTA is one warp);
  // the accumulators in lane f < 6 of warps 0 .. code_warp; the FLL's last
  // prompt in every lane of warp 0.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = n_thr >> 5;
  const int code_warp = n_warps > 1 ? 1 : 0;
  const bool code_thread = tid == 32 * code_warp;
  long long ptr = 0, rem = 0, ms = 0, bad_max = 0, fb = 0, ms0 = 0;
  unsigned int cp = 0;
  double carr_freq = 0, code_freq = 0, carr_nco = 0, carr_err = 0,
         code_nco = 0, code_err = 0;
  float acc = 0, fll_ip = 0, fll_qp = 0;
  const double cb = carr_basis[c];
  if (warp <= code_warp) {
    ptr = si_in[c];
    rem = si_in[n_ch + c];
    ms0 = ms = si_in[2 * n_ch + c];
    cp = static_cast<unsigned int>(si_in[3 * n_ch + c]);
    carr_freq = sf_in[c];
    code_freq = sf_in[n_ch + c];
    carr_nco = sf_in[2 * n_ch + c];
    carr_err = sf_in[3 * n_ch + c];
    code_nco = sf_in[4 * n_ch + c];
    code_err = sf_in[5 * n_ch + c];
    if (lane < 6) acc = sa_in[lane * n_ch + c];
    fll_ip = sa_in[6 * n_ch + c];
    fll_qp = sa_in[7 * n_ch + c];
    fb = fb0[c];
  }
  // the NCO steps of ms j, for every thread: the carrier's from thread 0,
  // the code's (and the overflow check) from the code thread
  auto carrier_steps = [&]() {
    s_cp = cp;
    s_w = static_cast<unsigned int>(__double2ll_rn(carr_freq / p.fs * 4294967296.0));
  };
  auto code_steps = [&](int j) {
    const long long step = __double2ll_rn(code_freq / p.fs * 1099511627776.0);
    const long long blk = floor_div_pos(p.code_len_q - rem + step - 1, step);
    const long long o = ptr - (fb + static_cast<long long>(j) * p.spc);
    long long bad = -o;
    if (o + blk - p.win > bad) bad = o + blk - p.win;
    if (bad > bad_max) bad_max = bad;
    s_rem = rem;
    s_step = step;
    s_o = static_cast<int>(o);
    s_blk = static_cast<int>(blk);
  };
  if (tid == 0) carrier_steps();  // r > 0: the launch skips an empty block
  if (code_thread) code_steps(0);

  for (int j = 0; j < p.r; ++j) {
    __syncthreads();
    const long long rem_j = s_rem, step = s_step;
    const unsigned int cp_j = s_cp, w = s_w;
    const int o = s_o, blk = s_blk;
    const long long w0 = window_word(j);
    if (kFused && kN == 1 && j + 1 < p.r) {
      // bring the next ms's window into L2 while this one is summed: its
      // ~300 lines of 128 B, strided over the threads (B1 reads frames
      // that B2 has just written, so its windows are in L2 already)
      for (int t = tid; 128 * t < p.win; t += n_thr) {
        const long long line = 4 * (w0 + p.spc / 4) + 128LL * t;
        if (line >= 0 && line < 4 * n_words)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(src8 + line));
      }
    }
    const int lo_c = src_lo(w0), hi_c = src_hi(w0, lo_c);

    double ie = 0.0, ip = 0.0, il = 0.0, qe = 0.0, qp = 0.0, ql = 0.0;
    if constexpr (kStage >= kLoad) {
      // this rank's samples of the ms: window indices [lo, hi), its slice
      // of the span [o, o + blk) inside the source (outside [0, win) is an
      // overflow, flagged and raised by the wrapper); any other sample
      // would add a zero
      const int lo = max(max(lo_r, o), lo_c);
      const int hi = min(min(hi_r, o + blk), hi_c);
      // window word v (samples 4v .. 4v+3) is the 4 bytes at base + 4v: the
      // source itself, or this rank's staged copy once its copy has landed
      // (both place a word 4-byte aligned: lo_c and hi_c are whole words)
      const unsigned char* base = reinterpret_cast<const unsigned char*>(src8 + 4 * w0);
      if constexpr (kStaged) {
        wait_bar(bars + (j & 1), static_cast<uint32_t>((j >> 1) & 1));
        base = stage + (j & 1) * p.slot + span_at(j).off;
      }
      auto word_at = [&](int v) -> uint32_t {
        return *reinterpret_cast<const uint32_t*>(base + 4 * v);
      };
      const int v_end = hi > lo ? (hi + 3) >> 2 : 0;
      int v = (lo >> 2) + tid;
      // the NCO counts and the Q40 code phase less one at sample 4v, then
      // advanced by addition: both wrap as the products do
      const int k0 = 4 * v - o;
      unsigned int counts = cp_j + w * static_cast<unsigned int>(k0);
      long long g = rem_j + step * static_cast<long long>(k0) - 1;
      const unsigned int d_counts = w * static_cast<unsigned int>(4 * n_thr);
      const long long d_g = step * static_cast<long long>(4 * n_thr);
      // The short path: a spacing of half a chip, and every chip of the
      // words this thread reads inside the table, so that no clamp is
      // needed.  The phase is linear in k, so the first sample of its first
      // word and the last of the rank's last word decide; with step and rem
      // bounded nothing wraps.
      auto short_path = [&]() {
        constexpr long long kBig = 1LL << 52;
        if (p.half_q != kHalfChip || step <= 0 || step >= (1LL << 44) || rem_j <= -kBig ||
            rem_j >= kBig)
          return false;
        const long long g1 = rem_j + step * static_cast<long long>(4 * v_end - 1 - o) - 1;
        return ((g - kHalfChip) >> 40) >= -1 && ((g1 - kHalfChip) >> 40) <= 1022;
      };
      // the loop, on the short path or the general one
      auto sum_words = [&](auto short_chips) {
        constexpr bool kShort = decltype(short_chips)::value;
        uint32_t next = v < v_end ? word_at(v) : 0u;
        for (; v < v_end; v += n_thr, counts += d_counts, g += d_g) {
          uint32_t word = next;
          if (v + n_thr < v_end) next = word_at(v + n_thr);
          const int i0 = 4 * v;
          if (i0 < lo || i0 + 4 > hi) {  // an edge word: keep bytes [a, b)
            const int a = max(lo - i0, 0), b = min(hi - i0, 4);
            word &= (0xFFFFFFFFu >> (8 * (4 - b + a))) << (8 * a);
          }
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const float x = static_cast<float>(static_cast<int8_t>(word >> (8 * s)));
            if constexpr (kStage == kLoad) {
              ip += static_cast<double>(x);
            } else {
              const unsigned int cs = counts + static_cast<unsigned int>(s) * w;
              const float turns = __int_as_float(static_cast<int>(0x3F800000u | (cs >> 9))) - 1.0f;
              const double ib = static_cast<double>(sin_turns_unit(turns) * x);
              const double qb = static_cast<double>(sin_turns_unit(turns + 0.25f) * x);
              if constexpr (kStage == kCarrier) {
                ip += ib;
                qp += qb;
              } else {
                // chip c = ceil(q / 2^40) = floor((q - 1) / 2^40) + 1 of
                // q = tq - h, tq, tq + h; ``pad`` + 1 takes the + 1
                const long long gs = g + static_cast<long long>(s) * step;
                double e, pr, l;
                if constexpr (kShort) {
                  // q -/+ 2^39 are 2^40 apart: L is E's next chip; h's low
                  // word is 0, so the high word of gs gives E and P
                  const int gh = static_cast<int>(gs >> 32);
                  const double* el = pad + 1 + ((gh - (1 << 7)) >> 8);
                  e = el[0];
                  l = el[1];
                  pr = pad[1 + (gh >> 8)];
                } else {
                  e = chip(pad, gs - p.half_q);
                  pr = chip(pad, gs);
                  l = chip(pad, gs + p.half_q);
                }
                // e, pr, l are +-1 or 0: each product is exact, so the fused
                // add equals the add of static_cast<double>(e * ib) in float32
                ie = __fma_rn(e, ib, ie);
                ip = __fma_rn(pr, ib, ip);
                il = __fma_rn(l, ib, il);
                qe = __fma_rn(e, qb, qe);
                qp = __fma_rn(pr, qb, qp);
                ql = __fma_rn(l, qb, ql);
              }
            }
          }
        }
      };
      if constexpr (kStage < kFull)
        sum_words(std::true_type{});
      else if (short_path())
        sum_words(std::true_type{});
      else
        sum_words(std::false_type{});
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
    if (lane == 0) {
      red[0][warp] = ie;
      red[1][warp] = ip;
      red[2][warp] = il;
      red[3][warp] = qe;
      red[4][warp] = qp;
      red[5][warp] = ql;
    }
    __syncthreads();

    if (warp > code_warp) continue;  // the other warps wait at the next ms's barrier
    const int slot = j & 1;
    const long long o_idx = static_cast<long long>(j) * n_ch + c;
    // lane f < 6: sum f of this CTA's warps in order (this rank's partial)
    double v = 0.0;
    if (kN == 1 || warp == 0) {
      if (lane < 6) {
#pragma unroll
        for (int i = 0; i < kMaxWarps; ++i)
          if (i < n_warps) v += red[lane][i];
      }
    }
    if constexpr (kN > 1) {
      if (warp == 0) {
        // push: lane l < 30 stores sums 2i, 2i + 1 (i = l % 3) into row
        // ``rank`` of ranks l/3 and l/3 + 10's inboxes
        const int i = lane % 3;
        const double lo = __shfl_sync(kAll, v, 2 * i);
        const double hi = __shfl_sync(kAll, v, 2 * i + 1);
        if (lane < 30)
          for (int q = lane / 3; q < kN; q += 10)
            push2(cluster_addr(&box.part[slot][rank][2 * i], q), lo, hi,
                  cluster_addr(box.bar + slot, q));
        if constexpr (kStaged) {  // every thread has read slot j & 1: refill it with ms j + 2
          if (lane == 0 && j + 2 < p.r) start_bulk(span_at(j + 2), stage + slot * p.slot, bars + slot);
        }
      }
    }
    // while the partials are in flight: what needs no filter
    if (tid == 0) cp = cp_j + w * static_cast<unsigned int>(blk);
    if (code_thread) {
      ptr += blk;
      rem = rem_j + step * blk - p.code_len_q;
      ms += 1;
      if (rank == 0) {
        abs_sample[o_idx] = ptr;
        of64[o_idx] = static_cast<double>(rem) / static_cast<double>(step);
      }
    }
    if constexpr (kN > 1) {  // every rank's partial of ms j, summed in rank order
      wait_bar(box.bar + slot, static_cast<uint32_t>((j >> 1) & 1));
      v = 0.0;
      if (lane < 6) {
#pragma unroll
        for (int q = 0; q < kN; ++q) v += box.part[slot][q][lane];
      }
      // slot j & 1 is read; the pushes of ms j + 2 come after this rank's of ms j + 1
      if (warp == 0 && lane == 0 && j + 2 < p.r) arm(box.bar + slot, kN * kRowBytes);
    }

    // lane f: sum f rounded once, s = (i_e, i_p, i_l, q_e, q_p, q_l); a, the
    // sums the filters take (accumulated over pdi_ms), in every lane
    const float sf = static_cast<float>(v);
    const float af = p.pdi_ms > 1 ? acc + sf : sf;
    float a[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) a[f] = __shfl_sync(kAll, af, f);
    // filters update this ms, or hold between the every-pdi_ms updates
    const bool upd = p.pdi_ms <= 1 || ((ms0 + j) % p.pdi_ms) == (p.pdi_ms - 1);

    if (warp == 0) {
      // Costas PLL and FLL assist (reference: tracking.py:221-235): lane 0
      // takes the PLL's atan and lane 1 the FLL's, as one instruction stream
      double t = 0.0;
      if (lane == 0 || (lane == 1 && p.fll_on)) {
        const double ip64 = a[1], qp64 = a[4];
        const double ipp = fll_ip, qpp = fll_qp;
        const double num = lane == 0 ? qp64 : ipp * qp64 - qpp * ip64;  // FLL: cross
        const double den = lane == 0 ? ip64 : ipp * ip64 + qpp * qp64;  // FLL: dot
        t = (den != 0.0) ? atan(num / den) : 0.0;
        t = t / (lane == 0 ? kTwoPi : p.fll_div);
      }
      const double ferr = __shfl_sync(kAll, t, 1);
      if (lane == 0) {
        double cerr = t;
        double cnco = carr_nco + p.pll_a * (cerr - carr_err) + cerr * p.pll_b;
        if (p.fll_on) cnco = cnco + p.fll_gain * ferr;
        double cfreq = cb + cnco;
        s_cfreq = cfreq;
        if (!upd) {
          cerr = carr_err;
          cnco = carr_nco;
          cfreq = carr_freq;
        }
        if constexpr (kStage == kFull) carr_freq = cfreq;  // the ablated stages run open loop
        carr_nco = cnco;
        carr_err = cerr;
        if (j + 1 < p.r) carrier_steps();
        if (rank == 0) {
          of64[2 * plane + o_idx] = cfreq;
          of64[5 * plane + o_idx] = cerr;
          of64[6 * plane + o_idx] = cnco;
        }
      }
      if (upd) {
        fll_ip = a[1];
        fll_qp = a[4];
      }
      if (rank == 0 && lane < 6) of32[(lane < 2 ? 1 - lane : lane) * plane + o_idx] = sf;
      if (p.aided && code_warp != 0) {  // hand warp 1 the carrier frequency
        __threadfence_block();
        __syncwarp();
        asm volatile("bar.arrive 1, 64;" ::: "memory");
      }
    }
    if (warp == code_warp) {
      if (p.aided && code_warp != 0) asm volatile("bar.sync 1, 64;" ::: "memory");
      if (lane == 0) {
        // DLL (reference: tracking.py:237-251)
        const double ie64 = a[0], qe64 = a[3], il64 = a[2], ql64 = a[5];
        const double e_mag = sqrt(ie64 * ie64 + qe64 * qe64);
        const double l_mag = sqrt(il64 * il64 + ql64 * ql64);
        double derr = (e_mag + l_mag > 0.0) ? (e_mag - l_mag) / (e_mag + l_mag) : 0.0;
        double dnco = code_nco + p.dll_a * (derr - code_err) + derr * p.dll_b;
        double dfreq = p.code_freq_basis - dnco;
        if (p.aided) dfreq = dfreq + p.aid_ratio * (s_cfreq - p.intermediate_freq);
        if (!upd) {
          derr = code_err;
          dnco = code_nco;
          dfreq = code_freq;
        }
        if constexpr (kStage == kFull) code_freq = dfreq;
        code_nco = dnco;
        code_err = derr;
        if (j + 1 < p.r) code_steps(j + 1);
        if (rank == 0) {
          of64[plane + o_idx] = dfreq;
          of64[3 * plane + o_idx] = derr;
          of64[4 * plane + o_idx] = dnco;
        }
      }
    }
    if (p.pdi_ms > 1 && lane < 6) acc = upd ? 0.f : af;
  }

  if (rank == 0) {
    if (tid == 0) {
      si_out[3 * n_ch + c] = static_cast<long long>(static_cast<int>(cp));
      sf_out[c] = carr_freq;
      sf_out[2 * n_ch + c] = carr_nco;
      sf_out[3 * n_ch + c] = carr_err;
      sa_out[6 * n_ch + c] = fll_ip;
      sa_out[7 * n_ch + c] = fll_qp;
    }
    if (code_thread) {
      si_out[c] = ptr;
      si_out[n_ch + c] = rem;
      si_out[2 * n_ch + c] = ms;
      sf_out[n_ch + c] = code_freq;
      sf_out[4 * n_ch + c] = code_nco;
      sf_out[5 * n_ch + c] = code_err;
      ovf[c] = bad_max > 0 ? bad_max : 0;
    }
    if (warp == 0 && lane < 6) sa_out[lane * n_ch + c] = acc;
  }
  if constexpr (kN > 1) cg::this_cluster().sync();  // peers may still push into this rank
}

// hf: fs, code_freq_basis, intermediate_freq, pll_a, pll_b, dll_a, dll_b,
//     fll_gain, fll_div, aid_ratio (host array)
// hi: code_len_q, half_q, pdi_ms, fll_on, aided, spc, win, r, n_ch, chunk
//     (host array)
Params make_params(const double* hf, const long long* hi) {
  Params p;
  p.fs = hf[0];
  p.code_freq_basis = hf[1];
  p.intermediate_freq = hf[2];
  p.pll_a = hf[3];
  p.pll_b = hf[4];
  p.dll_a = hf[5];
  p.dll_b = hf[6];
  p.fll_gain = hf[7];
  p.fll_div = hf[8];
  p.aid_ratio = hf[9];
  p.code_len_q = hi[0];
  p.half_q = hi[1];
  p.pdi_ms = static_cast<int>(hi[2]);
  p.fll_on = static_cast<int>(hi[3]);
  p.aided = static_cast<int>(hi[4]);
  p.spc = static_cast<int>(hi[5]);
  p.win = static_cast<int>(hi[6]);
  p.r = static_cast<int>(hi[7]);
  p.n_ch = static_cast<int>(hi[8]);
  p.chunk = static_cast<int>(hi[9]);
  p.slot = p.chunk + 16;
  return p;
}

// The launch configuration of one instantiation: C*kN CTAs of ``threads``,
// clusters of kN (none for kN = 1), the staging buffers as dynamic shared
// memory; sets the kernel attributes the configuration needs.
template <bool kFused, int kStage, int kN>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int n_ch, int threads,
                      int slot, cudaStream_t stream) {
  auto kernel = track_block_kernel<kFused, kStage, kN>;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return cudaErrorInvalidValue;
  const int smem = (kN > 1 && kStage >= kLoad) ? 2 * slot : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  if (kN > 8) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(n_ch * kN));
  cfg->blockDim = dim3(static_cast<unsigned>(threads));
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kN;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = kN > 1 ? 1 : 0;
  return cudaSuccess;
}

template <bool kFused, int kStage, int kN>
int launch(const void* src, long long n_words, const void* starts_w, const void* fb0,
           const void* code_pads, const void* carr_basis, const void* active,
           const void* si_in, const void* sf_in, const void* sa_in, void* si_out,
           void* sf_out, void* sa_out, void* abs_sample, void* of64, void* of32,
           void* ovf, int threads, const double* hf, const long long* hi, void* stream) {
  const Params p = make_params(hf, hi);
  if (p.r <= 0 || p.n_ch <= 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<kFused, kStage, kN>(&cfg, &attr, p.n_ch, threads, p.slot,
                                                  static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(
      &cfg, track_block_kernel<kFused, kStage, kN>,
      static_cast<const int32_t*>(src), n_words, static_cast<const long long*>(starts_w),
      static_cast<const long long*>(fb0), static_cast<const float*>(code_pads),
      static_cast<const double*>(carr_basis), static_cast<const uint8_t*>(active),
      static_cast<const long long*>(si_in), static_cast<const double*>(sf_in),
      static_cast<const float*>(sa_in), static_cast<long long*>(si_out),
      static_cast<double*>(sf_out), static_cast<float*>(sa_out),
      static_cast<long long*>(abs_sample), static_cast<double*>(of64),
      static_cast<float*>(of32), static_cast<long long*>(ovf), p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ``alone``: count as if each CTA held an SM alone (dynamic shared memory
// past half of an SM's), so that no two of the clusters counted share an SM
template <bool kFused, int kStage, int kN>
int max_clusters(int threads, int chunk, int alone, int* out) {
  auto kernel = track_block_kernel<kFused, kStage, kN>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<kFused, kStage, kN>(&cfg, &attr, 1, threads, chunk + 16, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (alone) {
    int dev = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    const size_t smem = static_cast<size_t>(per_sm / 2 + 1);
    if (err == cudaSuccess && cfg.dynamicSmemBytes < smem) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      cfg.dynamicSmemBytes = smem;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cfg.numAttrs = 1;  // kN = 1 counts resident CTAs as clusters of one
  err = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  return static_cast<int>(err);
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

// B1 over the frames of build_frames.cu, ``kn`` CTAs per channel of
// ``threads`` threads each
extern "C" int sg_track_block(const void* frames, const void* fb0,
                              const void* code_pads, const void* carr_basis,
                              const void* active, const void* si_in,
                              const void* sf_in, const void* sa_in,
                              void* si_out, void* sf_out, void* sa_out,
                              void* abs_sample, void* of64, void* of32,
                              void* ovf, int kn, int threads, const double* hf,
                              const long long* hi, void* stream) {
  SG_BY_KN(kn, (launch<false, kFull, kN>(frames, 0, nullptr, fb0, code_pads, carr_basis, active,
                                         si_in, sf_in, sa_in, si_out, sf_out, sa_out, abs_sample,
                                         of64, of32, ovf, threads, hf, hi, stream)))
}

// B3: B1 reading the capture's (n_words,) int32 word view directly
extern "C" int sg_track_block_fused(const void* cap_words, long long n_words,
                                    const void* starts_w, const void* fb0,
                                    const void* code_pads, const void* carr_basis,
                                    const void* active, const void* si_in,
                                    const void* sf_in, const void* sa_in,
                                    void* si_out, void* sf_out, void* sa_out,
                                    void* abs_sample, void* of64, void* of32,
                                    void* ovf, int kn, int threads, const double* hf,
                                    const long long* hi, void* stream) {
  SG_BY_KN(kn, (launch<true, kFull, kN>(cap_words, n_words, starts_w, fb0, code_pads, carr_basis,
                                        active, si_in, sf_in, sa_in, si_out, sf_out, sa_out,
                                        abs_sample, of64, of32, ovf, threads, hf, hi, stream)))
}

// B1 stripped to ``stage`` (0 kFilters, 1 kLoad, 2 kCarrier, 3 kFull: the
// very instantiation sg_track_block launches at the same kn); arguments as
// sg_track_block
extern "C" int sg_track_block_stage(int stage, const void* frames, const void* fb0,
                                    const void* code_pads, const void* carr_basis,
                                    const void* active, const void* si_in,
                                    const void* sf_in, const void* sa_in,
                                    void* si_out, void* sf_out, void* sa_out,
                                    void* abs_sample, void* of64, void* of32,
                                    void* ovf, int kn, int threads, const double* hf,
                                    const long long* hi, void* stream) {
#define SG_STAGE(S)                                                                           \
  SG_BY_KN(kn, (launch<false, S, kN>(frames, 0, nullptr, fb0, code_pads, carr_basis, active, \
                                     si_in, sf_in, sa_in, si_out, sf_out, sa_out, abs_sample, \
                                     of64, of32, ovf, threads, hf, hi, stream)))
  switch (stage) {
    case kFilters: SG_STAGE(kFilters)
    case kLoad: SG_STAGE(kLoad)
    case kCarrier: SG_STAGE(kCarrier)
    case kFull: SG_STAGE(kFull)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SG_STAGE
}

// How many clusters of ``kn`` CTAs of B1 (fused = 0) or B3 (fused = 1) the
// card can hold at once, into *out (cudaOccupancyMaxActiveClusters; for
// kn = 1 the resident CTAs), and with ``alone`` how many with no two
// sharing an SM: the wrapper launches a size only where all n_ch clusters
// fit, preferring one where each has SMs of its own.  ``chunk``: window
// bytes per rank (sizes the staging).
extern "C" int sg_track_block_max_clusters(int fused, int kn, int threads, int chunk,
                                           int alone, int* out) {
  if (fused) {
    SG_BY_KN(kn, (max_clusters<true, kFull, kN>(threads, chunk, alone, out)))
  }
  SG_BY_KN(kn, (max_clusters<false, kFull, kN>(threads, chunk, alone, out)))
}
