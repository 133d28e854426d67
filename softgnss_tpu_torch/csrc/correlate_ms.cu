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
// cached global read.  The samples are read straight from the device
// capture, so no frame exists that a span could overflow.
//
// What bounds it on the H100: one ms of 8 channels is ~305k samples at ~90
// integer/float ops each, 0.4 us of work for the card: less than a launch
// costs.  What a call costs is the chain of serial steps around that work:
// the launch, the loads, the reductions across threads and CTAs.
//
// Design (correlate_ms_kernel): ONE launch per ms.  Each channel's window
// [ptr, ptr + blk) spreads over kn CTAs (the launch plan,
// track/pallas_kernel.py ``correlate_plan``, sets kn, the threads per CTA
// and the 16-sample vectors per CTA; this file only refuses a plan past its
// limits; at 8 channels 16 CTAs of 608 threads, one per SM).  The window is
// cut on the capture's 16-byte address grid: vector v holds window samples
// 16 v - head .. 16 v - head + 15, head = (address of ptr) mod 16.  CTA r
// stages vectors [r vpc, (r + 1) vpc) into shared memory (then the next
// kn vpc on, so any blk is covered): one 16-byte cp.async per vector inside
// the capture, byte loads on its edges, zeros outside it; in the same
// round trip, 4-byte cp.asyncs stage the chips of the code row that those
// samples reach (tq rises with k, so they are [chip(tq_first - half),
// chip(tq_last + half)], ~60 of 1 025), nothing of the table before the
// first sample.  Each thread then takes 4 samples (one 32-bit word) and
// walks them in order, advancing counts by w (uint32 wrap) and tq by step
// (int64), exact in integers; lanes outside the window or the capture add
// nothing.  For +-1 chips (every C/A table) a product is the widened ib or
// qb with the chip's sign: two float64 conversions per sample instead of
// six, the same bits.  The thread's six float64 sums meet in each warp by a
// butterfly that halves the sums a lane holds at each step (9 float64
// shuffles, not a tree's 30), then in warp order; warp 0 writes the CTA's
// row of six into a float64 scratch (n_ch, kn, 6) and draws a per-channel
// ticket (atom.acq_rel: the release publishes the row); the CTA that draws
// the last ticket copies the kn rows from L2 in one round of 16-byte
// cp.asyncs, sums them in CTA order, rounds once to float32, writes out and
// resets the ticket, so the next launch, or a CUDA graph's next replay,
// finds it zero.  The scratch and tickets are allocated once per device by
// the wrapper.  Every order is fixed and no float atomics are used, so two
// launches give the same bits; the float64 accumulation of the float32
// products makes the float32 result agree with the plain version's to the
// last bit (bar a float64 sum within ~1e-16 of a float32 rounding
// boundary).  Inactive channels: CTA 0 writes zeros, all exit.  (A cluster
// of kn CTAs reducing through rank 0's shared memory was timed against this
// design in the same runs and lost: a cluster's CTAs must share one GPC,
// and at one CTA per SM the eighth 16-CTA cluster waits for a second wave.)
//
// The first design (two launches: CTA partial rows in a scratch the host
// allocated per call, then a reduce kernel; the whole code table staged in
// shared memory, byte loads) lost every timing to this one and was deleted.
//
// Stage ablation (the counterpart of scripts/pallas_ablate.py's
// ``make_fn``, which stripped the TPU kernel stage by stage): ``kStage``
// strips the sample loop at compile time.  kNoop runs no sample loop (the
// launch and the reductions of zeros); kCarrier loads the samples and
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

constexpr int kPad = 1025;
constexpr long long kCodeOne = 1LL << 40;
constexpr int kVec = 16;             // samples per 16-byte copy
constexpr int kWord = 4;             // samples per thread and step: one 32-bit word
constexpr int kMaxThreads = 1024;    // launch bounds of correlate_ms_kernel
constexpr int kMaxVecPerCta = 512;   // 16-byte vectors a CTA stages per pass (8 KB)
constexpr int kMaxCtas = 64;         // CTAs per channel

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

// d with the sign of s flipped in: d * s exactly for s = +-1
__device__ __forceinline__ double signed_by(double d, float s) {
  return __hiloint2double(__double2hiint(d) ^ static_cast<int>(__float_as_uint(s) & 0x80000000u),
                          __double2loint(d));
}

// one sample's terms added to the six sums [i_e, i_p, i_l, q_e, q_p, q_l]
// as ``kStage`` keeps them; ``code(i)`` reads chip i of the padded code
template <int kStage, typename Code>
__device__ __forceinline__ void add_sample(double (&acc)[6], float x, unsigned int counts,
                                           long long tq, long long half_q, Code code) {
  const float turns = __int_as_float(static_cast<int>(0x3F800000u | (counts >> 9))) - 1.0f;
  const float ib = sin_turns(turns) * x;
  const float qb = sin_turns(turns + 0.25f) * x;
  if constexpr (kStage == kCarrier) {
    acc[1] += static_cast<double>(ib);
    acc[4] += static_cast<double>(qb);
  } else if constexpr (kStage == kPhase) {
    acc[0] += static_cast<double>(chip_index(tq - half_q));
    acc[3] += static_cast<double>(chip_index(tq));
    acc[2] += static_cast<double>(chip_index(tq + half_q));
    acc[1] += static_cast<double>(ib);
    acc[4] += static_cast<double>(qb);
  } else {
    const float e = code(chip_index(tq - half_q));
    const float pr = code(chip_index(tq));
    const float l = code(chip_index(tq + half_q));
    if (fabsf(e) == 1.0f && fabsf(pr) == 1.0f && fabsf(l) == 1.0f) {
      // +-1 chips (every C/A table): each float32 product is +-ib or +-qb
      // exactly, so its float64 value is the widened ib or qb with the
      // chip's sign; two conversions instead of six (the conversion pipe
      // runs at a quarter of DADD's rate)
      const double di = static_cast<double>(ib), dq = static_cast<double>(qb);
      acc[0] += signed_by(di, e);
      acc[1] += signed_by(di, pr);
      acc[2] += signed_by(di, l);
      acc[3] += signed_by(dq, e);
      acc[4] += signed_by(dq, pr);
      acc[5] += signed_by(dq, l);
    } else {
      acc[0] += static_cast<double>(e * ib);
      acc[1] += static_cast<double>(pr * ib);
      acc[2] += static_cast<double>(l * ib);
      acc[3] += static_cast<double>(e * qb);
      acc[4] += static_cast<double>(pr * qb);
      acc[5] += static_cast<double>(l * qb);
    }
  }
}

// B4's CTA sums: in each warp a butterfly that halves the sums a lane holds
// at every step (8 slots, 6 sums and 2 zeros: 4 + 2 + 1 + 1 + 1 float64
// shuffles instead of the tree's 30), after which lanes 4f .. 4f + 3 hold
// sum f; then the warps in order (threads 0..5 hold sum f = tid; ``red``
// is [6][warps] shared)
template <int kOff, int kWidth>
__device__ __forceinline__ void halve(double (&v)[8], int lane) {
  // the lower lane of the pair keeps slots [0, kWidth), the upper one
  // [kWidth, 2 kWidth), each adding its partner's copy of them into v[j]
  const bool upper = (lane & kOff) != 0;
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    const double keep = upper ? v[kWidth + j] : v[j];
    const double give = upper ? v[j] : v[kWidth + j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, give, kOff);
  }
}

__device__ __forceinline__ double cta_sum_butterfly(const double (&acc)[6],
                                                   double (*red)[kMaxThreads / 32]) {
  const int tid = threadIdx.x, lane = tid & 31;
  double v[8] = {acc[0], acc[1], acc[2], acc[3], acc[4], acc[5], 0.0, 0.0};
  halve<16, 4>(v, lane);
  halve<8, 2>(v, lane);
  halve<4, 1>(v, lane);
  double s = v[0];
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  const int f = lane >> 2;
  if ((lane & 3) == 0 && f < 6) red[f][tid >> 5] = s;
  __syncthreads();
  double t = 0.0;
  if (tid < 6) {
    const int warps = static_cast<int>(blockDim.x >> 5);
#pragma unroll
    for (int i = 0; i < kMaxThreads / 32; ++i)
      if (i < warps) t += red[tid][i];
  }
  return t;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

// the old value of *p; *p += 1, releasing this warp's prior writes and
// acquiring those that every earlier ticket released
__device__ __forceinline__ unsigned int take_ticket(unsigned int* p) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// --- B4: one launch per ms ---------------------------------------------------

// grid (n_ch * kn): CTA b is rank b % kn of channel b / kn; ``threads`` per
// CTA; scratch (n_ch, kn, 6) float64, tickets (n_ch,) uint32
template <int kStage>
__global__ void __launch_bounds__(kMaxThreads)
correlate_ms_kernel(const int8_t* __restrict__ cap, long long n_cap,
                    const long long* __restrict__ ptr, const int32_t* __restrict__ carr_phase,
                    const int32_t* __restrict__ carr_w, const long long* __restrict__ rem,
                    const long long* __restrict__ step, const long long* __restrict__ blk,
                    const float* __restrict__ code_pads, const uint8_t* __restrict__ active,
                    long long half_q, int kn, int vec_per_cta, double* __restrict__ scratch,
                    unsigned int* __restrict__ tickets, float* __restrict__ out) {
  __shared__ double red[6][kMaxThreads / 32];
  const int c = blockIdx.x / kn;
  const int rank = blockIdx.x % kn;
  const int tid = threadIdx.x;
  // the channel's parameters in one round trip, before its activity decides
  const bool on = active[c];
  const long long p0 = ptr[c], n = blk[c], rem0 = rem[c], st = step[c];
  const unsigned int cp = static_cast<unsigned int>(carr_phase[c]);
  const unsigned int w = static_cast<unsigned int>(carr_w[c]);
  if (!on) {
    if (rank == 0 && tid < 6) out[c * 6 + tid] = 0.0f;
    return;
  }

  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if constexpr (kStage != kNoop) {
    __shared__ __align__(16) uint8_t buf[kMaxVecPerCta * kVec];  // this pass's samples
    __shared__ float chips[kPad];                                // the code chips it reaches
    const float* __restrict__ row = code_pads + static_cast<long long>(c) * kPad;
    float* const chip_buf = chips;  // a pointer: a lambda cannot capture a static array
    const long long head = static_cast<long long>(
        (reinterpret_cast<uintptr_t>(cap) + static_cast<unsigned long long>(p0)) & (kVec - 1));
    const long long n_vec = n > 0 ? (head + n + kVec - 1) / kVec : 0;
    const long long span = static_cast<long long>(kn) * vec_per_cta;
    for (long long v0 = static_cast<long long>(rank) * vec_per_cta; v0 < n_vec; v0 += span) {
      const int nv = static_cast<int>(v0 + vec_per_cta < n_vec ? vec_per_cta : n_vec - v0);
      const long long s_base = p0 - head + v0 * kVec;  // capture sample of buf[0] (aligned)
      if (v0 != static_cast<long long>(rank) * vec_per_cta) __syncthreads();  // buf is free
      // stage: one 16-byte cp.async per vector inside the capture, bytes
      // (0 outside it) on its edges
      for (int i = tid; i < nv; i += blockDim.x) {
        const long long s0 = s_base + static_cast<long long>(i) * kVec;
        if (s0 >= 0 && s0 + kVec <= n_cap) {
          cp_async16(buf + i * kVec, cap + s0);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            buf[i * kVec + j] = (s0 + j >= 0 && s0 + j < n_cap) ? cap[s0 + j] : 0;
        }
      }
      // and, in the same round trip, the chips [lo, hi] of the code row
      // that the pass's window samples reach (tq rises with k: ~60 of them
      // at the plan's sizes)
      int chip_lo = 0;
      if constexpr (kStage == kFull) {
        const long long k_a = s_base - p0 > 0 ? s_base - p0 : 0;
        const long long k_end = s_base + static_cast<long long>(nv) * kVec - p0;
        const long long k_b = (k_end < n ? k_end : n) - 1;
        if (k_a <= k_b) {
          chip_lo = chip_index(rem0 + st * k_a - half_q);
          const int chip_hi = chip_index(rem0 + st * k_b + half_q);
          for (int i = tid; i <= chip_hi - chip_lo; i += blockDim.x)
            cp_async4(chip_buf + i, row + chip_lo + i);
        }
      }
      const auto code = [chip_buf, chip_lo](int i) { return chip_buf[i - chip_lo]; };
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncthreads();
      // thread t: the 4 samples of word t, lanes [lo, hi) in the window and the capture
      for (int i = tid * kWord; i < nv * kVec; i += blockDim.x * kWord) {
        const long long s0 = s_base + i, k0 = s0 - p0;
        const long long lo_l = k0 < 0 ? -k0 : 0, lo_c = s0 < 0 ? -s0 : 0;
        const long long hi_l = n - k0, hi_c = n_cap - s0;
        const int lo = static_cast<int>(lo_l > lo_c ? lo_l : lo_c);
        const long long hi_m = hi_l < hi_c ? hi_l : hi_c;
        const int hi = static_cast<int>(hi_m < kWord ? hi_m : kWord);
        if (lo >= hi) continue;
        const uint32_t word = *reinterpret_cast<const uint32_t*>(buf + i);
        unsigned int counts = cp + w * static_cast<unsigned int>(k0);
        long long tq = rem0 + st * k0;
#pragma unroll
        for (int j = 0; j < kWord; ++j) {
          if (j >= lo && j < hi) {
            const float x = static_cast<float>(static_cast<int8_t>(word >> (8 * j)));
            add_sample<kStage>(acc, x, counts, tq, half_q, code);
          }
          counts += w;
          tq += st;
        }
      }
    }
  }
  const double t = cta_sum_butterfly(acc, red);

  // warp 0 (threads 0..5 hold the sums) finishes alone
  if (tid >= 32) return;
  double* rows = scratch + static_cast<long long>(c) * kn * 6;
  if (tid < 6) rows[rank * 6 + tid] = t;
  __syncwarp();
  unsigned int ticket = 0;
  if (tid == 0) ticket = take_ticket(&tickets[c]);  // releases this CTA's row
  if (__shfl_sync(0xffffffffu, ticket, 0) != static_cast<unsigned int>(kn - 1)) return;
  __syncwarp();
  // the last ticket acquired every row: the warp copies all kn of them from
  // L2 in one round of 16-byte copies (a row is 48 bytes, the scratch
  // 16-byte aligned), then lane f sums its column in CTA order
  __shared__ __align__(16) double fin[kMaxCtas * 6];
  for (int i = tid; i < kn * 3; i += 32) cp_async16(fin + 2 * i, rows + 2 * i);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();
  if (tid < 6) {
    double s = fin[tid];
    for (int q = 1; q < kn; ++q) s += fin[q * 6 + tid];
    out[c * 6 + tid] = static_cast<float>(s);
  }
  if (tid == 0) tickets[c] = 0u;  // ready for the next launch (and graph replay)
}

// --- launches ----------------------------------------------------------------

struct Args {
  const int8_t* cap;
  long long n_cap;
  const long long* ptr;
  const int32_t* carr_phase;
  const int32_t* carr_w;
  const long long* rem;
  const long long* step;
  const long long* blk;
  const float* code_pads;
  const uint8_t* active;
  long long half_q;
  int n_ch;
  float* out;
  cudaStream_t stream;
};

Args make_args(const void* cap, long long n_cap, const void* ptr, const void* carr_phase,
               const void* carr_w, const void* rem, const void* step, const void* blk,
               const void* code_pads, const void* active, long long half_q, int n_ch, void* out,
               void* stream) {
  return Args{static_cast<const int8_t*>(cap), n_cap, static_cast<const long long*>(ptr),
              static_cast<const int32_t*>(carr_phase), static_cast<const int32_t*>(carr_w),
              static_cast<const long long*>(rem), static_cast<const long long*>(step),
              static_cast<const long long*>(blk), static_cast<const float*>(code_pads),
              static_cast<const uint8_t*>(active), half_q, n_ch, static_cast<float*>(out),
              static_cast<cudaStream_t>(stream)};
}

// B4 at the plan (kn CTAs per channel, ``threads`` each, vec_per_cta)
template <int kStage>
int launch_one_pass(const Args& a, int kn, int threads, int vec_per_cta, void* scratch,
                    void* tickets) {
  if (kn < 1 || kn > kMaxCtas || threads < 32 || threads > kMaxThreads || threads % 32 ||
      vec_per_cta < 1 || vec_per_cta > kMaxVecPerCta || scratch == nullptr || tickets == nullptr ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_ch <= 0) return 0;
  correlate_ms_kernel<kStage><<<a.n_ch * kn, threads, 0, a.stream>>>(
      a.cap, a.n_cap, a.ptr, a.carr_phase, a.carr_w, a.rem, a.step, a.blk, a.code_pads, a.active,
      a.half_q, kn, vec_per_cta, static_cast<double*>(scratch),
      static_cast<unsigned int*>(tickets), a.out);
  return static_cast<int>(cudaGetLastError());
}

#define SG_BY_STAGE(STAGE, CALL)                             \
  switch (STAGE) {                                           \
    case kNoop: { constexpr int kS = kNoop; return CALL; }   \
    case kCarrier: { constexpr int kS = kCarrier; return CALL; } \
    case kPhase: { constexpr int kS = kPhase; return CALL; } \
    case kFull: { constexpr int kS = kFull; return CALL; }   \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

// cap: (n_cap,) int8 capture; ptr, rem, step, blk: (n_ch,) int64;
// carr_phase, carr_w: (n_ch,) int32; code_pads: (n_ch, 1025) float32;
// active: (n_ch,) bool, one byte of 0 or 1; scratch: (n_ch, kn, 6) float64
// and tickets: (n_ch,) uint32, zero before the first launch and left zero
// by every launch; out: (n_ch, 6) float32.  One launch on ``stream`` at
// the plan (kn CTAs per channel, ``threads`` per CTA, ``vec_per_cta``
// 16-sample vectors per CTA and pass); cudaErrorInvalidValue for a plan
// past the kernel's limits.
extern "C" int sg_correlate_ms(const void* cap, long long n_cap, const void* ptr,
                               const void* carr_phase, const void* carr_w, const void* rem,
                               const void* step, const void* blk, const void* code_pads,
                               const void* active, long long half_q, int n_ch, int kn,
                               int threads, int vec_per_cta, void* scratch, void* tickets,
                               void* out, void* stream) {
  const Args a = make_args(cap, n_cap, ptr, carr_phase, carr_w, rem, step, blk, code_pads, active,
                           half_q, n_ch, out, stream);
  return launch_one_pass<kFull>(a, kn, threads, vec_per_cta, scratch, tickets);
}

// B4 stripped to ``stage`` (0 kNoop, 1 kCarrier, 2 kPhase, 3 kFull: the
// very instantiation sg_correlate_ms launches); arguments as sg_correlate_ms
extern "C" int sg_correlate_ms_stage(int stage, const void* cap, long long n_cap,
                                     const void* ptr, const void* carr_phase, const void* carr_w,
                                     const void* rem, const void* step, const void* blk,
                                     const void* code_pads, const void* active, long long half_q,
                                     int n_ch, int kn, int threads, int vec_per_cta,
                                     void* scratch, void* tickets, void* out, void* stream) {
  const Args a = make_args(cap, n_cap, ptr, carr_phase, carr_w, rem, step, blk, code_pads, active,
                           half_q, n_ch, out, stream);
  SG_BY_STAGE(stage, (launch_one_pass<kS>(a, kn, threads, vec_per_cta, scratch, tickets)))
}
