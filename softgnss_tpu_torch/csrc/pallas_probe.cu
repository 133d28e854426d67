// S5, the construct probes: six small kernels, each a Hopper construct that
// the receiver's kernels use or could use (B1 and B3 run each channel on a
// thread-block cluster, as ``acc`` does).
//
// Replaces scripts/pallas_probe.py, which checked that Mosaic lowers six
// constructs on the TPU: a gridded kernel (_k_grid via gridded), a sum
// whose output block is revisited across grid steps (_k_acc via
// gridded_acc), an int32 -> float32 convert (_k_conv via conv), a
// channel-batched one-hot compare and reduce (_k_3d via batched3d), a
// batched dot_general (_k_bdot via bdot) and a 2-D dot in an in-kernel
// fori loop (_k_dot via dot2d).  Each kernel here computes what its TPU
// kernel computes, at the script's shapes:
//   grid   — o = x + 1, one CTA of 256 threads per (8, 128) block, each
//            thread moving one 16-byte float4 (probe_grid_kernel);
//   acc    — o[r] = sum_i sum_j x[8i + r, j], (64, 128) -> (8,): on the TPU
//            the grid runs in order and the sum stays in VMEM; on Hopper
//            the eight blocks run at once, so they form ONE 8-CTA thread
//            block cluster: each CTA sums its (8, 128) block to 8 partials
//            and rank 0 sums the 8 ranks' partials in rank order.  The
//            design (probe_acc_kernel) is a one-sided push: each warp
//            stores its partial into rank 0's shared memory by st.async,
//            completing on rank 0's mbarrier, and a consumer warp of rank
//            0 frees the slot with a remote mbarrier arrive: no cluster
//            barrier per rep.  ``reps`` repeats the step: its cost per rep
//            is a handoff a cluster pays per ms;
//   conv   — __int2float_rn, elementwise, 16-byte vectors, a grid sized
//            by the wrapper's plan (probe_conv_kernel); the first design,
//            a grid-stride loop of 4-byte loads, is kept as
//            probe_conv_loop_kernel (section 3);
//   onehot — o[c, k] = sum_w [h[c, w] == k] * b[c, w], one warp per row c:
//            each lane sums its run of columns into its own row of a
//            per-warp table in shared memory, then lane k sums bin k over
//            the lanes that touched it (probe_onehot_kernel, section 4);
//   bdot   — batched (B, 8, K) @ (B, K, 8) on the tensor cores by hand
//            (mma.sync.aligned.m16n8k8 TF32, float32 accumulation, rows
//            8..15 of the m16 tile zero): batch i is one 8 x 8 output tile,
//            so probe_dot_kernel runs it, one CTA per batch on the grid's
//            y index, steps = 1;
//   dot    — steps * (a @ b), the ``steps``-step loop inside the kernel
//            as the TPU kernel's fori_loop: one CTA of 8 warps per 8 x 8
//            output tile, its operands staged on chip once and K split
//            across the warps (probe_dot_kernel, section 6 below).
//
// Every probe was redesigned; the first designs of grid, acc, onehot,
// bdot and dot (and B1's former acc handoff, one cluster barrier per rep)
// lost every timing to these and were deleted.  conv's first design stays
// (section 3): it is faster at the script's shape and slower at B2's.
//
// Sums that must be bit-equal to the plain versions (acc, onehot) are
// taken in float64 in a fixed order and rounded once; the plain versions
// in scripts/pallas_probe.py repeat that order.  bdot and dot round their inputs to TF32 (cvt.rna), so they are
// held to 2^-10 * sum_k |a_ik b_kj|.
//
// What bounds them on the H100 at the script's shapes: nothing but the
// launch and, inside it, the longest chain of dependent loads and
// instructions.  The largest, dot, moves 336 KB (0.1 us at 3.35 TB/s) and
// does 16.8 MFLOP (0.03 us at 495 TF32 TFLOP/s); a launch costs
// microseconds.  acc's per-rep step is the handoff of 64 partials to rank
// 0 and of the slot back, the number it exists for.  conv and onehot are
// also run where they do real work, at B2's frame geometry and at the
// receiver's one-hot geometry, where their bytes bound them.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlockRows = 8;    // rows of one (8, 128) block
constexpr int kCols = 128;
constexpr int kCluster = 8;      // CTAs of the acc cluster: the script's grid
constexpr int kBins = 32;        // one-hot bins

// --- 1. grid ---------------------------------------------------------------

// What bounds it: 64 KB in and out (0.02 us at 3.35 TB/s) against a launch
// of ~2 us, so only the launch and one round trip to memory should remain.
// The first design ran four passes of 4-byte loads and stores per thread
// (its bound, blockDim.x, known only at run time).  Here one CTA still takes one (8, 128) block, the TPU grid, and its 256
// threads each move one float4 (neighbouring threads on neighbouring 16
// bytes): one load and one store per thread, no loop.  The wrapper requires x to be
// contiguous and 16-byte aligned (o is allocated so).
constexpr int kGridThreads = kBlockRows * kCols / 4;

__global__ void __launch_bounds__(kGridThreads)
probe_grid_kernel(const float4* __restrict__ x, float4* __restrict__ o) {
  const long long i = static_cast<long long>(blockIdx.x) * kGridThreads + threadIdx.x;
  float4 v = x[i];
  v.x += 1.0f;
  v.y += 1.0f;
  v.z += 1.0f;
  v.w += 1.0f;
  o[i] = v;
}

// --- 2. acc: one 8-CTA cluster, DSMEM reduction ---------------------------
//
// One 8-CTA cluster run ``reps`` times in one launch: warp w < 8 of CTA
// ``rank`` sums row 8*rank + w (row_sum), and rank 0 sums the 8 ranks'
// partials of row w in rank order and rounds once.  A rep's partials reach
// rank 0 by a one-sided push (probe_acc_kernel): each warp stores its
// partial straight into rank 0's slot [rep & 1][rank][w] by st.async,
// whose completion counts its 8 bytes on rank 0's ``full`` mbarrier of the
// slot (armed for the 8 x 64 bytes of a rep); a ninth warp of rank 0, the
// consumer, waits on it (try_wait.parity), reads the slot from its own
// shared memory, arms the slot for the rep two on and arrives remotely on
// each rank's ``empty`` mbarrier of the slot, on which that rank's warps
// wait before they reuse the slot.  A producer/consumer ring: one cluster
// barrier at the start (the mbarriers initialised), none per rep.  The
// first design (one slot per rank between two cluster barriers per rep)
// and B1's former handoff (ONE cluster barrier per rep, parity slots read
// through DSMEM) lost to it and were deleted.
// What the push's design had to get right (PERF.md section 6): the
// consumer is a warp of its own, since rank 0's warp 0 both summing its row
// and draining the slot put the two in series (1.72 us per rep, slower
// than two cluster barriers, against 0.36 now); and the mbarrier
// operations keep PTX's default semantics (release / acquire at CTA scope,
// as CUTLASS's cluster pipelines use them for a peer's copies into a CTA's
// shared memory and for the remote "slot free" arrive), since
// cluster-scope release and acquire on every wait and arrive were slower.

// warp w of CTA ``rank`` sums row 8*rank + w: lane l adds x[row, l + 32 i],
// i = 0..3, in order in float64, then a shuffle tree (offsets 16 .. 1);
// lane 0 holds the row's sum
__device__ __forceinline__ double row_sum(const float* row, int lane) {
  double v = static_cast<double>(row[lane]);
#pragma unroll
  for (int i = 1; i < kCols / 32; ++i) v += static_cast<double>(row[lane + 32 * i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
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

// wait for phase ``parity`` of a local mbarrier
__device__ __forceinline__ void wait_bar(const uint64_t* bar, uint32_t parity) {
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

// arm a phase of a local mbarrier of count 1: expect ``bytes`` and arrive
__device__ __forceinline__ void arm(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

constexpr uint32_t kRepBytes = kCluster * kBlockRows * sizeof(double);  // one rep's partials
constexpr int kAccThreads = kBlockRows * 32 + 32;  // 8 producer warps and the consumer warp

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kAccThreads)
probe_acc_kernel(const float* x, float* __restrict__ o, int reps) {
  __shared__ double slots[2][kCluster][kBlockRows];  // rank 0's: every rank's partials by parity
  __shared__ __align__(8) uint64_t full[2];          // rank 0's: slot s holds a whole rep
  __shared__ __align__(8) uint64_t empty[2];         // each rank's: rank 0 has read slot s
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(empty + s)) : "memory");
      if (rank == 0)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(full + s)) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (rank == 0)
      for (int s = 0; s < 2 && s < reps; ++s) arm(full + s, kRepBytes);  // reps 0 and 1
  }
  cluster.sync();  // every mbarrier initialised before a rank pushes or arrives

  if (w == kBlockRows) {  // the consumer: rank 0's ninth warp; the peers' have nothing to do
    if (rank != 0) return;
    for (int rep = 0; rep < reps; ++rep) {
      const int s = rep & 1;
      wait_bar(full + s, static_cast<uint32_t>((rep >> 1) & 1));  // all 64 partials landed
      double t = 0.0;
      if (lane < kBlockRows) {
        t = slots[s][0][lane];
#pragma unroll
        for (int q = 1; q < kCluster; ++q) t += slots[s][q][lane];
      }
      if (rep + 2 < reps) {  // slot s is read: expect rep + 2 in it, and free it on every rank
        __syncwarp();
        if (lane == 0) arm(full + s, kRepBytes);
        __syncwarp();
        if (lane < kCluster)
          asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];"
                       ::"r"(cluster_addr(empty + s, lane))
                       : "memory");
      }
      if (lane < kBlockRows) o[lane] = static_cast<float>(t);
    }
    return;
  }

  // the producers: this warp's entry of rank 0's two slots, and their mbarriers
  const uint32_t dst0 = cluster_addr(&slots[0][rank][w], 0);
  const uint32_t dst1 = cluster_addr(&slots[1][rank][w], 0);
  const uint32_t full0 = cluster_addr(full, 0);
  const uint32_t full1 = cluster_addr(full + 1, 0);
  const float* row = x + (static_cast<long long>(rank) * kBlockRows + w) * kCols;
  for (int rep = 0; rep < reps; ++rep) {
    const int s = rep & 1;
    const double v = row_sum(row, lane);
    if (lane == 0) {
      if (rep >= 2) wait_bar(empty + s, static_cast<uint32_t>(((rep >> 1) - 1) & 1));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
          ::"r"(s ? dst1 : dst0), "l"(__double_as_longlong(v)), "r"(s ? full1 : full0)
          : "memory");
    }
  }
}

// --- 3. conv ---------------------------------------------------------------
//
// o = __int2float_rn(x), int32 -> float32, round to nearest even.  What
// bounds it: its bytes, 8 per element (2.4 ns at the script's 1 024
// elements, where the launch is all that remains; 11.7 us on one block of
// B2's frames, 64 x 8 x 9 580 int32).  The first design
// (probe_conv_loop_kernel) is a grid-stride loop of 4-byte loads over at
// most 1 024 CTAs: at the script's shape 4 CTAs of one element per
// thread.  This design moves 16-byte vectors: an int4 load, four
// __int2float_rn, one float4 store, neighbouring threads on neighbouring
// vectors.  Thread t of the grid's S threads takes vectors t, t + S, ...,
// kConvVecs of them loaded before any is stored, so that each thread keeps
// that many loads in flight.  The wrapper's launch plan
// (pallas_probe.conv_plan) sizes the grid: at the script's shape one CTA
// of 256 threads, one vector each, no second pass (grid's kernel, the
// launch floor); at large n a few CTAs per SM.  The n % 4 elements past
// the last whole vector are converted one by one by the first threads of
// CTA 0.  x and o are 16-byte aligned (the entry refuses them otherwise).
constexpr int kConvThreads = 256;
constexpr int kConvVecs = 4;  // vectors a thread loads before it stores

__global__ void __launch_bounds__(kConvThreads)
probe_conv_kernel(const int4* __restrict__ x, float4* __restrict__ o, long long n) {
  const long long vecs = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kConvThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kConvThreads + threadIdx.x;
  for (long long i = t; i < vecs; i += kConvVecs * stride) {
    int4 v[kConvVecs];
#pragma unroll
    for (int j = 0; j < kConvVecs; ++j)
      if (i + j * stride < vecs) v[j] = x[i + j * stride];
#pragma unroll
    for (int j = 0; j < kConvVecs; ++j)
      if (i + j * stride < vecs)
        o[i + j * stride] = make_float4(__int2float_rn(v[j].x), __int2float_rn(v[j].y),
                                        __int2float_rn(v[j].z), __int2float_rn(v[j].w));
  }
  if (t < n - 4 * vecs) {
    const long long e = 4 * vecs + t;
    reinterpret_cast<float*>(o)[e] = __int2float_rn(reinterpret_cast<const int*>(x)[e]);
  }
}

// The first design, kept: it wins at the script's shape and loses at B2's
__global__ void __launch_bounds__(256)
probe_conv_loop_kernel(const int* __restrict__ x, float* __restrict__ o, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    o[i] = __int2float_rn(x[i]);
}

// --- 4. onehot: weighted one-hot histogram per row -------------------------
//
// o[c, k] = sum_w [h[c, w] == k] * b[c, w] for the 32 bins k; an h outside
// [0, 32) matches no bin (the receiver's sentinels -1 and 32 among them).
// What bounds it: at the script's shape, (8, 256), the launch (5.3 KB
// moved); at the receiver's one-hot geometry, (4 800, 128) -> (4 800, 32),
// its 5.53 MB, 1.65 us at 3.35 TB/s (its 39 M compares and adds take 0.59
// us at 67 TFLOP/s).  The first design (deleted) ran one CTA of 256
// threads per row: the row copied to shared memory behind a CTA barrier,
// then thread k walked all ``width`` columns for bin k, one chain of
// ``width`` dependent float64 adds, while 224 of the 256 threads idled.
//
// This design runs one warp per row, ``warps`` rows per CTA (the wrapper's
// launch plan, pallas_probe.onehot_plan).  Lane l owns the columns
// [l * width / 32, (l + 1) * width / 32) and reads them straight into
// registers as 16-byte int4 / float4 vectors: no staging copy, no CTA
// barrier.  Pass 1: the lane sums its columns, in column order and in
// float64, into its own row p[l][.] of the warp's table in shared memory.
// __syncwarp.  Pass 2: lane k sums p[0..31][k] in lane order and rounds
// once to float32.  The dependent chain is width / 32 adds and then one
// per lane that touched bin k, against ``width`` in the first design.
//
// Pass 1 keeps the current run of equal bins in a register and writes an
// entry only when the run ends (stored at the lane's first touch of the
// bin, added to at later ones: the same float64 adds, in the same order,
// as an add per column onto a zeroed entry); pass 2 adds only the lanes
// that touched bin k, which lane k learns from the lanes' masks of
// touched bins transposed across the warp by five shuffles.  What had to
// be got right (PERF.md section 6): the table's traffic did not set the
// time (a zeroed table read in full took as long), but learning the
// touching lanes by a ballot per bin took ~1.3 us more than the transpose
// at the receiver's shape.  An entry never touched would be +0.0, and no
// partial is -0.0 (each starts as 0.0 + b), so skipping it changes no
// bit.  A table row is kOnehotPitch = 33 doubles, so that entry (l, k)
// lies on bank pair (l + k) mod 16 of its half-warp's access (a 64-bit
// access is served per half-warp).  The table is warps x 32 x 33 x 8
// bytes of dynamic shared memory (the entry raises the kernel's limit
// above the default 48 KB once, where a plan needs it; the default plan,
// 2 warps per CTA, takes 16.9 KB).  h and b are 16-byte aligned and width
// is 128 * vecs_per_lane (the entry refuses anything else).
constexpr int kOnehotPitch = kBins + 1;  // doubles per lane row of the table
constexpr int kOnehotMaxWarps = 16;      // the launch bounds
constexpr int kOnehotMaxVecs = 8;        // vectors per lane: width <= 1024
constexpr int kOnehotVecs = 2;           // vectors of h and of b loaded before they are added

// One column of pass 1: bin k (none outside [0, 32)) gets v.  ``run`` is
// the bin whose sum ``acc`` holds in a register (-1: none yet),
// ``touched`` the bins this lane has summed.
__device__ __forceinline__ void onehot_add(double* mine, int k, float v, int& run, double& acc,
                                           unsigned& touched) {
  if (static_cast<unsigned>(k) >= static_cast<unsigned>(kBins)) return;
  if (k != run) {
    if (run >= 0) mine[run] = acc;
    acc = (touched >> k) & 1u ? mine[k] : 0.0;
    touched |= 1u << k;
    run = k;
  }
  acc += static_cast<double>(v);
}

// The warp's 32 x 32 bit matrix transposed: lane l holds row l (bit k of
// ``x``) and gets column l (bit j: bit l of lane j's row), by five
// exchanges of the off-diagonal blocks between lanes l and l ^ j
__device__ __forceinline__ unsigned transpose_bits(unsigned x, int lane) {
#pragma unroll
  for (int j = 16; j >= 1; j >>= 1) {
    // the bit positions k with k & j == 0
    const unsigned m = j == 16 ? 0x0000ffffu : j == 8 ? 0x00ff00ffu : j == 4 ? 0x0f0f0f0fu
                     : j == 2 ? 0x33333333u : 0x55555555u;
    const unsigned y = __shfl_xor_sync(0xffffffffu, x, j);
    x = (lane & j) ? (x & ~m) | ((y & ~m) >> j) : (x & m) | ((y & m) << j);
  }
  return x;
}

__global__ void __launch_bounds__(kOnehotMaxWarps * 32)
probe_onehot_kernel(const int4* __restrict__ h, const float4* __restrict__ b,
                    float* __restrict__ o, int rows, int vecs_per_lane) {
  extern __shared__ double table[];  // [warp][lane][kOnehotPitch]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // the whole warp: no barrier follows but the warp's own
  double* p = table + warp * 32 * kOnehotPitch;
  double* mine = p + lane * kOnehotPitch;
  const long long v0 = (row * 32 + lane) * vecs_per_lane;  // this lane's first vector
  int run = -1;
  double acc = 0.0;
  unsigned touched = 0;
  for (int v = 0; v < vecs_per_lane; v += kOnehotVecs) {
    int4 hv[kOnehotVecs];
    float4 bv[kOnehotVecs];
#pragma unroll
    for (int j = 0; j < kOnehotVecs; ++j)
      if (v + j < vecs_per_lane) {
        hv[j] = h[v0 + v + j];
        bv[j] = b[v0 + v + j];
      }
#pragma unroll
    for (int j = 0; j < kOnehotVecs; ++j)
      if (v + j < vecs_per_lane) {
        onehot_add(mine, hv[j].x, bv[j].x, run, acc, touched);
        onehot_add(mine, hv[j].y, bv[j].y, run, acc, touched);
        onehot_add(mine, hv[j].z, bv[j].z, run, acc, touched);
        onehot_add(mine, hv[j].w, bv[j].w, run, acc, touched);
      }
  }
  if (run >= 0) mine[run] = acc;
  const unsigned lanes = transpose_bits(touched, lane);  // the lanes that touched bin ``lane``
  __syncwarp();  // every lane's entries written
  double s = 0.0;
  for (unsigned m = lanes; m; m &= m - 1) s += p[(__ffs(m) - 1) * kOnehotPitch + lane];
  o[row * kBins + lane] = static_cast<float>(s);
}

// --- 5, 6. tensor-core products: mma.sync m16n8k8 TF32 ---------------------

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

// d += A (16 x 8) * B (8 x 8); fragments in the PTX ISA's m16n8k8 .tf32
// layout: g = lane / 4, t = lane % 4; a = {A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, d = {D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --- 6. dot: operands on chip, K split across warps ------------------------
//
// What bounds it: 336 KB of operands and output (0.10 us at 3.35 TB/s) and
// 16.8 MFLOP TF32 (0.03 us at 495 TFLOP/s); in practice the launch, one
// round of loads, and the longest dependent chain.  The first design
// (deleted) gave each warp a 16 x 8 tile and all of K: 4 x 64 dependent
// mma.sync, each behind its own fragment loads from global memory, so four
// passes over the operands paid the load latency link by link (51-53 us).
//
// This design keeps the operands on chip, as the TPU kernel keeps them
// resident in VMEM across the fori_loop.  CTA c owns the 8 x 8 output
// tile (c / tiles_n, c % tiles_n): rows 8..15 of the m16n8k8 tile are zero
// (as in bdot), which halves the bytes each CTA stages (a's 8 rows and b's
// 8 columns, 32 KB at k = 512) and doubles the CTAs (64 at the script's
// shape).  Warp w owns the K slices (8 wide) [w * spw, (w + 1) * spw)
// (``warps`` and ``slices_per_warp`` from the wrapper's launch plan, spw
// <= kDotSlices).  Each warp stages its slices by 16-byte cp.async into
// shared memory ONCE (neighbouring lanes on neighbouring addresses), waits
// for its own copies, converts its fragments to TF32 into registers once,
// and runs the ``steps`` loop on the tensor cores over them, alternating
// two accumulators: at the script's shape 8 mma.sync per step in two
// chains of 4, with no load inside the loop.  The warps' partial tiles
// meet in shared memory and are summed in warp order (no atomics), so
// every launch gives the same bits.
//
// Shared memory (dynamic, its size and the row stride lda from the
// wrapper's launch plan, pallas_probe.dot_plan): sa [8][lda] floats, the
// tile's rows of a, padded (lda = k + 4 in the plan) so that a fragment
// read (rows g = 0..7, columns t = 0..3 at g * lda + t) hits 32 distinct
// banks (lda / 4 odd for k % 8 == 0); sb [k][8] floats, the tile's columns
// of b (lanes at t * 8 + g: distinct banks unpadded); part [warps][8 * 8],
// the partial tiles.  The launch bounds name one CTA per SM: without that
// minimum ptxas held the kernel to 64 registers and spilled; with it, 66
// and no spill.
//
// bdot runs this same body: batch i of (B, 8, K) @ (B, K, 8) is one 8 x 8
// output tile of an (8, K) @ (K, 8) product at steps = 1, so its grid is
// (1, B) and the grid's y index selects the batch through the strides
// batch_a, batch_b, batch_o (dot's grid has one row, y = 0).
constexpr int kDotMaxWarps = 16;  // the launch bounds
constexpr int kDotSlices = 8;     // most K slices per warp: their fragments stay in registers

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(kDotMaxWarps * 32, 1)
probe_dot_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ o, int k_dim, int n_dim, int steps, int slices_per_warp,
                 int lda, long long batch_a, long long batch_b, long long batch_o) {
  extern __shared__ __align__(16) float smem[];
  a += blockIdx.y * batch_a;
  b += blockIdx.y * batch_b;
  o += blockIdx.y * batch_o;
  float* sa = smem;
  float* sb = sa + 8 * lda;
  float* part = sb + 8 * k_dim;
  const int tiles_n = n_dim / 8;
  const int m0 = (blockIdx.x / tiles_n) * 8, n0 = (blockIdx.x % tiles_n) * 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slices = k_dim / 8;
  const int j0 = min(warp * slices_per_warp, slices);
  const int nj = min(slices_per_warp, slices - j0);
  const int k0 = 8 * j0, kw = 8 * nj;            // this warp's columns of a, rows of b

  // stage: a[m0 + r, k0 + c .. +4) for r < 8 (kw / 4 float4 per row), then
  // b[k0 + r, n0 + c .. +4) for r < kw (2 float4 per row)
  const int q = kw / 4;
  for (int i = lane; i < 8 * q; i += 32) {
    const int r = i / q, c = k0 + 4 * (i % q);
    cp_async16(sa + r * lda + c, a + static_cast<long long>(m0 + r) * k_dim + c);
  }
  for (int i = lane; i < 2 * kw; i += 32) {
    const int r = k0 + (i >> 1), c = 4 * (i & 1);
    cp_async16(sb + r * 8 + c, b + static_cast<long long>(r) * n_dim + n0 + c);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();                                  // the warp's copies, visible to all its lanes

  // slice j's fragments: a = {A[g][8j + t], 0, A[g][8j + t + 4], 0} (zero
  // rows 8..15), b = {B[8j + t][g], B[8j + t + 4][g]}
  const int g = lane >> 2, t = lane & 3;
  uint32_t fa[kDotSlices][4], fb[kDotSlices][2];
#pragma unroll
  for (int j = 0; j < kDotSlices; ++j) {
    const int kk = k0 + 8 * j;
    fa[j][1] = fa[j][3] = 0u;
    if (j < nj) {
      fa[j][0] = to_tf32(sa[g * lda + kk + t]);
      fa[j][2] = to_tf32(sa[g * lda + kk + t + 4]);
      fb[j][0] = to_tf32(sb[(kk + t) * 8 + g]);
      fb[j][1] = to_tf32(sb[(kk + t + 4) * 8 + g]);
    } else {
      fa[j][0] = fa[j][2] = fb[j][0] = fb[j][1] = 0u;
    }
  }
  float d[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int j = 0; j < kDotSlices; ++j)
      if (j < nj) mma_tf32(d[j & 1], fa[j], fb[j]);
  }

  // the partial tiles, [warp][row][col] (rows 0..7: d[.][0], d[.][1]), then
  // their sum in warp order
  float* p = part + warp * 64;
  *reinterpret_cast<float2*>(p + g * 8 + 2 * t) = make_float2(d[0][0] + d[1][0], d[0][1] + d[1][1]);
  __syncthreads();
  if (threadIdx.x < 64) {
    float v = part[threadIdx.x];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) v += part[w * 64 + threadIdx.x];
    o[static_cast<long long>(m0 + (threadIdx.x >> 3)) * n_dim + n0 + (threadIdx.x & 7)] = v;
  }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Every entry launches on ``stream`` and returns cudaGetLastError(); the
// wrappers in softgnss_tpu_torch/scripts/pallas_probe.py check shapes,
// types and devices first.

// x, o: (n_blocks * 8, 128) float32, 16-byte aligned
extern "C" int sg_probe_grid(const void* x, void* o, int n_blocks, void* stream) {
  probe_grid_kernel<<<n_blocks, kGridThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(o));
  return last_error();
}

// x: (64, 128) float32; o: (8,) float32; reps >= 1
extern "C" int sg_probe_acc(const void* x, void* o, int reps, void* stream) {
  probe_acc_kernel<<<kCluster, kAccThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), reps);
  return last_error();
}

// x: (n,) int32; o: (n,) float32; both 16-byte aligned; ``blocks`` CTAs
// of kConvThreads from the wrapper's launch plan (pallas_probe.conv_plan)
extern "C" int sg_probe_conv(const void* x, void* o, long long n, int blocks, void* stream) {
  if (n < 0 || blocks < 1 || !aligned16(x) || !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  probe_conv_kernel<<<blocks, kConvThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<float4*>(o), n);
  return last_error();
}

// The first conv design: x: (n,) int32; o: (n,) float32; any alignment
extern "C" int sg_probe_conv_loop(const void* x, void* o, long long n, void* stream) {
  const long long blocks = (n + 255) / 256;
  probe_conv_loop_kernel<<<static_cast<int>(blocks < 1024 ? blocks : 1024), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(static_cast<const int*>(x),
                                                                static_cast<float*>(o), n);
  return last_error();
}

// h: (rows, width) int32; b: (rows, width) float32; o: (rows, 32) float32;
// h and b 16-byte aligned; at the wrapper's launch plan
// (pallas_probe.onehot_plan): ``warps`` rows per CTA, ``vecs_per_lane``
// 16-byte vectors per lane (width = 128 * vecs_per_lane), ``smem`` bytes
// of dynamic shared memory.  Refuses a plan the kernel cannot run: no
// row, more warps than its launch bounds, a width it does not split into
// whole vectors per lane or that exceeds 1 024, less shared memory than
// the warps' tables take, or an unaligned input.
extern "C" int sg_probe_onehot(const void* h, const void* b, void* o, int rows, int width,
                               int warps, int vecs_per_lane, int smem, void* stream) {
  if (rows < 1 || warps < 1 || warps > kOnehotMaxWarps || vecs_per_lane < 1 ||
      vecs_per_lane > kOnehotMaxVecs || width != 128 * vecs_per_lane ||
      smem < warps * 32 * kOnehotPitch * static_cast<int>(sizeof(double)) || !aligned16(h) ||
      !aligned16(b))
    return static_cast<int>(cudaErrorInvalidValue);
  static int smem_limit = 48 * 1024;  // the kernel's dynamic shared memory limit, raised once
  if (smem > smem_limit) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_limit = smem;
  }
  probe_onehot_kernel<<<(rows + warps - 1) / warps, warps * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(h), static_cast<const float4*>(b), static_cast<float*>(o), rows,
      vecs_per_lane);
  return last_error();
}

namespace {

// probe_dot_kernel over a grid of (m/8 * n/8, batch) CTAs at the wrapper's
// launch plan (warps per CTA, K slices per warp, the row stride lda of sa,
// the bytes of dynamic shared memory); refuses a plan the kernel cannot
// run: a ragged or empty tile, more warps than its launch bounds, more
// slices per warp than its registers hold, K left uncovered, a stride that
// breaks 16-byte copies, less shared memory than the layout above takes,
// or a batch outside the grid's y range.
int launch_dot(const void* a, const void* b, void* o, int m_dim, int k_dim, int n_dim,
               int steps, int batch, int warps, int slices_per_warp, int lda, int smem,
               void* stream) {
  if (m_dim < 8 || m_dim % 8 || k_dim < 8 || k_dim % 8 || n_dim < 8 || n_dim % 8 ||
      warps < 1 || warps > kDotMaxWarps || slices_per_warp < 1 ||
      slices_per_warp > kDotSlices || 8 * warps * slices_per_warp < k_dim || lda < k_dim ||
      lda % 4 || smem < 4 * (8 * lda + 8 * k_dim + 64 * warps) || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(probe_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long m = m_dim, k = k_dim, n = n_dim;
  probe_dot_kernel<<<dim3((m_dim / 8) * (n_dim / 8), batch), warps * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(o), k_dim,
      n_dim, steps, slices_per_warp, lda, m * k, k * n, m * n);
  return last_error();
}

}  // namespace

// a: (batch, 8, k); b: (batch, k, 8); o: (batch, 8, 8) float32; a and b
// 16-byte aligned; probe_dot_kernel, one CTA per batch (steps = 1), at the
// wrapper's launch plan (pallas_probe.dot_plan(8, k, 8)), refused past the
// kernel's limits as sg_probe_dot
extern "C" int sg_probe_bdot(const void* a, const void* b, void* o, int batch, int k_dim,
                             int warps, int slices_per_warp, int lda, int smem, void* stream) {
  return launch_dot(a, b, o, 8, k_dim, 8, 1, batch, warps, slices_per_warp, lda, smem, stream);
}

// a: (m, k); b: (k, n); o: (m, n) float32 = steps * (a @ b); a and b
// 16-byte aligned; at the wrapper's launch plan (pallas_probe.dot_plan)
extern "C" int sg_probe_dot(const void* a, const void* b, void* o, int m_dim, int k_dim,
                            int n_dim, int steps, int warps, int slices_per_warp, int lda,
                            int smem, void* stream) {
  return launch_dot(a, b, o, m_dim, k_dim, n_dim, steps, 1, warps, slices_per_warp, lda, smem,
                    stream);
}
