// Table-stream variants of the batched block matvec, written for Hopper
// (sm_90a): how the table bytes are brought on chip is what varies.
// Counterpart of the Pallas kernels of the JAX package's two microbenchmark
// scripts:
//
//   nstt_block_mv_rows_f32  <- _mv_kernel via make_bmv
//                              (scripts/microbench_dma.py:92, call :101)
//   nstt_block_mv_mega_f32  <- kern of make_bmv_mega   (:179, call :190)
//   nstt_block_mv_ring_f32  <- kern of make_bmv_manual (:220, call :253)
//   nstt_block_mv_soa_f32   <- mv_kernel
//                              (scripts/microbench_apply2.py:123, call :129)
//
// (_mv_kernel_splitk_seq, microbench_dma.py:119, is nstt_block_mv_splitk_f32
// of block_mv.cu over consecutive-tile sub-tables.)
//
// The first three compute y[b, i] = sum_j A[b, i, j] x[b, j] on the natural
// (nblk, m, k) row-major f32 table, viewed as nblk * m output rows whose
// table rows are one contiguous stretch of memory; the last computes
// y[i, e] = sum_j A[i, j, e] u[j, e] on the structure-of-arrays table
// (nb, nb, ne) with the element index fastest.
//
// Bound: each reads its table once and does 2 flops per entry, so each is
// bound by device memory bandwidth: table bytes / 3.35 TB/s on an H100 SXM.
// What the design of each does about it:
//
//   rows   the CTA's row count R is an argument, from 1 up to what opt-in
//          shared memory holds (227 KB), one thread per row (a warp takes
//          a longer run of consecutive rows where R passes 1,024 threads).
//          Each warp stages and waits for its own rows (redesigned): lane
//          0 of warp w copies the warp's contiguous table stretch -- its
//          16-byte units by one bulk copy (cp.async.bulk), its at most
//          3 + 3 ragged head and tail floats by 4-byte cp.async -- onto the
//          warp's own mbarrier, and lane 0 of warp 0 the x of the touched
//          blocks the same way onto one more barrier.  Every warp issues
//          before it waits, and waits only on its own barrier and x's, so
//          at large R the CTA's arithmetic overlaps its own later copies.
//          The tile lands at row stride k shifted by (a + r0 k) mod 16
//          bytes, so that each copy's source and destination are aligned
//          alike; where k and the shifts are even a row is read in 8-byte
//          pairs, which at k = 54 (27 pairs: an odd stride) hit distinct
//          bank pairs across each half-warp.  The earlier design, per-
//          thread 16-byte loads scattered into an odd-stride tile behind
//          one __syncthreads, never overlapped a CTA's copy with its
//          arithmetic.  Measured (tools/sweep_redesign.py, 7740 x 54 x 54;
//          NVIDIA H100 80GB HBM3, 700 W): rows 64 / 192 / 432 / 864 took
//          0.0444 / 0.0451 / 0.0446 / 0.0479 ms (0.58-0.63 of the 0.0279
//          ms bound), the earlier design in the same call 0.0556 / 0.0574
//          / 0.0602 / 0.0624, torch.bmm 0.0601, mega at 64 rows 0.0447.
//          At 864 rows (190,548 bytes) one CTA fills an SM, and its tail
//          idles the SM until the next CTA's first rows land.
//   mega   one CTA takes its whole stretch with ONE 1-D bulk asynchronous
//          copy (cp.async.bulk, completing on an mbarrier), started by one
//          thread: the copy engine computes the addresses, no thread spends
//          registers or cycles on the copy.  The rows land at stride
//          k (a 2-way bank conflict for k = 54 with one thread per row).
//          The x of the touched blocks is staged by all threads with plain
//          loads, in flight beside the bulk copy.
//   ring   a producer/consumer ring (redesigned): a persistent grid, as many
//          CTAs per SM as fit, each walking its tiles through nbuf
//          shared-memory stages.  One producer warp, whose one lane keeps
//          up to nbuf stages in flight: each stage is one bulk copy of the
//          table stretch and one of the aligned middle of its x (the at
//          most 3 + 3 ragged x floats, and the table's last at most 3, by
//          4-byte cp.async whose completion is the stage's one arrival),
//          announced on the stage's full mbarrier.  G consumer groups of one thread per row (G the largest
//          divisor of nbuf up to nbuf / 2) take the stages in turn and
//          arrive, one arrival per warp, on the stage's empty mbarrier when
//          done, which is what the producer waits on before refilling it:
//          no consumer thread waits on a global load or on a CTA-wide
//          barrier.  What bounds it: the table bytes, if enough copies are
//          in flight per SM and enough consumer warps keep up with them.
//          Warps per SM at k = m = 54 (stage 14,496 bytes at 64 rows,
//          28,528 at 128; CTAs per SM from 228 KB less 1 KB per CTA),
//          producer + consumer: nbuf 2 / 4 / 8 at 64 rows 7 + 14 / 3 + 12
//          / 1 + 8, at 128 rows 4 + 16 / 2 + 16 / 1 + 16 (the earlier
//          design, one thread per row and every thread refilling x with
//          plain loads behind a per-stage __syncthreads, had 2 to 16).
//          Measured (tools/sweep_redesign.py, 7740 x 54 x 54; NVIDIA H100
//          80GB HBM3, 700 W): nbuf 2 / 4 / 8 took 0.0473 / 0.0472 /
//          0.0458 ms at 64 rows and 0.0468 / 0.0479 / 0.0482 at 128
//          (0.58-0.61 of the 0.0279 ms bound), the earlier design in the
//          same call 0.0524 / 0.0608 / 0.1393 and 0.0492 / 0.0544 /
//          0.0788, torch.bmm 0.0606, mega 0.0451.  With the ragged floats
//          by plain loads in the producer lane, nbuf 8 at 64 rows (one CTA
//          per SM) took 0.0595: one load round trip per 14.5 KB stage
//          held the stream; by cp.async it no longer waits.
//   soa    tensor-map tiles through a producer/consumer ring (redesigned):
//          the host encodes A2 as a 3-D tensor (ne, nb, nb) with a box of
//          kSoaE elements x all nb columns j x kSoaRi rows i, and u as a
//          2-D tensor (ne, nb) with a box of kSoaE x nb (no swizzle, boxes
//          past the edges zero-filled; the global strides must be 16-byte
//          multiples, so ne % 4 == 0).  A persistent grid splits the
//          (element tile, row chunk) items into one consecutive run per
//          CTA.  One producer lane keeps kSoaStages table boxes in flight
//          by cp.async.bulk.tensor (full / empty mbarriers per stage) and
//          loads each element tile's u box once, into one of two slots
//          with full / empty barriers of their own.  Consumer threads take
//          one output (i, e) each, e on the lanes: for each j in order one
//          fmaf of A[i][j][e] and u[j][e] from shared memory (conflict-
//          free; u broadcast across i), and a coalesced store masked at
//          e < ne.  The earlier design, one thread per element with every
//          entry a 4-byte load and u re-read per row chunk, issued one
//          128-byte load per warp instruction.  Measured (tools/
//          sweep_redesign.py, 54 x 54 x 7936; NVIDIA H100 80GB HBM3, 700
//          W): 0.0468-0.0644 ms over kSoaE 32 / 64 / 128, kSoaRi 1 / 2 / 4
//          and kSoaStages 2 / 3 / 4, the earlier design in the same call
//          0.0708, torch.bmm on the permuted views 0.2726.  The smaller a
//          CTA's shared memory, the more CTAs per SM and the faster: 64 x
//          1 x 2 (55.5 KB, 4 CTAs per SM) took 0.0470, 128 x 1 x 2 0.0468,
//          64 x 2 x 3 0.0486; 64 x 1 x 2 is kept, which still fits 3 CTAs
//          per SM at nb = 64.
//
// Every kernel sums a row in column order with one fmaf per entry, the
// accumulation order of block_mv: on the same table the results are bitwise
// equal to block_mv's.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() (or cudaErrorInvalidValue for shapes it does
// not take) so that the caller can raise on a refused launch.

#include <cuda.h>  // CUtensorMap and its enums (libcuda is not linked)
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemOptIn = 232448;  // 227 KB per CTA after opt-in
constexpr int kHeader = 128;        // mbarriers ahead of the stages
constexpr int kMaxStages = 8;
constexpr int kRowsDefault = 64;  // rows = 0: block_mv.cu's kMvRows
constexpr int kSoaMaxNb = 64;     // the j loop is unrolled to it
// block_mv_soa's tile: kSoaE elements (a multiple of 32: whole warps, and
// 128-byte aligned boxes) x all nb columns x kSoaRi rows per stage,
// kSoaStages stages per CTA
constexpr int kSoaE = 64;
constexpr int kSoaRi = 1;
constexpr int kSoaStages = 2;
static_assert(kSoaE % 32 == 0 && kSoaE <= 256, "kSoaE: whole warps");
static_assert(kSoaRi >= 1 && 32 + kSoaE * kSoaRi <= kMaxThreads,
              "kSoaRi: the CTA's threads");
static_assert(kSoaStages >= 1 && (2 * kSoaStages + 4) * 8 <= kHeader,
              "kSoaStages: the header's mbarriers");

// -- bulk asynchronous copies (mega, ring; helpers in bulk_copy.cuh) -------------

// The rows [r0, r1) of the table and the blocks of x they touch.
struct Stretch {
  long long r0;  // first output row
  int nrows;     // rows in the stretch
  long long b0;  // first block touched
  int nx;        // x entries of the touched blocks
  int off0;      // r0 - b0 * m: row of r0 inside its block
};

__device__ __forceinline__ Stretch stretch_of(long long t, int R,
                                              long long nrows_all, int m,
                                              int k) {
  Stretch s;
  s.r0 = t * R;
  long long r1 = s.r0 + R;
  if (r1 > nrows_all) r1 = nrows_all;
  s.nrows = static_cast<int>(r1 - s.r0);
  s.b0 = s.r0 / m;
  s.nx = static_cast<int>((r1 - 1) / m - s.b0 + 1) * k;
  s.off0 = static_cast<int>(s.r0 - s.b0 * m);
  return s;
}

// Called by EVERY thread of the CTA: fill one stage (tab: the stretch's
// table rows at row stride k, xs: its x entries) and arrive on the stage's
// barrier, whose arrival count is blockDim.x.  Thread 0 starts ONE bulk
// asynchronous copy for the whole 16-byte units of the table stretch (src
// is 16-byte aligned) and stores the at most three floats after them (only
// the last stretch of a table has any); every thread copies its share of x
// with plain loads, which are in flight beside the bulk copy.  Each
// thread's arrival releases its stores; the phase completes when all have
// arrived and the copy's bytes have landed.
__device__ __forceinline__ void fill_stage(float* tab, float* xs,
                                           const float* __restrict__ a,
                                           const float* __restrict__ x,
                                           const Stretch& s, int k,
                                           uint64_t* bar) {
  if (threadIdx.x == 0) {
    const float* src = a + s.r0 * k;
    const int count = s.nrows * k, whole = count & ~3;
    if (whole) {
      mbar_expect_tx(bar, static_cast<uint32_t>(whole) * 4u);
      bulk_copy(tab, src, static_cast<uint32_t>(whole) * 4u, bar);
    }
    for (int c = whole; c < count; ++c) tab[c] = __ldg(src + c);
  }
  const float* xsrc = x + s.b0 * k;
  for (int e = threadIdx.x; e < s.nx; e += blockDim.x) xs[e] = __ldg(xsrc + e);
  mbar_arrive(bar);
}

// The rows of one filled stage, row t, t + nt, ... for thread t of nt:
// one thread per row, everything from shared memory.
__device__ __forceinline__ void rows_from_stage(const float* __restrict__ tab,
                                                const float* __restrict__ xs,
                                                float* __restrict__ y,
                                                const Stretch& s, int m, int k,
                                                int t, int nt) {
  for (int rr = t; rr < s.nrows; rr += nt) {
    const float* ar = tab + rr * k;
    const float* xb = xs + ((s.off0 + rr) / m) * k;
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) acc = fmaf(ar[j], xb[j], acc);
    y[s.r0 + rr] = acc;
  }
}

// One CTA, one stretch of R rows, ONE bulk copy.
__global__ void __launch_bounds__(kMaxThreads)
    block_mv_mega_kernel(const float* __restrict__ a,
                         const float* __restrict__ x, float* __restrict__ y,
                         long long nrows_all, int m, int k, int R) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* tab = reinterpret_cast<float*>(smem_raw + kHeader);
  float* xs = tab + static_cast<long long>(R) * k;
  const Stretch s = stretch_of(blockIdx.x, R, nrows_all, m, k);
  if (threadIdx.x == 0) {
    mbar_init(bar, blockDim.x);
    mbar_init_fence();
  }
  __syncthreads();
  fill_stage(tab, xs, a, x, s, k, bar);
  mbar_wait(bar, 0);
  rows_from_stage(tab, xs, y, s, m, k, threadIdx.x, blockDim.x);
}

// The ring.  A persistent CTA walks the tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... of R rows each; its i-th tile goes through stage i % nbuf.
// Warp 0 is the producer: its lane 0 fills the stages in order.  The other
// warps are G consumer groups of gw warps each (G divides nbuf); group g
// takes the tiles i = g, g + G, ..., so a stage always goes to the same
// group, which consumes its fills in order.  Two mbarriers per stage:
//   full[s]   one arrival (the producer's, when its 4-byte copies have
//             landed) plus the bytes of the fill's bulk copies; the f-th
//             fill of stage s is its phase f;
//   empty[s]  one arrival per warp of the consuming group when it is done
//             reading the stage; the producer waits on phase f - 1 before
//             the f-th fill.
// Each wait is on the phase that is next to complete or has just completed
// (a stage is never refilled before its consumers are done, and they take
// its fills in order), so the parity of the phase names it.

// Shared memory of one ring stage, in floats: R table rows at stride k, and
// the x of the blocks they touch with 4 floats of room to shift it (see
// ring_fill), rounded up to 16 bytes so that every stage starts aligned.
inline __host__ __device__ long long ring_stage_floats(int R, int m, int k) {
  const long long xfloats = static_cast<long long>((R - 1) / m + 2) * k + 4;
  return static_cast<long long>(R) * k + (xfloats + 3) / 4 * 4;
}

// Where x entry 0 of the stretch lies in the stage's x area: as far past
// the area's (16-byte aligned) start as src lies past a 16-byte boundary,
// so that the bulk copy of the aligned middle lands aligned.
__device__ __forceinline__ int ring_x_shift(const float* src) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15) / 4;
}

// 4-byte asynchronous copy global -> shared (cp.async): the producer does
// not wait for it.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// The barrier's arrival, made when every cp.async this thread started has
// landed (.noinc: it is one of the arrivals the barrier counts).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// Producer lane: fill one stage with stretch s -- the table stretch's whole
// 16-byte units (src 16-byte aligned) by one bulk copy, the aligned middle
// of its x by another, both announced on full first; the at most 3 ragged
// table floats and the ragged head and tail of x by 4-byte cp.async; the
// stage's one arrival when those have landed.  Nothing here waits on a
// global load.
__device__ __forceinline__ void ring_fill(float* tab, float* xarea,
                                          const float* __restrict__ a,
                                          const float* __restrict__ x,
                                          const Stretch& s, int k,
                                          uint64_t* full) {
  const float* src = a + s.r0 * k;
  const int count = s.nrows * k, whole = count & ~3;
  const float* xsrc = x + s.b0 * k;
  float* xs = xarea + ring_x_shift(xsrc);
  int head = (4 - ring_x_shift(xsrc)) & 3;
  if (head > s.nx) head = s.nx;
  const int xwhole = (s.nx - head) & ~3;
  const uint32_t bytes = 4u * static_cast<uint32_t>(whole + xwhole);
  if (bytes) mbar_expect_tx(full, bytes);
  if (whole) bulk_copy(tab, src, 4u * whole, full);
  if (xwhole) bulk_copy(xs + head, xsrc + head, 4u * xwhole, full);
  for (int c = whole; c < count; ++c) cp_async4(tab + c, src + c);
  for (int e = 0; e < head; ++e) cp_async4(xs + e, xsrc + e);
  for (int e = head + xwhole; e < s.nx; ++e) cp_async4(xs + e, xsrc + e);
  cp_async_arrive(full);
}

__global__ void __launch_bounds__(kMaxThreads)
    block_mv_ring_kernel(const float* __restrict__ a,
                         const float* __restrict__ x, float* __restrict__ y,
                         long long nrows_all, int m, int k, int R, int nbuf,
                         int groups, long long ntiles) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kMaxStages;
  float* stages = reinterpret_cast<float*>(smem_raw + kHeader);
  const long long sfl = ring_stage_floats(R, m, k);
  const long long tfl = static_cast<long long>(R) * k;
  const int warp = threadIdx.x / 32;
  const int gw = (blockDim.x / 32 - 1) / groups;  // warps per group
  const long long first = blockIdx.x, step = gridDim.x;
  const long long mine = (ntiles - first + step - 1) / step;
  if (threadIdx.x == 0) {
    for (int s = 0; s < nbuf; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, gw);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == 0) {
    if (threadIdx.x == 0) {
      for (long long i = 0; i < mine; ++i) {
        const int s = static_cast<int>(i % nbuf);
        const long long f = i / nbuf;  // the stage's fill number
        if (f > 0) mbar_wait(empty + s, static_cast<uint32_t>((f - 1) & 1));
        ring_fill(stages + s * sfl, stages + s * sfl + tfl, a, x,
                  stretch_of(first + i * step, R, nrows_all, m, k), k,
                  full + s);
      }
    }
    return;
  }
  const int g = (warp - 1) / gw;
  const int t = threadIdx.x - 32 - g * gw * 32;
  for (long long i = g; i < mine; i += groups) {
    const int s = static_cast<int>(i % nbuf);
    const Stretch st = stretch_of(first + i * step, R, nrows_all, m, k);
    const float* tab = stages + s * sfl;
    mbar_wait(full + s, static_cast<uint32_t>((i / nbuf) & 1));
    rows_from_stage(tab, tab + tfl + ring_x_shift(x + st.b0 * k), y, st, m,
                    k, t, gw * 32);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + s);
  }
}


// -- staged by warp (rows) ---------------------------------------------------------

// Shared memory of one rows CTA, in bytes: the header (one mbarrier per warp
// and one for x, rounded up to 16 bytes), the tile (R rows at stride k and
// up to 3 floats of shift, rounded up to 16 bytes) and the x of the blocks
// the rows touch (up to 3 floats of shift).  ops/stream_mv.py's
// rows_smem_bytes is the same sum.
inline __host__ __device__ int rows_warps(int R) {
  const int w = (R + 31) / 32;
  return w < kMaxThreads / 32 ? w : kMaxThreads / 32;
}
inline __host__ __device__ int rows_header(int R) {
  return (8 * (rows_warps(R) + 1) + 15) / 16 * 16;
}
inline __host__ __device__ long long rows_tile_floats(int R, int k) {
  return (static_cast<long long>(R) * k + 3 + 3) / 4 * 4;
}
inline __host__ __device__ long long rows_cta_smem(int R, int m, int k) {
  const long long xfloats = static_cast<long long>((R - 1) / m + 2) * k + 3;
  return rows_header(R) + 4 * (rows_tile_floats(R, k) + xfloats);
}

// Lane-0 copy of count floats src -> dst (src and dst congruent modulo 16
// bytes): the whole 16-byte units by one bulk copy announced on bar, the
// ragged head and tail by 4-byte cp.async, and bar's one arrival when those
// have landed.  Nothing here waits.
__device__ __forceinline__ void copy_span(float* dst, const float* src,
                                          int count, uint64_t* bar) {
  int head = ring_x_shift(src) ? 4 - ring_x_shift(src) : 0;
  if (head > count) head = count;
  const int whole = (count - head) & ~3;
  if (whole) {
    mbar_expect_tx(bar, 4u * static_cast<uint32_t>(whole));
    bulk_copy(dst + head, src + head, 4u * static_cast<uint32_t>(whole), bar);
  }
  for (int c = 0; c < head; ++c) cp_async4(dst + c, src + c);
  for (int c = head + whole; c < count; ++c) cp_async4(dst + c, src + c);
  cp_async_arrive(bar);
}

// One row's dot product in column order, one fmaf per entry (block_mv's
// order); kPairs: ar and xb 8-byte aligned and k even, read as pairs.
template <bool kPairs>
__device__ __forceinline__ float row_dot(const float* __restrict__ ar,
                                         const float* __restrict__ xb,
                                         int k) {
  float acc = 0.0f;
  if (kPairs) {
    const float2* a2 = reinterpret_cast<const float2*>(ar);
    const float2* x2 = reinterpret_cast<const float2*>(xb);
#pragma unroll 3
    for (int j = 0; j < k / 2; ++j) {
      const float2 av = a2[j], xv = x2[j];
      acc = fmaf(av.x, xv.x, acc);
      acc = fmaf(av.y, xv.y, acc);
    }
  } else {
    for (int j = 0; j < k; ++j) acc = fmaf(ar[j], xb[j], acc);
  }
  return acc;
}

// y[r] = sum_j a[r, j] * x[r / m, j] for the R rows from blockIdx.x * R.
// Warp w owns the rpw consecutive rows from w * rpw (rpw = 32 up to 1,024
// rows per CTA), lane l the rows l, l + 32, ... of them.
__global__ void __launch_bounds__(kMaxThreads)
    block_mv_rows_kernel(const float* __restrict__ a,
                         const float* __restrict__ x, float* __restrict__ y,
                         long long nrows_all, int m, int k, int R) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nw = blockDim.x / 32;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);  // warps, then x
  float* tile = reinterpret_cast<float*>(smem_raw + rows_header(R));
  float* xarea = tile + rows_tile_floats(R, k);
  const Stretch s = stretch_of(blockIdx.x, R, nrows_all, m, k);
  const float* src = a + s.r0 * k;
  const float* xsrc = x + s.b0 * k;
  float* tab = tile + ring_x_shift(src);
  float* xs = xarea + ring_x_shift(xsrc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rpw = 32 * ((R + 32 * nw - 1) / (32 * nw));
  const int w0 = warp * rpw;
  const int w1 = w0 + rpw < s.nrows ? w0 + rpw : s.nrows;
  if (threadIdx.x == 0) {
    for (int w = 0; w <= nw; ++w) mbar_init(bars + w, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (lane == 0) {
    if (warp == 0) copy_span(xs, xsrc, s.nx, bars + nw);
    if (w1 > w0)
      copy_span(tab + w0 * k, src + static_cast<long long>(w0) * k,
                (w1 - w0) * k, bars + warp);
  }
  if (w1 <= w0) return;
  mbar_wait(bars + nw, 0);
  mbar_wait(bars + warp, 0);
  const bool pairs =
      !(k & 1) && !(ring_x_shift(src) & 1) && !(ring_x_shift(xsrc) & 1);
  for (int rr = w0 + lane; rr < w1; rr += 32) {
    const float* ar = tab + rr * k;
    const float* xb = xs + ((s.off0 + rr) / m) * k;
    y[s.r0 + rr] = pairs ? row_dot<true>(ar, xb, k) : row_dot<false>(ar, xb, k);
  }
}

// -- structure of arrays: tensor-map tiles through a ring ---------------------------

// cuTensorMapEncodeTiled's type (cuda.h, CUDA 12).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the runtime, so that the library
// links without -lcuda; null where it cannot be found.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// One arrival that also announces the bytes the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Tensor copies global -> shared of one box at the given coordinates
// (innermost first), completing on the mbarrier.
__device__ __forceinline__ void tensor_copy_2d(void* dst, const CUtensorMap* map,
                                               int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tensor_copy_3d(void* dst, const CUtensorMap* map,
                                               int c0, int c1, int c2,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// Shared memory of one SoA CTA, in bytes: 128 of room to align the start,
// the header, kSoaStages table boxes and two u boxes.
inline long long soa_smem(int nb) {
  return 128 + kHeader + 4LL * kSoaE * nb * (kSoaStages * kSoaRi + 2);
}

// The items are (element tile, row chunk) pairs, tile-major; CTA b takes
// the consecutive run [items b / G, items (b + 1) / G) of the G CTAs.
// Warp 0 is the producer: its lane 0 fills stage q % kSoaStages with item q's
// table box and, where item q starts a new element tile (the CTA's v-th),
// u slot v % 2 with the tile's u box first.  Barriers (phases named by
// parity as in the ring kernel): full[s] / ufull[v] one arrival (the
// producer's, announcing the box's bytes); empty[s] / uempty[v] one arrival
// per consumer warp when done with the stage or with the tile's last item.
__global__ void __launch_bounds__(32 + kSoaE * kSoaRi)
    block_mv_soa_kernel(const __grid_constant__ CUtensorMap tm_a,
                        const __grid_constant__ CUtensorMap tm_u,
                        float* __restrict__ y, int nb, long long ne,
                        long long items) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + kSoaStages;
  uint64_t* ufull = empty + kSoaStages;
  uint64_t* uempty = ufull + 2;
  float* stages = reinterpret_cast<float*>(base + kHeader);
  const int sfl = kSoaE * nb * kSoaRi;  // floats of one table box
  const int ufl = kSoaE * nb;           // floats of one u box
  float* uslots = stages + kSoaStages * sfl;
  const int nchunks = (nb + kSoaRi - 1) / kSoaRi;
  const long long q0 = items * blockIdx.x / gridDim.x;
  const long long q1 = items * (blockIdx.x + 1) / gridDim.x;
  constexpr int kWarps = kSoaE * kSoaRi / 32;  // consumer warps
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSoaStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWarps);
    }
    for (int v = 0; v < 2; ++v) {
      mbar_init(ufull + v, 1);
      mbar_init(uempty + v, kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      int v = -1;
      for (long long q = q0; q < q1; ++q) {
        const int tile = static_cast<int>(q / nchunks);
        const int chunk = static_cast<int>(q % nchunks);
        if (v < 0 || q % nchunks == 0) {  // a new element tile
          ++v;
          if (v >= 2) mbar_wait(uempty + (v & 1), ((v >> 1) - 1) & 1);
          mbar_arrive_expect_tx(ufull + (v & 1), 4u * ufl);
          tensor_copy_2d(uslots + (v & 1) * ufl, &tm_u, tile * kSoaE, 0,
                         ufull + (v & 1));
        }
        const long long i = q - q0;
        const int s = static_cast<int>(i % kSoaStages);
        const long long f = i / kSoaStages;  // the stage's fill number
        if (f > 0) mbar_wait(empty + s, static_cast<uint32_t>((f - 1) & 1));
        mbar_arrive_expect_tx(full + s, 4u * sfl);
        tensor_copy_3d(stages + s * sfl, &tm_a, tile * kSoaE, 0,
                       chunk * kSoaRi, full + s);
      }
    }
    return;
  }
  const int t = threadIdx.x - 32, lane = threadIdx.x % 32;
  const int e = t % kSoaE, il = t / kSoaE;
  int v = -1;
  for (long long q = q0; q < q1; ++q) {
    const int tile = static_cast<int>(q / nchunks);
    const int chunk = static_cast<int>(q % nchunks);
    if (v < 0 || chunk == 0) {
      ++v;
      mbar_wait(ufull + (v & 1), static_cast<uint32_t>((v >> 1) & 1));
    }
    const long long i = q - q0;
    const int s = static_cast<int>(i % kSoaStages);
    mbar_wait(full + s, static_cast<uint32_t>((i / kSoaStages) & 1));
    const float* ar = stages + s * sfl + il * nb * kSoaE + e;
    const float* ur = uslots + (v & 1) * ufl + e;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kSoaMaxNb; ++j)
      if (j < nb) acc = fmaf(ar[j * kSoaE], ur[j * kSoaE], acc);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(empty + s);
      if (q + 1 == q1 || chunk + 1 == nchunks) mbar_arrive(uempty + (v & 1));
    }
    const int row = chunk * kSoaRi + il;
    const long long col = static_cast<long long>(tile) * kSoaE + e;
    if (row < nb && col < ne) y[row * ne + col] = acc;
  }
}

// -- host side -------------------------------------------------------------------

inline bool bad_shape(long long nblk, int m, int k) {
  return nblk < 0 || m <= 0 || k <= 0;
}

inline int round32(long long n) { return static_cast<int>((n + 31) / 32 * 32); }

int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

// Shared memory of R table rows at stride ks and the x of the blocks they
// touch: one stage of mega (ks = k).
inline long long rows_smem(int R, int m, int k, int ks) {
  const long long xblocks = (R - 1) / m + 2;
  return 4LL * (static_cast<long long>(R) * ks + xblocks * k);
}

// A tiled f32 tensor map of the given rank (dims and box innermost first,
// strides in bytes of dims 1..rank-1), no swizzle, boxes past the edges
// zero-filled.
bool encode_f32(CUtensorMap* map, const float* base, cuuint32_t rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  const EncodeTiledFn enc = encode_tiled();
  const cuuint32_t ones[3] = {1, 1, 1};
  return enc && enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                    const_cast<float*>(base), dims, strides, box, ones,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// rows = 0: kRowsDefault, block_mv's choice.  Any a and x (4-byte aligned).
int nstt_block_mv_rows_f32(const float* a, const float* x, float* y,
                           long long nblk, int m, int k, int rows,
                           void* stream) {
  if (bad_shape(nblk, m, k) || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nrows = nblk * m;
  if (nrows == 0) return 0;
  const int R = rows ? rows : kRowsDefault;
  const long long smem = rows_cta_smem(R, m, k);
  if (smem > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      block_mv_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptIn);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const unsigned int grid = static_cast<unsigned int>((nrows + R - 1) / R);
  block_mv_rows_kernel<<<grid, 32 * rows_warps(R), static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
      a, x, y, nrows, m, k, R);
  return static_cast<int>(cudaGetLastError());
}

// rows: the rows of one CTA's stretch (the caller's k tiles together).  The
// stretch starts must be 16-byte aligned: a is, and rows * k is a multiple
// of 4.
int nstt_block_mv_mega_f32(const float* a, const float* x, float* y,
                           long long nblk, int m, int k, int rows,
                           void* stream) {
  if (bad_shape(nblk, m, k) || rows < 1 ||
      (static_cast<long long>(rows) * k) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nrows = nblk * m;
  if (nrows == 0) return 0;
  const long long smem = kHeader + rows_smem(rows, m, k, k);
  if (smem > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      block_mv_mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptIn);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int threads = rows < kMaxThreads ? round32(rows) : kMaxThreads;
  const unsigned int grid =
      static_cast<unsigned int>((nrows + rows - 1) / rows);
  block_mv_mega_kernel<<<grid, threads, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(a, x, y, nrows,
                                                              m, k, rows);
  return static_cast<int>(cudaGetLastError());
}

// rows: the rows of one stage (rows * k a multiple of 4, a 16-byte
// aligned); nbuf stages per CTA.  The consumer groups: the largest divisor
// of nbuf up to nbuf / 2 (at least 1), each of round32(rows) threads, fewer
// where the CTA would pass kMaxThreads (a thread then takes several rows).
// As many persistent CTAs per SM as shared memory, threads and registers
// allow, and no more CTAs than tiles.
int nstt_block_mv_ring_f32(const float* a, const float* x, float* y,
                           long long nblk, int m, int k, int rows, int nbuf,
                           void* stream) {
  if (bad_shape(nblk, m, k) || rows < 1 || nbuf < 1 || nbuf > kMaxStages ||
      (static_cast<long long>(rows) * k) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nrows = nblk * m;
  if (nrows == 0) return 0;
  const long long smem = kHeader + 4 * nbuf * ring_stage_floats(rows, m, k);
  if (smem > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      block_mv_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptIn);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  int groups = nbuf / 2 > 1 ? nbuf / 2 : 1;
  while (nbuf % groups) --groups;
  int gw = round32(rows) / 32;  // warps per group
  const int gw_max = (kMaxThreads / 32 - 1) / groups;
  if (gw > gw_max) gw = gw_max;
  const int threads = 32 * (1 + groups * gw);
  int per_sm = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, block_mv_ring_kernel, threads, static_cast<size_t>(smem));
  if (occ != cudaSuccess) return static_cast<int>(occ);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long ntiles = (nrows + rows - 1) / rows;
  long long grid = static_cast<long long>(per_sm) * sm_count();
  if (grid > ntiles) grid = ntiles;
  block_mv_ring_kernel<<<static_cast<unsigned int>(grid), threads,
                         static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
      a, x, y, nrows, m, k, rows, nbuf, groups, ntiles);
  return static_cast<int>(cudaGetLastError());
}


// a2 (nb, nb, ne), u (nb, ne) -> y (nb, ne), nb <= kSoaMaxNb; ne % 4 == 0
// and a2, u 16-byte aligned (the tensor maps' rule).  As many persistent
// CTAs per SM as fit, and no more CTAs than items.
int nstt_block_mv_soa_f32(const float* a2, const float* u, float* y, int nb,
                          long long ne, void* stream) {
  if (nb <= 0 || nb > kSoaMaxNb || ne < 0 || ne % 4 != 0 ||
      ne > 0x7fffffffLL || reinterpret_cast<uintptr_t>(a2) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(u) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ne == 0) return 0;
  const long long smem = soa_smem(nb);
  if (smem > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_a, tm_u;
  const cuuint64_t dims_a[3] = {static_cast<cuuint64_t>(ne),
                                static_cast<cuuint64_t>(nb),
                                static_cast<cuuint64_t>(nb)};
  const cuuint64_t strides_a[2] = {4ull * ne, 4ull * nb * ne};
  const cuuint32_t box_a[3] = {kSoaE, static_cast<cuuint32_t>(nb), kSoaRi};
  const cuuint32_t box_u[2] = {kSoaE, static_cast<cuuint32_t>(nb)};
  // u (ne, nb): the first two dims and the first stride of a2's
  if (!encode_f32(&tm_a, a2, 3, dims_a, strides_a, box_a) ||
      !encode_f32(&tm_u, u, 2, dims_a, strides_a, box_u))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      block_mv_soa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptIn);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int threads = 32 + kSoaE * kSoaRi;
  int per_sm = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, block_mv_soa_kernel, threads, static_cast<size_t>(smem));
  if (occ != cudaSuccess) return static_cast<int>(occ);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long items =
      (ne + kSoaE - 1) / kSoaE * ((nb + kSoaRi - 1) / kSoaRi);
  long long grid = static_cast<long long>(per_sm) * sm_count();
  if (grid > items) grid = items;
  block_mv_soa_kernel<<<static_cast<unsigned int>(grid), threads,
                        static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(tm_a, tm_u, y, nb,
                                                             ne, items);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
