// Batched dense block matvecs of the flagship solve, written for Hopper
// (sm_90a).  Counterpart of the Pallas kernels in
// navier_stokes_tpu/ops/pallas_mv.py:
//
//   nstt_block_mv_{f32,bf16}      <- _mv_kernel      (pallas_mv.py:118)
//   nstt_block_mv_seg_{f32,bf16}  <- _mv_kernel on the GS solve tables
//   nstt_block_mv2_f32            <- _mv2_kernel     (pallas_mv.py:124)
//   nstt_block_mv_ds_f32          <- _mv_ds_kernel   (pallas_mv.py:129)
//   nstt_block_mv_comp_f32        <- _mv_comp_kernel (pallas_mv.py:166)
//
// Each computes y[b, i] = sum_j A[b, i, j] x[b, j] for a batch of small dense
// blocks.  Layout: tables (nblk, m, k) row-major and contiguous, vectors
// (nblk, k) in and (nblk, m) out -- the natural array-of-structures layout,
// not the TPU's tile-packed (ntile, m, k, TILE) lane layout.
//
// Bound: every kernel reads its table(s) once and does 2 flops per table
// element (3 for kernel 3's three chains, about 15 for the compensated
// kernel), far below the card's f32 rate for the bytes moved, so each is
// bound by device memory bandwidth: table bytes / 3.35 TB/s on an H100 SXM.
//
// Kernels 1 to 4 are the split-k kernel (section below) at one sub-table:
// each CTA's table stretches reach shared memory by bulk asynchronous copies
// (bulk_copy.cuh), bf16 as stored, x is staged beside them, and one thread
// computes one output row in column order, f32 accumulation.  The segment
// entry is kernel 1 over the ragged blocks of a GS solve table (its section
// below).
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() (or cudaErrorInvalidValue for shapes it does
// not take) so that the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "bulk_copy.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSmemOptIn = 232448;  // 227 KB per CTA after opt-in
constexpr int kHeader = 128;        // the mbarrier ahead of the stretches

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// widen the 16 bytes in w to 4 (f32) or 8 (bf16) floats
template <typename T>
__device__ __forceinline__ void unpack(uint4 w, float* out) {
  const unsigned int u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (sizeof(T) == 4) {
      out[q] = __uint_as_float(u[q]);
    } else {  // bf16, little endian: element 2q in the low half
      out[2 * q] = __uint_as_float(u[q] << 16);
      out[2 * q + 1] = __uint_as_float(u[q] & 0xffff0000u);
    }
  }
}

// -- split-k kernels ----------------------------------------------------------
//
//   nstt_block_mv_splitk_{f32,bf16}  <- _mv_kernel_splitk      (:305)
//   nstt_block_mv2_splitk_f32        <- _mv2_kernel_splitk     (:358)
//   nstt_block_mv_comp_splitk_f32    <- _mv_comp_kernel_splitk (:397)
//
// and, as the same kernel at ONE sub-table (the table itself, one tile of
// nblk blocks, every row real),
//
//   nstt_block_mv_{f32,bf16}         <- _mv_kernel             (:118)
//   nstt_block_mv2_f32               <- _mv2_kernel            (:124)
//   nstt_block_mv_ds_f32             <- _mv_ds_kernel          (:129)
//   nstt_block_mv_comp_f32           <- _mv_comp_kernel        (:166)
//
// The table arrives as ns <= kMaxSplit consecutive-tile sub-tables (global
// tile i*ns+j is tile i of sub-table j; the wrapper zero-pads the block count
// to a whole number of groups), each (nsub, m, k) row-major, passed by value
// as an array of pointers.  The real blocks of each sub-table are a prefix
// of it; the kernels neither load nor compute the rows of the zero pad.
// Bound: the bytes of the nblk real blocks (and x, y) / 3.35 TB/s, as for
// the unsplit kernels.
//
// Design.  One kernel, splitk_kernel<OP, T, NS>, with four row bodies:
//   kMv   (kernel 5; kernel 1 at NS = 1): one table, f32 or bf16, and x;
//         one fmaf chain per row, each bf16 entry widened where it is used;
//   kMv2  (kernel 6; kernel 2 at NS = 1): the f32 pair (hi, lo) and x; two
//         fmaf chains per row, added once at the end;
//   kComp (kernel 7; kernel 4 at NS = 1): the f32 pair, x_hi and x_lo; the
//         two_prod / two_sum chain;
//   kDs   (kernel 3, NS = 1 only: the JAX package has no split-k ds kernel):
//         the f32 pair, x_hi and x_lo; three fmaf chains per row, A_hi x_hi,
//         A_hi x_lo and A_lo x_hi, each kernel 1's chain on its pair.
// A CTA owns the same stretch of R sub-table rows [r0, r0 + R) in EVERY
// sub-table.  Each thread computes output rows in the unsplit kernel's
// column order, so a split-k result is bitwise equal to the unsplit
// kernel's on the same table (one thread per row: lanes per row would sum
// in another order).  The stretches reach shared memory by stage_split:
// one thread starts NT*NS 1-D bulk asynchronous copies (bulk_copy.cuh),
// one per (table, sub-table) stretch of real rows, all onto one mbarrier,
// and every thread stages the x of the blocks the stretches touch beside
// them, kXLoads loads in flight per thread.  The rows land at stride k; a
// thread reads its row a 16-byte vector at a time where the row holds
// whole vectors (walk_row), else entry by entry (a 2-way bank conflict
// for f32 at k = 54, accepted; none for bf16 there).  No thread spends
// registers or instructions on the table bytes, and the CTA is small, so that many CTAs per SM overlap one's copies with
// another's arithmetic.  Every stretch must start on a 16-byte boundary:
// the sub-table bases are (the entries refuse any other), and R is a
// multiple of V = 16 / sizeof(T) entries (4 f32, 8 bf16), so r0 * k
// entries are a whole number of 16-byte units for any k.
//
// Rows per sub-table (split_rows): kernels 4 and 7 take kCompRows and
// kCompSplitRows, kernel 3 kCompRows (the same tables, the same staging);
// kernels 5 and 6 share kSplitCtaRows rows among their NS sub-tables, so
// that the CTA stays the same size at every k; at NS = 1 (kernels 1 and 2,
// and the segment entry) they take kMvRows.
//   Sweep of kMvRows (the same tool and card; random tables of the main
//   path's shapes at maxh=0.09, sums of the better of two passes): kernel
//   1 on S, ext, ext^T, inner, M_F, M_F^T and one color's GS row panels
//   (7799 x 12 x 96 f32) 32 / 64 / 128 / 256 rows took 0.1235 / 0.1210 /
//   0.1253 / 0.1322 ms (the parent's kernel 1, per-thread loads into
//   odd-stride tiles, 0.1466; seven torch.bmm 0.1966); the segment entry
//   on one color's GS solve table (bf16, 12.20 MB of segments standing for
//   1497 x 96 x 96) 0.0140 / 0.0140 / 0.0140 / 0.0145 (kernel 1 on the
//   padded table 0.0216, the parent's 0.0336); kernel 2 on pairs of the
//   shapes of A32, B32 and BT32 0.1039 / 0.1028 / 0.1040 / 0.1076 (the
//   parent's 0.1637; three torch.bmm of the stacked pairs 0.1713).  Fixed:
//   64, the best on kernels 1 and 2, tied on the segments.
//   Sweep of kCompSplitRows (tools/sweep_redesign.py, random tables of
//   the shapes of A_ds, B_ds and BT_ds at maxh=0.09, summed; NVIDIA H100
//   80GB HBM3, 700 W): R = 16 / 32 / 64 took 0.1161 / 0.1109 / 0.1125 ms
//   at k = 2 and 0.1133 / 0.1150 / 0.1196 at k = 4; in the same call the
//   earlier design (a copy loop into odd-stride tiles, x read from global
//   memory) 0.1887 and 0.1800, the f64 torch.bmm of hi + lo 0.1430, the
//   byte bound 0.0660.  Fixed: R = 32, the best at k = 2.
//   Sweep of kCompRows (kernel 4, the same tables and card): R = 32 /
//   64 / 128 took 0.1096 / 0.1086 / 0.1098 ms; in the same call the
//   earlier kernel 4 (one thread per row after a copy loop into
//   odd-stride tiles, 48 KB CTAs) 0.1873, the f64 torch.bmm 0.1437.
//   Fixed: R = 64.  Kernel 4 is bitwise equal to the earlier one.
//   Kernel 3 at kCompRows (the same tool and card; random hi/lo pairs and
//   x_hi/x_lo of the shapes of A_ds, B_ds and BT_ds, summed): R = 32 / 64
//   / 128 took 0.1081 / 0.1075 / 0.1093 ms; in the same call the earlier
//   kernel 3 (per-thread loads into odd-stride tiles, 48 KB CTAs) 0.1809,
//   the f32 torch.bmm of the stacked pair 0.2644, the byte bound 0.0671.
//   Kept: R = 64, the best; every variant bitwise equal to kernel 1 on each
//   (table, vector) pair, as the earlier kernel 3 is.
//   Sweep of kSplitCtaRows (the same tool and card; random tables): on the
//   A32-shaped pair (7740 x 54 x 54, kernel 6, tile 256) 32 / 64 / 128 /
//   256 rows took 0.0748 / 0.0744 / 0.0745 / 0.0750 ms at k = 2, 0.0824 /
//   0.0744 / 0.0758 / 0.0763 at k = 8 (the earlier design, kernel 5's copy
//   loop into odd-stride tiles with x read from global memory: 0.1326 and
//   0.1395; torch.bmm of the stacked pair 0.1159); kernel 10's six variants
//   on the 7740 x 54 x 54 f32 table 0.3260 / 0.2728 / 0.2691 / 0.2756
//   (earlier 0.3720; six torch.bmm 0.3606); tables of the shapes of S, ext,
//   ext^T and inner 0.0714 / 0.0689 / 0.0689 / 0.0722 at k = 2, 0.0953 /
//   0.0761 / 0.0713 / 0.0739 at k = 8 (earlier 0.0836 and 0.1020).
//   Fixed: 128, the best summed over every case, tied at k = 2.

constexpr int kMaxSplit = 8;
constexpr int kXLoads = 4;  // x loads in flight per thread
// rows per CTA of kernels 3 and 4 (one sub-table) and per sub-table of one
// kernel-7 CTA; rows per kernel-5/6 CTA, summed over its sub-tables; rows
// per CTA of kernels 1 and 2 and the segment entry
// (tools/sweep_redesign.py)
constexpr int kCompRows = 64;
constexpr int kCompSplitRows = 32;
constexpr int kSplitCtaRows = 128;
constexpr int kMvRows = 64;
static_assert(kCompRows % 4 == 0 && kCompSplitRows % 4 == 0,
              "kernel 3's and the compensated kernel's f32 stretches start "
              "on 16-byte boundaries");
static_assert(kMvRows % 8 == 0,
              "kernel 1's and 2's stretches start on 16-byte boundaries");

enum SplitOp { kMv, kMv2, kComp, kDs };

// tables and x vectors each row body stages
__host__ __device__ constexpr int split_tables(int op) {
  return op == kMv ? 1 : 2;
}
__host__ __device__ constexpr int split_xs(int op) {
  return op == kComp || op == kDs ? 2 : 1;
}

// Rows per sub-table of row body op at ns sub-tables of es-byte entries:
// a multiple of 16 / es entries (see above).
constexpr int split_rows(int op, int ns, int es) {
  return op == kComp || op == kDs ? (ns == 1 ? kCompRows : kCompSplitRows)
         : ns == 1                 ? kMvRows
         : kSplitCtaRows / ns >= 16 / es
             ? kSplitCtaRows / ns / (16 / es) * (16 / es)
             : 16 / es;
}
static_assert(split_rows(kMv, 3, 2) % 8 == 0 && split_rows(kMv, 8, 2) % 8 == 0
                  && split_rows(kMv2, 3, 4) % 4 == 0,
              "kernel 5's and 6's stretches start on 16-byte boundaries");

struct SubTables {
  const void* p[kMaxSplit];
};

// Entries of the real rows of each sub-table (its real blocks are a prefix
// of it), computed on the host: the kernels compare against them and do no
// integer division for the pad.
struct SplitReal {
  long long n[kMaxSplit];
};

// Global output row of row sr of sub-table j, or -1 for a row of the pad.
__device__ __forceinline__ long long global_row(long long sr, int j, int ns,
                                                int m, int tile,
                                                long long nblk) {
  const long long sb = sr / m;  // block within the sub-table
  const long long i = sb / tile;
  const long long gb = (i * ns + j) * tile + (sb - i * tile);
  return gb < nblk ? gb * m + (sr - sb * m) : -1;
}

struct SplitTile {
  long long r0;  // first sub-table row of this CTA
  int nrows;     // sub-table rows in this tile (in each sub-table)
};

__device__ __forceinline__ SplitTile cta_tile(long long nsub_rows,
                                                   int R) {
  SplitTile t;
  t.r0 = static_cast<long long>(blockIdx.x) * R;
  long long r1 = t.r0 + R;
  if (r1 > nsub_rows) r1 = nsub_rows;
  t.nrows = static_cast<int>(r1 - t.r0);
  return t;
}

// A CTA's shared memory after stage_split: the mbarrier; the NT tables'
// stretches (table i, sub-table j at tab[i] + j * R * k entries); the NX
// x vectors of the xb = (R - 1) / m + 2 sub-table blocks a stretch can
// touch (vector i, sub-table j at x[i] + j * xb * k floats).
template <typename T, int NT, int NX>
struct SplitSmem {
  uint64_t* bar;
  T* tab[NT];
  float* x[NX];
};

// Bring the CTA's stretches of NT tables (a0, and a1 if NT = 2) and of NX
// x vectors (x0, and x1 if NX = 2; block gb's entries at gb * xstride) on
// chip, and wait until every byte has landed.  Only the real rows of each
// sub-table are loaded: their whole 16-byte units by one bulk copy per
// (table, sub-table), all NT*NS started before anyone waits on their one
// barrier; the at most V - 1 entries after them by plain loads.  NS is a compile-time constant: j
// indexes the by-value pointer arrays with compile-time indices only (a
// run-time index would put the kernel parameters in local memory).
template <typename T, int NT, int NX, int NS>
__device__ __forceinline__ SplitSmem<T, NT, NX> stage_split(
    unsigned char* smem_raw, const SubTables& a0, const SubTables& a1,
    const SplitReal& real, const float* __restrict__ x0,
    const float* __restrict__ x1, const SplitTile& t, long long nblk, int m,
    int k, int R, int xb, int tile, long long xstride) {
  constexpr int V = 16 / sizeof(T);
  SplitSmem<T, NT, NX> s;
  s.bar = reinterpret_cast<uint64_t*>(smem_raw);
  T* tp = reinterpret_cast<T*>(smem_raw + kHeader);
#pragma unroll
  for (int i = 0; i < NT; ++i) s.tab[i] = tp + i * NS * R * k;
  float* xp = reinterpret_cast<float*>(tp + NT * NS * R * k);
#pragma unroll
  for (int i = 0; i < NX; ++i) s.x[i] = xp + i * NS * xb * k;
  const long long off = t.r0 * k;
  const int count = t.nrows * k;
  if (threadIdx.x == 0) {
    mbar_init(s.bar, blockDim.x);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int lim[NS];
    uint32_t bytes = 0;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const long long l = real.n[j] - off;  // real entries in this stretch
      lim[j] = static_cast<int>(l < 0 ? 0 : (l > count ? count : l));
      bytes += static_cast<uint32_t>(NT * sizeof(T)) *
               static_cast<uint32_t>(lim[j] & ~(V - 1));
    }
    if (bytes) mbar_expect_tx(s.bar, bytes);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const T* src[NT];
      src[0] = static_cast<const T*>(a0.p[j]) + off;
      if constexpr (NT == 2) src[1] = static_cast<const T*>(a1.p[j]) + off;
      const int whole = lim[j] & ~(V - 1);
      if (whole) {
#pragma unroll
        for (int i = 0; i < NT; ++i)
          bulk_copy(s.tab[i] + j * R * k, src[i],
                    static_cast<uint32_t>(sizeof(T)) * whole, s.bar);
      }
      for (int c = whole; c < lim[j]; ++c) {
#pragma unroll
        for (int i = 0; i < NT; ++i) s.tab[i][j * R * k + c] = __ldg(src[i] + c);
      }
    }
  }
  // x of the touched blocks, by every thread beside the copies: stretch
  // block b of sub-table j is global block gb (a stretch that crosses a
  // tile boundary jumps in gb; blocks of the pad are skipped).  Each
  // thread issues kXLoads rounds of loads before it stores any: with few
  // rows per block (m = 4) the x of a stretch is a sixth of its table
  // bytes, and one load in flight per thread would serialize on latency.
  const long long sb0 = t.r0 / m;
  const int nbx = static_cast<int>((t.r0 + t.nrows - 1) / m - sb0 + 1);
  const int nx = NS * nbx * k;
  for (int e0 = threadIdx.x; e0 < nx; e0 += kXLoads * blockDim.x) {
    float v[NX][kXLoads];
    int at[kXLoads];
#pragma unroll
    for (int q = 0; q < kXLoads; ++q) {
      const int e = e0 + q * blockDim.x;
      at[q] = -1;
      if (e < nx) {
        const int j = e / (nbx * k), rem = e - j * nbx * k;
        const int b = rem / k, c = rem - b * k;
        const long long sb = sb0 + b, i = sb / tile;
        const long long gb = (i * NS + j) * tile + (sb - i * tile);
        if (gb < nblk) {
          v[0][q] = __ldg(x0 + gb * xstride + c);
          if constexpr (NX == 2) v[1][q] = __ldg(x1 + gb * xstride + c);
          at[q] = (j * xb + b) * k + c;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kXLoads; ++q) {
      if (at[q] >= 0) {
#pragma unroll
        for (int i = 0; i < NX; ++i) s.x[i][at[q]] = v[i][q];
      }
    }
  }
  mbar_arrive(s.bar);  // releases this thread's stores
  mbar_wait(s.bar, 0);  // every store made, every copied byte landed
  return s;
}

// f(c, a, b) for the entries c = 0..k-1 of the row at ao, in column order,
// a from table 0 and b from table NT - 1, widened to f32.  Where a row holds
// whole 16-byte vectors (k a multiple of V) they are read a vector at a
// time: at row stride k the 8 threads of a quarter warp then meet
// 8 / gcd(k / V, 8)-way bank conflicts (none at odd k / V, 4-way at k = 48
// f32, 8-way at k = 96 f32: the GS row panels), where entry-by-entry reads
// would meet up to 16-way ones (gcd(k, 32) for f32: 16 at k = 48).
template <typename T, int NT, typename F>
__device__ __forceinline__ void walk_row(T* const (&tab)[NT], int ao, int k,
                                         F&& f) {
  constexpr int V = 16 / sizeof(T);
  if (k % V == 0) {
    for (int c0 = 0; c0 < k; c0 += V) {
      float a[NT][V];
#pragma unroll
      for (int i = 0; i < NT; ++i)
        unpack<T>(*reinterpret_cast<const uint4*>(tab[i] + ao + c0), a[i]);
#pragma unroll
      for (int q = 0; q < V; ++q) f(c0 + q, a[0][q], a[NT - 1][q]);
    }
  } else {
    for (int c = 0; c < k; ++c)
      f(c, to_f32(tab[0][ao + c]), to_f32(tab[NT - 1][ao + c]));
  }
}

// The compensated double-single product of kComp (kernel 7; at NS = 1
// kernel 4): (y_hi, y_lo) with y_hi + y_lo ~ (A_hi + A_lo)(x_hi + x_lo) to
// ~2^-45 of sum_j |a_ij x_j|.  The dominant products a_hi * x_hi are split
// exactly (two_prod through one fused multiply-add) and summed with two_sum
// error capture, column by column as in the Pallas kernel.  Every add,
// subtract and multiply is an explicitly rounded intrinsic, so nvcc cannot
// contract any of them into an FMA, which would silently drop the error
// terms (the failure the reference hit on its interpret path,
// pallas_mv.py:146-154, 191-200).  Build without --use_fast_math.
//
// Parameters: a0 (and a1: lo) the sub-tables, x0 (and x1: x_lo) the
// vectors, y0 (and y1: y_lo; kDs: y0, y1, y2 = hh, hl, lh) the outputs;
// unused ones are never read.
template <int OP, typename T, int NS>
__global__ void __launch_bounds__(kMaxThreads)
    splitk_kernel(SubTables a0, SubTables a1, SplitReal real,
                  const float* __restrict__ x0, const float* __restrict__ x1,
                  float* __restrict__ y0, float* __restrict__ y1,
                  float* __restrict__ y2, long long nsub_rows,
                  long long nblk, int m, int k, int R, int xb, int tile) {
  constexpr int NT = split_tables(OP), NX = split_xs(OP);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const SplitTile t = cta_tile(nsub_rows, R);
  const SplitSmem<T, NT, NX> s = stage_split<T, NT, NX, NS>(
      smem_raw, a0, a1, real, x0, x1, t, nblk, m, k, R, xb, tile, k);
  const long long sb0 = t.r0 / m;
  for (int e = threadIdx.x; e < NS * t.nrows; e += blockDim.x) {
    const int j = e / t.nrows, rr = e - j * t.nrows;
    const long long g = global_row(t.r0 + rr, j, NS, m, tile, nblk);
    if (g < 0) continue;
    const int ao = (j * R + rr) * k;
    const int xo = (j * xb + static_cast<int>((t.r0 + rr) / m - sb0)) * k;
    const float* xr = s.x[0] + xo;
    if constexpr (OP == kMv) {
      float acc = 0.0f;
      walk_row(s.tab, ao, k, [&](int c, float a, float) {
        acc = fmaf(a, xr[c], acc);
      });
      y0[g] = acc;
    } else if constexpr (OP == kMv2) {
      float acc_hi = 0.0f, acc_lo = 0.0f;
      walk_row(s.tab, ao, k, [&](int c, float h, float l) {
        const float xc = xr[c];
        acc_hi = fmaf(h, xc, acc_hi);
        acc_lo = fmaf(l, xc, acc_lo);
      });
      y0[g] = acc_hi + acc_lo;
    } else if constexpr (OP == kDs) {
      // the three f32 products of the plain double-single apply (the caller
      // sums them in f64; A_lo x_lo is below f64 roundoff of the result),
      // each the chain of kernel 1 on its (table, vector) pair
      const float* xl = s.x[1] + xo;
      float hh = 0.0f, hl = 0.0f, lh = 0.0f;
      walk_row(s.tab, ao, k, [&](int c, float ah, float al) {
        const float xhc = xr[c];
        hh = fmaf(ah, xhc, hh);
        hl = fmaf(ah, xl[c], hl);
        lh = fmaf(al, xhc, lh);
      });
      y0[g] = hh;
      y1[g] = hl;
      y2[g] = lh;
    } else {
      const float* xl = s.x[NX - 1] + xo;
      // two_prod, then two_sum(sh, p), the small terms summed beside
      float sh = 0.0f, sl = 0.0f;
      walk_row(s.tab, ao, k, [&](int c, float ah, float al) {
        const float xhj = xr[c], xlj = xl[c];
        const float p = __fmul_rn(ah, xhj);
        const float err = __fmaf_rn(ah, xhj, -p);
        const float small =
            __fadd_rn(__fadd_rn(__fmul_rn(ah, xlj), __fmul_rn(al, xhj)), err);
        const float tt = __fadd_rn(sh, p);
        const float bb = __fsub_rn(tt, sh);
        const float e2 =
            __fadd_rn(__fsub_rn(sh, __fsub_rn(tt, bb)), __fsub_rn(p, bb));
        sh = tt;
        sl = __fadd_rn(sl, __fadd_rn(e2, small));
      });
      y0[g] = sh;
      y1[g] = sl;
    }
  }
}

// -- kernel 1 on segments: the GS solve tables without their padding ---------
//
//   nstt_block_mv_seg_{f32,bf16}  <- _mv_kernel (:118) on the merged GS
//                                    solve tables (ops/faceblock.py)
//
// A segmented table stands for an (nblk, width, width) table whose blocks
// are zero-padded squares: segment s is count_s blocks of d_s x d_s
// entries, row-major, at entry offset off_s of one allocation, and holds
// blocks first_s .. first_s + count_s - 1; the segments cover blocks
// 0 .. nreal - 1 in order, and the blocks from nreal on are zero.  The
// descriptors are rows {off, first, count, d} of int64, one copy in host
// memory (checked, and read to plan the launch) and one in device memory
// (read by the kernel: a color has more segments than a launch can take by
// value).  x and y are (nblk, width):
//   y[first_s + b, i] = sum_{j < d_s} T_s[b, i, j] x[first_s + b, j]
// for i < d_s, and every other entry of y is 0.  That is kernel 1 on the
// padded table without the products with its zero entries: equal as values
// to it (a sum of -0 may come out +0 there), and it streams only the real
// blocks.  Bound: their bytes (and x, y) / 3.35 TB/s.
//
// Design: kernel 1 (splitk_kernel<kMv, T, 1>) per segment, all segments in
// one launch.  The CTAs of segment s are the ceil(count_s d_s / R) after
// those of the segments before it; warp 0 of each CTA finds its segment by
// a prefix sum over the descriptors (32 at a time, by shuffles).  A CTA
// stages its stretch of R segment rows as kernel 1 does (stage_split), the
// x of a block being the first d_s entries of its row of x, and writes the
// zero columns of the blocks whose last row lies in its stretch.  The CTAs
// after all segments' write the zero blocks, kZeroPerThread floats a thread.

constexpr int kSegFields = 4;  // off, first, count, d
constexpr int kZeroPerThread = 8;
constexpr int kSegAt = 64;  // byte offset of the CTA's descriptor copy
static_assert(kSegAt >= 8 && kSegAt + 8 * (kSegFields + 1) <= kHeader,
              "the descriptor copy sits between the mbarrier and the "
              "stretches");

// Warp 0: this CTA's segment descriptor into seg[0..3] and its CTA index
// within the segment into seg[4]; for a CTA past every segment's, seg[4] =
// -1 and seg[0] = its index among the zero-writing CTAs.
__device__ __forceinline__ void find_segment(const long long* __restrict__ desc,
                                             int nseg, int R, long long* seg) {
  const int lane = threadIdx.x;
  long long before = 0;  // CTAs of the segments already scanned
  bool found = false;
  for (int s0 = 0; s0 < nseg && !found; s0 += 32) {
    const int s = s0 + lane;
    long long n = 0;
    if (s < nseg)
      n = (__ldg(desc + kSegFields * s + 2) * __ldg(desc + kSegFields * s + 3) +
           R - 1) / R;
    long long inc = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    const long long c = static_cast<long long>(blockIdx.x) - before;
    const bool mine = c >= inc - n && c < inc;  // n = 0 past the last
    if (mine) {
#pragma unroll
      for (int f = 0; f < kSegFields; ++f)
        seg[f] = __ldg(desc + kSegFields * s + f);
      seg[4] = c - (inc - n);
    }
    found = __any_sync(0xffffffffu, mine);
    before += __shfl_sync(0xffffffffu, inc, 31);
  }
  if (!found && lane == 0) {
    seg[0] = static_cast<long long>(blockIdx.x) - before;
    seg[4] = -1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    segment_kernel(const T* __restrict__ tab,
                   const long long* __restrict__ desc, int nseg,
                   const float* __restrict__ x, float* __restrict__ y,
                   long long nreal, long long nblk, int width, int R) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // in the header, past the mbarrier: no static shared memory, which would
  // take from the kSmemOptIn bytes the launch opts in to
  long long* seg = reinterpret_cast<long long*>(smem_raw + kSegAt);
  if (threadIdx.x < 32) find_segment(desc, nseg, R, seg);
  __syncthreads();
  if (seg[4] < 0) {  // a zero-writing CTA
    const long long n = (nblk - nreal) * width;
    const long long e0 = seg[0] * blockDim.x * kZeroPerThread + threadIdx.x;
    float* yz = y + nreal * width;
#pragma unroll
    for (int q = 0; q < kZeroPerThread; ++q) {
      const long long e = e0 + static_cast<long long>(q) * blockDim.x;
      if (e < n) yz[e] = 0.0f;
    }
    return;
  }
  const long long first = seg[1], count = seg[2];
  const int d = static_cast<int>(seg[3]);
  SplitTile t;
  t.r0 = seg[4] * R;
  const long long r1 = t.r0 + R < count * d ? t.r0 + R : count * d;
  t.nrows = static_cast<int>(r1 - t.r0);
  SubTables a;
  a.p[0] = tab + seg[0];
  SplitReal real;
  real.n[0] = count * d * d;
  const SplitSmem<T, 1, 1> s = stage_split<T, 1, 1, 1>(
      smem_raw, a, a, real, x + first * width, nullptr, t, count, d, d, R,
      (R - 1) / d + 2, static_cast<int>(count), width);
  const long long sb0 = t.r0 / d;
  for (int rr = threadIdx.x; rr < t.nrows; rr += blockDim.x) {
    const long long sb = (t.r0 + rr) / d;
    const int i = static_cast<int>(t.r0 + rr - sb * d);
    const float* xr = s.x[0] + (sb - sb0) * d;
    float acc = 0.0f;
    walk_row(s.tab, rr * d, d, [&](int c, float av, float) {
      acc = fmaf(av, xr[c], acc);
    });
    y[(first + sb) * width + i] = acc;
  }
  // the zero columns of the blocks whose last row is in this stretch
  const int pad = width - d;
  const long long b0 = t.r0 / d, nb = r1 / d - b0;
  for (long long e = threadIdx.x; e < nb * pad; e += blockDim.x) {
    const long long b = e / pad;
    y[(first + b0 + b) * width + d + (e - b * pad)] = 0.0f;
  }
}

struct Launch {
  int R = 0;        // rows per CTA (split-k: per sub-table)
  int threads = 0;  // threads per CTA
  unsigned int grid = 0;
  size_t smem = 0;  // dynamic shared memory bytes
};

// Split-k launch: split_rows rows per sub-table, or the largest multiple of
// V below it whose NT*ns stretches and NX x stages fit opt-in shared
// memory.  Threads: one per (sub-table, row), or as many as issue every x
// load of a stretch in one round of kXLoads, whichever is more (at most
// kMaxThreads): 64 on 54 x 54 blocks at k = 2, 256 on the 4 x 54 blocks of
// B.
template <int OP, typename T>
Launch plan_split(long long nsub_rows, int m, int k, int ns) {
  constexpr int V = 16 / sizeof(T);
  constexpr int NT = split_tables(OP), NX = split_xs(OP);
  Launch L;
  for (int R = split_rows(OP, ns, sizeof(T)); R >= V; R -= V) {
    const long long xb = (R - 1) / m + 2;
    const long long bytes =
        kHeader + static_cast<long long>(sizeof(T)) * NT * ns * R * k +
        4LL * NX * ns * xb * k;
    if (bytes <= kSmemOptIn) {
      L.R = R;
      long long want = static_cast<long long>(ns) * R;
      const long long xwant = (ns * xb * k + kXLoads - 1) / kXLoads;
      if (xwant > want) want = xwant;
      L.threads = want >= kMaxThreads
                      ? kMaxThreads
                      : static_cast<int>((want + 31) / 32 * 32);
      L.smem = static_cast<size_t>(bytes);
      L.grid = static_cast<unsigned int>((nsub_rows + R - 1) / R);
      return L;
    }
  }
  return L;
}

// Opt in to kSmemOptIn bytes once per instantiation.
template <int OP, typename T, int NS>
cudaError_t split_opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      splitk_kernel<OP, T, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptIn);
  return err;
}

inline bool bad_split(int op, int ns, long long nblk, long long nsub, int m,
                      int k, int tile) {
  return ns < 1 || ns > (op == kDs ? 1 : kMaxSplit) || nblk < 0 || m <= 0 ||
         k <= 0 || tile <= 0 || nsub % tile != 0 || nblk > ns * nsub;
}

// Any of the ns sub-table bases off a 16-byte boundary (the bulk copies
// start there).
inline bool misaligned(const void* const* p, int ns) {
  for (int j = 0; j < ns; ++j)
    if (reinterpret_cast<uintptr_t>(p[j]) % 16 != 0) return true;
  return false;
}

SubTables sub_tables(const void* const* p, int ns) {
  SubTables s;
  for (int j = 0; j < kMaxSplit; ++j) s.p[j] = j < ns ? p[j] : p[0];
  return s;
}

// Calls f(std::integral_constant<int, ns>()) for ns in 1..kMaxSplit: the
// split-k kernel is instantiated per sub-table count.
template <typename F>
void with_split(int ns, F&& f) {
  switch (ns) {
    case 1: f(std::integral_constant<int, 1>()); break;
    case 2: f(std::integral_constant<int, 2>()); break;
    case 3: f(std::integral_constant<int, 3>()); break;
    case 4: f(std::integral_constant<int, 4>()); break;
    case 5: f(std::integral_constant<int, 5>()); break;
    case 6: f(std::integral_constant<int, 6>()); break;
    case 7: f(std::integral_constant<int, 7>()); break;
    case 8: f(std::integral_constant<int, 8>()); break;
  }
}
static_assert(kMaxSplit == 8, "with_split covers 1..kMaxSplit");

// Global tile i*ns+j is tile i of sub-table j: the tiles below nblk / tile
// are full, the one at it holds the remainder, the rest are zero pad.
SplitReal split_real(int ns, long long nblk, int m, int k, int tile) {
  SplitReal r;
  const long long full = nblk / tile, rem = nblk - full * tile;
  for (int j = 0; j < kMaxSplit; ++j) {
    long long blocks = 0;
    if (j < ns) {
      blocks = full > j ? (full - j + ns - 1) / ns * tile : 0;
      if (rem > 0 && full >= j && (full - j) % ns == 0) blocks += rem;
    }
    r.n[j] = blocks * m * k;
  }
  return r;
}

// One split-k launch of row body OP: a0 (and a1) point at ns sub-table
// pointers (host memory), each 16-byte aligned; unused operands may be
// null.  kDs is instantiated at ns = 1 only.
template <int OP, typename T>
int launch_split(const void* const* a0, const void* const* a1, int ns,
                 const float* x0, const float* x1, float* y0, float* y1,
                 float* y2, long long nblk, int m, int k, long long nsub,
                 int tile, void* stream) {
  if (bad_split(OP, ns, nblk, nsub, m, k, tile) || misaligned(a0, ns) ||
      misaligned(a1, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblk == 0) return 0;
  const Launch L = plan_split<OP, T>(nsub * m, m, k, ns);
  if (L.R == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  auto go = [&](auto c) {
    constexpr int NS = decltype(c)::value;
    err = split_opt_in<OP, T, NS>();
    if (err != cudaSuccess) return;
    splitk_kernel<OP, T, NS>
        <<<L.grid, L.threads, L.smem, static_cast<cudaStream_t>(stream)>>>(
            sub_tables(a0, ns), sub_tables(a1, ns),
            split_real(ns, nblk, m, k, tile), x0, x1, y0, y1, y2, nsub * m,
            nblk, m, k, L.R, (L.R - 1) / m + 2, tile);
  };
  if constexpr (OP == kDs)
    go(std::integral_constant<int, 1>());
  else
    with_split(ns, go);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Segment launch: kernel 1's rows per CTA at one sub-table, or the largest
// multiple of V below it whose stretch and x stage fit opt-in shared memory
// for every segment; threads as plan_split's, for the segment that wants
// the most.  Sets *nreal to the blocks the segments cover.  R = 0 for
// descriptors that break the layout (segments in block order from block
// 0, offsets increasing and 16-byte aligned, each segment inside the
// table, 1 <= d <= width, at most nblk blocks) or a launch too large.
template <typename T>
Launch plan_segments(const long long* desc, int nseg, long long entries,
                     long long nblk, int width, long long* nreal) {
  constexpr int V = 16 / sizeof(T);
  Launch L;
  long long next_block = 0, next_off = 0;
  for (int s = 0; s < nseg; ++s) {
    const long long* g = desc + kSegFields * s;
    const long long off = g[0], first = g[1], count = g[2], d = g[3];
    if (first != next_block || off < next_off ||
        off * static_cast<long long>(sizeof(T)) % 16 != 0 || count < 1 ||
        count > INT_MAX || d < 1 || d > width ||
        count > (entries - off) / (d * d))
      return L;
    next_block += count;
    next_off = off + count * d * d;
  }
  if (next_block > nblk) return L;
  *nreal = next_block;
  for (int R = split_rows(kMv, 1, sizeof(T)); R >= V; R -= V) {
    long long bytes = kHeader, want = 32, grid = 0;
    for (int s = 0; s < nseg; ++s) {
      const long long count = desc[kSegFields * s + 2];
      const long long d = desc[kSegFields * s + 3];
      const long long xb = (R - 1) / d + 2;
      const long long b = kHeader + static_cast<long long>(sizeof(T)) * R * d +
                          4LL * xb * d;
      const long long w = (xb * d + kXLoads - 1) / kXLoads;
      if (b > bytes) bytes = b;
      if (w > want) want = w;
      if (R > want) want = R;
      grid += (count * d + R - 1) / R;
    }
    if (bytes > kSmemOptIn) continue;
    L.R = R;
    L.threads = want >= kMaxThreads ? kMaxThreads
                                    : static_cast<int>((want + 31) / 32 * 32);
    const long long per = static_cast<long long>(L.threads) * kZeroPerThread;
    grid += ((nblk - next_block) * width + per - 1) / per;
    if (grid > INT_MAX) {
      L.R = 0;
      return L;
    }
    L.grid = static_cast<unsigned int>(grid);
    L.smem = static_cast<size_t>(bytes);
    return L;
  }
  return L;
}

// One segment launch: tab (entries long, 16-byte aligned) and its nseg
// descriptors, desc_host in host memory and desc_dev the same in device
// memory.
template <typename T>
int launch_segments(const void* tab, long long entries,
                    const long long* desc_host, const long long* desc_dev,
                    int nseg, const float* x, float* y, long long nblk,
                    int width, void* stream) {
  if (nseg < 0 || nblk < 0 || width <= 0 || entries < 0 ||
      reinterpret_cast<uintptr_t>(tab) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblk == 0) return 0;
  long long nreal = 0;
  const Launch L =
      plan_segments<T>(desc_host, nseg, entries, nblk, width, &nreal);
  if (L.R == 0) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt = cudaFuncSetAttribute(
      segment_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptIn);
  if (opt != cudaSuccess) return static_cast<int>(opt);
  segment_kernel<T>
      <<<L.grid, L.threads, L.smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(tab), desc_dev, nseg, x, y, nreal, nblk, width,
          L.R);
  return static_cast<int>(cudaGetLastError());
}

__global__ void spin_kernel(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

inline bool bad_shape(long long nblk, int m, int k) {
  return nblk < 0 || m <= 0 || k <= 0;
}

// Row body OP at one sub-table: the table itself, one tile of nblk blocks,
// every row real (kernels 1 to 4).  launch_split refuses tables off a
// 16-byte boundary.
template <int OP, typename T>
int launch_unsplit(const void* a0, const void* a1, const float* x0,
                   const float* x1, float* y0, float* y1, float* y2,
                   long long nblk, int m, int k, void* stream) {
  if (bad_shape(nblk, m, k) || nblk > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblk == 0) return 0;
  const void* p0[1] = {a0};
  const void* p1[1] = {a1};
  return launch_split<OP, T>(p0, p1, 1, x0, x1, y0, y1, y2, nblk, m, k, nblk,
                             static_cast<int>(nblk), stream);
}

}  // namespace

extern "C" {

// Kernels 1 to 3: the split-k kernel at one sub-table (launch_unsplit).
// Tables 16-byte aligned: the bulk copies start there.

int nstt_block_mv_f32(const float* a, const float* x, float* y,
                      long long nblk, int m, int k, void* stream) {
  return launch_unsplit<kMv, float>(a, a, x, nullptr, y, nullptr, nullptr,
                                    nblk, m, k, stream);
}

int nstt_block_mv_bf16(const void* a, const float* x, float* y,
                       long long nblk, int m, int k, void* stream) {
  return launch_unsplit<kMv, __nv_bfloat16>(a, a, x, nullptr, y, nullptr,
                                            nullptr, nblk, m, k, stream);
}

int nstt_block_mv2_f32(const float* a_hi, const float* a_lo, const float* x,
                       float* y, long long nblk, int m, int k, void* stream) {
  return launch_unsplit<kMv2, float>(a_hi, a_lo, x, nullptr, y, nullptr,
                                     nullptr, nblk, m, k, stream);
}

int nstt_block_mv_ds_f32(const float* a_hi, const float* a_lo,
                         const float* x_hi, const float* x_lo, float* y_hh,
                         float* y_hl, float* y_lh, long long nblk, int m,
                         int k, void* stream) {
  return launch_unsplit<kDs, float>(a_hi, a_lo, x_hi, x_lo, y_hh, y_hl, y_lh,
                                    nblk, m, k, stream);
}

// Kernel 1 on a segmented table (the section above): tab holds `entries`
// entries; desc_host and desc_dev hold the same nseg descriptors {off,
// first, count, d}, in host and in device memory; x and y are (nblk,
// width).

int nstt_block_mv_seg_f32(const float* tab, long long entries,
                          const long long* desc_host,
                          const long long* desc_dev, int nseg, const float* x,
                          float* y, long long nblk, int width, void* stream) {
  return launch_segments<float>(tab, entries, desc_host, desc_dev, nseg, x, y,
                                nblk, width, stream);
}

int nstt_block_mv_seg_bf16(const void* tab, long long entries,
                           const long long* desc_host,
                           const long long* desc_dev, int nseg,
                           const float* x, float* y, long long nblk,
                           int width, void* stream) {
  return launch_segments<__nv_bfloat16>(tab, entries, desc_host, desc_dev,
                                        nseg, x, y, nblk, width, stream);
}

// Split-k entry points: subs (his, los) point at ns sub-table pointers
// (host memory), each 16-byte aligned; nblk is the real block count (rows
// of x and y), nsub the blocks of each sub-table (a multiple of tile).

int nstt_block_mv_splitk_f32(const void* const* subs, int ns, const float* x,
                             float* y, long long nblk, int m, int k,
                             long long nsub, int tile, void* stream) {
  return launch_split<kMv, float>(subs, subs, ns, x, nullptr, y, nullptr,
                                  nullptr, nblk, m, k, nsub, tile, stream);
}

int nstt_block_mv_splitk_bf16(const void* const* subs, int ns, const float* x,
                              float* y, long long nblk, int m, int k,
                              long long nsub, int tile, void* stream) {
  return launch_split<kMv, __nv_bfloat16>(subs, subs, ns, x, nullptr, y,
                                          nullptr, nullptr, nblk, m, k, nsub,
                                          tile, stream);
}

int nstt_block_mv2_splitk_f32(const void* const* his, const void* const* los,
                              int ns, const float* x, float* y,
                              long long nblk, int m, int k, long long nsub,
                              int tile, void* stream) {
  return launch_split<kMv2, float>(his, los, ns, x, nullptr, y, nullptr,
                                   nullptr, nblk, m, k, nsub, tile, stream);
}

int nstt_block_mv_comp_splitk_f32(const void* const* his,
                                  const void* const* los, int ns,
                                  const float* x_hi, const float* x_lo,
                                  float* y_hi, float* y_lo, long long nblk,
                                  int m, int k, long long nsub, int tile,
                                  void* stream) {
  return launch_split<kComp, float>(his, los, ns, x_hi, x_lo, y_hi, y_lo,
                                    nullptr, nblk, m, k, nsub, tile, stream);
}

// Kernel 4: the compensated kernel at one sub-table (launch_unsplit).  Both
// tables 16-byte aligned: the bulk copies start there.
int nstt_block_mv_comp_f32(const float* a_hi, const float* a_lo,
                           const float* x_hi, const float* x_lo, float* y_hi,
                           float* y_lo, long long nblk, int m, int k,
                           void* stream) {
  return launch_unsplit<kComp, float>(a_hi, a_lo, x_hi, x_lo, y_hi, y_lo,
                                      nullptr, nblk, m, k, stream);
}

// One thread spinning on the SM clock for `cycles` cycles: work that keeps
// the stream busy while the host prepares a timed call
// (utils/timers.KernelTimer).
int nstt_spin(long long cycles, void* stream) {
  spin_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(cycles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
