// Batched dense block matvecs of the flagship solve, written for Hopper
// (sm_90a).  Counterpart of the Pallas kernels in
// navier_stokes_tpu/ops/pallas_mv.py:
//
//   nstt_block_mv_{f32,bf16}  <- _mv_kernel      (pallas_mv.py:118)
//   nstt_block_mv2_f32        <- _mv2_kernel     (pallas_mv.py:124)
//   nstt_block_mv_ds_f32      <- _mv_ds_kernel   (pallas_mv.py:129)
//   nstt_block_mv_comp_f32    <- _mv_comp_kernel (pallas_mv.py:166)
//
// Each computes y[b, i] = sum_j A[b, i, j] x[b, j] for a batch of small dense
// blocks.  Layout: tables (nblk, m, k) row-major and contiguous, vectors
// (nblk, k) in and (nblk, m) out -- the natural array-of-structures layout,
// not the TPU's tile-packed (ntile, m, k, TILE) lane layout.
//
// Bound: every kernel reads its table(s) once and does 2 flops per table
// element (about 15 for the compensated kernel), far below the card's f32
// rate for the bytes moved, so each is bound by device memory bandwidth:
// table bytes / 3.35 TB/s on an H100 SXM.
//
// Design.  Viewed as nblk * m output rows, the table rows of any run of
// consecutive output rows are one contiguous stretch of memory, whatever the
// block boundaries.  A CTA owns R consecutive rows (R chosen on the host so
// that its tiles fit 48 KB of shared memory):
//   1. the CTA copies its rows' table stretch into shared memory with
//      coalesced 16-byte loads (bf16 is widened to f32 on the way), one row
//      per ks = k | 1 floats -- an odd row stride, so that the threads of a
//      warp, each reading its own row, hit distinct banks;
//   2. it copies the x rows of the blocks those rows belong to;
//   3. each thread computes one output row from shared memory, in column
//      order, and writes it (coalesced).
// Accumulation is f32.  The simple kernel comes first; overlapping the copy
// of one tile with the arithmetic of the previous one is later work.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() (or cudaErrorInvalidValue for shapes it does
// not take) so that the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSmemBudget = 48 * 1024;  // dynamic shared memory, no opt-in

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

// Copy count contiguous table entries src[0..count) into dst as rows of k
// entries at row stride ks.  Coalesced 16-byte loads for the aligned middle,
// single loads for the unaligned head and the tail.
template <typename T>
__device__ void stage_rows(const T* __restrict__ src, int count, int k, int ks,
                           float* __restrict__ dst) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  int head = static_cast<int>(((16 - (addr & 15)) & 15) / sizeof(T));
  if (head > count) head = count;
  const int nvec = (count - head) / V;
  for (int e = threadIdx.x; e < head; e += blockDim.x)
    dst[(e / k) * ks + e % k] = to_f32(src[e]);
  const uint4* pv = reinterpret_cast<const uint4*>(src + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[V];
    unpack<T>(__ldg(pv + i), v);
    const int e0 = head + i * V;
    int row = e0 / k, col = e0 - row * k;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      dst[row * ks + col] = v[q];
      if (++col == k) {
        col = 0;
        ++row;
      }
    }
  }
  for (int e = head + nvec * V + threadIdx.x; e < count; e += blockDim.x)
    dst[(e / k) * ks + e % k] = to_f32(src[e]);
}

__device__ __forceinline__ void stage_x(const float* __restrict__ src,
                                        int count, float* __restrict__ dst) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) dst[e] = __ldg(src + e);
}

struct Tile {
  long long r0;  // first output row of this CTA
  int nrows;     // rows in this tile
  long long b0;  // first block touched
  int nx;        // x entries staged (whole blocks)
};

__device__ __forceinline__ Tile tile_of(long long nrows_all, int R, int m,
                                        int k) {
  Tile t;
  t.r0 = static_cast<long long>(blockIdx.x) * R;
  long long r1 = t.r0 + R;
  if (r1 > nrows_all) r1 = nrows_all;
  t.nrows = static_cast<int>(r1 - t.r0);
  t.b0 = t.r0 / m;
  t.nx = static_cast<int>((r1 - 1) / m - t.b0 + 1) * k;
  return t;
}

// y[r] = sum_j a[r, j] * x[r / m, j]
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    block_mv_kernel(const T* __restrict__ a, const float* __restrict__ x,
                    float* __restrict__ y, long long nrows_all, int m, int k,
                    int ks, int R) {
  extern __shared__ float smem[];
  const Tile t = tile_of(nrows_all, R, m, k);
  float* tab = smem;
  float* xs = smem + R * ks;
  stage_rows(a + t.r0 * k, t.nrows * k, k, ks, tab);
  stage_x(x + t.b0 * k, t.nx, xs);
  __syncthreads();
  for (int rr = threadIdx.x; rr < t.nrows; rr += blockDim.x) {
    const long long r = t.r0 + rr;
    const float* ar = tab + rr * ks;
    const float* xb = xs + (r / m - t.b0) * k;
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) acc = fmaf(ar[j], xb[j], acc);
    y[r] = acc;
  }
}

// y = (A_hi x) + (A_lo x): both tables in one pass sharing x, the two
// products summed separately and added at the end as _mv2_kernel does.
__global__ void __launch_bounds__(kMaxThreads)
    block_mv2_kernel(const float* __restrict__ a_hi,
                     const float* __restrict__ a_lo,
                     const float* __restrict__ x, float* __restrict__ y,
                     long long nrows_all, int m, int k, int ks, int R) {
  extern __shared__ float smem[];
  const Tile t = tile_of(nrows_all, R, m, k);
  float* th = smem;
  float* tl = smem + R * ks;
  float* xs = smem + 2 * R * ks;
  stage_rows(a_hi + t.r0 * k, t.nrows * k, k, ks, th);
  stage_rows(a_lo + t.r0 * k, t.nrows * k, k, ks, tl);
  stage_x(x + t.b0 * k, t.nx, xs);
  __syncthreads();
  for (int rr = threadIdx.x; rr < t.nrows; rr += blockDim.x) {
    const long long r = t.r0 + rr;
    const float* hr = th + rr * ks;
    const float* lr = tl + rr * ks;
    const float* xb = xs + (r / m - t.b0) * k;
    float acc_hi = 0.0f, acc_lo = 0.0f;
    for (int j = 0; j < k; ++j) {
      acc_hi = fmaf(hr[j], xb[j], acc_hi);
      acc_lo = fmaf(lr[j], xb[j], acc_lo);
    }
    y[r] = acc_hi + acc_lo;
  }
}

// The three f32 products of the plain double-single apply, A_hi x_hi,
// A_hi x_lo and A_lo x_hi, from ONE pass over both tables (the caller sums
// them in f64; A_lo x_lo is below f64 roundoff of the result).  Each is a
// plain f32 fmaf chain, as _mv_ds_kernel's three _bmv reductions.
__global__ void __launch_bounds__(kMaxThreads)
    block_mv_ds_kernel(const float* __restrict__ a_hi,
                       const float* __restrict__ a_lo,
                       const float* __restrict__ x_hi,
                       const float* __restrict__ x_lo,
                       float* __restrict__ y_hh, float* __restrict__ y_hl,
                       float* __restrict__ y_lh, long long nrows_all, int m,
                       int k, int ks, int R) {
  extern __shared__ float smem[];
  const Tile t = tile_of(nrows_all, R, m, k);
  float* th = smem;
  float* tl = smem + R * ks;
  float* xh = smem + 2 * R * ks;
  float* xl = xh + t.nx;
  stage_rows(a_hi + t.r0 * k, t.nrows * k, k, ks, th);
  stage_rows(a_lo + t.r0 * k, t.nrows * k, k, ks, tl);
  stage_x(x_hi + t.b0 * k, t.nx, xh);
  stage_x(x_lo + t.b0 * k, t.nx, xl);
  __syncthreads();
  for (int rr = threadIdx.x; rr < t.nrows; rr += blockDim.x) {
    const long long r = t.r0 + rr;
    const float* hr = th + rr * ks;
    const float* lr = tl + rr * ks;
    const long long xo = (r / m - t.b0) * k;
    float hh = 0.0f, hl = 0.0f, lh = 0.0f;
    for (int j = 0; j < k; ++j) {
      const float ah = hr[j], xhj = xh[xo + j];
      hh = fmaf(ah, xhj, hh);
      hl = fmaf(ah, xl[xo + j], hl);
      lh = fmaf(lr[j], xhj, lh);
    }
    y_hh[r] = hh;
    y_hl[r] = hl;
    y_lh[r] = lh;
  }
}

// Compensated double-single product: (y_hi, y_lo) with
// y_hi + y_lo ~ (A_hi + A_lo)(x_hi + x_lo) to ~2^-45 of sum_j |a_ij x_j|.
// The dominant products a_hi * x_hi are split exactly (two_prod through one
// fused multiply-add) and summed with two_sum error capture, column by
// column as in the Pallas kernel.  Every add, subtract and multiply is an
// explicitly rounded intrinsic, so nvcc cannot contract any of them into an
// FMA, which would silently drop the error terms (the failure the reference
// hit on its interpret path, pallas_mv.py:146-154,191-200).  Build without
// --use_fast_math.
__global__ void __launch_bounds__(kMaxThreads)
    block_mv_comp_kernel(const float* __restrict__ a_hi,
                         const float* __restrict__ a_lo,
                         const float* __restrict__ x_hi,
                         const float* __restrict__ x_lo,
                         float* __restrict__ y_hi, float* __restrict__ y_lo,
                         long long nrows_all, int m, int k, int ks, int R) {
  extern __shared__ float smem[];
  const Tile t = tile_of(nrows_all, R, m, k);
  float* th = smem;
  float* tl = smem + R * ks;
  float* xh = smem + 2 * R * ks;
  float* xl = xh + t.nx;
  stage_rows(a_hi + t.r0 * k, t.nrows * k, k, ks, th);
  stage_rows(a_lo + t.r0 * k, t.nrows * k, k, ks, tl);
  stage_x(x_hi + t.b0 * k, t.nx, xh);
  stage_x(x_lo + t.b0 * k, t.nx, xl);
  __syncthreads();
  for (int rr = threadIdx.x; rr < t.nrows; rr += blockDim.x) {
    const long long r = t.r0 + rr;
    const float* hr = th + rr * ks;
    const float* lr = tl + rr * ks;
    const long long xo = (r / m - t.b0) * k;
    float s = 0.0f, sl = 0.0f;
    for (int j = 0; j < k; ++j) {
      const float ah = hr[j], al = lr[j];
      const float xhj = xh[xo + j], xlj = xl[xo + j];
      // two_prod: p + err == ah * xhj exactly
      const float p = __fmul_rn(ah, xhj);
      const float err = __fmaf_rn(ah, xhj, -p);
      const float small =
          __fadd_rn(__fadd_rn(__fmul_rn(ah, xlj), __fmul_rn(al, xhj)), err);
      // two_sum(s, p)
      const float tt = __fadd_rn(s, p);
      const float bb = __fsub_rn(tt, s);
      const float e =
          __fadd_rn(__fsub_rn(s, __fsub_rn(tt, bb)), __fsub_rn(p, bb));
      s = tt;
      sl = __fadd_rn(sl, __fadd_rn(e, small));
    }
    y_hi[r] = s;
    y_lo[r] = sl;
  }
}

// -- split-k variants ---------------------------------------------------------
//
//   nstt_block_mv_splitk_{f32,bf16}  <- _mv_kernel_splitk      (:305)
//   nstt_block_mv2_splitk_f32        <- _mv2_kernel_splitk     (:358)
//   nstt_block_mv_comp_splitk_f32    <- _mv_comp_kernel_splitk (:397)
//
// The table arrives as ns <= kMaxSplit consecutive-tile sub-tables (global
// tile i*ns+j is tile i of sub-table j; the wrapper zero-pads the block count
// to a whole number of groups), each (nsub, m, k) row-major, passed by value
// as an array of pointers.  The real blocks of each sub-table are a prefix
// of it; the kernels neither load nor compute the rows of the zero pad.
// Bound: the bytes of the nblk real blocks (and x, y) / 3.35 TB/s, as for
// the unsplit kernels.
//
// Design.  A CTA owns the same stretch of R sub-table rows [r0, r0 + R) in
// EVERY sub-table.  Its copy loop reads one 16-byte vector from each of the
// ns sub-tables into registers before it stores any of them to shared
// memory, so ns independent table streams are in flight per CTA (what a
// split buys on Hopper; the TPU kernel instead keeps ns block DMAs in
// flight per sequential grid step).  Each thread then computes output rows
// in the unsplit kernel's column order -- the same fmaf chain, or the same
// two_prod/two_sum chain -- so a split-k result is bitwise equal to the
// unsplit kernel's on the same table.  x is read straight from global
// memory (L2-resident, a few MB).

constexpr int kMaxSplit = 8;

struct SubTables {
  const void* p[kMaxSplit];
};

// Entries of the real rows of each sub-table (its real blocks are a prefix
// of it), computed on the host: the kernels compare against them and do no
// integer division for the pad.
struct SplitReal {
  long long n[kMaxSplit];
};

// Copy count entries at element offset off of each of the NS sub-tables
// into dst as rows of k entries at row stride ks, sub-table j at
// dst + j * jstride, loading only the entries of real rows (a 16-byte vector
// that straddles the end of the real rows is loaded whole: it lies inside
// the sub-table).  All sub-tables share their base alignment mod 16 (the
// wrapper checks 16-byte aligned bases), so they share the unaligned head.
// NS is a compile-time constant: j indexes the by-value pointer array with
// compile-time indices only (a run-time index would put the kernel
// parameters in local memory), and a thread holds NS vectors, not
// kMaxSplit.
template <typename T, int NS>
__device__ __forceinline__ void stage_rows_split(
    const SubTables& subs, const SplitReal& real, long long off, int count,
    int k, int ks, int jstride, float* __restrict__ dst) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(static_cast<const T*>(subs.p[0]) + off);
  int head = static_cast<int>(((16 - (addr & 15)) & 15) / sizeof(T));
  if (head > count) head = count;
  const int nvec = (count - head) / V;
  const int tail0 = head + nvec * V;
  // head and tail, one entry per thread
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const T* src = static_cast<const T*>(subs.p[j]) + off;
    float* d = dst + j * jstride;
    const long long l = real.n[j] - off;  // real entries in this stretch
    const int lim = static_cast<int>(l < 0 ? 0 : (l > count ? count : l));
    const int hj = head < lim ? head : lim;
    for (int c = threadIdx.x; c < hj; c += blockDim.x)
      d[(c / k) * ks + c % k] = to_f32(src[c]);
    for (int c = tail0 + threadIdx.x; c < lim; c += blockDim.x)
      d[(c / k) * ks + c % k] = to_f32(src[c]);
  }
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int e0 = head + i * V;
    const long long pos = off + e0;
    uint4 w[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (pos < real.n[j]) {
        const T* src = static_cast<const T*>(subs.p[j]) + off + head;
        w[j] = __ldg(reinterpret_cast<const uint4*>(src) + i);
      }
    }
    const int row0 = e0 / k, col0 = e0 - row0 * k;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (pos < real.n[j]) {
        float v[V];
        unpack<T>(w[j], v);
        int row = row0, col = col0;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          dst[j * jstride + row * ks + col] = v[q];
          if (++col == k) {
            col = 0;
            ++row;
          }
        }
      }
    }
  }
}

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

__device__ __forceinline__ SplitTile split_tile_of(long long nsub_rows,
                                                   int R) {
  SplitTile t;
  t.r0 = static_cast<long long>(blockIdx.x) * R;
  long long r1 = t.r0 + R;
  if (r1 > nsub_rows) r1 = nsub_rows;
  t.nrows = static_cast<int>(r1 - t.r0);
  return t;
}

template <typename T, int NS>
__global__ void __launch_bounds__(kMaxThreads)
    block_mv_splitk_kernel(SubTables subs, SplitReal real,
                           const float* __restrict__ x, float* __restrict__ y,
                           long long nsub_rows, long long nblk, int m, int k,
                           int ks, int R, int tile) {
  extern __shared__ float smem[];
  const SplitTile t = split_tile_of(nsub_rows, R);
  stage_rows_split<T, NS>(subs, real, t.r0 * k, t.nrows * k, k, ks, R * ks,
                          smem);
  __syncthreads();
  for (int e = threadIdx.x; e < NS * t.nrows; e += blockDim.x) {
    const int j = e / t.nrows, rr = e - j * t.nrows;
    const long long g = global_row(t.r0 + rr, j, NS, m, tile, nblk);
    if (g < 0) continue;
    const float* ar = smem + (j * R + rr) * ks;
    const float* xb = x + (g / m) * k;
    float acc = 0.0f;
    for (int c = 0; c < k; ++c) acc = fmaf(ar[c], __ldg(xb + c), acc);
    y[g] = acc;
  }
}

template <int NS>
__global__ void __launch_bounds__(kMaxThreads)
    block_mv2_splitk_kernel(SubTables his, SubTables los, SplitReal real,
                            const float* __restrict__ x, float* __restrict__ y,
                            long long nsub_rows, long long nblk, int m, int k,
                            int ks, int R, int tile) {
  extern __shared__ float smem[];
  const SplitTile t = split_tile_of(nsub_rows, R);
  float* th = smem;
  float* tl = smem + NS * R * ks;
  stage_rows_split<float, NS>(his, real, t.r0 * k, t.nrows * k, k, ks,
                              R * ks, th);
  stage_rows_split<float, NS>(los, real, t.r0 * k, t.nrows * k, k, ks,
                              R * ks, tl);
  __syncthreads();
  for (int e = threadIdx.x; e < NS * t.nrows; e += blockDim.x) {
    const int j = e / t.nrows, rr = e - j * t.nrows;
    const long long g = global_row(t.r0 + rr, j, NS, m, tile, nblk);
    if (g < 0) continue;
    const float* hr = th + (j * R + rr) * ks;
    const float* lr = tl + (j * R + rr) * ks;
    const float* xb = x + (g / m) * k;
    float acc_hi = 0.0f, acc_lo = 0.0f;
    for (int c = 0; c < k; ++c) {
      const float xc = __ldg(xb + c);
      acc_hi = fmaf(hr[c], xc, acc_hi);
      acc_lo = fmaf(lr[c], xc, acc_lo);
    }
    y[g] = acc_hi + acc_lo;
  }
}

// Same rounded-intrinsic recurrence as block_mv_comp_kernel.
template <int NS>
__global__ void __launch_bounds__(kMaxThreads)
    block_mv_comp_splitk_kernel(SubTables his, SubTables los, SplitReal real,
                                const float* __restrict__ x_hi,
                                const float* __restrict__ x_lo,
                                float* __restrict__ y_hi,
                                float* __restrict__ y_lo, long long nsub_rows,
                                long long nblk, int m, int k, int ks, int R,
                                int tile) {
  extern __shared__ float smem[];
  const SplitTile t = split_tile_of(nsub_rows, R);
  float* th = smem;
  float* tl = smem + NS * R * ks;
  stage_rows_split<float, NS>(his, real, t.r0 * k, t.nrows * k, k, ks,
                              R * ks, th);
  stage_rows_split<float, NS>(los, real, t.r0 * k, t.nrows * k, k, ks,
                              R * ks, tl);
  __syncthreads();
  for (int e = threadIdx.x; e < NS * t.nrows; e += blockDim.x) {
    const int j = e / t.nrows, rr = e - j * t.nrows;
    const long long g = global_row(t.r0 + rr, j, NS, m, tile, nblk);
    if (g < 0) continue;
    const float* hr = th + (j * R + rr) * ks;
    const float* lr = tl + (j * R + rr) * ks;
    const long long xo = (g / m) * k;
    float s = 0.0f, sl = 0.0f;
    for (int c = 0; c < k; ++c) {
      const float ah = hr[c], al = lr[c];
      const float xhj = __ldg(x_hi + xo + c), xlj = __ldg(x_lo + xo + c);
      const float p = __fmul_rn(ah, xhj);
      const float err = __fmaf_rn(ah, xhj, -p);
      const float small =
          __fadd_rn(__fadd_rn(__fmul_rn(ah, xlj), __fmul_rn(al, xhj)), err);
      const float tt = __fadd_rn(s, p);
      const float bb = __fsub_rn(tt, s);
      const float e2 =
          __fadd_rn(__fsub_rn(s, __fsub_rn(tt, bb)), __fsub_rn(p, bb));
      s = tt;
      sl = __fadd_rn(sl, __fadd_rn(e2, small));
    }
    y_hi[g] = s;
    y_lo[g] = sl;
  }
}

struct Launch {
  int R = 0;        // rows per CTA
  int threads = 0;  // threads per CTA
  unsigned int grid = 0;
  size_t smem = 0;  // dynamic shared memory bytes
};

// Largest row stretch whose ntab x ns sub-table tiles fit the budget.
Launch plan_splitk(long long nsub_rows, int ks, int ntab, int ns) {
  Launch L;
  const long long per_row = 4LL * ntab * ns * ks;
  long long R = kSmemBudget / per_row;
  if (R > kMaxThreads) R = kMaxThreads;
  if (R < 1) return L;
  L.R = static_cast<int>(R);
  const long long work = static_cast<long long>(ns) * R;
  L.threads = work >= kMaxThreads ? kMaxThreads
                                  : static_cast<int>((work + 31) / 32 * 32);
  L.smem = static_cast<size_t>(per_row * R);
  L.grid = static_cast<unsigned int>((nsub_rows + R - 1) / R);
  return L;
}

inline bool bad_split(int ns, long long nblk, long long nsub, int m, int k,
                      int tile) {
  return ns < 1 || ns > kMaxSplit || nblk < 0 || m <= 0 || k <= 0 ||
         tile <= 0 || nsub % tile != 0 || nblk > ns * nsub;
}

SubTables sub_tables(const void* const* p, int ns) {
  SubTables s;
  for (int j = 0; j < kMaxSplit; ++j) s.p[j] = j < ns ? p[j] : p[0];
  return s;
}

// Calls f(std::integral_constant<int, ns>()) for ns in 1..kMaxSplit: the
// split-k kernels are instantiated per sub-table count.
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

// Largest row tile whose ntab table tiles (row stride ks) and nxv x stages
// fit the shared-memory budget.
Launch plan(long long nrows_all, int m, int k, int ks, int ntab, int nxv) {
  Launch L;
  for (int R = kMaxThreads; R >= 1; R -= (R > 32 ? 32 : 1)) {
    const long long xblocks = (R - 1) / m + 2;
    const long long bytes =
        4LL * (static_cast<long long>(ntab) * R * ks + nxv * xblocks * k);
    if (bytes <= kSmemBudget) {
      L.R = R;
      L.threads = R < 32 ? 32 : ((R + 31) / 32) * 32;
      L.smem = static_cast<size_t>(bytes);
      L.grid = static_cast<unsigned int>((nrows_all + R - 1) / R);
      return L;
    }
  }
  return L;
}

inline bool bad_shape(long long nblk, int m, int k) {
  return nblk < 0 || m <= 0 || k <= 0;
}

inline int row_stride(int k) { return k | 1; }

}  // namespace

extern "C" {

int nstt_block_mv_f32(const float* a, const float* x, float* y,
                      long long nblk, int m, int k, void* stream) {
  if (bad_shape(nblk, m, k)) return static_cast<int>(cudaErrorInvalidValue);
  const long long nrows = nblk * m;
  if (nrows == 0) return 0;
  const int ks = row_stride(k);
  const Launch L = plan(nrows, m, k, ks, 1, 1);
  if (L.R == 0) return static_cast<int>(cudaErrorInvalidValue);
  block_mv_kernel<float><<<L.grid, L.threads, L.smem,
                           static_cast<cudaStream_t>(stream)>>>(
      a, x, y, nrows, m, k, ks, L.R);
  return static_cast<int>(cudaGetLastError());
}

int nstt_block_mv_bf16(const void* a, const float* x, float* y,
                       long long nblk, int m, int k, void* stream) {
  if (bad_shape(nblk, m, k)) return static_cast<int>(cudaErrorInvalidValue);
  const long long nrows = nblk * m;
  if (nrows == 0) return 0;
  const int ks = row_stride(k);
  const Launch L = plan(nrows, m, k, ks, 1, 1);
  if (L.R == 0) return static_cast<int>(cudaErrorInvalidValue);
  block_mv_kernel<__nv_bfloat16><<<L.grid, L.threads, L.smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), x, y, nrows, m, k, ks, L.R);
  return static_cast<int>(cudaGetLastError());
}

int nstt_block_mv2_f32(const float* a_hi, const float* a_lo, const float* x,
                       float* y, long long nblk, int m, int k, void* stream) {
  if (bad_shape(nblk, m, k)) return static_cast<int>(cudaErrorInvalidValue);
  const long long nrows = nblk * m;
  if (nrows == 0) return 0;
  const int ks = row_stride(k);
  const Launch L = plan(nrows, m, k, ks, 2, 1);
  if (L.R == 0) return static_cast<int>(cudaErrorInvalidValue);
  block_mv2_kernel<<<L.grid, L.threads, L.smem,
                     static_cast<cudaStream_t>(stream)>>>(
      a_hi, a_lo, x, y, nrows, m, k, ks, L.R);
  return static_cast<int>(cudaGetLastError());
}

int nstt_block_mv_ds_f32(const float* a_hi, const float* a_lo,
                         const float* x_hi, const float* x_lo, float* y_hh,
                         float* y_hl, float* y_lh, long long nblk, int m,
                         int k, void* stream) {
  if (bad_shape(nblk, m, k)) return static_cast<int>(cudaErrorInvalidValue);
  const long long nrows = nblk * m;
  if (nrows == 0) return 0;
  const int ks = row_stride(k);
  const Launch L = plan(nrows, m, k, ks, 2, 2);
  if (L.R == 0) return static_cast<int>(cudaErrorInvalidValue);
  block_mv_ds_kernel<<<L.grid, L.threads, L.smem,
                       static_cast<cudaStream_t>(stream)>>>(
      a_hi, a_lo, x_hi, x_lo, y_hh, y_hl, y_lh, nrows, m, k, ks, L.R);
  return static_cast<int>(cudaGetLastError());
}

int nstt_block_mv_comp_f32(const float* a_hi, const float* a_lo,
                           const float* x_hi, const float* x_lo, float* y_hi,
                           float* y_lo, long long nblk, int m, int k,
                           void* stream) {
  if (bad_shape(nblk, m, k)) return static_cast<int>(cudaErrorInvalidValue);
  const long long nrows = nblk * m;
  if (nrows == 0) return 0;
  const int ks = row_stride(k);
  const Launch L = plan(nrows, m, k, ks, 2, 2);
  if (L.R == 0) return static_cast<int>(cudaErrorInvalidValue);
  block_mv_comp_kernel<<<L.grid, L.threads, L.smem,
                         static_cast<cudaStream_t>(stream)>>>(
      a_hi, a_lo, x_hi, x_lo, y_hi, y_lo, nrows, m, k, ks, L.R);
  return static_cast<int>(cudaGetLastError());
}

// Split-k entry points: subs points at ns sub-table pointers (host memory),
// nblk is the real block count (rows of x and y), nsub the blocks of each
// sub-table (a multiple of tile).

int nstt_block_mv_splitk_f32(const void* const* subs, int ns, const float* x,
                             float* y, long long nblk, int m, int k,
                             long long nsub, int tile, void* stream) {
  if (bad_split(ns, nblk, nsub, m, k, tile))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblk == 0) return 0;
  const int ks = row_stride(k);
  const Launch L = plan_splitk(nsub * m, ks, 1, ns);
  if (L.R == 0) return static_cast<int>(cudaErrorInvalidValue);
  with_split(ns, [&](auto c) {
    block_mv_splitk_kernel<float, decltype(c)::value>
        <<<L.grid, L.threads, L.smem, static_cast<cudaStream_t>(stream)>>>(
            sub_tables(subs, ns), split_real(ns, nblk, m, k, tile), x, y,
            nsub * m, nblk, m, k, ks, L.R, tile);
  });
  return static_cast<int>(cudaGetLastError());
}

int nstt_block_mv_splitk_bf16(const void* const* subs, int ns, const float* x,
                              float* y, long long nblk, int m, int k,
                              long long nsub, int tile, void* stream) {
  if (bad_split(ns, nblk, nsub, m, k, tile))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblk == 0) return 0;
  const int ks = row_stride(k);
  const Launch L = plan_splitk(nsub * m, ks, 1, ns);
  if (L.R == 0) return static_cast<int>(cudaErrorInvalidValue);
  with_split(ns, [&](auto c) {
    block_mv_splitk_kernel<__nv_bfloat16, decltype(c)::value>
        <<<L.grid, L.threads, L.smem, static_cast<cudaStream_t>(stream)>>>(
            sub_tables(subs, ns), split_real(ns, nblk, m, k, tile), x, y,
            nsub * m, nblk, m, k, ks, L.R, tile);
  });
  return static_cast<int>(cudaGetLastError());
}

int nstt_block_mv2_splitk_f32(const void* const* his, const void* const* los,
                              int ns, const float* x, float* y,
                              long long nblk, int m, int k, long long nsub,
                              int tile, void* stream) {
  if (bad_split(ns, nblk, nsub, m, k, tile))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblk == 0) return 0;
  const int ks = row_stride(k);
  const Launch L = plan_splitk(nsub * m, ks, 2, ns);
  if (L.R == 0) return static_cast<int>(cudaErrorInvalidValue);
  with_split(ns, [&](auto c) {
    block_mv2_splitk_kernel<decltype(c)::value>
        <<<L.grid, L.threads, L.smem, static_cast<cudaStream_t>(stream)>>>(
            sub_tables(his, ns), sub_tables(los, ns),
            split_real(ns, nblk, m, k, tile), x, y, nsub * m, nblk, m, k, ks,
            L.R, tile);
  });
  return static_cast<int>(cudaGetLastError());
}

int nstt_block_mv_comp_splitk_f32(const void* const* his,
                                  const void* const* los, int ns,
                                  const float* x_hi, const float* x_lo,
                                  float* y_hi, float* y_lo, long long nblk,
                                  int m, int k, long long nsub, int tile,
                                  void* stream) {
  if (bad_split(ns, nblk, nsub, m, k, tile))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nblk == 0) return 0;
  const int ks = row_stride(k);
  const Launch L = plan_splitk(nsub * m, ks, 2, ns);
  if (L.R == 0) return static_cast<int>(cudaErrorInvalidValue);
  with_split(ns, [&](auto c) {
    block_mv_comp_splitk_kernel<decltype(c)::value>
        <<<L.grid, L.threads, L.smem, static_cast<cudaStream_t>(stream)>>>(
            sub_tables(his, ns), sub_tables(los, ns),
            split_real(ns, nblk, m, k, tile), x_hi, x_lo, y_hi, y_lo,
            nsub * m, nblk, m, k, ks, L.R, tile);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
