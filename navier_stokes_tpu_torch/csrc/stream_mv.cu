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
//   rows   the CTA's row count R is an argument, from a few rows up to what
//          opt-in shared memory holds (227 KB): small R means many resident
//          CTAs per SM whose copies and arithmetic overlap by scheduling,
//          large R means long copies per CTA.  Per-thread 16-byte loads
//          into an odd-stride tile, as block_mv.
//   mega   one CTA takes its whole stretch with ONE 1-D bulk asynchronous
//          copy (cp.async.bulk, completing on an mbarrier), started by one
//          thread: the copy engine computes the addresses, no thread spends
//          registers or cycles on the copy.  The rows land at stride
//          k (a 2-way bank conflict for k = 54 with one thread per row).
//          The x of the touched blocks is staged by all threads with plain
//          loads, in flight beside the bulk copy.
//   ring   a persistent grid (a few CTAs per SM) walks the tiles with a
//          ring of nbuf shared-memory stages, one mbarrier per stage, each
//          stage filled by one bulk asynchronous copy: the copy of tile
//          i + nbuf is started as soon as every thread has finished tile i
//          (a __syncthreads), so copies and arithmetic overlap inside the
//          CTA.
//   soa    one thread per element e: every load of A[i, j, e] and every
//          store of y[i, e] is coalesced across the warp with no shared
//          memory; the element's u stays in registers, and the rows i are
//          cut into chunks over blockIdx.y so that the grid fills the card
//          in one wave.
//
// Every kernel sums a row in column order with one fmaf per entry, the
// accumulation order of block_mv: on the same table the results are bitwise
// equal to block_mv's.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() (or cudaErrorInvalidValue for shapes it does
// not take) so that the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemDefault = 48 * 1024;  // dynamic shared memory, no opt-in
constexpr int kSmemOptIn = 232448;       // 227 KB per CTA after opt-in
constexpr int kSmemPerSm = 233472;       // 228 KB per SM, 1 KB per CTA kept
constexpr int kHeader = 128;             // mbarriers ahead of the stages
constexpr int kMaxStages = 8;
constexpr int kSoaMaxNb = 64;   // u entries one thread holds in registers
constexpr int kSoaThreads = 128;

// -- per-thread staged copy (rows) ---------------------------------------------

// Copy count contiguous table entries src[0..count) into dst as rows of k
// entries at row stride ks.  Coalesced 16-byte loads for the aligned middle,
// single loads for the unaligned head and the tail.
__device__ void stage_rows(const float* __restrict__ src, int count, int k,
                           int ks, float* __restrict__ dst) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  int head = static_cast<int>(((16 - (addr & 15)) & 15) / 4);
  if (head > count) head = count;
  const int nvec = (count - head) / 4;
  for (int e = threadIdx.x; e < head; e += blockDim.x)
    dst[(e / k) * ks + e % k] = src[e];
  const float4* pv = reinterpret_cast<const float4*>(src + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const float4 w = __ldg(pv + i);
    const float v[4] = {w.x, w.y, w.z, w.w};
    const int e0 = head + i * 4;
    int row = e0 / k, col = e0 - row * k;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      dst[row * ks + col] = v[q];
      if (++col == k) {
        col = 0;
        ++row;
      }
    }
  }
  for (int e = head + nvec * 4 + threadIdx.x; e < count; e += blockDim.x)
    dst[(e / k) * ks + e % k] = src[e];
}

// y[r] = sum_j a[r, j] * x[r / m, j] for the R rows from blockIdx.x * R:
// block_mv_kernel's body with R given by the caller.
__global__ void __launch_bounds__(kMaxThreads)
    block_mv_rows_kernel(const float* __restrict__ a,
                         const float* __restrict__ x, float* __restrict__ y,
                         long long nrows_all, int m, int k, int ks, int R) {
  extern __shared__ float smem[];
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  long long r1 = r0 + R;
  if (r1 > nrows_all) r1 = nrows_all;
  const int nrows = static_cast<int>(r1 - r0);
  const long long b0 = r0 / m;
  const int nx = static_cast<int>((r1 - 1) / m - b0 + 1) * k;
  float* tab = smem;
  float* xs = smem + R * ks;
  stage_rows(a + r0 * k, nrows * k, k, ks, tab);
  for (int e = threadIdx.x; e < nx; e += blockDim.x)
    xs[e] = __ldg(x + b0 * k + e);
  __syncthreads();
  for (int rr = threadIdx.x; rr < nrows; rr += blockDim.x) {
    const long long r = r0 + rr;
    const float* ar = tab + rr * ks;
    const float* xb = xs + (r / m - b0) * k;
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) acc = fmaf(ar[j], xb[j], acc);
    y[r] = acc;
  }
}

// -- bulk asynchronous copies (mega, ring) ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Announce bytes that the barrier's current phase waits for (no arrival).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival; releases this thread's earlier shared-memory stores to the
// threads that wait on the barrier.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk asynchronous copy global -> shared of bytes (a multiple of 16,
// both addresses 16-byte aligned), completing on the mbarrier.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

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

// The rows of one filled stage: one thread per row, everything from shared
// memory.
__device__ __forceinline__ void rows_from_stage(const float* __restrict__ tab,
                                                const float* __restrict__ xs,
                                                float* __restrict__ y,
                                                const Stretch& s, int m,
                                                int k) {
  for (int rr = threadIdx.x; rr < s.nrows; rr += blockDim.x) {
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
  rows_from_stage(tab, xs, y, s, m, k);
}

// A persistent CTA walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// of R rows each through a ring of nbuf stages.  Stage s = i % nbuf holds
// the CTA's i-th tile; its barrier completes one phase per fill, so the fill
// of the i-th tile is phase i / nbuf.  A stage is refilled only after the
// __syncthreads that follows the arithmetic on it: every thread has
// finished reading it.
__global__ void __launch_bounds__(256)
    block_mv_ring_kernel(const float* __restrict__ a,
                         const float* __restrict__ x, float* __restrict__ y,
                         long long nrows_all, int m, int k, int R, int nbuf,
                         int xstage, long long ntiles) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* tabs = reinterpret_cast<float*>(smem_raw + kHeader);
  const long long tstage = static_cast<long long>(R) * k;
  float* xss = tabs + nbuf * tstage;  // nbuf x stages of xstage floats
  const long long first = blockIdx.x, step = gridDim.x;
  const long long mine = (ntiles - first + step - 1) / step;

  auto fill = [&](long long i) {  // the CTA's i-th tile into stage i % nbuf
    const int s = static_cast<int>(i % nbuf);
    fill_stage(tabs + s * tstage, xss + s * xstage, a, x,
               stretch_of(first + i * step, R, nrows_all, m, k), k, bars + s);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < nbuf; ++s) mbar_init(bars + s, blockDim.x);
    mbar_init_fence();
  }
  __syncthreads();
  for (long long i = 0; i < nbuf && i < mine; ++i) fill(i);
  for (long long i = 0; i < mine; ++i) {
    const int s = static_cast<int>(i % nbuf);
    mbar_wait(bars + s, static_cast<uint32_t>((i / nbuf) & 1));
    rows_from_stage(tabs + s * tstage, xss + s * xstage, y,
                    stretch_of(first + i * step, R, nrows_all, m, k), m, k);
    __syncthreads();
    if (i + nbuf < mine) fill(i + nbuf);
  }
}

// -- structure of arrays ---------------------------------------------------------

// y[i, e] = sum_j a2[i, j, e] u[j, e] for the rows i of chunk blockIdx.y
// (ri rows each) and element e = blockIdx.x * blockDim.x + threadIdx.x.  The
// loops over j are unrolled to kSoaMaxNb with a uniform predicate, so that
// ur stays in registers for any nb <= kSoaMaxNb.
__global__ void __launch_bounds__(kSoaThreads, 4)
    block_mv_soa_kernel(const float* __restrict__ a2,
                        const float* __restrict__ u, float* __restrict__ y,
                        int nb, long long ne, int ri) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= ne) return;
  float ur[kSoaMaxNb];
#pragma unroll
  for (int j = 0; j < kSoaMaxNb; ++j)
    ur[j] = j < nb ? __ldg(u + j * ne + e) : 0.0f;
  const int i0 = blockIdx.y * ri;
  const int i1 = i0 + ri < nb ? i0 + ri : nb;
  for (int i = i0; i < i1; ++i) {
    const float* ai = a2 + static_cast<long long>(i) * nb * ne + e;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kSoaMaxNb; ++j)
      if (j < nb) acc = fmaf(__ldg(ai + j * ne), ur[j], acc);
    y[i * ne + e] = acc;
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
// touch: the rows kernel's tile, or one stage of mega and ring (ks = k).
inline long long rows_smem(int R, int m, int k, int ks) {
  const long long xblocks = (R - 1) / m + 2;
  return 4LL * (static_cast<long long>(R) * ks + xblocks * k);
}

}  // namespace

extern "C" {

// rows = 0: the largest multiple of 32 (below 32: any count) that fits 48 KB,
// at most 256 -- block_mv's choice.
int nstt_block_mv_rows_f32(const float* a, const float* x, float* y,
                           long long nblk, int m, int k, int rows,
                           void* stream) {
  if (bad_shape(nblk, m, k) || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nrows = nblk * m;
  if (nrows == 0) return 0;
  const int ks = k | 1;
  int R = rows;
  if (R == 0) {
    for (R = 256; R >= 1; R -= (R > 32 ? 32 : 1))
      if (rows_smem(R, m, k, ks) <= kSmemDefault) break;
    if (R < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = rows_smem(R, m, k, ks);
  if (smem > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      block_mv_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptIn);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int threads = R < kMaxThreads ? round32(R) : kMaxThreads;
  const unsigned int grid = static_cast<unsigned int>((nrows + R - 1) / R);
  block_mv_rows_kernel<<<grid, threads, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
      a, x, y, nrows, m, k, ks, R);
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

// rows: the rows of one stage (rows * k a multiple of 4, a 16-byte aligned);
// nbuf stages per CTA; as many CTAs per SM as fit, at most 4, and no more
// CTAs than tiles.
int nstt_block_mv_ring_f32(const float* a, const float* x, float* y,
                           long long nblk, int m, int k, int rows, int nbuf,
                           void* stream) {
  if (bad_shape(nblk, m, k) || rows < 1 || nbuf < 1 || nbuf > kMaxStages ||
      (static_cast<long long>(rows) * k) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nrows = nblk * m;
  if (nrows == 0) return 0;
  const long long smem = kHeader + nbuf * rows_smem(rows, m, k, k);
  if (smem > kSmemOptIn) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      block_mv_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptIn);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const long long ntiles = (nrows + rows - 1) / rows;
  long long per_sm = kSmemPerSm / (smem + 1024);
  if (per_sm > 4) per_sm = 4;
  if (per_sm < 1) per_sm = 1;
  long long grid = per_sm * sm_count();
  if (grid > ntiles) grid = ntiles;
  const int threads = rows < 256 ? round32(rows) : 256;
  block_mv_ring_kernel<<<static_cast<unsigned int>(grid), threads,
                         static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
      a, x, y, nrows, m, k, rows, nbuf, ((rows - 1) / m + 2) * k, ntiles);
  return static_cast<int>(cudaGetLastError());
}

// a2 (nb, nb, ne), u (nb, ne) -> y (nb, ne), nb <= kSoaMaxNb.  The rows are
// cut into as many chunks as keep the whole grid resident at once (one
// wave: no tail of a second, partly filled wave), at most one chunk per
// row.
int nstt_block_mv_soa_f32(const float* a2, const float* u, float* y, int nb,
                          long long ne, void* stream) {
  if (nb <= 0 || nb > kSoaMaxNb || ne < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ne == 0) return 0;
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, block_mv_soa_kernel,
                                                  kSoaThreads, 0);
    return n > 0 ? n : 1;
  }();
  const long long eblocks = (ne + kSoaThreads - 1) / kSoaThreads;
  long long chunks = static_cast<long long>(per_sm) * sm_count() / eblocks;
  if (chunks > nb) chunks = nb;
  if (chunks < 1) chunks = 1;
  const int ri = static_cast<int>((nb + chunks - 1) / chunks);
  const dim3 grid(static_cast<unsigned int>(eblocks),
                  static_cast<unsigned int>((nb + ri - 1) / ri));
  block_mv_soa_kernel<<<grid, kSoaThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a2, u, y, nb, ne,
                                                             ri);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
