// Batched element-local matvec of the transient step, written for Hopper
// (sm_90a).  Counterpart of the Pallas kernel
//
//   nstt_local_mv_{f32,f64}  <- _matvec_kernel / batched_local_matvec
//                               (navier_stokes_tpu/ops/pallas_kernels.py:26-60)
//
// y[e, i] = sum_j A[e, i, j] u[e, j] over (ne, nout, nin) row-major element
// blocks and (ne, nin) element vectors, in the scalar type of its inputs:
// float, or double (the model's default; the H100 has native FP64 units).
// The Pallas kernel takes square blocks (nout = nin = nb) and tiles the
// element axis 256 elements per grid step and pads it; here nothing is
// padded, and a rectangular coupling (the dd solve's B and B^T,
// parallel/ddshard.py) is taken as it is.
//
// Bound: the block table is read once and every entry is used for one
// multiply-add, so the kernel is bound by device memory bandwidth,
// ne*nout*nin*sizeof(T) bytes / 3.35 TB/s (27 us for the 90 MB f32 mass table
// of the maxh=0.09 channel, 54 us for its f64 twin), far above the f32 or
// f64 operation time for those bytes.
//
// Design.  Viewed as ne * nout output rows, the table rows of any run of
// consecutive output rows are one contiguous stretch of memory, whatever the
// element boundaries.  A CTA owns kRows consecutive rows (fewer only where
// nin-wide rows would not fit 227 KB), one thread per row:
//   1. one thread starts ONE 1-D bulk asynchronous copy (cp.async.bulk,
//      bulk_copy.cuh) of the stretch's whole 16-byte units onto an mbarrier;
//      the rows land at stride nin, as they lie in memory.  The head before
//      the first 16-byte boundary (a view may start 4 or 8 bytes into one)
//      and the tail after the last whole unit are plain loads;
//   2. beside the copy, every thread stages its share of the u rows of the
//      elements the stretch touches, and arrives on the barrier (which
//      releases its stores); one wait covers table and u;
//   3. each thread sums its row in column order with fused multiply-adds
//      and writes it (coalesced).
// What bounds it: the table bytes; with one bulk copy per CTA the stream
// reaches 0.6-0.7 of the byte bound, and per-CTA latency (one stretch in
// flight per CTA, copy then arithmetic) holds it there.  Sweep of kRows
// (tools/sweep_redesign.py, random tables of the shapes of M_loc, A_cond
// and S_inv at maxh=0.09, summed; NVIDIA H100 80GB HBM3, 700 W): R = 32 /
// 64 / 128 took f32 0.0967 / 0.0969 / 0.0976 ms and f64 0.1585 / 0.1589 /
// 0.1599; in the same call the earlier design (per-thread 16-byte loads
// into an odd-stride tile, 48 KB per CTA) f32 0.1240 and f64 0.2647,
// torch.bmm 0.1327 and 0.1915.  Fixed: R = 32, the best in both types.
// Splitting a row over 2 lanes of a warp, combined by shuffles, measured
// 1-3% faster in f32 and about 1% in f64 on the transient tables
// (chip_smoke.py, same card), too little for its code: one thread per row.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() (or cudaErrorInvalidValue for shapes it does
// not take) so that the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kRows = 32;           // rows per CTA (tools/sweep_redesign.py)
static_assert(kRows % 32 == 0, "a CTA is whole warps, one thread per row");
constexpr int kSmemOptIn = 232448;  // 227 KB per CTA after opt-in
constexpr int kHeader = 128;        // the mbarrier ahead of the stretch
constexpr int kSlack = 16;          // room to shift the stretch (see below)

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// y[r] = sum_j a[r, j] * u[r / nout, j] for the R rows from blockIdx.x * R,
// thread t taking row t; a row is nin wide.
template <typename T>
__global__ void __launch_bounds__(kRows)
    local_mv_kernel(const T* __restrict__ a, const T* __restrict__ u,
                    T* __restrict__ y, long long nrows_all, int nout, int nin,
                    int R) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  long long r1 = r0 + R;
  if (r1 > nrows_all) r1 = nrows_all;
  const int nrows = static_cast<int>(r1 - r0);
  const long long e0 = r0 / nout;  // first element touched
  const int nu = static_cast<int>((r1 - 1) / nout - e0 + 1) * nin;
  const T* src = a + r0 * nin;
  const int count = nrows * nin;
  // The stretch src[0..count) is contiguous but starts wherever the table
  // (a view may start mid-allocation) and r0 * nin put it: the head up to
  // the first 16-byte boundary and the tail after the last whole 16-byte
  // unit are plain loads, the middle one bulk copy.  tab is shifted so that
  // tab + head is 16-byte aligned, as the copy's destination must be.
  constexpr int kSize = static_cast<int>(sizeof(T));
  const int misalign =
      static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
  int head = ((16 - misalign) & 15) / kSize;
  if (head > count) head = count;
  const int whole = ((count - head) * kSize & ~15) / kSize;
  T* tab = reinterpret_cast<T*>(smem_raw + kHeader +
                                ((16 - head * kSize) & 15));
  T* us = reinterpret_cast<T*>(smem_raw + kHeader + kSlack) +
          static_cast<long long>(R) * nin;
  if (threadIdx.x == 0) {
    mbar_init(bar, blockDim.x);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0 && whole > 0) {
    const uint32_t bytes = static_cast<uint32_t>(whole * kSize);
    mbar_expect_tx(bar, bytes);
    bulk_copy(tab + head, src + head, bytes, bar);
  }
  for (int c = threadIdx.x; c < head; c += blockDim.x)
    tab[c] = __ldg(src + c);
  for (int c = head + whole + threadIdx.x; c < count; c += blockDim.x)
    tab[c] = __ldg(src + c);
  for (int e = threadIdx.x; e < nu; e += blockDim.x)
    us[e] = __ldg(u + e0 * nin + e);
  mbar_arrive(bar);   // releases this thread's stores
  mbar_wait(bar, 0);  // every store made, every copied byte landed
  const int rr = threadIdx.x;
  if (rr < nrows) {
    const T* ar = tab + rr * nin;
    const T* ub = us + ((r0 + rr) / nout - e0) * nin;
    T acc = 0;
    for (int j = 0; j < nin; ++j) acc = fma_t(ar[j], ub[j], acc);
    y[r0 + rr] = acc;
  }
}

struct Launch {
  int R = 0;        // rows per CTA
  int threads = 0;  // threads per CTA
  unsigned int grid = 0;
  size_t smem = 0;  // dynamic shared memory bytes
};

// kRows rows per CTA, or the most below it whose stretch and u rows fit
// opt-in shared memory.
template <typename T>
Launch plan(long long nrows_all, int nout, int nin) {
  Launch L;
  for (int R = kRows; R >= 1; --R) {
    const long long ublocks = (R - 1) / nout + 2;
    const long long bytes =
        kHeader + kSlack + static_cast<long long>(sizeof(T)) *
                               (static_cast<long long>(R) + ublocks) * nin;
    if (bytes <= kSmemOptIn) {
      L.R = R;
      L.threads = (R + 31) / 32 * 32;
      L.smem = static_cast<size_t>(bytes);
      L.grid = static_cast<unsigned int>((nrows_all + R - 1) / R);
      return L;
    }
  }
  return L;
}

template <typename T>
int launch_local_mv(const T* a, const T* u, T* y, long long ne, int nout,
                    int nin, void* stream) {
  if (ne < 0 || nout <= 0 || nin <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nrows = ne * nout;
  if (nrows == 0) return 0;
  const Launch L = plan<T>(nrows, nout, nin);
  if (L.R == 0) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      local_mv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemOptIn);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  local_mv_kernel<T><<<L.grid, L.threads, L.smem,
                       static_cast<cudaStream_t>(stream)>>>(a, u, y, nrows,
                                                            nout, nin, L.R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int nstt_local_mv_f32(const float* a, const float* u, float* y, long long ne,
                      int nout, int nin, void* stream) {
  return launch_local_mv<float>(a, u, y, ne, nout, nin, stream);
}

int nstt_local_mv_f64(const double* a, const double* u, double* y,
                      long long ne, int nout, int nin, void* stream) {
  return launch_local_mv<double>(a, u, y, ne, nout, nin, stream);
}

}  // extern "C"
