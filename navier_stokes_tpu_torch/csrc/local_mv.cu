// Batched element-local matvec of the transient step, written for Hopper
// (sm_90a).  Counterpart of the Pallas kernel
//
//   nstt_local_mv_{f32,f64}  <- _matvec_kernel / batched_local_matvec
//                               (navier_stokes_tpu/ops/pallas_kernels.py:26-60)
//
// y[e, i] = sum_j A[e, i, j] u[e, j] over (ne, nb, nb) row-major element
// blocks and (ne, nb) element vectors, in the scalar type of its inputs:
// float, or double (the model's default; the H100 has native FP64 units).
// The Pallas kernel tiles the element axis 256 elements per grid step and
// pads it; here nothing is padded.
//
// Bound: the block table is read once and every entry is used for one
// multiply-add, so the kernel is bound by device memory bandwidth,
// ne*nb*nb*sizeof(T) bytes / 3.35 TB/s (27 us for the 90 MB f32 mass table
// of the maxh=0.09 channel, 54 us for its f64 twin), far above the f32 or
// f64 operation time for those bytes.
//
// Design.  Viewed as ne * nb output rows, the table rows of any run of
// consecutive output rows are one contiguous stretch of memory, whatever the
// element boundaries.  A CTA owns R consecutive rows (R chosen on the host so
// that the stretch fits 48 KB of shared memory: 192 rows of 54 floats, 96
// rows of 54 doubles, 256 rows of the 4 x 4 pressure blocks, so that a small
// block never costs a CTA per element):
//   1. the CTA copies its rows' table stretch into shared memory with
//      coalesced 16-byte loads, one row per ks = nb | 1 scalars -- an odd
//      row stride, so that the threads of a warp, each reading its own row,
//      hit distinct banks;
//   2. it copies the u rows of the elements those rows belong to;
//   3. each thread computes one output row from shared memory, in column
//      order with fused multiply-adds, and writes it (coalesced).
// Overlapping the copy of one tile with the arithmetic of the previous one
// (cp.async or TMA double buffering) is later work.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() (or cudaErrorInvalidValue for shapes it does
// not take) so that the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSmemBudget = 48 * 1024;  // dynamic shared memory, no opt-in

// 16 bytes of table entries: 4 floats or 2 doubles
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ void unpack(float4 w, float* out) {
    out[0] = w.x;
    out[1] = w.y;
    out[2] = w.z;
    out[3] = w.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  static __device__ __forceinline__ void unpack(double2 w, double* out) {
    out[0] = w.x;
    out[1] = w.y;
  }
};

// Copy count contiguous table entries src[0..count) into dst as rows of k
// entries at row stride ks.  Coalesced 16-byte loads for the aligned middle,
// single loads for the unaligned head and the tail.
template <typename T>
__device__ void stage_rows(const T* __restrict__ src, int count, int k, int ks,
                           T* __restrict__ dst) {
  using V = Vec16<T>;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  int head = static_cast<int>(((16 - (addr & 15)) & 15) / sizeof(T));
  if (head > count) head = count;
  const int nvec = (count - head) / V::n;
  for (int e = threadIdx.x; e < head; e += blockDim.x)
    dst[(e / k) * ks + e % k] = src[e];
  const typename V::type* pv =
      reinterpret_cast<const typename V::type*>(src + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    T v[V::n];
    V::unpack(__ldg(pv + i), v);
    const int e0 = head + i * V::n;
    int row = e0 / k, col = e0 - row * k;
#pragma unroll
    for (int q = 0; q < V::n; ++q) {
      dst[row * ks + col] = v[q];
      if (++col == k) {
        col = 0;
        ++row;
      }
    }
  }
  for (int e = head + nvec * V::n + threadIdx.x; e < count; e += blockDim.x)
    dst[(e / k) * ks + e % k] = src[e];
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// y[r] = sum_j a[r, j] * u[r / nb, j]
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    local_mv_kernel(const T* __restrict__ a, const T* __restrict__ u,
                    T* __restrict__ y, long long nrows_all, int nb, int ks,
                    int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);
  T* us = tab + static_cast<long long>(R) * ks;
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  long long r1 = r0 + R;
  if (r1 > nrows_all) r1 = nrows_all;
  const int nrows = static_cast<int>(r1 - r0);
  const long long e0 = r0 / nb;  // first element touched
  const int nu = static_cast<int>((r1 - 1) / nb - e0 + 1) * nb;
  stage_rows(a + r0 * nb, nrows * nb, nb, ks, tab);
  for (int e = threadIdx.x; e < nu; e += blockDim.x)
    us[e] = __ldg(u + e0 * nb + e);
  __syncthreads();
  for (int rr = threadIdx.x; rr < nrows; rr += blockDim.x) {
    const long long r = r0 + rr;
    const T* ar = tab + rr * ks;
    const T* ub = us + (r / nb - e0) * nb;
    T acc = 0;
    for (int j = 0; j < nb; ++j) acc = fma_t(ar[j], ub[j], acc);
    y[r] = acc;
  }
}

struct Launch {
  int R = 0;        // rows per CTA
  int threads = 0;  // threads per CTA
  unsigned int grid = 0;
  size_t smem = 0;  // dynamic shared memory bytes
};

// Largest row tile whose table stretch (row stride ks) and u rows fit the
// shared-memory budget.
Launch plan(long long nrows_all, int nb, int ks, int itemsize) {
  Launch L;
  for (int R = kMaxThreads; R >= 1; R -= (R > 32 ? 32 : 1)) {
    const long long ublocks = (R - 1) / nb + 2;
    const long long bytes =
        static_cast<long long>(itemsize) *
        (static_cast<long long>(R) * ks + ublocks * nb);
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

template <typename T>
int launch_local_mv(const T* a, const T* u, T* y, long long ne, int nb,
                    void* stream) {
  if (ne < 0 || nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nrows = ne * nb;
  if (nrows == 0) return 0;
  const int ks = nb | 1;
  const Launch L = plan(nrows, nb, ks, static_cast<int>(sizeof(T)));
  if (L.R == 0) return static_cast<int>(cudaErrorInvalidValue);
  local_mv_kernel<T><<<L.grid, L.threads, L.smem,
                       static_cast<cudaStream_t>(stream)>>>(a, u, y, nrows,
                                                            nb, ks, L.R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int nstt_local_mv_f32(const float* a, const float* u, float* y, long long ne,
                      int nb, void* stream) {
  return launch_local_mv<float>(a, u, y, ne, nb, stream);
}

int nstt_local_mv_f64(const double* a, const double* u, double* y,
                      long long ne, int nb, void* stream) {
  return launch_local_mv<double>(a, u, y, ne, nb, stream);
}

}  // extern "C"
