// DIA-format sparse matrix times vector for Hopper (sm_90a), f32 and f64:
//
//   out_b[i] = sum_k data[k, i] * v_b[i + off_k],   i = 0..n-1, b = 0..K-1
//
// with v_b zero outside [0, n): an entry data[k, i] whose column i + off_k
// falls outside the matrix (out of band) contributes nothing, whatever it
// holds, and neither it nor v is read there.  `data` is (ndiag, n)
// row-major, so data[k, i] is the entry in row i; the K vectors v_b (K, n)
// share it.
//
// Replaces the TPU kernel bifurcationkit/jl_tpu/ops/pallas_spmv.py::
// dia_spmv_pallas (body _dia_kernel), which pads n to a multiple of its
// 1024-row tile and loads, for each output tile, a window of
// 2 * ceil(max|off| / 1024) + 1 tiles of v.  With the offsets +-n of a
// two-component system (the Brusselator's u-v coupling) that window is the
// whole vector, so this kernel does not carry it over.
//
// Design: one thread per output row and vector.  Its reads of data[k, i]
// are coalesced along the row index across the warp, and its reads of
// v[i + off_k] are contiguous across the warp for each k and go through the
// read-only data cache.  The loop over the diagonals is unrolled over a
// compile-time bound (FEW_DIAGS = 8, or MAX_DIAGS = 32 for wider bands),
// each load predicated on its entry being in band, so all of a row's loads
// are in flight before the first multiply-add.  The offsets arrive by
// value as a kernel parameter (at most MAX_DIAGS of them), so they cost no
// device allocation and no copy.  Any n (no padding), any offsets, any K up
// to the grid's y limit.
//
// Bound: bytes.  The function moves (in-band entries of data + 2 K n)
// values for 2 flops per in-band entry and vector: under one flop per byte
// in f32 and f64, far below the card's balance point.  What bounds it in
// practice depends on n:
// - at the Brusselator path's n = 256 the bytes take nanoseconds and the
//   launch latency is the whole time; small n is spread over blocks of
//   SMALL_NT threads so that the rows land on several SMs, not one;
// - at 2^20 rows it streams, in blocks of NT threads, near the bytes
//   bound.
//
// C interface for ctypes: each entry point launches on the given stream and
// returns cudaGetLastError() (0 = success).  `offsets` is a host array.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIAGS = 32;
constexpr int FEW_DIAGS = 8;       // the band of most stencil jacobians
constexpr int NT = 256;            // threads per block, one per output row
constexpr int SMALL_NT = 64;       // ... when NT-thread blocks leave SMs idle
constexpr int MAX_BATCH = 65535;   // gridDim.y limit

struct Offsets {
  int off[MAX_DIAGS];
};

// D is the compile-time bound on ndiag: the loop over the diagonals is
// unrolled with constant indices, each load predicated on its entry being
// in band, so all of a row's loads are issued before the first multiply.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
dia_spmv_kernel(const T* __restrict__ data,
                const __grid_constant__ Offsets offs, int ndiag,
                const T* __restrict__ v, T* __restrict__ out, int n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long plane = static_cast<long long>(blockIdx.y) * n;
  const T* vb = v + plane;
  T a[D], b[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const long long j = i + offs.off[k];     // off[k] = 0 past ndiag
    const bool in_band = k < ndiag && j >= 0 && j < n;
    a[k] = in_band ? data[static_cast<long long>(k) * n + i] : T(0);
    b[k] = in_band ? __ldg(vb + j) : T(0);
  }
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < D; ++k) acc += a[k] * b[k];
  out[plane + i] = acc;
}

// The card's SMs, asked of the runtime once per process.  The count only
// sizes the grid, so a launch on a card of another size stays correct.
int sm_count() {
  static const int sms = [] {
    int device = 0, n = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    return n > 0 ? n : 1;
  }();
  return sms;
}

template <typename T>
int launch(const T* data, const int* offsets, int ndiag, const T* v, T* out,
           int n, int K, void* stream) {
  if (ndiag < 0 || ndiag > MAX_DIAGS || n < 0 || K < 0 || K > MAX_BATCH) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || K == 0) return static_cast<int>(cudaGetLastError());
  Offsets offs = {};
  for (int k = 0; k < ndiag; ++k) offs.off[k] = offsets[k];
  const long long big_blocks = (static_cast<long long>(n) + NT - 1) / NT;
  const int nt = big_blocks * K >= sm_count() ? NT : SMALL_NT;
  const dim3 grid((n + nt - 1) / nt, K, 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndiag <= FEW_DIAGS) {
    dia_spmv_kernel<T, FEW_DIAGS><<<grid, nt, 0, s>>>(data, offs, ndiag, v,
                                                      out, n);
  } else {
    dia_spmv_kernel<T, MAX_DIAGS><<<grid, nt, 0, s>>>(data, offs, ndiag, v,
                                                      out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dia_spmv_f32(const float* data, const int* offsets, int ndiag,
                            const float* v, float* out, int n, int K,
                            void* stream) {
  return launch<float>(data, offsets, ndiag, v, out, n, K, stream);
}

extern "C" int dia_spmv_f64(const double* data, const int* offsets, int ndiag,
                            const double* v, double* out, int n, int K,
                            void* stream) {
  return launch<double>(data, offsets, ndiag, v, out, n, K, stream);
}
