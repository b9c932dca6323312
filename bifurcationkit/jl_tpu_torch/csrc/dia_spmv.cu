// DIA-format sparse matrix times vector for Hopper (sm_90a), f32 and f64:
//
//   out_b[i] = sum_k data[k, i] * v_b[i + off_k],   i = 0..n-1, b = 0..K-1
//
// with v_b zero outside [0, n): an entry data[k, i] whose column i + off_k
// falls outside the matrix (out of band) contributes nothing, whatever it
// holds, and v is never read there.  `data` is (ndiag, n) row-major, so
// data[k, i] is the entry in row i; the K vectors v_b (K, n) share it.
//
// Replaces the TPU kernel bifurcationkit/jl_tpu/ops/pallas_spmv.py::
// dia_spmv_pallas (body _dia_kernel), which pads n to a multiple of its
// 1024-row tile and loads, for each output tile, a window of
// 2 * ceil(max|off| / 1024) + 1 tiles of v.  With the offsets +-n of a
// two-component system (the Brusselator's u-v coupling) that window is the
// whole vector, so this kernel does not carry it over.
//
// Design: one thread per output row and vector.  The thread loops over the
// diagonals; its reads of data[k, i] are coalesced along the row index
// across the warp, and its reads of v[i + off_k] are contiguous across the
// warp for each k and go through the read-only data cache.  The offsets
// arrive by value as a kernel parameter (at most MAX_DIAGS of them), so
// they cost no device allocation and no copy.  Any n (no padding), any
// offsets, any K up to the grid's y limit.
//
// Bound: bytes.  The function moves (in-band entries of data + 2 K n)
// values for 2 flops per in-band entry and vector: under one flop per byte
// in f32 and f64, far below the card's balance point.
//
// C interface for ctypes: each entry point launches on the given stream and
// returns cudaGetLastError() (0 = success).  `offsets` is a host array.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIAGS = 32;
constexpr int NT = 256;            // threads per block, one per output row
constexpr int MAX_BATCH = 65535;   // gridDim.y limit

struct Offsets {
  int off[MAX_DIAGS];
};

template <typename T>
__global__ void __launch_bounds__(NT)
dia_spmv_kernel(const T* __restrict__ data,
                const __grid_constant__ Offsets offs, int ndiag,
                const T* __restrict__ v, T* __restrict__ out, int n) {
  const long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (i >= n) return;
  const long long plane = static_cast<long long>(blockIdx.y) * n;
  const T* vb = v + plane;
  T acc = T(0);
  for (int k = 0; k < ndiag; ++k) {
    const long long j = i + offs.off[k];
    if (j >= 0 && j < n) {
      acc += data[static_cast<long long>(k) * n + i] * __ldg(vb + j);
    }
  }
  out[plane + i] = acc;
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
  const dim3 grid((n + NT - 1) / NT, K, 1);
  dia_spmv_kernel<T><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      data, offs, ndiag, v, out, n);
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
