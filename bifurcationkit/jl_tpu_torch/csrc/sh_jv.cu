// Fused Swift-Hohenberg J.v for Hopper (sm_90a), f32 and f64:
//
//   out_k = -(I + Lap)^2 v_k + (l + 2 nu u - 3 u^2) v_k,   k = 0..K-1
//
// on an (N, M) row-major grid (M contiguous), for a batch of K fields v_k
// that share one linearisation point u.  Both Laplacians use the Neumann
// edge-replicating closure: the first one replicates v at the border, the
// second one replicates w = (I + Lap) v, so w(-1) := w(0).  That is NOT the
// 13-point biharmonic with clamped v indices, which is wrong on the two
// outermost rows and columns.
//
// Replaces the TPU kernel bifurcationkit/jl_tpu/ops/pallas_sh.py::
// sh_jv_pallas (body _sh_jv_kernel), which needs N % block_rows == 0 and
// M % 128 == 0; this kernel takes any (N, M) and any K.
//
// Design: one block computes a TN x TM output tile of one field.  It loads
// the (TN+4) x (TM+4) halo of v (indices clamped to the domain) into shared
// memory, computes w on the (TN+2) x (TM+2) ring at indices clamped to the
// domain (the w-level closure), then applies the second stencil and the
// diagonal term.  Device memory sees one read of u and v and one write of
// the output; the intermediate w never leaves shared memory.
//
// Bound: bytes.  The function moves (1 + 2K) * N * M * sizeof(T) bytes for
// about 24 * K * N * M flops.  At the 151 x 100 flagship grid one f64 field
// is 121 KB, far below the 50 MB L2, so one launch there is set by launch
// latency, not by bandwidth.
//
// C interface for ctypes: each entry point launches on the given stream and
// returns cudaGetLastError() (0 = success).

#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;            // tile columns (contiguous axis)
constexpr int TN = 8;             // tile rows
constexpr int NT = TM * TN;       // threads per block, one per output
constexpr int HM = TM + 4;        // v halo tile
constexpr int HN = TN + 4;
constexpr int WM = TM + 2;        // w ring tile
constexpr int WN = TN + 2;

__device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

template <typename T>
__global__ void __launch_bounds__(NT)
sh_jv_kernel(const T* __restrict__ u, const T* __restrict__ v,
             const T* __restrict__ scal, T* __restrict__ out, int N, int M) {
  __shared__ T sv[HN][HM];
  __shared__ T sw[WN][WM];

  const int i0 = blockIdx.y * TN;
  const int j0 = blockIdx.x * TM;
  const long long plane = static_cast<long long>(N) * M;
  const T* vk = v + blockIdx.z * plane;
  T* ok = out + blockIdx.z * plane;
  const T l = scal[0];
  const T nu = scal[1];
  const T ihx2 = scal[2];
  const T ihy2 = scal[3];
  const int tid = threadIdx.y * TM + threadIdx.x;

  // 1. v on rows i0-2 .. i0+TN+1, cols j0-2 .. j0+TM+1, edge-replicated:
  //    sv[a][b] = v[clamp(i0-2+a)][clamp(j0-2+b)]
  for (int e = tid; e < HN * HM; e += NT) {
    const int a = e / HM;
    const int b = e - a * HM;
    const int gi = clampi(i0 - 2 + a, N);
    const int gj = clampi(j0 - 2 + b, M);
    sv[a][b] = vk[static_cast<long long>(gi) * M + gj];
  }
  __syncthreads();

  // 2. w = v + Lap v on rows i0-1 .. i0+TN, cols j0-1 .. j0+TM, each taken
  //    at its CLAMPED global index (the second Laplacian's closure).  The
  //    sv neighbours of a clamped index already hold the v-level closure.
  for (int e = tid; e < WN * WM; e += NT) {
    const int a = e / WM;
    const int b = e - a * WM;
    const int ci = clampi(i0 - 1 + a, N) - (i0 - 2);
    const int cj = clampi(j0 - 1 + b, M) - (j0 - 2);
    const T c = sv[ci][cj];
    sw[a][b] = c + (sv[ci - 1][cj] - T(2) * c + sv[ci + 1][cj]) * ihx2
                 + (sv[ci][cj - 1] - T(2) * c + sv[ci][cj + 1]) * ihy2;
  }
  __syncthreads();

  // 3. out = -(w + Lap w) + (l + 2 nu u - 3 u^2) v on the tile
  const int a = threadIdx.y;
  const int b = threadIdx.x;
  const int i = i0 + a;
  const int j = j0 + b;
  if (i < N && j < M) {
    const T c = sw[a + 1][b + 1];
    const T L1v = c
        + (sw[a][b + 1] - T(2) * c + sw[a + 2][b + 1]) * ihx2
        + (sw[a + 1][b] - T(2) * c + sw[a + 1][b + 2]) * ihy2;
    const long long idx = static_cast<long long>(i) * M + j;
    const T uu = u[idx];
    const T vv = sv[a + 2][b + 2];
    ok[idx] = -L1v + (l + T(2) * nu * uu - T(3) * uu * uu) * vv;
  }
}

template <typename T>
int launch(const T* u, const T* v, const T* scal, T* out, int N, int M, int K,
           void* stream) {
  const dim3 block(TM, TN, 1);
  const dim3 grid((M + TM - 1) / TM, (N + TN - 1) / TN, K);
  sh_jv_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      u, v, scal, out, N, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sh_jv_f32(const float* u, const float* v, const float* scal,
                         float* out, int N, int M, int K, void* stream) {
  return launch<float>(u, v, scal, out, N, M, K, stream);
}

extern "C" int sh_jv_f64(const double* u, const double* v, const double* scal,
                         double* out, int N, int M, int K, void* stream) {
  return launch<double>(u, v, scal, out, N, M, K, stream);
}
