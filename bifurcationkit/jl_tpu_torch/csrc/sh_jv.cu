// Fused Swift-Hohenberg J.v for Hopper (sm_90a), f32 and f64:
//
//   out_k = -(I + Lap)^2 v_k + (l + 2 nu u - 3 u^2) v_k,   k = 0..K-1
//
// on an (N, M) row-major grid (M contiguous), for a batch of K fields v_k
// that share one linearisation point u.  The closure of the rows is a
// template parameter (the columns keep the Neumann one, except in the
// periodic closure):
// - Neumann (SH2d-fronts): both Laplacians replicate the edge, the first
//   one v at the border, the second one w = (I + Lap) v, so w(-1) := w(0).
//   That is NOT the 13-point biharmonic with clamped v indices, which is
//   wrong on the two outermost rows and columns;
// - Periodic (the periodic SH2d of SH2d-fronts-cuda): every halo source
//   index wraps, i - 2 + a mod N and j - 2 + b mod M, and w needs no
//   replacement: with wrapped v indices the 13-point biharmonic is the
//   periodic operator;
// - Halo (a row block of a field partitioned by rows over ranks,
//   parallel/halo.py): v is the block's N = B rows, and the 2 rows above
//   and below it come from separate (K, 2, M) arrays `top` and `bot` (its
//   neighbours' edge rows), so no index of a row is clamped or wrapped.
//   `edges` flags the block's top (bit 0) and bottom (bit 1) as the
//   field's global edge: there the halo rows are the replicated edge row
//   and w past the edge is the edge's own w, as the Neumann closure does,
//   and that halo array is not read.  The whole field with both flags is
//   the Neumann closure.  The wrapper passes the halos as they arrive
//   instead of one (B + 4)-row field, which would cost a copy of the
//   block per product.
//
// Replaces the TPU kernel bifurcationkit/jl_tpu/ops/pallas_sh.py::
// sh_jv_pallas (body _sh_jv_kernel), which needs N % block_rows == 0 and
// M % 128 == 0; this kernel takes any (N, M) and any K.  The periodic
// closure computes the J.v that the JAX package's periodic model
// (jl_tpu/models/sh.py::swift_hohenberg_periodic_2d) takes by jvp of its
// residual; the halo closure is the row block of
// jl_tpu/parallel/halo.py::sharded_sh_jv, which is jnp under shard_map.
//
// Bound: bytes.  The function moves (1 + 2K) * N * M * sizeof(T) bytes for
// about 24 * K * N * M flops.  On the flagship's 151 x 100 grid that is
// 0.05-4.4 microseconds of HBM time (f32 K = 1 to f64 K = 60), so what
// bounds a call there is the launch, the latency of the first loads and,
// at LOBPCG's K = 60, how many fields each SM keeps in flight against the
// instructions and registers each output costs.  On the periodic model's
// 512 x 512 grid it is 1.9 microseconds (f64, K = 1) to 9.7 (f32, K = 15),
// where the halo's reads and HBM's rate set the time.
//
// Design: a block owns one TN x tm output tile (tm <= TM = 64 columns, one
// per thread in x, spread evenly over the tiles of a row: two tiles of 50
// at M = 100; each thread computes R rows of its column) and walks a chunk
// of kc of the K fields:
// - per block, once: each thread works out the clamped (Neumann), wrapped
//   (periodic) or halo-array (halo) source offsets of its share of the
//   (TN+4) x (tm+4) v halo (one modulo per point for the periodic closure),
//   and keeps them in registers with the diagonal coefficient
//   l + 2 nu u - 3 u^2 of its R outputs.  u is read once per block, not
//   once per field;
// - per field: the halo goes through a ring of STAGES shared-memory
//   buffers.  While the block computes field k, cp.async (Hopper's
//   asynchronous global-to-shared copy) fills the buffers of the next
//   STAGES - 1 fields, so the copies overlap the arithmetic.  The clamped
//   addresses are per element, which rules out TMA's zero-filled boxes at
//   the edges; each thread copies its elements one by one from its
//   precomputed offsets.  One barrier per field;
// - the stencils run in registers: each thread slides a window down its R
//   rows and computes w = (I + Lap) v at its column and at the columns on
//   either side from the halo, so w never exists in memory.  With the
//   Neumann closure a neighbour of w outside the domain is w at the
//   centre (the second Laplacian's closure: w(-1) := w(0));
// - grid: R = 4 (TN = 16-row tiles; at M = 100 two tiles of 50 columns
//   read (16 + 4) x (50 + 4) halo points for 16 x 50 outputs, 1.35x, and
//   1.43x over the 151 rows with the ragged last tile) when the tiles times
//   K fill the SMs, otherwise R = 1 (TN = 4-row tiles, as at the flagship's
//   K = 1) so that a small grid still spreads over more SMs.  The chunk kc
//   is the fewest fields per block that fit the grid into one wave of
//   resident blocks (the occupancy the runtime reports), so no tail wave
//   follows.
// Device memory sees one read of v, one read of u per block and one write
// of the output.
//
// C interface for ctypes: each entry point launches on the given stream and
// returns cudaGetLastError() (0 = success).

#include <cuda_runtime.h>

namespace {

constexpr int TX = 64;             // threads in x = tile columns
constexpr int TY = 4;              // threads in y
constexpr int NT = TX * TY;        // threads per block
constexpr int BIG_R = 4;           // rows per thread: 16 x 64 tiles
constexpr int SMALL_R = 1;         // ... 4 x 64 tiles for small grids
constexpr int STAGES = 3;          // halo buffers: fields in flight + 1
constexpr int MAX_BATCH = 65535;   // gridDim.z limit

// The closure of the rows (a template parameter)
constexpr int NEUMANN = 0;
constexpr int PERIODIC = 1;
constexpr int HALO = 2;
// halo closure: the block's top / bottom is the field's global edge
constexpr int TOP_EDGE = 1;
constexpr int BOTTOM_EDGE = 2;

template <int R>
struct Tile {
  static constexpr int TN = TY * R, TM = TX;
  static constexpr int HN = TN + 4, HM = TM + 4;      // v halo
  static constexpr int HALO = HN * HM;
  static constexpr int HQ = (HALO + NT - 1) / NT;     // halo points a thread
};

__device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// i mod n in [0, n) for any i >= -2 and n >= 1 (a halo index)
__device__ __forceinline__ int wrapi(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// The halo's source index along an axis of n points (columns, and the
// rows of the Neumann and periodic closures).
template <int C>
__device__ __forceinline__ int source(int i, int n) {
  return C == PERIODIC ? wrapi(i, n) : clampi(i, n);
}

// Halo closure: the array (0 = the block v, 1 = top, 2 = bot) and row in
// it of the block's row i, for -2 <= i < n + 2 + TN.  At a flagged edge
// the row past it is the edge row; rows past the bottom halo feed only
// outputs past the block, which are not stored, and read its last row.
__device__ __forceinline__ int halo_row(int i, int n, int edges, int& sel) {
  if (i < 0) {
    sel = (edges & TOP_EDGE) ? 0 : 1;
    return (edges & TOP_EDGE) ? 0 : i + 2;
  }
  if (i >= n) {
    sel = (edges & BOTTOM_EDGE) ? 0 : 2;
    return (edges & BOTTOM_EDGE) ? n - 1 : min(i - n, 1);
  }
  sel = 0;
  return i;
}

// Row and column of the first element of a thread in a W-wide row-major
// tile, and the step by NT elements: no division at run time.
template <int W>
__device__ __forceinline__ void first(int tid, int& a, int& b) {
  a = 0;
  b = tid;
  while (b >= W) {
    b -= W;
    ++a;
  }
}

template <int W>
__device__ __forceinline__ void next(int& a, int& b) {
  a += NT / W;
  b += NT % W;
  if (b >= W) {
    b -= W;
    ++a;
  }
}

template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(s), "l"(gmem), "n"(sizeof(T)) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T, int R, int C>
__global__ void __launch_bounds__(NT, 2)
sh_jv_kernel(const T* __restrict__ u, const T* __restrict__ v,
             const T* __restrict__ top, const T* __restrict__ bot,
             const T* __restrict__ scal, T* __restrict__ out, int N, int M,
             int K, int kc, int tm, int edges) {
  using G = Tile<R>;
  __shared__ T sv[STAGES][G::HALO];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int i0 = blockIdx.y * G::TN;
  const int j0 = blockIdx.x * tm;       // tm <= TM columns of this tile
  const int k0 = blockIdx.z * kc;
  const int k1 = min(K, k0 + kc);
  const long long plane = static_cast<long long>(N) * M;
  const long long hplane = 2LL * M;     // halo closure: top, bot

  // Sources of this thread's halo points in a field, clamped to the domain
  // or wrapped around it (the v-level closure), or -1 past the halo's
  // TN + 4 rows and tm + 4 columns.  sv[.][tid + q NT] is
  // v[source(i0-2+a)][source(j0-2+b)]; with the halo closure, the row is
  // in the array sel[q] (v, top or bot).
  long long src[G::HQ];
  int sel[G::HQ];
  {
    int a, b;
    first<G::HM>(tid, a, b);
#pragma unroll
    for (int q = 0; q < G::HQ; ++q) {
      sel[q] = 0;
      if (a < G::HN && b < tm + 4) {
        const int row = C == HALO ? halo_row(i0 - 2 + a, N, edges, sel[q])
                                  : source<C>(i0 - 2 + a, N);
        src[q] = static_cast<long long>(row) * M + source<C>(j0 - 2 + b, M);
      } else {
        src[q] = -1;
      }
      next<G::HM>(a, b);
    }
  }

  // One copy group per field (empty past the chunk), so that waiting for
  // all but the newest STAGES - 2 groups waits for the oldest field.
  auto fetch = [&](int k, T* buf) {
    if (k < k1) {
      const T* vk = v + k * plane;
      const T* tk = C == HALO ? top + k * hplane : vk;
      const T* bk = C == HALO ? bot + k * hplane : vk;
#pragma unroll
      for (int q = 0; q < G::HQ; ++q) {
        const T* base = C != HALO ? vk
                        : (sel[q] == 0 ? vk : (sel[q] == 1 ? tk : bk));
        if (src[q] >= 0) cp_async(buf + tid + q * NT, base + src[q]);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(k0 + s, sv[s]);

  // This thread's outputs: column j, rows i0 + a0 .. i0 + a0 + R - 1, with
  // their diagonal coefficients held across the fields (loaded while the
  // first halos are in flight).
  const T l = scal[0];
  const T nu = scal[1];
  const T ihx2 = scal[2];
  const T ihy2 = scal[3];
  const int a0 = ty * R;
  const int j = j0 + tx;
  T coef[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + a0 + r;
    const T uu = (i < N && j < M) ? u[static_cast<long long>(i) * M + j]
                                  : T(0);
    coef[r] = l + T(2) * nu * uu - T(3) * uu * uu;
  }
  // Neumann: w at a clamped neighbour is w at the centre (the second
  // Laplacian's closure); these say which neighbours lie outside the
  // domain.  Periodic: none does, the halo already wrapped.  Halo: the
  // columns are Neumann, and the rows only at a flagged global edge
  const bool left_edge = C != PERIODIC && j == 0;
  const bool right_edge = C != PERIODIC && j == M - 1;
  const bool top_closed =
      C == NEUMANN || (C == HALO && (edges & TOP_EDGE) != 0);
  const bool bottom_closed =
      C == NEUMANN || (C == HALO && (edges & BOTTOM_EDGE) != 0);

  int cur = 0;                       // buffer of field k
  for (int k = k0; k < k1; ++k) {
    // V(r, d) is v at tile row r, column j + d (halo row r + 2, column
    // tx + 2 + d), already clamped to or wrapped around the domain
    const T* h = sv[cur] + (a0 + 2) * G::HM + tx + 2;
    const int prev = cur == 0 ? STAGES - 1 : cur - 1;
    cur = cur == STAGES - 1 ? 0 : cur + 1;
    cp_async_wait<STAGES - 2>();
    // field k is in h, and every thread is done with field k - 1, whose
    // buffer the next fetch overwrites
    __syncthreads();
    fetch(k + STAGES - 1, sv[prev]);

    // a window sliding down the R rows: w = v + Lap v at the centre and
    // the four neighbours of each output, from v in registers
    T c_m2 = h[-2 * G::HM], c_m1 = h[-G::HM], c_0 = h[0], c_p1 = h[G::HM];
    T l_m1 = h[-G::HM - 1], l_0 = h[-1];
    T r_m1 = h[-G::HM + 1], r_0 = h[1];
    T w_up = c_m1 + (c_m2 - T(2) * c_m1 + c_0) * ihx2
                  + (l_m1 - T(2) * c_m1 + r_m1) * ihy2;
    T w_c = c_0 + (c_m1 - T(2) * c_0 + c_p1) * ihx2
                + (l_0 - T(2) * c_0 + r_0) * ihy2;
    T* ok = out + k * plane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T* hr = h + r * G::HM;
      const T c_p2 = hr[2 * G::HM];
      const T l_p1 = hr[G::HM - 1];
      const T r_p1 = hr[G::HM + 1];
      const T l2_0 = hr[-2];
      const T r2_0 = hr[2];
      const T w_dn = c_p1 + (c_0 - T(2) * c_p1 + c_p2) * ihx2
                          + (l_p1 - T(2) * c_p1 + r_p1) * ihy2;
      const T w_l = l_0 + (l_m1 - T(2) * l_0 + l_p1) * ihx2
                        + (l2_0 - T(2) * l_0 + c_0) * ihy2;
      const T w_r = r_0 + (r_m1 - T(2) * r_0 + r_p1) * ihx2
                        + (c_0 - T(2) * r_0 + r2_0) * ihy2;
      const int i = i0 + a0 + r;
      const T up = top_closed && i == 0 ? w_c : w_up;
      const T dn = bottom_closed && i == N - 1 ? w_c : w_dn;
      const T lf = left_edge ? w_c : w_l;
      const T rt = right_edge ? w_c : w_r;
      const T L1v = w_c + (up - T(2) * w_c + dn) * ihx2
                        + (lf - T(2) * w_c + rt) * ihy2;
      if (i < N && j < M && tx < tm) {
        ok[static_cast<long long>(i) * M + j] = -L1v + coef[r] * c_0;
      }
      // slide down one row
      w_up = w_c;
      w_c = w_dn;
      c_0 = c_p1;
      c_p1 = c_p2;
      l_m1 = l_0;
      l_0 = l_p1;
      r_m1 = r_0;
      r_0 = r_p1;
    }
  }
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

// Blocks of sh_jv_kernel<T, R, C> that one SM holds at once (registers
// and shared memory allow), asked of the runtime once per process.
template <typename T, int R, int C>
int resident_per_sm() {
  static const int blocks = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, sh_jv_kernel<T, R, C>, NT, 0);
    return b > 0 ? b : 1;
  }();
  return blocks;
}

template <typename T, int R, int C>
int walk(const T* u, const T* v, const T* top, const T* bot, const T* scal,
         T* out, int N, int M, int K, int edges, cudaStream_t stream) {
  using G = Tile<R>;
  const int tiles_x = (M + G::TM - 1) / G::TM;
  const int tm = (M + tiles_x - 1) / tiles_x;   // the columns spread evenly
  const int tiles_y = (N + G::TN - 1) / G::TN;
  const long long tiles = static_cast<long long>(tiles_x) * tiles_y;
  // fields per block: the fewest that fit the grid into one wave of
  // resident blocks, so that no tail wave follows
  const long long wave =
      static_cast<long long>(sm_count()) * resident_per_sm<T, R, C>();
  long long kc = (tiles * K + wave - 1) / wave;
  kc = kc < 1 ? 1 : (kc > K ? K : kc);
  const int chunks = static_cast<int>((K + kc - 1) / kc);
  const dim3 grid(tiles_x, tiles_y, chunks);
  sh_jv_kernel<T, R, C><<<grid, dim3(TX, TY, 1), 0, stream>>>(
      u, v, top, bot, scal, out, N, M, K, static_cast<int>(kc), tm, edges);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch(const T* u, const T* v, const T* top, const T* bot,
           const T* scal, T* out, int N, int M, int K, int edges,
           void* stream) {
  if (N < 1 || M < 1 || K < 0 || K > MAX_BATCH || edges < 0 || edges > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (K == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using Big = Tile<BIG_R>;
  const long long big_tiles =
      static_cast<long long>((N + Big::TN - 1) / Big::TN) * ((M + TX - 1) / TX);
  if (big_tiles * K >= sm_count()) {
    return walk<T, BIG_R, C>(u, v, top, bot, scal, out, N, M, K, edges, s);
  }
  return walk<T, SMALL_R, C>(u, v, top, bot, scal, out, N, M, K, edges, s);
}

}  // namespace

extern "C" int sh_jv_f32(const float* u, const float* v, const float* scal,
                         float* out, int N, int M, int K, void* stream) {
  return launch<float, NEUMANN>(u, v, v, v, scal, out, N, M, K, 0, stream);
}

extern "C" int sh_jv_f64(const double* u, const double* v, const double* scal,
                         double* out, int N, int M, int K, void* stream) {
  return launch<double, NEUMANN>(u, v, v, v, scal, out, N, M, K, 0, stream);
}

extern "C" int sh_jv_periodic_f32(const float* u, const float* v,
                                  const float* scal, float* out, int N, int M,
                                  int K, void* stream) {
  return launch<float, PERIODIC>(u, v, v, v, scal, out, N, M, K, 0, stream);
}

extern "C" int sh_jv_periodic_f64(const double* u, const double* v,
                                  const double* scal, double* out, int N,
                                  int M, int K, void* stream) {
  return launch<double, PERIODIC>(u, v, v, v, scal, out, N, M, K, 0,
                                  stream);
}

// Halo closure: v, out (K, N, M) is the block, top and bot (K, 2, M) its
// neighbours' rows (not read at an edge flagged in `edges`), u (N, M).
extern "C" int sh_jv_halo_f32(const float* u, const float* v,
                              const float* top, const float* bot,
                              const float* scal, float* out, int N, int M,
                              int K, int edges, void* stream) {
  return launch<float, HALO>(u, v, top, bot, scal, out, N, M, K, edges,
                             stream);
}

extern "C" int sh_jv_halo_f64(const double* u, const double* v,
                              const double* top, const double* bot,
                              const double* scal, double* out, int N, int M,
                              int K, int edges, void* stream) {
  return launch<double, HALO>(u, v, top, bot, scal, out, N, M, K, edges,
                              stream);
}
