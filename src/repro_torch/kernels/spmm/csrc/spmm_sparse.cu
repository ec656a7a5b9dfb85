// Sparse-operand SpMM for Hopper (sm_90a): the padded neighbour-list mean,
// Y = A @ X with A the row-normalised adjacency of a neighbour list, read
// straight from the list, and its transposed launch dX = Aᵀ @ dY.
//
// The block kernel (spmm.cu) reads a dense (N, M) operand. At Reddit's size
// (232,965 nodes, FedAIS arXiv:2409.14655 Table 1) that operand is 217 GB for
// the eval and 22.6 GB for a client's loss pass, so it cannot be built. Here
// A is never formed:
//
// * Forward (spmm_ell_kernel). The operand is the list itself: idx (N, K)
//   int32 and mask (N, K) fp32, an ELL layout at 8 bytes a slot. Row i of Y
//   is (sum over the live slots s of mask[i, s] * X[idx[i, s], :]) / deg_i,
//   deg_i = max(sum_s mask[i, s], 1): the sums in slot order, deg summed in
//   slot order, one rounding an operation (__fmul_rn, __fadd_rn, __fdiv_rn:
//   no contraction into an FMA), so the plain version in ref.py gives the
//   same bits. A slot whose mask is 0 is never read, so a non-finite row k
//   of X reaches exactly the rows with a live slot naming k (the block
//   kernel's rule).
// * Transposed (spmm_ell_t_kernel). Row j of dX is the sum of
//   w_p * dY[row_p, :] over the live slots p that name j, w_p =
//   mask[i, s] / deg_i, in (column, row, slot) order. The wrapper (ops.py)
//   builds that order on the device at fixed shape: the N·K slots sorted
//   stably by column (dead slots last), with column pointers from a search
//   of the sorted columns; no count is read back, so the build and both
//   launches can be captured into a CUDA graph. Rows of dX that no slot
//   names are written as 0.
//
// Each launch is one kernel; both names hold "spmm", so a device trace
// counts them as the SpMM's (the operand build's kernels do not).
//
// What bounds it: the gathers. A warp owns one output row and a slab of its
// columns, and for each live slot streams the named row of X (or dY); the
// slot's index and mask are read once, by one lane, and broadcast with
// __shfl_sync. A group of four slots' loads (two at the widest slabs) is
// issued before their adds. Rows start 4-byte aligned when D is odd and
// 8-byte aligned when D is even, so the host picks the widest vector the
// width and both bases allow (float4, float2 or float; Reddit's 602-wide
// rows take float2, its 256-wide layer-1 rows float4), and a slab is as
// many vectors a lane as balance the slabs (at most 8, so the sums stay in
// registers). The ghost pull's realignment by shuffles (ghost_pull.cu, float4
// over rows at any phase) is not used: a gathered row comes from anywhere in
// X, so a warp's float2 load is already 256 contiguous bytes of one row.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py). The entry points
//        have a plain C interface, loaded with ctypes.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // output rows (warps) per block
constexpr int kMaxVecs = 8;   // vectors a lane per slab
constexpr unsigned kFull = 0xffffffffu;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

template <int V>
__device__ __forceinline__ void load(float (&out)[V], const float* p) {
  const typename Vec<V>::T v = __ldg(reinterpret_cast<const typename Vec<V>::T*>(p));
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = f[e];
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&in)[V]) {
  typename Vec<V>::T v;
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int e = 0; e < V; ++e) f[e] = in[e];
  *reinterpret_cast<typename Vec<V>::T*>(p) = v;
}

// The slab of a warp: vectors c0 + 32 u + lane, u < U, below nvec.
template <int V, int U>
struct Slab {
  float acc[U][V];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[u][e] = 0.f;
  }
};

// Slots a group: their loads are issued before their adds (two where a
// lane's slab is wide, so the loads in flight stay in registers).
template <int V, int U>
__host__ __device__ constexpr int group() {
  return U * V <= 16 ? 4 : 2;
}

// Y[i, :] for one slab: the live slots of row i in slot order, a group of
// slots at a time.
template <int V, int U>
__global__ void __launch_bounds__(kWarps * 32)
spmm_ell_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                const float* __restrict__ mask, float* __restrict__ y, int N, int M, int K,
                int D, int nvec) {
  const int i = blockIdx.x * kWarps + (int)(threadIdx.x >> 5);
  const int lane = (int)(threadIdx.x & 31);
  if (i >= N) return;
  const int c0 = blockIdx.y * 32 * U;
  Slab<V, U> s;
  s.zero();
  float deg = 0.f;
  const int* irow = idx + (size_t)i * K;
  const float* mrow = mask + (size_t)i * K;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int nk = min(32, K - k0);
    const int my_j = lane < nk ? irow[k0 + lane] : 0;
    const float my_m = lane < nk ? mrow[k0 + lane] : 0.f;
    constexpr int G = group<V, U>();
    for (int t = 0; t < nk; t += G) {
      int j[G];
      float m[G];
      float v[G][U][V];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        j[q] = __shfl_sync(kFull, my_j, t + q < nk ? t + q : 0);
        m[q] = __shfl_sync(kFull, my_m, t + q < nk ? t + q : 0);
        const bool live = t + q < nk && m[q] != 0.f;
        if (t + q >= nk) m[q] = 0.f;
        if (live) assert(j[q] >= 0 && j[q] < M);
        const float* xr = x + (size_t)(live ? j[q] : 0) * D;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + 32 * u + lane;
          if (live && c < nvec) {
            load<V>(v[q][u], xr + (size_t)c * V);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) v[q][u][e] = 0.f;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (t + q < nk) deg = __fadd_rn(deg, m[q]);
        if (m[q] != 0.f) {
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int e = 0; e < V; ++e)
              s.acc[u][e] = __fadd_rn(s.acc[u][e], __fmul_rn(m[q], v[q][u][e]));
        }
      }
    }
  }
  deg = fmaxf(deg, 1.f);
  float* yr = y + (size_t)i * D;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = c0 + 32 * u + lane;
    if (c < nvec) {
      float out[V];
#pragma unroll
      for (int e = 0; e < V; ++e) out[e] = __fdiv_rn(s.acc[u][e], deg);
      store<V>(yr + (size_t)c * V, out);
    }
  }
}

// dX[j, :] for one slab: the entries ptr[j] .. ptr[j + 1] of the
// column-sorted slots, in order, each w * dY[row, :].
template <int V, int U>
__global__ void __launch_bounds__(kWarps * 32)
spmm_ell_t_kernel(const float* __restrict__ dy, const int* __restrict__ rows,
                  const float* __restrict__ w, const int* __restrict__ ptr,
                  float* __restrict__ dx, int M, int N, int D, int nvec) {
  const int j = blockIdx.x * kWarps + (int)(threadIdx.x >> 5);
  const int lane = (int)(threadIdx.x & 31);
  if (j >= M) return;
  const int c0 = blockIdx.y * 32 * U;
  Slab<V, U> s;
  s.zero();
  const int p0 = ptr[j], p1 = ptr[j + 1];
  for (int b = p0; b < p1; b += 32) {
    const int nb = min(32, p1 - b);
    const int my_r = lane < nb ? rows[b + lane] : 0;
    const float my_w = lane < nb ? w[b + lane] : 0.f;
    constexpr int G = group<V, U>();
    for (int t = 0; t < nb; t += G) {
      float wq[G];
      float v[G][U][V];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const bool in = t + q < nb;
        const int r = __shfl_sync(kFull, my_r, in ? t + q : 0);
        wq[q] = __shfl_sync(kFull, my_w, in ? t + q : 0);
        if (in) assert(r >= 0 && r < N);
        const float* gr = dy + (size_t)(in ? r : 0) * D;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + 32 * u + lane;
          if (in && c < nvec) {
            load<V>(v[q][u], gr + (size_t)c * V);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) v[q][u][e] = 0.f;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (t + q < nb) {
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int e = 0; e < V; ++e)
              s.acc[u][e] = __fadd_rn(s.acc[u][e], __fmul_rn(wq[q], v[q][u][e]));
        }
      }
    }
  }
  float* xr = dx + (size_t)j * D;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = c0 + 32 * u + lane;
    if (c < nvec) store<V>(xr + (size_t)c * V, s.acc[u]);
  }
}

// The widest vector that D and every base allow.
int vec_width(int D, const void* a, const void* b) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  if (D % 4 == 0 && (bases & 15) == 0) return 4;
  if (D % 2 == 0 && (bases & 7) == 0) return 2;
  return 1;
}

// Vectors a lane (1..8) and slabs: as few slabs as 8 vectors a lane allow,
// the vectors spread evenly over them.
void slabs_of(int nvec, int* vecs, int* slabs) {
  const int per = 32 * kMaxVecs;
  *slabs = (nvec + per - 1) / per;
  const int each = (nvec + *slabs - 1) / *slabs;
  *vecs = (each + 31) / 32;
}

template <int V, int U>
cudaError_t launch_fwd(dim3 grid, cudaStream_t st, const float* x, const int* idx,
                       const float* mask, float* y, int N, int M, int K, int D, int nvec) {
  spmm_ell_kernel<V, U><<<grid, kWarps * 32, 0, st>>>(x, idx, mask, y, N, M, K, D, nvec);
  return cudaGetLastError();
}

template <int V, int U>
cudaError_t launch_t(dim3 grid, cudaStream_t st, const float* dy, const int* rows,
                     const float* w, const int* ptr, float* dx, int M, int N, int D, int nvec) {
  spmm_ell_t_kernel<V, U><<<grid, kWarps * 32, 0, st>>>(dy, rows, w, ptr, dx, M, N, D, nvec);
  return cudaGetLastError();
}

#define SPMM_ELL_DISPATCH(V, CALL)                                                    \
  switch (vecs) {                                                                     \
    case 1: return (int)CALL(V, 1);                                                   \
    case 2: return (int)CALL(V, 2);                                                   \
    case 3: return (int)CALL(V, 3);                                                   \
    case 4: return (int)CALL(V, 4);                                                   \
    case 5: return (int)CALL(V, 5);                                                   \
    case 6: return (int)CALL(V, 6);                                                   \
    case 7: return (int)CALL(V, 7);                                                   \
    case 8: return (int)CALL(V, 8);                                                   \
  }                                                                                   \
  return (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

// Y (N, D) = the mean over the live slots of idx (N, K) int32 / mask (N, K)
// fp32 of the rows of X (M, D): Y[i] = (sum_s mask[i, s] X[idx[i, s]]) /
// max(sum_s mask[i, s], 1). Every array contiguous, Y apart from the inputs.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError().
int spmm_ell_f32(const float* x, const int* idx, const float* mask, float* y, int N, int M,
                 int K, int D, void* stream) {
  if (N < 0 || M < 0 || K < 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (N == 0 || D == 0) return (int)cudaSuccess;
  const int V = vec_width(D, x, y);
  const int nvec = D / V;
  int vecs, slabs;
  slabs_of(nvec, &vecs, &slabs);
  if (slabs > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kWarps - 1) / kWarps, slabs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD(V_, U_) launch_fwd<V_, U_>(grid, st, x, idx, mask, y, N, M, K, D, nvec)
  if (V == 4) {
    SPMM_ELL_DISPATCH(4, FWD)
  } else if (V == 2) {
    SPMM_ELL_DISPATCH(2, FWD)
  } else {
    SPMM_ELL_DISPATCH(1, FWD)
  }
#undef FWD
}

// dX (M, D) = Aᵀ @ dY (N, D) over the column-sorted slots: rows (P,) int32
// and w (P,) fp32 in (column, row, slot) order, ptr (M + 1,) int32 the first
// entry of each column (entries past ptr[M] are dead and not read). Every
// array contiguous, dX apart from the inputs. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
int spmm_ell_t_f32(const float* dy, const int* rows, const float* w, const int* ptr,
                   float* dx, int M, int N, int D, void* stream) {
  if (M < 0 || N < 0 || D < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || D == 0) return (int)cudaSuccess;
  const int V = vec_width(D, dy, dx);
  const int nvec = D / V;
  int vecs, slabs;
  slabs_of(nvec, &vecs, &slabs);
  if (slabs > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kWarps - 1) / kWarps, slabs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TRN(V_, U_) launch_t<V_, U_>(grid, st, dy, rows, w, ptr, dx, M, N, D, nvec)
  if (V == 4) {
    SPMM_ELL_DISPATCH(4, TRN)
  } else if (V == 2) {
    SPMM_ELL_DISPATCH(2, TRN)
  } else {
    SPMM_ELL_DISPATCH(1, TRN)
  }
#undef TRN
}

const char* spmm_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
