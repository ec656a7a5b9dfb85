// Block-sparse SpMM for Hopper (sm_90a): Y = A @ X, FMAs only on the
// nonzeros of A's live tiles.
//
// Replaces the Pallas TPU kernel src/repro/kernels/spmm/spmm.py::spmm_pallas
// (body _spmm_kernel). It computes the same function: A (N, M) fp32, X
// (M, D) fp32, a block mask (ceil(N/32), ceil(M/32)) int32 that is 0 where
// the 32 x 32 tile of A holds no nonzero, Y (N, D) fp32 accumulated in fp32.
//
// What bounds it on an H100: the bytes. The adjacencies it serves are row-
// normalised neighbour lists: at the serving warm fill (N = M = 24,647,
// D = 500) 23% of the 32 x 32 tiles are live, and a live tile holds 1.25
// nonzeros on average. The work the product needs is 2 D flops per nonzero
// (0.17 GFLOP, 2.6 us at 67 TFLOP/s), while reading the live tiles of A once
// is 0.56 GB (0.17 ms at 3.35 TB/s). So the design reads each live tile once
// and keeps as many of its rows in flight as it can, and does no FMA on a
// zero:
//
// * A warp owns two whole rows of Y, every column of D up to 512 (wider
//   outputs take more column slabs of 512, the only case that reads A
//   twice). Its fp32 sums stay in registers.
// * A block of 8 warps first compacts its row tile's mask row into the
//   list of live tile columns, in shared memory (ballot and popcount; 1,024
//   mask entries at a time).
// * A warp then walks the list in batches of 8 live tiles: each lane loads
//   one element of each of its two rows of every tile of the batch (128-byte
//   coalesced rows, streamed past the L2 with ld.global.cs), and the next
//   batch's 16 loads are issued before this one's nonzeros are multiplied,
//   so that the stream of A does not wait on X. It finds each row's
//   nonzeros with __ballot_sync(a != 0), __ffs and __shfl_sync. Only for a
//   nonzero a at column k does it read row k of X (16-byte loads with an L2
//   evict-last policy: X, 49 MB at the warm fill, is gathered about 7 times
//   per row) and add a * X[k, :] into the row's sums with fmaf.
// * A skinny grid (a query bucket of 8..4,224 rows) gives too few warps to
//   keep enough loads in flight, so `splits` warps of one block share a row
//   group: split s takes the live tiles whose rank in the list is s modulo
//   `splits`. The partial sums meet in shared memory and are added in split
//   order (p0 + p1) + p2 ..., with no atomics: the same launch on the same
//   input gives the same bits.
// * The ragged edges of N, M and D are masked in the kernel, so the caller
//   never pads A or X.
//
// Non-finite values. Skipping the zeros defines 0 * inf and 0 * NaN away: a
// non-finite X[k, :] reaches exactly the rows of A with a nonzero in column
// k (what a gather or segment sum over the neighbour lists gives), where a
// dense A @ X would make every row non-finite. A NaN in A counts as a nonzero.
//
// No tensor cores: there is about one nonzero per live tile, so there is no
// dense product to give them; the FMA pipes give fp32 exactly.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py). Entry points have
//        a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;               // mask tile: 32 x 32 elements of A
constexpr int kWarps = 8;               // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kWindow = 4 * kThreads;   // mask entries compacted at a time
constexpr int kSlab = 512;              // columns of Y per block, at most
constexpr int kRows = 2;                // rows of Y per warp
constexpr int kBatch = 8;               // live tiles per batch, two batches in flight
constexpr unsigned kFull = 0xffffffffu;

// An L2 policy that keeps X (the rows the nonzeros gather) ahead of the
// stream of A, which is read once with ld.global.cs (evict first).
__device__ __forceinline__ uint64_t keep_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ float4 ld_keep4(const float* p, uint64_t pol) {
  float4 v;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ float ld_keep1(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(pol));
  return v;
}

// acc += s * X[k, col0 : col0 + ncols] in this lane's columns: chunk c of
// 128 columns, 4 consecutive ones per lane (V4), or chunk c of 32, one per
// lane.
template <int CPL, bool V4>
__device__ __forceinline__ void axpy_row(float (&acc)[CPL], float s,
                                         const float* __restrict__ xr, int lane,
                                         int ncols, uint64_t pol) {
  if constexpr (V4) {
#pragma unroll
    for (int c = 0; c < CPL / 4; ++c) {
      const int col = c * 128 + lane * 4;
      if (col < ncols) {
        const float4 t = ld_keep4(xr + col, pol);
        acc[4 * c + 0] = fmaf(s, t.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(s, t.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(s, t.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(s, t.w, acc[4 * c + 3]);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = c * 32 + lane;
      if (col < ncols) acc[c] = fmaf(s, ld_keep1(xr + col, pol), acc[c]);
    }
  }
}

// One element of each of this warp's rows of the live tiles at list
// positions i, i + splits, ... (kBatch of them); 0 past the list or an edge.
__device__ __forceinline__ void load_batch(
    float (&av)[kBatch][kRows], const int* list, int i, int splits, int cnt,
    const float* const (&arow)[kRows], const bool (&rv)[kRows], int lane, int M) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int p = i + u * splits;
    const int kt = p < cnt ? list[p] : -1;
    const bool ok = kt >= 0 && kt * kTile + lane < M;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      av[u][r] = (ok && rv[r]) ? __ldcs(arow[r] + kt * kTile) : 0.f;
  }
}

// Each nonzero of the batch, row by row, in ascending column order.
template <int CPL, bool V4>
__device__ __forceinline__ void fma_batch(
    float (&acc)[kRows][CPL], const float (&av)[kBatch][kRows], const int* list,
    int i, int splits, const float* __restrict__ xs, long long ldx, int lane,
    int ncols, uint64_t pol) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      unsigned bits = __ballot_sync(kFull, av[u][r] != 0.f);
      if (bits) {
        const int k0 = list[i + u * splits] * kTile;
        do {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          const float s = __shfl_sync(kFull, av[u][r], b);
          axpy_row<CPL, V4>(acc[r], s, xs + (long long)(k0 + b) * ldx, lane, ncols, pol);
        } while (bits);
      }
    }
  }
}

template <int CPL, bool V4>
__global__ void __launch_bounds__(kThreads, 2)
spmm_nnz_kernel(const float* __restrict__ a, const float* __restrict__ x,
                const int* __restrict__ mask, float* __restrict__ y, int N, int M,
                int D, long long lda, long long ldx, long long ldy, int splits) {
  __shared__ int list[kWindow];
  __shared__ int wcount[4][kWarps];
  extern __shared__ float part[];  // (splits - 1) x groups warps x kRows x CPL x 32

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = kWarps / splits;  // row groups of a block
  const int g = warp % groups;
  const int s = warp / groups;         // this warp's split
  const int brow = blockIdx.x * groups * kRows;
  const int row0 = brow + g * kRows;
  const int nbm = (M + kTile - 1) / kTile;
  const int* __restrict__ mrow = mask + (long long)(brow / kTile) * nbm;
  const int col0 = blockIdx.y * kSlab;
  const int ncols = min(kSlab, D - col0);
  const float* __restrict__ xs = x + col0;
  const uint64_t pol = keep_policy();

  const float* arow[kRows];
  bool rv[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    rv[r] = row0 + r < N;
    arow[r] = a + (rv[r] ? (long long)(row0 + r) * lda : 0) + lane;
  }
  float acc[kRows][CPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;

  int base = 0;  // live tiles in earlier windows
  for (int w0 = 0; w0 < nbm; w0 += kWindow) {
    // the window's live tile columns, in ascending order, into list
    bool live[4];
    unsigned bal[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = w0 + e * kThreads + threadIdx.x;
      live[e] = j < nbm && __ldg(mrow + j) != 0;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bal[e] = __ballot_sync(kFull, live[e]);
      if (lane == 0) wcount[e][warp] = __popc(bal[e]);
    }
    __syncthreads();
    int cnt = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int before = 0, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = wcount[e][w];
        total += c;
        before += w < warp ? c : 0;
      }
      if (live[e])
        list[cnt + before + __popc(bal[e] & ((1u << lane) - 1u))] =
            w0 + e * kThreads + threadIdx.x;
      cnt += total;
    }
    __syncthreads();

    // this split's live tiles: global rank base + i == s (mod splits)
    int i = ((s - base) % splits + splits) % splits;
    float av[kBatch][kRows];
    load_batch(av, list, i, splits, cnt, arow, rv, lane, M);
    while (i < cnt) {
      // the next batch is in flight while this one's nonzeros are multiplied
      const int next = i + kBatch * splits;
      float an[kBatch][kRows];
      load_batch(an, list, next, splits, cnt, arow, rv, lane, M);
      fma_batch<CPL, V4>(acc, av, list, i, splits, xs, ldx, lane, ncols, pol);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int r = 0; r < kRows; ++r) av[u][r] = an[u][r];
      i = next;
    }
    base += cnt;
    __syncthreads();  // the next window rewrites list
  }

  if (splits > 1) {
    // splits 1.. leave their sums in shared memory; split 0 adds them in order
    constexpr int kPart = kRows * CPL * 32;
    if (s > 0) {
      float* mine = part + ((s - 1) * groups + g) * kPart;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < CPL; ++c) mine[(r * CPL + c) * 32 + lane] = acc[r][c];
    }
    __syncthreads();
    if (s > 0) return;
    for (int t = 1; t < splits; ++t) {
      const float* p = part + ((t - 1) * groups + g) * kPart;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[r][c] += p[(r * CPL + c) * 32 + lane];
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (!rv[r]) continue;
    float* yr = y + (long long)(row0 + r) * ldy + col0;
    if constexpr (V4) {
#pragma unroll
      for (int c = 0; c < CPL / 4; ++c) {
        const int col = c * 128 + lane * 4;
        if (col < ncols)
          *reinterpret_cast<float4*>(yr + col) =
              make_float4(acc[r][4 * c], acc[r][4 * c + 1], acc[r][4 * c + 2],
                          acc[r][4 * c + 3]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int col = c * 32 + lane;
        if (col < ncols) yr[col] = acc[r][c];
      }
    }
  }
}

template <int CPL, bool V4>
cudaError_t launch_cpl(dim3 grid, size_t smem, cudaStream_t st, const float* a,
                       const float* x, const int* mask, float* y, int N, int M, int D,
                       int lda, int ldx, int ldy, int splits) {
  spmm_nnz_kernel<CPL, V4><<<grid, kThreads, smem, st>>>(a, x, mask, y, N, M, D, lda,
                                                         ldx, ldy, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Y (N, D; row stride ldy) = A (N, M; lda) @ X (M, D; ldx), reading only
// the (bm_tile x bk_tile) tiles of A whose mask entry is not 0 and
// multiplying only their nonzeros. mask is (ceil(N/bm_tile),
// ceil(M/bk_tile)) int32, row-major and contiguous; bm_tile and bk_tile
// must be 32. splits (1, 2, 4 or 8) warps share each row group's live
// tiles. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
int spmm_block_f32(const float* a, const float* x, const int* mask, float* y, int N,
                   int M, int D, int lda, int ldx, int ldy, int bm_tile, int bk_tile,
                   int splits, void* stream) {
  if (N < 0 || M < 0 || D < 0 || bm_tile != kTile || bk_tile != kTile ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      (D + kSlab - 1) / kSlab > 65535)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || D == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows_per_block = kWarps / splits * kRows;
  const dim3 grid((N + rows_per_block - 1) / rows_per_block, (D + kSlab - 1) / kSlab);
  const int slab = D < kSlab ? D : kSlab;
  const int cpl = (slab + 127) / 128 * 4;  // 4, 8, 12 or 16 columns a lane
  const bool v4 = D % 4 == 0 && ldx % 4 == 0 && ldy % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const size_t smem = (size_t)(splits - 1) * (kWarps / splits) * kRows * cpl * 32 *
                      sizeof(float);
#define SPMM_CASE(C)                                                                \
  case C:                                                                           \
    return (int)(v4 ? launch_cpl<C, true>(grid, smem, st, a, x, mask, y, N, M, D,   \
                                          lda, ldx, ldy, splits)                    \
                    : launch_cpl<C, false>(grid, smem, st, a, x, mask, y, N, M, D,  \
                                           lda, ldx, ldy, splits));
  switch (cpl) {
    SPMM_CASE(4)
    SPMM_CASE(8)
    SPMM_CASE(12)
    SPMM_CASE(16)
  }
#undef SPMM_CASE
  return (int)cudaErrorInvalidValue;
}

const char* spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
