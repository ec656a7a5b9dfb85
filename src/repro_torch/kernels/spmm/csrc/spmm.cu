// Block-sparse SpMM for Hopper (sm_90a): Y = A @ X, dead tiles of A skipped.
//
// Replaces the Pallas TPU kernel src/repro/kernels/spmm/spmm.py::spmm_pallas
// (body _spmm_kernel). It computes the same function: A (N, M) fp32, X
// (M, D) fp32, a block mask (ceil(N/32), ceil(M/32)) int32 that is 0 where
// the 32 x 32 tile of A holds no nonzero, Y (N, D) fp32 accumulated in
// fp32. It is not a tile-by-tile copy of the Pallas version:
//
// * The TPU grid carries the sum in VMEM scratch across its sequential
//   contraction axis. Here one thread block owns a (32 x 128) tile of Y and
//   loops over the contraction steps itself, keeping a 4 x 8 register
//   micro-tile per thread in fp32 FMA.
// * Each block reads the mask entry of a (row tile, k step) once and issues
//   no load for a dead step. The next live step's A and X tiles are loaded
//   into registers while the current one is multiplied from shared memory.
// * The ragged edges of N, M and D are masked in the kernel, so the caller
//   never pads A or X (at the serving warm fill a padded copy of A would be
//   a second 2.4 GB adjacency).
// * A skinny problem (a query bucket of 8..128 rows) gives too few output
//   tiles to fill 132 SMs, so the contraction is split over gridDim.z
//   blocks that write partial sums to a workspace, and a second kernel adds
//   them in a fixed order (no atomics: the result does not change from run
//   to run).
//
// Rows of 32: a 128-row tile with an 8 x 8 micro-tile was measured beside
// it on an H100 and lost at every serving shape but one (PERF.md): on these
// random-neighbour graphs a 32-row tile is live about half as often, and
// the FMA work falls with it.
//
// No tensor cores: TF32 keeps a 10-bit mantissa and would break the 1e-5
// agreement with the fp32 reference; the FMA pipes give fp32 exactly.
//
// What bounds it on an H100: the multiply does 2 * D FLOP for each live
// element of A, and reads each live element of A once per 128 columns of
// D. At the serving warm fill (N = M = 24,647, D = 500, 23% of the 32 x 32
// tiles live as measured on an H100, PERF.md) that is about 0.14 TFLOP
// against 0.56 GB of live A (2.2 GB read over the 4 column tiles of D), so
// the 67 TFLOP/s fp32 FMA rate, not the 3.35 TB/s memory, is the bound; the
// design answers with a register micro-tile (32 FMA per 3 shared loads per
// k) and by never touching a dead tile. At the query buckets the work is
// small and the split over k exists to put enough blocks in flight.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py). Entry points have
//        a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;   // rows of A (and Y) of one block == mask row tile
constexpr int kBK = 32;   // contraction depth of one step == mask column tile
constexpr int kBD = 128;  // output columns of one block
constexpr int kTX = 16;   // threads across the columns; each owns 2 x 4 of them
constexpr int kTY = kBM / 4;                // threads down the rows; 4 rows each
constexpr int kNT = kTY * kTX;              // threads per block
constexpr int kAPerT = kBM * kBK / kNT;     // A elements each thread stages
constexpr int kXPerT = kBK * kBD / kNT;     // X elements each thread stages
constexpr int kAP = kBM + 4;                // padded row of the transposed A tile
static_assert((kBM * kBK) % kNT == 0 && (kBK * kBD) % kNT == 0, "even loads");

__device__ __forceinline__ void load_step(
    const float* __restrict__ a, const float* __restrict__ x, int s, int n0,
    int d0, int N, int M, int D, int lda, int ldx, int tid, float (&ra)[kAPerT],
    float (&rx)[kXPerT]) {
  const int k0 = s * kBK;
#pragma unroll
  for (int l = 0; l < kAPerT; ++l) {
    const int i = tid + l * kNT;
    const int r = n0 + i / kBK, c = k0 + i % kBK;
    ra[l] = (r < N && c < M) ? __ldg(a + (long long)r * lda + c) : 0.f;
  }
#pragma unroll
  for (int l = 0; l < kXPerT; ++l) {
    const int i = tid + l * kNT;
    const int r = k0 + i / kBD, c = d0 + i % kBD;
    rx[l] = (r < M && c < D) ? __ldg(x + (long long)r * ldx + c) : 0.f;
  }
}

__global__ void __launch_bounds__(kNT)
spmm_block_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  const int* __restrict__ mask, float* __restrict__ out,
                  int N, int M, int D, int lda, int ldx, int ldo,
                  int steps_per_split, long long split_stride) {
  __shared__ __align__(16) float As[kBK][kAP];
  __shared__ __align__(16) float Xs[kBK][kBD];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int d0 = blockIdx.x * kBD;
  const int n0 = blockIdx.y * kBM;
  const int k_steps = (M + kBK - 1) / kBK;
  const int* mrow = mask + (long long)blockIdx.y * k_steps;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(k_steps, s_begin + steps_per_split);
  out += blockIdx.z * split_stride;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ra[kAPerT];
  float rx[kXPerT];
  int s = s_begin;
  while (s < s_end && mrow[s] == 0) ++s;  // block-uniform: no divergence
  if (s < s_end) load_step(a, x, s, n0, d0, N, M, D, lda, ldx, tid, ra, rx);

  while (s < s_end) {
#pragma unroll
    for (int l = 0; l < kAPerT; ++l) {
      const int i = tid + l * kNT;
      As[i % kBK][i / kBK] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < kXPerT; ++l) {
      const int i = tid + l * kNT;
      Xs[i / kBD][i % kBD] = rx[l];
    }
    __syncthreads();

    int sn = s + 1;
    while (sn < s_end && mrow[sn] == 0) ++sn;
    if (sn < s_end) load_step(a, x, sn, n0, d0, N, M, D, lda, ldx, tid, ra, rx);

#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      float xv[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 t = *reinterpret_cast<const float4*>(&Xs[k][h * (kBD / 2) + tx * 4]);
        xv[4 * h + 0] = t.x;
        xv[4 * h + 1] = t.y;
        xv[4 * h + 2] = t.z;
        xv[4 * h + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a4[i], xv[j], acc[i][j]);
    }
    __syncthreads();
    s = sn;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = n0 + ty * 4 + i;
    if (r >= N) continue;
    float* orow = out + (long long)r * ldo;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = d0 + h * (kBD / 2) + tx * 4;
      if (c + 3 < D && (reinterpret_cast<uintptr_t>(orow + c) & 15) == 0) {
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < D) orow[c + j] = acc[i][4 * h + j];
      }
    }
  }
}

// Y = sum over z of the split partials, in z order (deterministic).
__global__ void split_sum_kernel(const float* __restrict__ ws, float* __restrict__ y,
                                 int N, int D, int ldy, int splits) {
  const long long total = (long long)N * D;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += ws[z * total + i];
    y[(i / D) * ldy + i % D] = acc;
  }
}

}  // namespace

extern "C" {

// Y (N, D; row stride ldy) = A (N, M; lda) @ X (M, D; ldx), skipping the
// (bm_tile x bk_tile) tiles of A whose mask entry is 0. mask is
// (ceil(N/bm_tile), ceil(M/bk_tile)) int32, row-major and contiguous.
// bm_tile and bk_tile must be 32. splits > 1 splits the contraction;
// workspace then holds splits * N * D floats. Launches on `stream`, does
// not synchronise, and returns cudaGetLastError().
int spmm_block_f32(const float* a, const float* x, const int* mask, float* y,
                   float* workspace, int N, int M, int D, int lda, int ldx,
                   int ldy, int bm_tile, int bk_tile, int splits, void* stream) {
  if (N < 0 || M < 0 || D < 0 || bm_tile != kBM || bk_tile != kBK || splits < 1 ||
      splits > 65535 || (splits > 1 && workspace == nullptr) ||
      (N + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || D == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k_steps = (M + kBK - 1) / kBK;
  const int steps_per_split = (k_steps + splits - 1) / splits;
  float* out = splits > 1 ? workspace : y;
  const int ldo = splits > 1 ? D : ldy;
  const long long split_stride = splits > 1 ? (long long)N * D : 0;
  const dim3 grid((D + kBD - 1) / kBD, (N + kBM - 1) / kBM, splits);
  spmm_block_kernel<<<grid, kNT, 0, st>>>(a, x, mask, out, N, M, D, lda, ldx, ldo,
                                          steps_per_split, split_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)N * D;
  const long long want = (total + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  split_sum_kernel<<<blocks, 256, 0, st>>>(workspace, y, N, D, ldy, splits);
  return (int)cudaGetLastError();
}

const char* spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
