// RWKV6 WKV recurrence for Hopper (sm_90a), state resident on chip.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6/wkv6.py::wkv6_pallas
// (body _wkv6_kernel). It computes the same function: for each (batch, head)
// row, from S = 0,
//     y_t = (sum_n r_t[n] u[n] k_t[n]) v_t + r_t^T S
//     S   = diag(w_t) S + k_t v_t^T
// with r, k, v (B, T, H, N) in fp32 or bf16, w (B, T, H, N) fp32 (decays
// near 1 would not survive a 2048-step product in bf16), u (H, N) fp32; it
// writes y (B, T, H, N) in r's type and the final S (B, H, N, N) fp32
// (S[n][m]: key n, value m). It is not a block-by-block copy of the Pallas
// version:
//
// * The TPU grid walks time as a sequential grid axis and keeps S in VMEM
//   scratch between grid steps. Here one thread block owns one (b, h) row
//   and walks all of T itself; S never leaves the registers. Thread (j, q)
//   holds rows q*N/4 .. q*N/4 + N/4 - 1 of value column j of S, so the
//   N x N state is spread over 4N threads with N/4 floats each.
// * The bonus term folds into the same pass: each thread sums
//   r[n] (u[n] k[n] v[j] + S[n][j]) over its rows, and two shuffles add the
//   four partial sums of a column. No separate reduction for coef.
// * r, k, w (which every column needs) and v are staged in shared memory a
//   chunk of 16 steps at a time, converted to fp32, with each quarter of the
//   key rows padded so the four quarters a warp reads fall on distinct
//   banks. The kernel reads the (B, T, H, N) layout in place: no transposes
//   to per-head rows, no padding of T (the ragged last chunk is masked).
//
// What bounds it on an H100: per step and row it does about 5 N^2 fp32
// operations against 3 N input elements in r/k/v's type, N in fp32 (w) and
// N written (y). At B=4, T=2048, H=32, N=64 with bf16 r/k/v that is
// 5.4 GFLOP against 0.10 GB, so the 67 TFLOP/s fp32 FMA rate bounds it,
// not memory. But the recurrence is sequential in T: one block per (b, h)
// (128 blocks for 132 SMs) walks 2048 dependent steps, so the latency of
// one step, not either peak, sets its time. The design keeps that step
// short: state in registers, 4-way split of the key rows per column with
// four independent FMA chains per thread, and only broadcast shared loads.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py). Entry points have
//        a plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKS = 4;      // threads per value column; each owns N/kKS key rows
constexpr int kChunk = 16;  // time steps staged in shared memory at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(N * kKS) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, T* __restrict__ y,
    float* __restrict__ s_out, int T_len, int H) {
  constexpr int R = N / kKS;       // key rows per thread
  constexpr int RP = R + 4;        // padded quarter in shared memory
  constexpr int NP = kKS * RP;     // padded row of r/k/w in shared memory
  constexpr int NT = N * kKS;      // threads per block
  static_assert(R % 4 == 0, "rows per thread must be a multiple of 4");
  __shared__ __align__(16) float rs[kChunk][NP];
  __shared__ __align__(16) float ks[kChunk][NP];
  __shared__ __align__(16) float ws[kChunk][NP];
  __shared__ float vs[kChunk][N];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int j = tid / kKS;  // value column
  const int q = tid % kKS;  // key rows q*R .. q*R + R - 1
  const long long t_stride = (long long)H * N;
  const long long base = (long long)b * T_len * t_stride + (long long)h * N;

  float S[R];
  float uu[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    S[i] = 0.f;
    uu[i] = u[h * N + q * R + i];
  }

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int steps = min(kChunk, T_len - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < kChunk * N; i += NT) {
      const int tt = i / N, n = i % N;
      const int ns = (n / R) * RP + n % R;
      float rv = 0.f, kv = 0.f, vv = 0.f, wv = 1.f;
      if (tt < steps) {
        const long long off = base + (long long)(t0 + tt) * t_stride + n;
        rv = to_f32(r[off]);
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
        wv = w[off];
      }
      rs[tt][ns] = rv;
      ks[tt][ns] = kv;
      ws[tt][ns] = wv;
      vs[tt][n] = vv;
    }
    __syncthreads();
    for (int tt = 0; tt < steps; ++tt) {
      const float vj = vs[tt][j];
      const float* rr = &rs[tt][q * RP];
      const float* kk = &ks[tt][q * RP];
      const float* wr = &ws[tt][q * RP];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < R; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rr + i);
        const float4 k4 = *reinterpret_cast<const float4*>(kk + i);
        const float4 w4 = *reinterpret_cast<const float4*>(wr + i);
        const float rn[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kn[4] = {k4.x, k4.y, k4.z, k4.w};
        const float wn[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float kv = kn[c] * vj;
          acc[c] = fmaf(rn[c], fmaf(uu[i + c], kv, S[i + c]), acc[c]);
          S[i + c] = fmaf(wn[c], S[i + c], kv);
        }
      }
      float yj = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      yj += __shfl_xor_sync(0xffffffffu, yj, 1);
      yj += __shfl_xor_sync(0xffffffffu, yj, 2);
      if (q == 0) y[base + (long long)(t0 + tt) * t_stride + j] = from_f32<T>(yj);
    }
  }

  float* so = s_out + (long long)bh * N * N;
#pragma unroll
  for (int i = 0; i < R; ++i) so[(q * R + i) * N + j] = S[i];
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w,
                   const float* u, void* y, float* s, int B, int T_len, int H, int N,
                   cudaStream_t st) {
  const dim3 grid(B * H);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* yt = static_cast<T*>(y);
  switch (N) {
    case 32:
      wkv6_kernel<T, 32><<<grid, 32 * kKS, 0, st>>>(rt, kt, vt, w, u, yt, s, T_len, H);
      break;
    case 64:
      wkv6_kernel<T, 64><<<grid, 64 * kKS, 0, st>>>(rt, kt, vt, w, u, yt, s, T_len, H);
      break;
    case 128:
      wkv6_kernel<T, 128><<<grid, 128 * kKS, 0, st>>>(rt, kt, vt, w, u, yt, s, T_len, H);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y (B, T, H, N; r's type), s (B, H, N, N; fp32) from r, k, v (B, T, H, N;
// fp32 when dtype == 0, bf16 when dtype == 1), w (B, T, H, N; fp32) and
// u (H, N; fp32), all contiguous. N must be 32, 64 or 128. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError().
int wkv6_fwd(const void* r, const void* k, const void* v, const float* w,
             const float* u, void* y, float* s, int B, int T_len, int H, int N,
             int dtype, void* stream) {
  if (B < 0 || T_len < 0 || H < 0 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(r, k, v, w, u, y, s, B, T_len, H, N, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(r, k, v, w, u, y, s, B, T_len, H, N, st);
  return (int)cudaErrorInvalidValue;
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
