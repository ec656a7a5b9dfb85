// Flash attention forward for Hopper (sm_90a): causal or sliding-window GQA
// attention with an online softmax in fp32.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (body _flash_kernel). It computes the same function: q (B, S, H, hd),
// k and v (B, S, Hkv, hd), fp32 or bf16; o (B, S, H, hd) in q's type, with
// o = softmax(q k^T * hd^-0.5 + mask) v, where the mask keeps key j for
// query i when j <= i (causal) and, with a window, i - j < window (the
// window applies only when causal). Running max, sum and accumulator are
// fp32. It is not a block-by-block copy of the Pallas version:
//
// * The TPU grid carries (m, l, acc) in VMEM scratch across a sequential
//   KV grid axis. Here one thread block owns a 64-row query tile of one
//   (b, h) and loops over the KV tiles itself, in ascending order, visiting
//   only the tiles that some (query, key) pair of the tile leaves live:
//   a windowed tile far below the diagonal and every tile above it are
//   never loaded.
// * A masked score contributes exactly 0 to the sum and the accumulator
//   (it is never exponentiated), so a row with no live key in a live tile
//   stays at l = 0, acc = 0 and costs nothing when its first live key comes.
//   The result does not rest on -1e30 underflowing in exp, as the TPU
//   kernel's does.
// * GQA: query head h reads KV head h / (H / Hkv) by index; K and V are
//   never repeated in memory. The kernel reads the (B, S, heads, hd) layout
//   in place and masks the ragged S and hd edges itself (zero-filled in
//   shared memory), so nothing is transposed or padded. hd is any value up
//   to 256 (gemma3's 240 included); it runs at the next of 64, 128, 256.
//
// Arithmetic: fp32 FMA on the CUDA cores for both input types (bf16 inputs
// are widened as they are staged). 256 threads as 16 x 16: thread (ty, tx)
// owns 4 query rows, keys tx and tx + 16 of each 32-key tile, and columns
// tx + 16 i of the accumulator. The 16 threads of a row group share a
// half-warp, so the row max and row sum are 4 shuffles each.
//
// What bounds it on an H100: at the gemma3-12b prefill shape (B=4, S=2048,
// H=16, Hkv=8, hd=240, bf16) each live (query, key) pair costs 4 hd
// operations (q.k and p.v), about 0.13 TFLOP for a causal layer, against
// 0.19 GB of q, k, v and o: the operations bound it by far, at the fp32
// FMA peak of 67 TFLOP/s that this kernel's type of arithmetic can reach
// (the bf16 tensor cores would be 989 TFLOP/s: a later version's work).
// The design answers with register accumulators, float4 shared loads laid
// out so a half-warp's K rows fall on distinct banks, and dead-tile skipping.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py). Entry points have
//        a plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 32;               // keys per KV tile
constexpr int kTX = 16;               // threads across keys / accumulator columns
constexpr int kTY = 16;               // threads down the query rows
constexpr int kNT = kTX * kTY;        // threads per block
constexpr int kRows = kBQ / kTY;      // query rows per thread
constexpr int kKeys = kBK / kTX;      // keys per thread per tile
constexpr int kPL = kBK + 1;          // padded row of the probability tile
constexpr float kNegInf = -1e30f;

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

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (HDP + 4) + (size_t)kBK * (HDP + 4) +
                          (size_t)kBK * HDP + (size_t)kBQ * kPL);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kNT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int S, int H, int Hkv, int hd, int causal, int window,
    float scale) {
  constexpr int LD = HDP + 4;         // padded row of the Q and K tiles
  constexpr int kCols = HDP / kTX;    // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * HDP;

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const long long q_stride = (long long)H * hd;   // between positions
  const long long kv_stride = (long long)Hkv * hd;
  const T* qb = q + (long long)b * S * q_stride + (long long)h * hd;
  const T* kb = k + (long long)b * S * kv_stride + (long long)hk * hd;
  const T* vb = v + (long long)b * S * kv_stride + (long long)hk * hd;
  T* ob = o + (long long)b * S * q_stride + (long long)h * hd;

  for (int i = tid; i < kBQ * HDP; i += kNT) {
    const int rr = i / HDP, d = i % HDP, s = q0 + rr;
    Qs[rr * LD + d] = (s < S && d < hd) ? to_f32(qb[s * q_stride + d]) : 0.f;
  }

  // the KV tiles some pair of this query tile leaves live, ascending
  const int q_last = min(q0 + kBQ, S) - 1;
  int kt_lo = 0, kt_hi = (S - 1) / kBK;
  if (causal) {
    kt_hi = q_last / kBK;
    if (window > 0) kt_lo = max(0, q0 - window + 1) / kBK;
  }

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kBK * HDP; i += kNT) {
      const int rr = i / HDP, d = i % HDP, s = k0 + rr;
      const bool in = s < S && d < hd;
      Ks[rr * LD + d] = in ? to_f32(kb[s * kv_stride + d]) : 0.f;
      Vs[rr * HDP + d] = in ? to_f32(vb[s * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    float sc[kRows][kKeys];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kKeys; ++c) sc[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; d += 4) {
      float4 qv[kRows], kv[kKeys];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        qv[r] = *reinterpret_cast<const float4*>(&Qs[(ty * kRows + r) * LD + d]);
#pragma unroll
      for (int c = 0; c < kKeys; ++c)
        kv[c] = *reinterpret_cast<const float4*>(&Ks[(tx + c * kTX) * LD + d]);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kKeys; ++c) {
          float a = sc[r][c];
          a = fmaf(qv[r].x, kv[c].x, a);
          a = fmaf(qv[r].y, kv[c].y, a);
          a = fmaf(qv[r].z, kv[c].z, a);
          a = fmaf(qv[r].w, kv[c].w, a);
          sc[r][c] = a;
        }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + ty * kRows + r;
      bool ok[kKeys];
      float tmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int kp = k0 + tx + c * kTX;
        bool live = kp < S;
        if (causal) {
          live = live && kp <= qp;
          if (window > 0) live = live && kp > qp - window;
        }
        ok[c] = live;
        sc[r][c] *= scale;
        if (live) tmax = fmaxf(tmax, sc[r][c]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[r], tmax);
      const float corr = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const float p = ok[c] ? expf(sc[r][c] - m_new) : 0.f;
        psum += p;
        Ps[(ty * kRows + r) * kPL + tx + c * kTX] = p;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[r] = l[r] * corr + psum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pr[r] = Ps[(ty * kRows + r) * kPL + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = Vs[kk * HDP + tx + c * kTX];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(pr[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + ty * kRows + r;
    if (qp >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + c * kTX;
      if (d < hd) ob[qp * q_stride + d] = from_f32<T>(acc[r][c] / den);
    }
  }
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                   int H, int Hkv, int hd, int causal, int window, float scale,
                   cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<HDP>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, HDP><<<grid, kNT, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, Hkv, hd, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int S,
                     int H, int Hkv, int hd, int causal, int window, float scale,
                     cudaStream_t st) {
  if (hd <= 64) return launch<T, 64>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, st);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, st);
  return launch<T, 256>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, st);
}

}  // namespace

extern "C" {

// o (B, S, H, hd) = attention of q (B, S, H, hd) over k, v (B, S, Hkv, hd),
// all contiguous, fp32 when dtype == 0 and bf16 when dtype == 1. causal != 0
// masks keys after the query; window > 0 (only with causal) also masks keys
// window or more positions before it. H must be a multiple of Hkv, and
// 1 <= hd <= 256. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                        int S, int H, int Hkv, int hd, int causal, int window,
                        float scale, int dtype, void* stream) {
  if (B < 0 || S < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 || hd < 1 || hd > 256 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, B, S, H, Hkv, hd, causal, window, scale, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, hd, causal, window,
                                        scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
