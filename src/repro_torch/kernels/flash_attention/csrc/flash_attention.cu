// Flash attention for Hopper (sm_90a), forward and backward: causal, sliding-window or
// unmasked GQA attention with an online softmax in fp32, the query and key
// lengths apart (self attention, and cross attention onto an encoder).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (body _flash_kernel). It computes the same function: q (B, Sq, H, hd),
// k and v (B, Sk, Hkv, hd), fp32 or bf16; o (B, Sq, H, hd) in q's type, with
// o = softmax(q k^T * hd^-0.5 + mask) v, where the mask keeps key j < Sk and,
// when causal, key j for query i when j <= i, both counted from 0 (the
// Pallas kernel's rule, whatever Sq and Sk are) and, with a window,
// i - j < window (the window applies only when causal). A query row with no
// live key comes out 0. Running max, sum and accumulator are fp32. It is not
// a block-by-block copy of the Pallas version:
//
// * The TPU grid carries (m, l, acc) in VMEM scratch across a sequential
//   KV grid axis. Here one thread block owns a query tile of one (b, h)
//   and loops over the KV tiles itself, in ascending order, visiting only
//   the tiles that some (query, key) pair of the tile leaves live: a
//   windowed tile far below the diagonal and every tile above it are never
//   loaded.
// * A masked score contributes exactly 0 to the sum and the accumulator
//   (it is never exponentiated), so a row with no live key in a live tile
//   stays at l = 0, acc = 0 and costs nothing when its first live key comes.
//   The result does not rest on -1e30 underflowing in exp, as the TPU
//   kernel's does.
// * GQA: query head h reads KV head h / (H / Hkv) by index; K and V are
//   never repeated in memory. The kernels read the (B, S, heads, hd) layout
//   in place and the ragged Sq, Sk and hd edges arrive zero-filled in shared
//   memory, so nothing is transposed or padded in device memory. A key tile
//   that crosses Sk is an edge tile: its zero-filled keys score 0, which is
//   live unless masked, so the key mask (key < Sk) runs there causal or not.
//   hd is any
//   value up to 256 (gemma3's 240 included); it runs at the next of 64,
//   128, 256.
//
// Three kernels, chosen by the input type and the layout
// (flash_attention_fwd_route):
//
// fp32 in a layout TMA can take (hd a multiple of 4, q, k, v and o 16-byte
//   aligned; every configuration of the repo): tc::x3::flash_fwd_x3_kernel,
//   both products on the tensor cores as three TF32 products each (route
//   tf32x3; the forward's note at the kernel, below). One TF32 product a
//   product would break the reference's fp32 tolerance of 2e-5; three, of
//   each operand's big and small TF32 terms, hold it
//   (tests/test_torch_flash_attention_fwd_tf32.py).
//
// fp32 in other layouts: flash_fwd_kernel, fp32 FMA on the CUDA cores (route
//   fma). 256 threads as 16 x 16: thread (ty, tx) owns 4 query rows, keys tx
//   and tx + 16 of each 32-key tile, and columns tx + 16 i of the
//   accumulator. The 16 threads of a row group share a half-warp, so the row
//   max and row sum are 4 shuffles each. It executes 4 hd operations per
//   live (query, key) pair at the fp32 FMA peak (67 TFLOP/s).
//
// bf16: flash_fwd_tc_kernel, both products on the tensor cores (wgmma,
//   bf16 in, fp32 accumulate; 989 TFLOP/s). What bounds it at the
//   gemma3-12b prefill shape (B=4, S=2048, H=16, Hkv=8, hd=240) is the
//   same count of operations, about 0.13 TFLOP a causal layer against
//   0.19 GB of q, k, v and o, so the design keeps the tensor cores fed:
//   - 384 threads: warpgroups 0 and 1 consume, 64 query rows each (a
//     128-row query tile); warpgroup 2 produces. setmaxnreg moves registers
//     to the consumers (240 each, the producer keeps 24), which hold O
//     (64 x 256 fp32: 128 a thread), S, and P.
//   - The producer's one thread loads the Q tile once and the 64-key K and
//     V tiles into a 2-stage ring in shared memory with TMA (descriptors
//     encoded on the host per call, passed as __grid_constant__), each
//     stage guarded by a full and an empty mbarrier. The descriptors give
//     the true extents (Q's Sq, K's and V's Sk, hd), so TMA zero-fills the
//     ragged edges. Tiles
//     are 128-byte swizzled panels of 64 columns, the layout the wgmma
//     descriptors read; hd 240 runs at 256 with the tail zero (6.7% more
//     work). Where TMA cannot take the layout (hd not a multiple of 8, or
//     a base address not 16-byte aligned; no configuration of the repo
//     has such an hd) bf16 runs flash_fwd_kernel's bf16 instance instead.
//   - S = Q K^T: wgmma m64n64k16 from shared memory, K-major both.
//     O += P V: P from registers (the S accumulator's fragment is the A
//     fragment), V from shared memory as the MN-major (transposed) B
//     operand, N = 64, 128 or 256.
//   - P is fp32; it goes in as two bf16 terms, hi = bf16(p) and
//     lo = bf16(p - hi), two wgmma into the same fp32 O: one rounding of P
//     to bf16 (as FlashAttention and SDPA do) would break the one-ulp bf16
//     tolerance at thousands of outputs at this shape; hi + lo holds it.
//     That makes 6 hd tensor-core operations a live pair, not 4. The row
//     sum l adds the fp32 p.
//   - Dead tiles are skipped per warpgroup, the mask is applied only in
//     tiles that cross the diagonal, the window's edge or Sk, and the grid
//     runs the heaviest query tiles (the last) first.
//
// Each forward kernel also writes each query row's fp32 log-sum-exp of its
// scaled scores, lse (B, H, Sq), when the caller gives a buffer for it (null
// leaves the launch as it was); a row with no live key gets +inf. The
// backward's kernels (below: on the tensor cores for bf16 and, as 3xTF32,
// for fp32 in a layout TMA can take, on the FMA pipes otherwise) recompute
// the probabilities from it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py). Entry points have
//        a plain C interface, loaded with ctypes. cuTensorMapEncodeTiled is
//        reached through the runtime's driver entry point, so nothing links
//        against libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
    T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int hd,
    int causal, int window, float scale) {
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
  const T* qb = q + (long long)b * Sq * q_stride + (long long)h * hd;
  const T* kb = k + (long long)b * Sk * kv_stride + (long long)hk * hd;
  const T* vb = v + (long long)b * Sk * kv_stride + (long long)hk * hd;
  T* ob = o + (long long)b * Sq * q_stride + (long long)h * hd;

  for (int i = tid; i < kBQ * HDP; i += kNT) {
    const int rr = i / HDP, d = i % HDP, s = q0 + rr;
    Qs[rr * LD + d] = (s < Sq && d < hd) ? to_f32(qb[s * q_stride + d]) : 0.f;
  }

  // the KV tiles some pair of this query tile leaves live, ascending (none
  // when a window lies wholly past Sk: the rows then come out 0)
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kt_lo = 0, kt_hi = (Sk - 1) / kBK;
  if (causal) {
    kt_hi = min(q_last, Sk - 1) / kBK;
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
      const bool in = s < Sk && d < hd;
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
        bool live = kp < Sk;
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
    if (qp >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + c * kTX;
      if (d < hd) ob[qp * q_stride + d] = from_f32<T>(acc[r][c] / den);
    }
    // m and l are the same in the 16 threads of the row group
    if (lse != nullptr && tx == 0)
      lse[(long long)bh * Sq + qp] = l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
  }
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                   float scale, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<HDP>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, HDP><<<grid, kNT, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Sk, H, Hkv, hd, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                     int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                     float scale, cudaStream_t st) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, causal, window, scale, st);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, causal, window, scale, st);
  return launch<T, 256>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, causal, window, scale, st);
}


// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBQ = 128;        // query rows per block: two consumer warpgroups
constexpr int kBK = 64;         // keys per KV tile
constexpr int kStages = 2;      // K/V ring depth
constexpr int kThreads = 384;   // warpgroups 0, 1 consume; 2 produces
constexpr int kSpinLimit = 1 << 24;  // mbarrier polls before a trap (a hang becomes an error)

// Shared memory, in bytes from a 1024-aligned base: Q (NP panels of 128 rows),
// then K[kStages], then V[kStages] (NP panels of 64 rows each), then the
// barriers. A panel holds 64 columns: rows of 128 bytes, 128-byte swizzled.
template <int HDP>
struct Layout {
  static constexpr int NP = HDP / 64;
  static constexpr int kQPanel = kBQ * 128;
  static constexpr int kKVPanel = kBK * 128;
  static constexpr int kQ = NP * kQPanel;
  static constexpr int kKV = NP * kKVPanel;   // one K or V tile
  static constexpr int kBar = kQ + 2 * kStages * kKV;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  int tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++tries == kSpinLimit) __trap();
  } while (!done);
}

// one box of a 4-D tensor map (hd, heads, S, B) into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int head, int pos, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(head), "r"(pos), "r"(b), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: before
// wgmma.fence, so every write to them is done when the fence orders them;
// after wgmma.wait_group, so no use moves above the wait.
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64, fp32) = A.B (+ d when acc != 0); A and B from shared memory
// through descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64, fp32) += A.B; A (64 x 16, bf16) from registers in the
// accumulator's fragment order, B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A.B; A (64 x 16, bf16) from registers in the
// accumulator's fragment order, B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, fp32) += A.B; A (64 x 16, bf16) from registers in the
// accumulator's fragment order, B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HDP>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (HDP == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (HDP == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// (x0, x1) fp32 as N bf16x2 terms of the A fragment, `stride` registers
// apart: t[0] = bf16(x), t[1] = bf16(x - t[0]), t[2] = bf16(x - t[0] - t[1])
// (each difference exact in fp32). Two terms keep about 16 of x's 24
// significant bits, three all of them.
template <int N>
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t* t, int stride) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    t[n * stride] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_tc_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
    float scale_log2) {
  using L = Layout<HDP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base;
  auto sk = [&](int s) { return base + L::kQ + s * L::kKV; };
  auto sv = [&](int s) { return base + L::kQ + (kStages + s) * L::kKV; };
  const uint32_t q_full = base + L::kBar;
  auto full = [&](int s) { return q_full + 8 * (1 + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + kStages + s); };

  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest (last) tiles first
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kt_lo = 0, kt_hi = (Sk - 1) / kBK;
  if (causal) {
    kt_hi = min(q_last, Sk - 1) / kBK;
    if (window > 0) kt_lo = max(0, q0 - window + 1) / kBK;
  }
  // <= 0 when a window lies wholly past Sk: no tile is loaded, the rows are 0
  const int n_tiles = kt_hi - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: Q once, then the K/V ring -------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tw == 0) {
      mbar_expect_tx(q_full, L::kQ);
      for (int p = 0; p < L::NP; ++p)
        tma_load(sq + p * L::kQPanel, &tq, q_full, p * 64, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int k0 = (kt_lo + it) * kBK;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kKV);
        for (int p = 0; p < L::NP; ++p) {
          tma_load(sk(s) + p * L::kKVPanel, &tk, full(s), p * 64, hk, k0, b);
          tma_load(sv(s) + p * L::kKVPanel, &tv, full(s), p * 64, hk, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = tw % 32;
    // this thread's accumulator rows: qp0 and qp0 + 8 (wgmma's fragment)
    const int qp0 = q0 + wg * 64 + (tw / 32) * 16 + lane / 4, qp1 = qp0 + 8;
    const int w_first = q0 + wg * 64, w_last = min(w_first + 63, Sq - 1);
    float acc[HDP / 2];
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j) acc[j] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int k0 = (kt_lo + it) * kBK;
      mbar_wait(full(s), (it / kStages) & 1);
      bool dead = w_last < w_first;  // every row of this warpgroup lies beyond Sq
      if (causal) {
        dead = dead || k0 > w_last;
        if (window > 0) dead = dead || k0 + kBK - 1 <= w_first - window;
      }
      if (!dead) {
        // S = Q K^T over HDP / 16 steps of 16 columns
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        pin<32>(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint32_t col = (kk / 4), off = (kk % 4) * 32;
          wgmma_ss_n64(sc,
                       sw128_desc(sq + col * L::kQPanel + wg * 64 * 128 + off, 16, 1024),
                       sw128_desc(sk(s) + col * L::kKVPanel + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        pin<32>(sc);

        // mask, only in tiles that cross Sk, the diagonal or the window's edge
        const bool edge =
            k0 + kBK > Sk ||
            (causal && (k0 + kBK - 1 > w_first || (window > 0 && k0 <= w_last - window)));
        if (edge) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int key = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
            const int qp = (i & 2) ? qp1 : qp0;
            bool live = key < Sk;
            if (causal) live = live && key <= qp && (window <= 0 || key > qp - window);
            if (!live) sc[i] = -INFINITY;
          }
        }
        // online softmax: rows qp0 (elements with i & 2 == 0) and qp1
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (i & 2) mx1 = fmaxf(mx1, sc[i]);
          else mx0 = fmaxf(mx0, sc[i]);
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float b0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
        const float b1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
        const float c0 = exp2f(m0 * scale_log2 - b0), c1 = exp2f(m1 * scale_log2 - b1);
        m0 = mx0;
        m1 = mx1;
        l0 *= c0;
        l1 *= c1;
#pragma unroll
        for (int j = 0; j < HDP / 2; ++j) acc[j] *= (j & 2) ? c1 : c0;
        // P = hi + lo, two bf16 terms of the fp32 p, in the A fragment order
        uint32_t pt[32];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float bb = (i & 1) ? b1 : b0;
          const float e0 = sc[2 * i], e1 = sc[2 * i + 1];
          const float p0 = (edge && e0 == -INFINITY) ? 0.f : exp2f(fmaf(e0, scale_log2, -bb));
          const float p1 = (edge && e1 == -INFINITY) ? 0.f : exp2f(fmaf(e1, scale_log2, -bb));
          if (i & 1) l1 += p0 + p1;
          else l0 += p0 + p1;
          split_bf16<2>(p0, p1, pt + i, 16);
        }
        // O += P_hi V + P_lo V over 4 steps of 16 keys
        pin<HDP / 2>(acc);
        pin<32>(pt);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_pv<HDP>(acc, pt + 16 * t + 4 * kk,
                          sw128_desc(sv(s) + kk * 2048, L::kKVPanel, 1024));
        wgmma_commit();
        wgmma_wait0();
        pin<HDP / 2>(acc);
        pin<32>(pt);
      }
      mbar_arrive(empty(s));
    }

    // epilogue: the row sums over the quad, then o = acc / l in bf16
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    // the natural log-sum-exp of the scaled scores: m is the raw score's
    // max, l the sum of 2^((s - m) * scale_log2); m and l are the same in a
    // quad
    if (lse != nullptr && lane % 4 == 0) {
      constexpr float kLn2 = 0.6931471805599453f;
      float* lb = lse + (long long)blockIdx.x * Sq;
      if (qp0 < Sq) lb[qp0] = l0 > 0.f ? (m0 * scale_log2 + log2f(l0)) * kLn2 : INFINITY;
      if (qp1 < Sq) lb[qp1] = l1 > 0.f ? (m1 * scale_log2 + log2f(l1)) * kLn2 : INFINITY;
    }
    const long long q_stride = (long long)H * hd;
    __nv_bfloat16* ob = o + (long long)b * Sq * q_stride + (long long)h * hd;
    const bool pairs = (hd % 2 == 0) && (reinterpret_cast<uintptr_t>(o) % 4 == 0);
#pragma unroll
    for (int j = 0; j < HDP / 2; j += 2) {
      const int d = (j / 4) * 8 + (lane % 4) * 2;
      const int qp = (j & 2) ? qp1 : qp0;
      const float den = (j & 2) ? den1 : den0;
      if (qp < Sq && d < hd) {
        __nv_bfloat16* dst = ob + qp * q_stride + d;
        const float x0 = acc[j] / den, x1 = acc[j + 1] / den;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
        } else {
          dst[0] = __float2bfloat16(x0);
          if (d + 1 < hd) dst[1] = __float2bfloat16(x1);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (B, S, heads, hd) bf16 (esz 2) or fp32 (esz 4) as a 4-D map (hd, heads, S,
// B), boxes of 128 bytes of columns (64 bf16, 32 fp32) x 1 head x `rows`
// positions, 128-byte swizzle, zero fill out of bounds
cudaError_t encode(CUtensorMap* map, const void* ptr, int B, int S, int heads, int hd,
                   int rows, int esz = 2) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * esz, (cuuint64_t)heads * hd * esz,
                                 (cuuint64_t)S * heads * hd * esz};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / esz), 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, esz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        4, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                   float scale, cudaStream_t st) {
  constexpr int bytes = Layout<HDP>::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_tc_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;
  cudaError_t e = encode(&tq, q, B, Sq, H, hd, kBQ);
  if (e == cudaSuccess) e = encode(&tk, k, B, Sk, Hkv, hd, kBK);
  if (e == cudaSuccess) e = encode(&tv, v, B, Sk, Hkv, hd, kBK);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_tc_kernel<HDP><<<grid, kThreads, bytes, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H, Hkv, hd, causal, window,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// TMA takes the layout: rows of hd bf16 a multiple of 16 bytes, and 16-byte
// aligned bases
bool tma_layout(const void* q, const void* k, const void* v, int hd) {
  return hd % 8 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v)) % 16) == 0;
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                     int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                     float scale, cudaStream_t st) {
  if ((long long)Sq > 65535LL * kBQ) return cudaErrorInvalidValue;
  if (hd <= 64)
    return launch<64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, causal, window, scale, st);
  if (hd <= 128)
    return launch<128>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, causal, window, scale, st);
  return launch<256>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, causal, window, scale, st);
}


// ---------------------------------------------------------------------------
// bf16 backward on the tensor cores: dQ (and delta), then dK and dV. The
// design and what bounds it are in the backward's note below.
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTerms = 3;   // bf16 terms of p and dS in the backward's products
// columns of a tile's product summed on the tensor cores at a time
// (add_tile_product): 64, a 32-register accumulator. All 128 of hd 128 at
// once spilled the dK/dV kernel's registers inside its loop (ptxas, with
// the consumers' 240); 64 keeps the loops free of spill traffic.
constexpr int kTileCols = 64;

// Shared memory of the two backward kernels, in bytes from a 1024-aligned
// base: two resident tiles of RES rows (dq: Q and dO, dq_rows: 128, or 64
// at HDP 256; dk/dv: K and V, 64), then a ring of kStages pairs of
// streamed tiles of kBK rows (dq: K and V; dk/dv: Q and dO), each NP
// 128-byte swizzled panels of 64 columns as in Layout; then the streamed
// query tiles' lse (base 2) and delta, kBK fp32 each a stage (dk/dv); then
// the barriers.
template <int HDP, int RES>
struct BwdLayout {
  static constexpr int NP = HDP / 64;
  static constexpr int kResPanel = RES * 128;
  static constexpr int kStrPanel = kBK * 128;
  static constexpr int kRes = NP * kResPanel;   // one resident tile
  static constexpr int kStr = NP * kStrPanel;   // one streamed tile
  static constexpr int kRows = 2 * kRes + 2 * kStages * kStr;
  static constexpr int kBar = kRows + kStages * 2 * kBK * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// acc (the 64 x OC fp32 fragment of rows r0, r0 + 8) += A B, A (64 x 64)
// as kTerms bf16 terms in registers (the S-shaped fragment, 16 registers a
// term), B (64 x OC) MN-major from shared memory at `b` in panels of 64
// columns `panel` bytes apart. kTileCols columns at a time are summed on
// the tensor cores into a zeroed accumulator (4 steps of 16 rows of B for
// each term), then added to acc in fp32, so that a sum on the tensor cores
// spans one tile.
template <int OC>
__device__ __forceinline__ void add_tile_product(float* acc, uint32_t* a, uint32_t b,
                                                 uint32_t panel) {
  constexpr int NC = OC < kTileCols ? OC : kTileCols;
#pragma unroll
  for (int part = 0; part < OC / NC; ++part) {
    float tile[NC / 2];
#pragma unroll
    for (int j = 0; j < NC / 2; ++j) tile[j] = 0.f;
    pin<NC / 2>(tile);
    pin<16 * kTerms>(a);
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < kTerms; ++n)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<NC>(tile, a + 16 * n + 4 * kk,
                     sw128_desc(b + part * (NC / 64) * panel + kk * 2048, panel, 1024));
    wgmma_commit();
    wgmma_wait0();
    pin<NC / 2>(tile);
    pin<16 * kTerms>(a);
#pragma unroll
    for (int j = 0; j < NC / 2; ++j) acc[NC / 2 * part + j] += tile[j];
  }
}

// x, opaque to the compiler. At HDP 256 the backward kernels take their
// block's coordinates through this after setmaxnreg, in each warp role, so
// that nothing derived from them is formed before the roles part (a value
// live across setmaxnreg.dec must fit the producer's registers, and ptxas
// spilled such values to local memory), and the dq kernel takes its
// epilogue's block and row through it, so that what the stores need is
// formed after the tile loop, not kept through it
__device__ __forceinline__ int fresh(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// 2^x as one MUFU.EX2 (ex2.approx.ftz; 2^-inf is +0): exp2f adds range
// handling for results below 2^-126, which the backward's p can flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc + the 8 products of two 16-byte chunks of bf16, widened to fp32
__device__ __forceinline__ float dot8(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                      float acc) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 yf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    acc = fmaf(xf.x, yf.x, acc);
    acc = fmaf(xf.y, yf.y, acc);
  }
  return acc;
}

// rows r0 and r0 + 8 of a 64-row accumulator fragment (HDP / 2 fp32 a thread:
// element j is row r0 + 8 * ((j / 2) % 2), column (j / 4) * 8 + 2 * (lane % 4)
// + j % 2) into bf16 rows of `out`, `stride` elements apart; rows at or past
// `n_rows` and columns at or past hd are not written
template <int HDP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long stride, int r0,
                                           int n_rows, int hd, int lane, const float* acc) {
  const bool pairs = (hd % 2 == 0) && (reinterpret_cast<uintptr_t>(out) % 4 == 0);
#pragma unroll
  for (int j = 0; j < HDP / 2; j += 2) {
    const int d = (j / 4) * 8 + (lane % 4) * 2;
    const int r = (j & 2) ? r0 + 8 : r0;
    if (r < n_rows && d < hd) {
      __nv_bfloat16* dst = out + r * stride + d;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc[j], acc[j + 1]);
      } else {
        dst[0] = __float2bfloat16(acc[j]);
        if (d + 1 < hd) dst[1] = __float2bfloat16(acc[j + 1]);
      }
    }
  }
}

// The dq kernel's block up to HDP 128: 128 query rows, 64 a consumer, each
// consumer summing all HDP columns of its rows. At HDP 256 (the note
// below): 64 rows, both consumers forming S, dP and dS of every live tile
// of them, consumer w summing dq's columns 128 w to 128 w + 127.
template <int HDP>
__host__ __device__ constexpr int dq_rows() { return HDP <= 128 ? kBQ : 64; }
// columns of an output a consumer sums (dq here; dk or dv in the dK/dV
// kernel, whose grid takes the halves at HDP 256)
template <int HDP>
__host__ __device__ constexpr int out_cols() { return HDP <= 128 ? HDP : 128; }

// dQ of dq_rows query rows of one (b, h), and their delta = sum dO.O
// (written to `delta` for the dK/dV kernel). Warpgroups 0 and 1 consume
// (64 rows each, all columns; at HDP 256 the same 64 rows, half the columns
// each); the producer warp's first lane loads Q and dO once and streams the
// live K and V tiles through the ring.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_tc_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
    int Sq, int Sk, int H, int Hkv, int hd, int causal, int window, float scale) {
  constexpr int BQ = dq_rows<HDP>(), OC = out_cols<HDP>();
  constexpr bool kShared = BQ == 64;   // both consumers on the same rows
  using L = BwdLayout<HDP, BQ>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sdo = base + L::kRes;
  auto sk = [&](int s) { return base + 2 * L::kRes + s * L::kStr; };
  auto sv = [&](int s) { return base + 2 * L::kRes + (kStages + s) * L::kStr; };
  const uint32_t res_full = base + L::kBar;
  auto full = [&](int s) { return res_full + 8 * (1 + s); };
  auto empty = [&](int s) { return res_full + 8 * (1 + kStages + s); };

  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  // the block's (b, h), first query row and live key tiles, kt_lo on; n_tiles
  // <= 0 when a window lies wholly past Sk. Formed before the roles part up
  // to HDP 128, in each role at HDP 256 (fresh)
  int bh, b, h, q0, kt_lo, n_tiles;
  auto block = [&](int bx, int by) {
    bh = bx;
    b = bh / H;
    h = bh % H;
    q0 = (gridDim.y - 1 - by) * BQ;  // heaviest (last) tiles first
    const int q_last = min(q0 + BQ, Sq) - 1;
    int kt_hi = (Sk - 1) / kBK;
    kt_lo = 0;
    if (causal) {
      kt_hi = min(q_last, Sk - 1) / kBK;
      if (window > 0) kt_lo = max(0, q0 - window + 1) / kBK;
    }
    n_tiles = kt_hi - kt_lo + 1;
  };
  if constexpr (!kShared) block(blockIdx.x, blockIdx.y);

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: Q and dO once, then the K/V ring ---------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tw == 0) {
      if constexpr (kShared) block(fresh(blockIdx.x), fresh(blockIdx.y));
      const int hk = h / (H / Hkv);
      mbar_expect_tx(res_full, 2 * L::kRes);
      for (int p = 0; p < L::NP; ++p) {
        tma_load(sq + p * L::kResPanel, &tq, res_full, p * 64, h, q0, b);
        tma_load(sdo + p * L::kResPanel, &tdo, res_full, p * 64, h, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int k0 = (kt_lo + it) * kBK;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kStr);
        for (int p = 0; p < L::NP; ++p) {
          tma_load(sk(s) + p * L::kStrPanel, &tk, full(s), p * 64, hk, k0, b);
          tma_load(sv(s) + p * L::kStrPanel, &tv, full(s), p * 64, hk, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    if constexpr (kShared) block(fresh(blockIdx.x), fresh(blockIdx.y));
    const int lane = tw % 32;
    const int row0 = kShared ? 0 : wg * 64;   // the warpgroup's first row in the block
    const int col0 = kShared ? wg * OC : 0;   // and its first column of dq
    const int r0 = row0 + (tw / 32) * 16 + lane / 4;   // rows r0 and r0 + 8 of the block
    const int qp0 = q0 + r0, qp1 = qp0 + 8;
    const int w_first = q0 + row0, w_last = min(w_first + 63, Sq - 1);
    const long long q_stride = (long long)H * hd;
    const long long q_base = (long long)b * Sq * q_stride + (long long)h * hd;
    // delta of rows qp0 and qp1: the quad's four threads take every fourth
    // 16-byte chunk of the row, then sum over the quad (the same bits in all
    // four, and in both warpgroups where they share the rows; warpgroup 0
    // writes it)
    const long long row_0 = q_base + qp0 * q_stride, row_1 = q_base + qp1 * q_stride;
    float d0 = 0.f, d1 = 0.f;
    for (int c = (lane % 4) * 8; c < hd; c += 32) {
      if (qp0 < Sq) d0 = dot8(dout + row_0 + c, o + row_0 + c, d0);
      if (qp1 < Sq) d1 = dot8(dout + row_1 + c, o + row_1 + c, d1);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, off);
      d1 += __shfl_xor_sync(0xffffffffu, d1, off);
    }
    if (lane % 4 == 0 && (!kShared || wg == 0)) {
      if (qp0 < Sq) delta[(long long)bh * Sq + qp0] = d0;
      if (qp1 < Sq) delta[(long long)bh * Sq + qp1] = d1;
    }
    // lse in base 2; a row past Sq takes +inf, so its p is 0
    const float* lrow = lse + (long long)bh * Sq;
    const float l0 = qp0 < Sq ? lrow[qp0] * kLog2e : INFINITY;
    const float l1 = qp1 < Sq ? lrow[qp1] * kLog2e : INFINITY;
    const float scale_log2 = scale * kLog2e;
    float acc[OC / 2];
#pragma unroll
    for (int j = 0; j < OC / 2; ++j) acc[j] = 0.f;
    mbar_wait(res_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int k0 = (kt_lo + it) * kBK;
      mbar_wait(full(s), (it / kStages) & 1);
      bool dead = w_last < w_first;  // every row of this warpgroup lies past Sq
      if (causal) {
        dead = dead || k0 > w_last;
        if (window > 0) dead = dead || k0 + kBK - 1 <= w_first - window;
      }
      if (!dead) {
        // S = Q K^T and dP = dO V^T, 64 x 64 each, over HDP / 16 steps
        float sc[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
        pin<32>(sc);
        pin<32>(dp);
        const uint32_t qa = sq + row0 * 128, da = sdo + row0 * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint32_t off = (kk / 4) * L::kResPanel + (kk % 4) * 32;
          const uint32_t koff = (kk / 4) * L::kStrPanel + (kk % 4) * 32;
          wgmma_ss_n64(sc, sw128_desc(qa + off, 16, 1024), sw128_desc(sk(s) + koff, 16, 1024),
                       kk > 0);
          wgmma_ss_n64(dp, sw128_desc(da + off, 16, 1024), sw128_desc(sv(s) + koff, 16, 1024),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        pin<32>(sc);
        pin<32>(dp);

        // p = 2^(s scale log2(e) - lse log2(e)) on live pairs, dS = p (dP -
        // delta) scale, as kTerms bf16 terms in the A fragment's order. The
        // mask only in tiles that cross Sk, the diagonal or the window's
        // edge (a uniform branch, so the elementwise code has none); a
        // masked pair's exponent is -inf, so its p is exactly 0 and its
        // score never enters
        const bool edge =
            k0 + kBK > Sk ||
            (causal && (k0 + kBK - 1 > w_first || (window > 0 && k0 <= w_last - window)));
        uint32_t dst[16 * kTerms];
        auto ds_terms = [&](auto edge_tag) {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int qp = (i & 1) ? qp1 : qp0;
            const float lz = (i & 1) ? l1 : l0, dz = (i & 1) ? d1 : d0;
            float x[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + (i / 2) * 8 + (lane % 4) * 2 + e;
              bool live = true;
              if constexpr (decltype(edge_tag)::value)
                live = key < Sk && (!causal || (key <= qp && (window <= 0 || qp - key < window)));
              const float arg = fmaf(sc[2 * i + e], scale_log2, -lz);
              const float p = exp2_ftz(live ? arg : -INFINITY);
              x[e] = p * (dp[2 * i + e] - dz) * scale;
            }
            split_bf16<kTerms>(x[0], x[1], dst + i, 16);
          }
        };
        if (edge)
          ds_terms(std::true_type{});
        else
          ds_terms(std::false_type{});
        // dQ (this warpgroup's columns) += this tile's dS K (K as the
        // MN-major B, from its column col0 on)
        add_tile_product<OC>(acc, dst, sk(s) + (col0 / 64) * L::kStrPanel, L::kStrPanel);
      }
      mbar_arrive(empty(s));
    }
    if constexpr (kShared) {
      const int bx = fresh(blockIdx.x);
      const long long row_base = (long long)(bx / H) * Sq * q_stride + (long long)(bx % H) * hd;
      store_rows<OC>(dq + row_base + col0, q_stride, fresh(qp0), Sq, hd - col0, lane, acc);
    } else {
      store_rows<OC>(dq + q_base, q_stride, qp0, Sq, hd, lane, acc);
    }
  }
}

// dK and dV of 64 keys of one (b, kv head), out_cols of their columns (all
// up to HDP 128; at HDP 256 the half blockIdx.z names). Warpgroup 0 forms
// dV and warpgroup 1 dK, each for all 64 keys, each held in registers over
// the whole loop; the producer warp's first lane loads K and V once and
// streams, for each query head of the group and each query tile some key
// of the block leaves live, the Q and dO tiles, and the warp copies that
// tile's lse (base 2) and delta into the ring beside them.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv_tc_kernel(
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
    int Hkv, int hd, int causal, int window, float scale) {
  constexpr int OC = out_cols<HDP>();
  using L = BwdLayout<HDP, kBK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base, sv = base + L::kRes;
  auto sq = [&](int s) { return base + 2 * L::kRes + s * L::kStr; };
  auto sdo = [&](int s) { return base + 2 * L::kRes + (kStages + s) * L::kStr; };
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kRows);
  auto lse_s = [&](int s) { return rows + s * 2 * kBK; };
  auto delta_s = [&](int s) { return rows + s * 2 * kBK + kBK; };
  const uint32_t res_full = base + L::kBar;
  auto full = [&](int s) { return res_full + 8 * (1 + s); };
  auto empty = [&](int s) { return res_full + 8 * (1 + kStages + s); };

  constexpr bool kWide = HDP > 128;
  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int R = H / Hkv;
  // the block's (b, kv head), first key, first column of dk and dv, and
  // the query tiles some key of it leaves live, qt_lo on, n_q of them for
  // each query head. Formed before the roles part up to HDP 128, in each
  // role at HDP 256 (fresh)
  int b, hk, k0, col0, k_last, qt_lo, n_q;
  auto block = [&](int bx, int by, int bz) {
    b = bx / Hkv;
    hk = bx % Hkv;
    k0 = by * kBK;   // causal: the lowest keys, the heaviest blocks, first
    col0 = kWide ? bz * OC : 0;
    k_last = min(k0 + kBK, Sk) - 1;
    int qt_hi = (Sq - 1) / kBK;
    qt_lo = 0;
    if (causal) {
      qt_lo = k0 / kBK;
      if (window > 0) qt_hi = min(Sq - 1, k_last + window - 1) / kBK;
    }
    n_q = max(0, qt_hi - qt_lo + 1);
  };
  if constexpr (!kWide) block(blockIdx.x, blockIdx.y, blockIdx.z);

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1 + 32);   // lane 0's expect_tx and the warp's 32 arrivals
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: K and V once, then the Q/dO ring; thread 0 issues the TMA
    // loads, warp 0 copies each tile's lse (base 2) and delta (a query past
    // Sq: lse +inf, so p = 0, and delta 0) ----------------------------------------
    // at HDP 256 the producer warp walks its tiles in 32 registers (in 24
    // ptxas spilled), and each consumer keeps 232 of the block's 64,512
    if constexpr (kWide)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tw >= 32) return;
    if constexpr (kWide) block(fresh(blockIdx.x), fresh(blockIdx.y), fresh(blockIdx.z));
    if (tw == 0) {
      mbar_expect_tx(res_full, 2 * L::kRes);
      for (int p = 0; p < L::NP; ++p) {
        tma_load(sk + p * L::kResPanel, &tk, res_full, p * 64, hk, k0, b);
        tma_load(sv + p * L::kResPanel, &tv, res_full, p * 64, hk, k0, b);
      }
    }
    int it = 0;
    for (int h = hk * R; h < hk * R + R; ++h) {
      const long long row = ((long long)b * H + h) * Sq;
      for (int qt = qt_lo; qt < qt_lo + n_q; ++qt, ++it) {
        const int s = it % kStages, q0 = qt * kBK;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        if (tw == 0) {
          mbar_expect_tx(full(s), 2 * L::kStr);
          for (int p = 0; p < L::NP; ++p) {
            tma_load(sq(s) + p * L::kStrPanel, &tq, full(s), p * 64, h, q0, b);
            tma_load(sdo(s) + p * L::kStrPanel, &tdo, full(s), p * 64, h, q0, b);
          }
        }
        for (int c = tw; c < kBK; c += 32) {
          const int qp = q0 + c;
          lse_s(s)[c] = qp < Sq ? lse[row + qp] * kLog2e : INFINITY;
          delta_s(s)[c] = qp < Sq ? delta[row + qp] : 0.f;
        }
        mbar_arrive(full(s));
      }
    }
  } else {
    // ---- consumers: warpgroup 0 dV, warpgroup 1 dK, of the block's 64 keys ----
    if constexpr (kWide)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    if constexpr (kWide) block(fresh(blockIdx.x), fresh(blockIdx.y), fresh(blockIdx.z));
    const int n_tiles = R * n_q;
    const int lane = tw % 32;
    const int kr0 = k0 + (tw / 32) * 16 + lane / 4, kr1 = kr0 + 8;
    const float scale_log2 = scale * kLog2e;
    // one body for each output, so that no wgmma sits on a branch
    auto consume = [&](auto dk_tag) {
      constexpr bool kDK = decltype(dk_tag)::value;
      float g[OC / 2];   // dV or dK of rows kr0, kr1, the block's columns
#pragma unroll
      for (int j = 0; j < OC / 2; ++j) g[j] = 0.f;
      mbar_wait(res_full, 0);

      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int q0 = (qt_lo + it % n_q) * kBK, q_end = min(q0 + kBK, Sq) - 1;
        mbar_wait(full(s), (it / kStages) & 1);
        bool dead = false;
        if (causal) {
          dead = q_end < k0;
          if (window > 0) dead = dead || q0 - k_last >= window;
        }
        if (!dead) {
          // S^T = K Q^T (and for dK, dP^T = V dO^T), 64 keys x 64 queries
          float st[32], dpt[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
          pin<32>(st);
          if constexpr (kDK) pin<32>(dpt);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HDP / 16; ++kk) {
            const uint32_t off = (kk / 4) * L::kResPanel + (kk % 4) * 32;
            const uint32_t qoff = (kk / 4) * L::kStrPanel + (kk % 4) * 32;
            wgmma_ss_n64(st, sw128_desc(sk + off, 16, 1024),
                         sw128_desc(sq(s) + qoff, 16, 1024), kk > 0);
            if constexpr (kDK)
              wgmma_ss_n64(dpt, sw128_desc(sv + off, 16, 1024),
                           sw128_desc(sdo(s) + qoff, 16, 1024), kk > 0);
          }
          wgmma_commit();
          wgmma_wait0();
          pin<32>(st);
          if constexpr (kDK) pin<32>(dpt);

          // p^T (dV) or dS^T (dK) in place (element 4m + e: key row e & 2 ?
          // kr1 : kr0, query column 8m + 2 (lane % 4) + (e & 1)); the mask,
          // as in the dq kernel, only in tiles that cross Sq, Sk, the
          // diagonal or the window's edge
          const bool edge =
              q0 + kBK > Sq || k0 + kBK > Sk ||
              (causal && (k0 + kBK - 1 > q0 || (window > 0 && q0 + kBK - 1 - k0 >= window)));
          const float* ls = lse_s(s);
          const float* ds = delta_s(s);
          auto p_or_ds = [&](auto edge_tag) {
#pragma unroll
            for (int m = 0; m < 8; ++m) {
              const int c = m * 8 + (lane % 4) * 2;
              const float2 lz = *reinterpret_cast<const float2*>(ls + c);
              const float2 dz = *reinterpret_cast<const float2*>(ds + c);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = 4 * m + e;
                const int kp = (e & 2) ? kr1 : kr0, qp = q0 + c + (e & 1);
                bool live = true;
                if constexpr (decltype(edge_tag)::value)
                  live = kp < Sk && qp < Sq &&
                         (!causal || (kp <= qp && (window <= 0 || qp - kp < window)));
                const float arg = fmaf(st[i], scale_log2, -((e & 1) ? lz.y : lz.x));
                const float p = exp2_ftz(live ? arg : -INFINITY);
                st[i] = kDK ? p * (dpt[i] - ((e & 1) ? dz.y : dz.x)) * scale : p;
              }
            }
          };
          if (edge)
            p_or_ds(std::true_type{});
          else
            p_or_ds(std::false_type{});
          // g += this tile's p^T dO or dS^T Q (dO or Q as the MN-major B,
          // from column col0 on)
          uint32_t t[16 * kTerms];
#pragma unroll
          for (int i = 0; i < 16; ++i) split_bf16<kTerms>(st[2 * i], st[2 * i + 1], t + i, 16);
          add_tile_product<OC>(g, t, (kDK ? sq(s) : sdo(s)) + (col0 / 64) * L::kStrPanel,
                               L::kStrPanel);
        }
        mbar_arrive(empty(s));
      }
      const long long kv_stride = (long long)Hkv * hd;
      const long long kv_base = (long long)b * Sk * kv_stride + (long long)hk * hd;
      store_rows<OC>((kDK ? dk : dv) + kv_base + col0, kv_stride, kr0, Sk, hd - col0, lane, g);
    };
    if (wg == 0)
      consume(std::false_type{});
    else
      consume(std::true_type{});
  }
}

// The backward's route: the bf16 tensor-core kernels take bf16 (any hd up
// to 256) in a layout TMA can take, dO (and o, which the dq kernel reads in
// 16-byte loads, when given) 16-byte aligned too; fp32 in such a layout
// takes x3's kernels (x3::takes); the rest runs the FMA kernels.
bool bwd_tensor_cores(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, int hd, int dtype) {
  return dtype == 1 && hd <= 256 && tma_layout(q, k, v, hd) &&
         ((reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(dout)) % 16) == 0;
}

template <int HDP>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                          const float* lse, const void* dout, void* dq, float* delta, int B,
                          int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                          float scale, cudaStream_t st) {
  constexpr int BQ = dq_rows<HDP>();
  constexpr int bytes = BwdLayout<HDP, BQ>::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  CUtensorMap tq, tdo, tk, tv;
  if ((long long)Sq > 65535LL * BQ) return cudaErrorInvalidValue;
  cudaError_t e = encode(&tq, q, B, Sq, H, hd, BQ);
  if (e == cudaSuccess) e = encode(&tdo, dout, B, Sq, H, hd, BQ);
  if (e == cudaSuccess) e = encode(&tk, k, B, Sk, Hkv, hd, kBK);
  if (e == cudaSuccess) e = encode(&tv, v, B, Sk, Hkv, hd, kBK);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_bwd_dq_tc_kernel<HDP><<<grid, kThreads, bytes, st>>>(
      tq, tdo, tk, tv, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, static_cast<__nv_bfloat16*>(dq), delta, Sq,
      Sk, H, Hkv, hd, causal, window, scale);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_bwd_dkdv(const void* q, const void* k, const void* v, const float* lse,
                            const float* delta, const void* dout, void* dk, void* dv, int B,
                            int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                            float scale, cudaStream_t st) {
  constexpr int bytes = BwdLayout<HDP, kBK>::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_tc_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  CUtensorMap tk, tv, tq, tdo;
  cudaError_t e = encode(&tk, k, B, Sk, Hkv, hd, kBK);
  if (e == cudaSuccess) e = encode(&tv, v, B, Sk, Hkv, hd, kBK);
  if (e == cudaSuccess) e = encode(&tq, q, B, Sq, H, hd, kBK);
  if (e == cudaSuccess) e = encode(&tdo, dout, B, Sq, H, hd, kBK);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * Hkv, (Sk + kBK - 1) / kBK, HDP / out_cols<HDP>());
  flash_bwd_dkdv_tc_kernel<HDP><<<grid, kThreads, bytes, st>>>(
      tk, tv, tq, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, Hkv, hd, causal, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                            const float* lse, const void* dout, void* dq, float* delta, int B,
                            int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                            float scale, cudaStream_t st) {
  if (hd <= 64)
    return launch_bwd_dq<64>(q, k, v, o, lse, dout, dq, delta, B, Sq, Sk, H, Hkv, hd, causal,
                             window, scale, st);
  if (hd <= 128)
    return launch_bwd_dq<128>(q, k, v, o, lse, dout, dq, delta, B, Sq, Sk, H, Hkv, hd, causal,
                              window, scale, st);
  return launch_bwd_dq<256>(q, k, v, o, lse, dout, dq, delta, B, Sq, Sk, H, Hkv, hd, causal,
                            window, scale, st);
}

cudaError_t dispatch_bwd_dkdv(const void* q, const void* k, const void* v, const float* lse,
                              const float* delta, const void* dout, void* dk, void* dv, int B,
                              int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                              float scale, cudaStream_t st) {
  if ((long long)Sk > 65535LL * kBK) return cudaErrorInvalidValue;
  if (hd <= 64)
    return launch_bwd_dkdv<64>(q, k, v, lse, delta, dout, dk, dv, B, Sq, Sk, H, Hkv, hd,
                               causal, window, scale, st);
  if (hd <= 128)
    return launch_bwd_dkdv<128>(q, k, v, lse, delta, dout, dk, dv, B, Sq, Sk, H, Hkv, hd,
                                causal, window, scale, st);
  return launch_bwd_dkdv<256>(q, k, v, lse, delta, dout, dk, dv, B, Sq, Sk, H, Hkv, hd,
                              causal, window, scale, st);
}

// ---------------------------------------------------------------------------
// fp32 backward on the tensor cores: dQ (and delta), then dK and dV, every
// product as three TF32 products. The design and what bounds it are in the
// backward's note below.
// ---------------------------------------------------------------------------

namespace x3 {

// The rows of a streamed tile (keys of the dq kernel's K and V tiles,
// queries of the dK/dV kernel's Q and dO tiles), and the ring's depth: two
// stages up to HDP 128; at 256, where a block of a cluster pair holds 128
// columns beside the partner's halves of the sums, one.
constexpr int kTileRows = 32;
template <int HDP>
__host__ __device__ constexpr int stages() { return HDP <= 128 ? 2 : 1; }
// setmaxnreg: the producer warpgroup splits tiles in 40 registers, each
// consumer keeps 232 (128 x 40 + 256 x 232 = 384 x 168, the registers the
// block is launched with)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Shared memory of the dq kernel, in bytes from a 1024-aligned base: Q and
// dO of the block's 64 query rows as loaded (fp32 in HC / 32 128-byte
// swizzled panels of 32 columns; HC = HDP up to 128, at 256 the pair of
// blocks of a cluster holds 128 each); a ring of stages, each K big, K
// small, V big, V small (T key rows each, the same panels); dS big and
// small (64 query rows of 128 bytes, T keys used); p of a tile in the S
// fragment's order; at HDP 256 the partner block's halves of S and dP, by
// the tile's parity; the barriers (the resident tiles', then full, ready
// and empty of each stage, the receipts of the partner's halves).
template <int HDP>
struct DqLayout {
  static constexpr bool kPair = HDP > 128;
  static constexpr int HC = kPair ? 128 : HDP;
  static constexpr int NP = HC / 32, T = kTileRows, NS = stages<HDP>();
  static constexpr int kRes = 64 * HC * 4;    // Q or dO
  static constexpr int kStr = T * HC * 4;     // one term of a K or V tile
  static constexpr int kRing = 2 * kRes;
  static constexpr int kDS = kRing + NS * 4 * kStr;
  static constexpr int kP = kDS + 2 * 64 * 128;
  static constexpr int kX = kP + 64 * T * 4;
  static constexpr int kXPart = 64 * T * 4;   // one warpgroup's half of S or dP
  static constexpr int kBar = kX + (kPair ? 2 * 2 * kXPart : 0);
  static constexpr int kBytes = kBar + 8 * (1 + 3 * NS + 4) + 1024;
};

// Shared memory of the dK/dV kernel: K and V of the block's 64 keys as
// loaded (its HC columns: all up to HDP 128; at 256 a pair of blocks, a
// thread-block cluster, holds 128 each); a ring of stages, each Q big, Q
// small, dO big, dO small (T query rows, HC columns); P big, P small, dS
// big, dS small (64 key rows of 128 bytes, T queries used); each stage's
// lse (base 2) and delta (T fp32 each); at HDP 256 the partner block's
// halves of S^T and dP^T, by the tile's parity; the barriers (the resident
// tiles', full, ready and empty of each stage, the receipts of the
// partner's halves by parity and warpgroup).
template <int HDP>
struct DkdvLayout {
  static constexpr bool kPair = HDP > 128;
  static constexpr int HC = kPair ? 128 : HDP;
  static constexpr int NP = HC / 32, T = kTileRows, NS = stages<HDP>();
  static constexpr int kRes = 64 * HC * 4;    // K or V
  static constexpr int kStr = T * HC * 4;     // one term of a Q or dO tile
  static constexpr int kRing = 2 * kRes;
  static constexpr int kPT = kRing + NS * 4 * kStr;
  static constexpr int kRows = kPT + 4 * 64 * 128;
  static constexpr int kX = kRows + NS * 2 * T * 4;
  static constexpr int kXPart = 64 * T * 4;   // one warpgroup's half of S^T or dP^T
  static constexpr int kBar = kX + (kPair ? 2 * 2 * kXPart : 0);
  static constexpr int kBytes = kBar + 8 * (1 + 3 * NS + 4) + 1024;
};

// this block's rank in its cluster
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// shared address `a` of this block as seen in block `rank` of the cluster
__device__ __forceinline__ uint32_t at_rank(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// 16 bytes into a cluster block's shared memory, counted on that block's
// mbarrier `bar` (its wait then sees them)
__device__ __forceinline__ void st_async4(uint32_t a, float4 x, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(a),
      "r"(__float_as_uint(x.x)), "r"(__float_as_uint(x.y)), "r"(__float_as_uint(x.z)),
      "r"(__float_as_uint(x.w)), "r"(bar)
      : "memory");
}

// every thread of the cluster: arrive (release) and wait (acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// byte offset of element (r, c) of an fp32 tile of R rows held as 128-byte
// swizzled panels of 32 columns (TMA's SWIZZLE_128B with 32-column boxes;
// the 16-byte chunk of a row XORed with the row's index mod 8)
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 5) * (R * 128) + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// x rounded to TF32, to nearest with ties away from zero (the low 13 bits
// 0): cvt.rna.tf32.f32's rule, as an integer add and a mask on the bits
// (two full-rate instructions; the conversion runs at a quarter of their
// rate, and splitting the operands is a large share of the kernels' issue)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x as big = tf32(x) and small = tf32(x - big); x - big is exact in fp32, so
// big + small keeps 22 of x's 24 significant bits
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// wait until at most N of this warpgroup's wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 32, fp32) += A.B, one TF32 product: A (64 x 8) from registers in
// the TF32 A fragment's order, B (8 x 32) K-major from shared memory
__device__ __forceinline__ void wgmma_tf32_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, fp32) += A.B, one TF32 product: A (64 x 8) from registers in
// the TF32 A fragment's order, B (8 x 64) K-major from shared memory
__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A.B, one TF32 product: A (64 x 8) from registers in
// the TF32 A fragment's order, B (8 x 128) K-major from shared memory
__device__ __forceinline__ void wgmma_tf32_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (N == 32) wgmma_tf32_n32(d, a, db);
  else if constexpr (N == 64) wgmma_tf32_n64(d, a, db);
  else wgmma_tf32_n128(d, a, db);
}

// acc (the 64 x N fp32 fragment) += A B over K = 8 STEPS, as three TF32
// products a step: big.big, big.small, small.big. frag(kk, big, small)
// gives step kk's A fragment (64 x 8: a0 row r, column c; a1 row r + 8; a2
// column c + 4; a3 both, r = 16 warp + lane / 4, c = lane % 4) as 4 big
// and 4 small TF32 registers; bdesc(kk, term) the descriptor of B's big (0)
// or small (1) 8 x N K-major block. A ring of kSlots register slots: step
// kk + kAhead's fragment is loaded (and split) while step kk runs on the
// tensor cores, into the slot whose step has completed (wait_group kSlots -
// kAhead). All into one accumulator. (Four slots spilled the dK/dV kernel's
// registers at HDP 128; two left its products waiting on the loads.)
constexpr int kSlots = 3, kAhead = 2;
template <int N, int STEPS, typename Frag, typename Desc>
__device__ __forceinline__ void mma3(float* acc, Frag frag, Desc bdesc) {
  uint32_t a[kSlots][8];
  pin<N / 2>(acc);
#pragma unroll
  for (int kk = 0; kk < kAhead && kk < STEPS; ++kk) frag(kk, a[kk], a[kk] + 4);
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    uint32_t* r = a[kk % kSlots];
    pin<8>(r);
    wgmma_fence();
    wgmma_tf32<N>(acc, r, bdesc(kk, 0));
    wgmma_tf32<N>(acc, r, bdesc(kk, 1));
    wgmma_tf32<N>(acc, r + 4, bdesc(kk, 0));
    wgmma_commit();
    if (kk + kAhead < STEPS) {
      // the slot's last step, kk + kAhead - kSlots, is done
      if (kk + kAhead >= kSlots) wgmma_wait<kSlots - kAhead>();
      uint32_t* nx = a[(kk + kAhead) % kSlots];
      frag(kk + kAhead, nx, nx + 4);
    }
  }
  wgmma_wait0();
  pin<N / 2>(acc);
#pragma unroll
  for (int i = 0; i < kSlots; ++i) pin<8>(a[i]);
}

// the A fragment of step kk from an fp32 tile of R rows as loaded (at
// `tile`, generic address), rows row0 + r and + 8 (M), columns 8 kk + c
// and + 4 (K), split here
template <int R>
__device__ __forceinline__ void frag_split(const uint8_t* tile, int row0, int kk, int lane,
                                           uint32_t* big, uint32_t* small) {
  const int r = row0 + lane / 4, c = 8 * kk + lane % 4;
  const float x[4] = {*reinterpret_cast<const float*>(tile + swz<R>(r, c)),
                      *reinterpret_cast<const float*>(tile + swz<R>(r + 8, c)),
                      *reinterpret_cast<const float*>(tile + swz<R>(r, c + 4)),
                      *reinterpret_cast<const float*>(tile + swz<R>(r + 8, c + 4))};
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], big[i], small[i]);
}

// the A fragment of step kk transposed out of a split tile of R rows (big
// at `tb`, small at `ts`): A's row m is the tile's column col0 + m, A's
// column k the tile's row 8 kk + k
template <int R>
__device__ __forceinline__ void frag_t(const uint8_t* tb, const uint8_t* ts, int col0, int kk,
                                       int lane, uint32_t* big, uint32_t* small) {
  const int m = col0 + lane / 4, k = 8 * kk + lane % 4;
  const uint32_t off[4] = {swz<R>(k, m), swz<R>(k, m + 8), swz<R>(k + 4, m),
                           swz<R>(k + 4, m + 8)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    big[i] = *reinterpret_cast<const uint32_t*>(tb + off[i]);
    small[i] = *reinterpret_cast<const uint32_t*>(ts + off[i]);
  }
}

// descriptor of step kk's 8 x N block of a K-major tile at `t` (shared
// address) whose N rows start there, panels `panel` bytes apart
__device__ __forceinline__ uint64_t kdesc(uint32_t t, int kk, uint32_t panel) {
  return sw128_desc(t + (kk / 4) * panel + (kk % 4) * 32, 16, 1024);
}

// a tile as loaded (n fp32 at `big`) into big = tf32(x) in place and small
// beside it, by the 128 threads of the producer warpgroup
__device__ __forceinline__ void split_tile(uint8_t* big, uint8_t* small, int n, int t) {
#pragma unroll 4
  for (int i = 4 * t; i < n; i += 4 * 128) {
    const float4 x = *reinterpret_cast<const float4*>(big + 4 * i);
    uint4 b, s;
    split(x.x, b.x, s.x);
    split(x.y, b.y, s.y);
    split(x.z, b.z, s.z);
    split(x.w, b.w, s.w);
    *reinterpret_cast<uint4*>(big + 4 * i) = b;
    *reinterpret_cast<uint4*>(small + 4 * i) = s;
  }
}

// dQ of 64 query rows of one (b, h), and their delta = sum dO.O; at HDP 256
// a cluster of two blocks (the grid's z) shares the rows, block z holding
// Q, dO, K and V's columns 128 z to 128 z + 127 and summing those of dq
// (the halves of S and dP cross the pair, as in the dK/dV kernel). The
// producer warpgroup's thread 0 loads Q and dO once and the live K and V
// tiles into the ring; its 128 threads split each tile. For each tile,
// consumer 0 forms S = Q K^T and p, consumer 1 dP = dO V^T and, from p,
// dS; then both add the tile's dQ^T = K^T dS^T to their rows of dQ^T (at
// HDP 64 each its 32 queries of all 64 columns; above, each its 64 of the
// block's columns).
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_x3_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk, int H, int Hkv, int hd,
    int causal, int window, float scale) {
  using L = DqLayout<HDP>;
  constexpr int T = L::T, NS = L::NS, HC = L::HC;
  constexpr bool kPair = L::kPair;
  constexpr int NQ = HDP == 64 ? 32 : 64;  // queries of dQ^T a consumer sums (64 columns)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gb = smem_raw + (base - raw);
  // stage s, tensor t (0 K, 1 V), term (0 big, 1 small): offset from base
  auto ring = [](int s, int t, int term) { return L::kRing + ((s * 2 + t) * 2 + term) * L::kStr; };
  const uint32_t res_full = base + L::kBar;
  auto full = [&](int s) { return res_full + 8 * (1 + s); };
  auto ready = [&](int s) { return res_full + 8 * (1 + NS + s); };
  auto empty = [&](int s) { return res_full + 8 * (1 + 2 * NS + s); };
  // the partner's half of S (w 0) or dP (w 1) for tiles of parity x
  auto xbar = [&](int x, int w) { return res_full + 8 * (1 + 3 * NS + 2 * x + w); };

  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  // the block's (b, h), first query row, first of its HC columns and live
  // key tiles, formed in each role after setmaxnreg (fresh)
  int bh, b, h, q0, col0, q_last, kt_lo, n_tiles;
  auto block = [&]() {
    bh = fresh(blockIdx.x);
    col0 = kPair ? cluster_rank() * HC : 0;
    b = bh / H;
    h = bh % H;
    q0 = (gridDim.y - 1 - fresh(blockIdx.y)) * 64;  // heaviest (last) tiles first
    q_last = min(q0 + 64, Sq) - 1;
    int kt_hi = (Sk - 1) / T;
    kt_lo = 0;
    if (causal) {
      kt_hi = min(q_last, Sk - 1) / T;
      if (window > 0) kt_lo = max(0, q0 - window + 1) / T;
    }
    n_tiles = kt_hi - kt_lo + 1;   // <= 0 when a window lies wholly past Sk
  };

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), 128);
      mbar_init(empty(s), 256);
    }
    if constexpr (kPair)
      for (int x = 0; x < 4; ++x) mbar_init(xbar(x / 2, x % 2), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // at HDP 256 the partner's barriers are set before anything is sent to it
  if constexpr (kPair)
    cluster_sync();
  else
    __syncthreads();

  if (wg == 2) {
    // ---- producer: Q and dO once; then each K/V tile loaded and split ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    block();
    const int hk = h / (H / Hkv);
    if (tw == 0) {
      mbar_expect_tx(res_full, 2 * L::kRes);
      for (int p = 0; p < L::NP; ++p) {
        tma_load(base + p * 64 * 128, &tq, res_full, col0 + p * 32, h, q0, b);
        tma_load(base + L::kRes + p * 64 * 128, &tdo, res_full, col0 + p * 32, h, q0, b);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % NS;
      if (tw == 0) {
        const int k0 = (kt_lo + it) * T;
        mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kStr);
        for (int p = 0; p < L::NP; ++p) {
          tma_load(base + ring(s, 0, 0) + p * T * 128, &tk, full(s), col0 + p * 32, hk, k0,
                   b);
          tma_load(base + ring(s, 1, 0) + p * T * 128, &tv, full(s), col0 + p * 32, hk, k0,
                   b);
        }
      }
      mbar_wait(full(s), (it / NS) & 1);
      split_tile(gb + ring(s, 0, 0), gb + ring(s, 0, 1), T * HC, tw);
      split_tile(gb + ring(s, 1, 0), gb + ring(s, 1, 1), T * HC, tw);
      fence_async_smem();
      mbar_arrive(ready(s));
    }
  } else {
    // ---- consumers ------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    block();
    const int lane = tw % 32, warp = tw / 32;
    const int r0 = warp * 16 + lane / 4;   // rows r0 and r0 + 8 of S and dP
    const int qp0 = q0 + r0, qp1 = qp0 + 8;
    const float scale_log2 = scale * kLog2e;
    const long long q_stride = (long long)H * hd;
    const long long q_base = (long long)b * Sq * q_stride + (long long)h * hd;
    // consumer 1: delta of rows qp0, qp1 (the quad's four threads take every
    // fourth 16-byte chunk of the row, then sum over the quad), written out;
    // consumer 0: lse of the rows in base 2 (+inf past Sq, so p = 0)
    float z0, z1;
    if (wg == 1) {
      z0 = z1 = 0.f;
      for (int c = (lane % 4) * 4; c < hd; c += 16) {
        if (qp0 < Sq) {
          const float4 x = *reinterpret_cast<const float4*>(dout + q_base + qp0 * q_stride + c);
          const float4 y = *reinterpret_cast<const float4*>(o + q_base + qp0 * q_stride + c);
          z0 = fmaf(x.x, y.x, z0);
          z0 = fmaf(x.y, y.y, z0);
          z0 = fmaf(x.z, y.z, z0);
          z0 = fmaf(x.w, y.w, z0);
        }
        if (qp1 < Sq) {
          const float4 x = *reinterpret_cast<const float4*>(dout + q_base + qp1 * q_stride + c);
          const float4 y = *reinterpret_cast<const float4*>(o + q_base + qp1 * q_stride + c);
          z1 = fmaf(x.x, y.x, z1);
          z1 = fmaf(x.y, y.y, z1);
          z1 = fmaf(x.z, y.z, z1);
          z1 = fmaf(x.w, y.w, z1);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        z0 += __shfl_xor_sync(0xffffffffu, z0, off);
        z1 += __shfl_xor_sync(0xffffffffu, z1, off);
      }
      if (lane % 4 == 0 && col0 == 0) {
        if (qp0 < Sq) delta[(long long)bh * Sq + qp0] = z0;
        if (qp1 < Sq) delta[(long long)bh * Sq + qp1] = z1;
      }
    } else {
      const float* lrow = lse + (long long)bh * Sq;
      z0 = qp0 < Sq ? lrow[qp0] * kLog2e : INFINITY;
      z1 = qp1 < Sq ? lrow[qp1] * kLog2e : INFINITY;
    }
    float4* const pbuf = reinterpret_cast<float4*>(gb + L::kP);
    const uint32_t ds_b = base + L::kDS, ds_s = ds_b + 64 * 128;
    // this consumer's dQ^T: the block's columns (M) d0 to d0 + 63, queries (N)
    // n0 on
    const int d0 = HDP == 64 ? 0 : wg * 64, n0 = HDP == 64 ? wg * 32 : 0;
    float acc[NQ / 2];
#pragma unroll
    for (int j = 0; j < NQ / 2; ++j) acc[j] = 0.f;
    mbar_wait(res_full, 0);

    auto consume = [&](auto dp_tag) {
      constexpr bool kDP = decltype(dp_tag)::value;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NS;
        const int k0 = (kt_lo + it) * T;
        mbar_wait(ready(s), (it / NS) & 1);
        // S = Q K^T (consumer 0) or dP = dO V^T (consumer 1), 64 x T over
        // HC / 8 steps, Q or dO split as it is read
        float sc[T / 2];
#pragma unroll
        for (int i = 0; i < T / 2; ++i) sc[i] = 0.f;
        const uint8_t* a_tile = gb + (kDP ? L::kRes : 0);
        const uint32_t bt = base + ring(s, kDP ? 1 : 0, 0);
        mma3<T, HC / 8>(
            sc, [&](int kk, uint32_t* bg, uint32_t* sm) {
              frag_split<64>(a_tile, warp * 16, kk, lane, bg, sm);
            },
            [&](int kk, int term) { return kdesc(bt + term * L::kStr, kk, T * 128); });
        if constexpr (kPair) {
          // this block's half of the sum to the partner, the partner's half
          // added here (a + b: both blocks hold the same bits)
          const int x = it & 1;
          const uint32_t part = L::kX + (x * 2 + (kDP ? 1 : 0)) * L::kXPart;
          if (tw == 0) mbar_expect_tx(xbar(x, wg), L::kXPart);
          const int other = cluster_rank() ^ 1;
          const uint32_t dst = at_rank(base + part, other), bar = at_rank(xbar(x, wg), other);
#pragma unroll
          for (int v = 0; v < T / 8; ++v)
            st_async4(dst + (v * 128 + tw) * 16,
                      make_float4(sc[4 * v], sc[4 * v + 1], sc[4 * v + 2], sc[4 * v + 3]), bar);
          mbar_wait(xbar(x, wg), (it >> 1) & 1);
          const float4* got = reinterpret_cast<const float4*>(gb + part);
#pragma unroll
          for (int v = 0; v < T / 8; ++v) {
            const float4 o = got[v * 128 + tw];
            sc[4 * v] += o.x;
            sc[4 * v + 1] += o.y;
            sc[4 * v + 2] += o.z;
            sc[4 * v + 3] += o.w;
          }
        }
        if constexpr (!kDP) {
          // p = 2^(s scale log2(e) - lse log2(e)) on live pairs; the mask only
          // in tiles that cross Sk, the diagonal or the window's edge
          const bool edge = k0 + T > Sk ||
                            (causal && (k0 + T - 1 > q0 || (window > 0 && k0 <= q_last - window)));
          auto probs = [&](auto edge_tag) {
#pragma unroll
            for (int i = 0; i < T / 2; ++i) {
              const int qp = (i & 2) ? qp1 : qp0;
              bool live = true;
              if constexpr (decltype(edge_tag)::value) {
                const int key = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
                live = key < Sk && (!causal || (key <= qp && (window <= 0 || qp - key < window)));
              }
              const float arg = fmaf(sc[i], scale_log2, -((i & 2) ? z1 : z0));
              sc[i] = exp2_ftz(live ? arg : -INFINITY);
            }
          };
          if (edge)
            probs(std::true_type{});
          else
            probs(std::false_type{});
#pragma unroll
          for (int v = 0; v < T / 8; ++v)
            pbuf[v * 128 + tw] = make_float4(sc[4 * v], sc[4 * v + 1], sc[4 * v + 2], sc[4 * v + 3]);
        }
        bar_sync(1, 256);
        if constexpr (kDP) {
          // dS = p (dP - delta) scale, split, into dS's rows (the B operand of
          // dQ^T = K^T dS^T: K-major, a query's T keys in a row)
#pragma unroll
          for (int v = 0; v < T / 8; ++v) {
            const float4 p = pbuf[v * 128 + tw];
            const float pv[4] = {p.x, p.y, p.z, p.w};
            uint32_t bg[4], sm[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * v + e;
              split(pv[e] * (sc[i] - ((i & 2) ? z1 : z0)) * scale, bg[e], sm[e]);
            }
            const int key = v * 8 + (lane % 4) * 2;
            const uint32_t o0 = swz<64>(r0, key), o1 = swz<64>(r0 + 8, key);
            *reinterpret_cast<uint2*>(gb + L::kDS + o0) = make_uint2(bg[0], bg[1]);
            *reinterpret_cast<uint2*>(gb + L::kDS + o1) = make_uint2(bg[2], bg[3]);
            *reinterpret_cast<uint2*>(gb + L::kDS + 64 * 128 + o0) = make_uint2(sm[0], sm[1]);
            *reinterpret_cast<uint2*>(gb + L::kDS + 64 * 128 + o1) = make_uint2(sm[2], sm[3]);
          }
          fence_async_smem();
        }
        bar_sync(2, 256);
        // dQ^T (this consumer's columns and queries) += K^T dS^T: K^T from the
        // split K tile as the A fragment, dS from shared memory
        const uint8_t* kb = gb + ring(s, 0, 0);
        mma3<NQ, T / 8>(
            acc, [&](int kk, uint32_t* bg, uint32_t* sm) {
              frag_t<T>(kb, kb + L::kStr, d0 + warp * 16, kk, lane, bg, sm);
            },
            [&](int kk, int term) { return kdesc((term ? ds_s : ds_b) + n0 * 128, kk, 0); });
        mbar_arrive(empty(s));
      }
    };
    if (wg == 0)
      consume(std::false_type{});
    else
      consume(std::true_type{});
    // dq = dQ^T transposed: element j is column col0 + d0 + 16 warp + lane / 4
    // (+ 8 when j & 2), query n0 + 8 (j / 4) + 2 (lane % 4) + j % 2
    float* const dqb = dq + q_base;
#pragma unroll
    for (int j = 0; j < NQ / 2; ++j) {
      const int d = col0 + d0 + warp * 16 + lane / 4 + ((j & 2) ? 8 : 0);
      const int qp = q0 + n0 + (j / 4) * 8 + (lane % 4) * 2 + (j & 1);
      if (qp < Sq && d < hd) dqb[qp * q_stride + d] = acc[j];
    }
  }
}

// dK and dV of 64 keys of one (b, kv head), all HDP columns up to 128; at
// HDP 256 a cluster of two blocks (the grid's z) shares the keys, block z
// holding K, V, Q and dO's columns 128 z to 128 z + 127 and summing those
// of dk and dv (all 256 would be 128 fp32 of output a consumer thread,
// which with the rest does not fit its 232 registers): each forms its
// half of S^T and dP^T's sums over hd, sends it to the other (st.async)
// and adds the other's, so both hold the same S^T and dP^T. The producer
// warpgroup's
// thread 0 loads K and V once and streams, for each query head of the group
// and each query tile some key of the block leaves live, the Q and dO tiles;
// its 128 threads split them and copy their lse (base 2) and delta. For each
// tile, consumer 0 forms S^T = K Q^T, p^T and (split) P, consumer 1 dP^T =
// V dO^T and, from P, dS; then consumer 0 adds dV^T += dO^T P and consumer 1
// dK^T += Q^T dS, each held in registers over the whole loop.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv_x3_kernel(
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
    float scale) {
  using L = DkdvLayout<HDP>;
  constexpr int T = L::T, NS = L::NS, HC = L::HC;
  constexpr bool kPair = L::kPair;
  constexpr int MT = HC / 64;   // 64-column M tiles of dV^T or dK^T a consumer sums
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gb = smem_raw + (base - raw);
  // stage s, tensor t (0 Q, 1 dO), term (0 big, 1 small)
  auto ring = [](int s, int t, int term) { return L::kRing + ((s * 2 + t) * 2 + term) * L::kStr; };
  float* const rows = reinterpret_cast<float*>(gb + L::kRows);
  auto lse_s = [&](int s) { return rows + s * 2 * T; };
  auto delta_s = [&](int s) { return rows + s * 2 * T + T; };
  const uint32_t res_full = base + L::kBar;
  auto full = [&](int s) { return res_full + 8 * (1 + s); };
  auto ready = [&](int s) { return res_full + 8 * (1 + NS + s); };
  auto empty = [&](int s) { return res_full + 8 * (1 + 2 * NS + s); };
  // the partner's half of S^T (w 0) or dP^T (w 1) for tiles of parity x
  auto xbar = [&](int x, int w) { return res_full + 8 * (1 + 3 * NS + 2 * x + w); };

  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int R = H / Hkv;
  // the block's (b, kv head), first key, first column of dk and dv, and the
  // query tiles some key of it leaves live, qt_lo on, n_q of them for each
  // query head; formed in each role after setmaxnreg (fresh)
  int b, hk, k0, col0, k_last, qt_lo, n_q;
  auto block = [&]() {
    const int bx = fresh(blockIdx.x);
    b = bx / Hkv;
    hk = bx % Hkv;
    k0 = fresh(blockIdx.y) * 64;   // causal: the lowest keys, the heaviest blocks, first
    col0 = kPair ? cluster_rank() * HC : 0;
    k_last = min(k0 + 64, Sk) - 1;
    int qt_hi = (Sq - 1) / T;
    qt_lo = 0;
    if (causal) {
      qt_lo = k0 / T;
      if (window > 0) qt_hi = min(Sq - 1, k_last + window - 1) / T;
    }
    n_q = max(0, qt_hi - qt_lo + 1);
  };

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), 128);
      mbar_init(empty(s), 256);
    }
    if constexpr (kPair)
      for (int x = 0; x < 4; ++x) mbar_init(xbar(x / 2, x % 2), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // at HDP 256 the partner's barriers are set before anything is sent to it
  if constexpr (kPair)
    cluster_sync();
  else
    __syncthreads();

  if (wg == 2) {
    // ---- producer: K and V once; then each Q/dO tile loaded and split, with
    // its lse (base 2) and delta (a query past Sq: lse +inf, so p = 0, and
    // delta 0) -----------------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    block();
    if (tw == 0) {
      mbar_expect_tx(res_full, 2 * L::kRes);
      for (int p = 0; p < L::NP; ++p) {
        tma_load(base + p * 64 * 128, &tk, res_full, col0 + p * 32, hk, k0, b);
        tma_load(base + L::kRes + p * 64 * 128, &tv, res_full, col0 + p * 32, hk, k0, b);
      }
    }
    int it = 0;
    for (int h = hk * R; h < hk * R + R; ++h) {
      const long long row = ((long long)b * H + h) * Sq;
      for (int qt = qt_lo; qt < qt_lo + n_q; ++qt, ++it) {
        const int s = it % NS, q0 = qt * T;
        if (tw == 0) {
          mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * L::kStr);
          for (int p = 0; p < L::NP; ++p) {
            tma_load(base + ring(s, 0, 0) + p * T * 128, &tq, full(s), col0 + p * 32, h, q0,
                     b);
            tma_load(base + ring(s, 1, 0) + p * T * 128, &tdo, full(s), col0 + p * 32, h, q0,
                     b);
          }
        }
        mbar_wait(full(s), (it / NS) & 1);
        split_tile(gb + ring(s, 0, 0), gb + ring(s, 0, 1), T * HC, tw);
        split_tile(gb + ring(s, 1, 0), gb + ring(s, 1, 1), T * HC, tw);
        if (tw < T) {
          const int qp = q0 + tw;
          lse_s(s)[tw] = qp < Sq ? lse[row + qp] * kLog2e : INFINITY;
          delta_s(s)[tw] = qp < Sq ? delta[row + qp] : 0.f;
        }
        fence_async_smem();
        mbar_arrive(ready(s));
      }
    }
  } else {
    // ---- consumers: 0 forms dV^T, 1 dK^T, of the block's 64 keys ---------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    block();
    const int n_tiles = R * n_q;
    const int lane = tw % 32, warp = tw / 32;
    const int kr0 = warp * 16 + lane / 4;   // key rows kr0 and kr0 + 8 of the block
    const float scale_log2 = scale * kLog2e;
    const uint32_t pt = base + L::kPT;      // P big, P small, dS big, dS small
    auto consume = [&](auto dk_tag) {
      constexpr bool kDK = decltype(dk_tag)::value;
      float g[MT][32];   // dV^T or dK^T: HC columns (M) x 64 keys (N)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 32; ++j) g[m][j] = 0.f;
      mbar_wait(res_full, 0);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NS;
        const int q0 = (qt_lo + it % n_q) * T;
        mbar_wait(ready(s), (it / NS) & 1);
        // S^T = K Q^T (consumer 0) or dP^T = V dO^T (consumer 1), 64 keys x T
        // queries over HC / 8 steps, K or V split as it is read
        float st[T / 2];
#pragma unroll
        for (int i = 0; i < T / 2; ++i) st[i] = 0.f;
        const uint8_t* a_tile = gb + (kDK ? L::kRes : 0);
        const uint32_t bt = base + ring(s, kDK ? 1 : 0, 0);
        mma3<T, HC / 8>(
            st, [&](int kk, uint32_t* bg, uint32_t* sm) {
              frag_split<64>(a_tile, warp * 16, kk, lane, bg, sm);
            },
            [&](int kk, int term) { return kdesc(bt + term * L::kStr, kk, T * 128); });
        if constexpr (kPair) {
          // this block's half of the sum to the partner, the partner's half
          // added here (a + b: both blocks hold the same bits)
          const int x = it & 1;
          const uint32_t part = L::kX + (x * 2 + (kDK ? 1 : 0)) * L::kXPart;
          if (tw == 0) mbar_expect_tx(xbar(x, wg), L::kXPart);
          const int other = cluster_rank() ^ 1;
          const uint32_t dst = at_rank(base + part, other), bar = at_rank(xbar(x, wg), other);
#pragma unroll
          for (int v = 0; v < T / 8; ++v)
            st_async4(dst + (v * 128 + tw) * 16,
                      make_float4(st[4 * v], st[4 * v + 1], st[4 * v + 2], st[4 * v + 3]), bar);
          mbar_wait(xbar(x, wg), (it >> 1) & 1);
          const float4* got = reinterpret_cast<const float4*>(gb + part);
#pragma unroll
          for (int v = 0; v < T / 8; ++v) {
            const float4 o = got[v * 128 + tw];
            st[4 * v] += o.x;
            st[4 * v + 1] += o.y;
            st[4 * v + 2] += o.z;
            st[4 * v + 3] += o.w;
          }
        }
        // both consumers are done with the previous tile's P and dS
        bar_sync(1, 256);
        const bool edge =
            q0 + T > Sq || k0 + 64 > Sk ||
            (causal && (k0 + 63 > q0 || (window > 0 && q0 + T - 1 - k0 >= window)));
        const float* ls = lse_s(s);
        const float* dz = delta_s(s);
        // element 4 v + e of the fragment: key row kr0 (+ 8 when e & 2), query
        // column 8 v + 2 (lane % 4) + e % 2; P's and dS's rows are keys
        if constexpr (kDK) bar_sync(2, 256);   // P is written
#pragma unroll
        for (int v = 0; v < T / 8; ++v) {
          const int c = v * 8 + (lane % 4) * 2;
          const uint32_t o0 = swz<64>(kr0, c), o1 = swz<64>(kr0 + 8, c);
          float x[4];
          if constexpr (!kDK) {
            // p = 2^(s scale log2(e) - lse log2(e)) on live pairs; the mask only
            // in tiles that cross Sq, Sk, the diagonal or the window's edge
            const float2 lz = *reinterpret_cast<const float2*>(ls + c);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float arg = fmaf(st[4 * v + e], scale_log2, -((e & 1) ? lz.y : lz.x));
              bool live = true;
              if (edge) {
                const int kp = k0 + ((e & 2) ? kr0 + 8 : kr0), qp = q0 + c + (e & 1);
                live = kp < Sk && qp < Sq &&
                       (!causal || (kp <= qp && (window <= 0 || qp - kp < window)));
              }
              x[e] = exp2_ftz(live ? arg : -INFINITY);
            }
          } else {
            // dS = p (dP - delta) scale, p as consumer 0 split it (big + small)
            const float2 dd = *reinterpret_cast<const float2*>(dz + c);
            const float2 b0 = *reinterpret_cast<const float2*>(gb + L::kPT + o0);
            const float2 b1 = *reinterpret_cast<const float2*>(gb + L::kPT + o1);
            const float2 s0 = *reinterpret_cast<const float2*>(gb + L::kPT + 64 * 128 + o0);
            const float2 s1 = *reinterpret_cast<const float2*>(gb + L::kPT + 64 * 128 + o1);
            const float p[4] = {b0.x + s0.x, b0.y + s0.y, b1.x + s1.x, b1.y + s1.y};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              x[e] = p[e] * (st[4 * v + e] - ((e & 1) ? dd.y : dd.x)) * scale;
          }
          uint32_t bg[4], sm[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split(x[e], bg[e], sm[e]);
          uint8_t* const dst = gb + L::kPT + (kDK ? 2 * 64 * 128 : 0);
          *reinterpret_cast<uint2*>(dst + o0) = make_uint2(bg[0], bg[1]);
          *reinterpret_cast<uint2*>(dst + o1) = make_uint2(bg[2], bg[3]);
          *reinterpret_cast<uint2*>(dst + 64 * 128 + o0) = make_uint2(sm[0], sm[1]);
          *reinterpret_cast<uint2*>(dst + 64 * 128 + o1) = make_uint2(sm[2], sm[3]);
        }
        fence_async_smem();
        if constexpr (!kDK)
          bar_sync(2, 256);   // P is written: consumer 1 may read it, this wgmma see it
        else
          bar_sync(3, 128);   // dS is written: this warpgroup's wgmma may read it
        // g += this tile's dO^T P (dV^T) or Q^T dS (dK^T): dO or Q from the split
        // tile as the transposed A fragment, P or dS from shared memory
        const uint8_t* at = gb + ring(s, kDK ? 0 : 1, 0);
        const uint32_t bt2 = pt + (kDK ? 2 * 64 * 128 : 0);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          mma3<64, T / 8>(
              g[m], [&](int kk, uint32_t* bg, uint32_t* sm) {
                frag_t<T>(at, at + L::kStr, m * 64 + warp * 16, kk, lane, bg, sm);
              },
              [&](int kk, int term) { return kdesc(bt2 + term * 64 * 128, kk, 0); });
        mbar_arrive(empty(s));
      }
      // dk or dv = g transposed: element j of M tile m is column col0 + 64 m +
      // 16 warp + lane / 4 (+ 8 when j & 2), key k0 + 8 (j / 4) + 2 (lane % 4) + j % 2
      const long long kv_stride = (long long)Hkv * hd;
      float* const out = (kDK ? dk : dv) + (long long)b * Sk * kv_stride + (long long)hk * hd;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int d = col0 + m * 64 + warp * 16 + lane / 4 + ((j & 2) ? 8 : 0);
          const int kp = k0 + (j / 4) * 8 + (lane % 4) * 2 + (j & 1);
          if (kp < Sk && d < hd) out[kp * kv_stride + d] = g[m][j];
        }
    };
    if (wg == 0)
      consume(std::false_type{});
    else
      consume(std::true_type{});
  }
}

// The route: fp32 at any hd up to 256 in a layout TMA can take (rows of hd
// fp32 a multiple of 16 bytes, every base 16-byte aligned; o null for the
// dK/dV kernel)
bool takes(const void* q, const void* k, const void* v, const void* o, const void* dout,
           int hd, int dtype) {
  return dtype == 0 && hd <= 256 && hd % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
           reinterpret_cast<uintptr_t>(dout)) % 16) == 0;
}

template <int HDP>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                          const float* lse, const void* dout, void* dq, float* delta, int B,
                          int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                          float scale, cudaStream_t st) {
  constexpr int bytes = DqLayout<HDP>::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_x3_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  if ((long long)Sq > 65535LL * 64) return cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t e = encode(&tq, q, B, Sq, H, hd, 64, 4);
  if (e == cudaSuccess) e = encode(&tdo, dout, B, Sq, H, hd, 64, 4);
  if (e == cudaSuccess) e = encode(&tk, k, B, Sk, Hkv, hd, DqLayout<HDP>::T, 4);
  if (e == cudaSuccess) e = encode(&tv, v, B, Sk, Hkv, hd, DqLayout<HDP>::T, 4);
  if (e != cudaSuccess) return e;
  // at HDP 256 the grid's z is the cluster pair that shares each row block
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H, (Sq + 63) / 64, DqLayout<HDP>::kPair ? 2 : 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = DqLayout<HDP>::kPair ? 2 : 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_bwd_dq_x3_kernel<HDP>, tq, tdo, tk, tv,
                         static_cast<const float*>(o), static_cast<const float*>(dout), lse,
                         static_cast<float*>(dq), delta, Sq, Sk, H, Hkv, hd, causal, window,
                         scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_bwd_dkdv(const void* q, const void* k, const void* v, const float* lse,
                            const float* delta, const void* dout, void* dk, void* dv, int B,
                            int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                            float scale, cudaStream_t st) {
  constexpr int bytes = DkdvLayout<HDP>::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_x3_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  CUtensorMap tk, tv, tq, tdo;
  cudaError_t e = encode(&tk, k, B, Sk, Hkv, hd, 64, 4);
  if (e == cudaSuccess) e = encode(&tv, v, B, Sk, Hkv, hd, 64, 4);
  if (e == cudaSuccess) e = encode(&tq, q, B, Sq, H, hd, DkdvLayout<HDP>::T, 4);
  if (e == cudaSuccess) e = encode(&tdo, dout, B, Sq, H, hd, DkdvLayout<HDP>::T, 4);
  if (e != cudaSuccess) return e;
  // at HDP 256 the grid's z is the cluster pair that shares each key block
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv, (Sk + 63) / 64, DkdvLayout<HDP>::kPair ? 2 : 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = DkdvLayout<HDP>::kPair ? 2 : 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_x3_kernel<HDP>, tk, tv, tq, tdo, lse, delta,
                         static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, H, Hkv, hd,
                         causal, window, scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

cudaError_t dispatch_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                            const float* lse, const void* dout, void* dq, float* delta, int B,
                            int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                            float scale, cudaStream_t st) {
  if (hd <= 64)
    return launch_bwd_dq<64>(q, k, v, o, lse, dout, dq, delta, B, Sq, Sk, H, Hkv, hd, causal,
                             window, scale, st);
  if (hd <= 128)
    return launch_bwd_dq<128>(q, k, v, o, lse, dout, dq, delta, B, Sq, Sk, H, Hkv, hd, causal,
                              window, scale, st);
  return launch_bwd_dq<256>(q, k, v, o, lse, dout, dq, delta, B, Sq, Sk, H, Hkv, hd, causal,
                            window, scale, st);
}

cudaError_t dispatch_bwd_dkdv(const void* q, const void* k, const void* v, const float* lse,
                              const float* delta, const void* dout, void* dk, void* dv, int B,
                              int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                              float scale, cudaStream_t st) {
  if ((long long)Sk > 65535LL * 64) return cudaErrorInvalidValue;
  if (hd <= 64)
    return launch_bwd_dkdv<64>(q, k, v, lse, delta, dout, dk, dv, B, Sq, Sk, H, Hkv, hd,
                               causal, window, scale, st);
  if (hd <= 128)
    return launch_bwd_dkdv<128>(q, k, v, lse, delta, dout, dk, dv, B, Sq, Sk, H, Hkv, hd,
                                causal, window, scale, st);
  return launch_bwd_dkdv<256>(q, k, v, lse, delta, dout, dk, dv, B, Sq, Sk, H, Hkv, hd,
                              causal, window, scale, st);
}

// ---- the fp32 forward on the tensor cores ------------------------------------
//
// flash_fwd_x3_kernel computes what flash_fwd_kernel computes (the mask rule,
// a row with no live key 0 with lse +inf, the optional lse) with both
// products on the tensor cores as three TF32 products (big.big + big.small +
// small.big, as the backward's pair above; 164.9 TFLOP/s of fp32-accurate
// products against the FMA pipes' 67). What bounds it: 4 hd operations a live
// pair against q, k, v read and o written once; at internvl2-2b's fp32 shape
// (B 4, S 2,304, H 16/8, hd 128, causal) 0.087 TFLOP against 0.23 GB, so
// operations. The design:
// * Roles (384 threads; setmaxnreg 56 for the producer, 224 for each
//   consumer): consumers 0 and 1 own 64 query rows each of a 128-row block;
//   the producer warpgroup's thread 0 loads Q once and the live 32-key K and
//   V tiles into a ring (four stages at HDP 64, two above) by TMA; its 128
//   threads split K in place (big over it, small beside) and write V^T's
//   big and small terms.
// * Q stays as loaded (64 KB at HDP 128) and is split as it is read, as in
//   the backward: split in shared memory it would take 128 KB.
// * S = Q K^T: A = Q from registers (frag_split), B = K's split tile,
//   K-major as it lands (m64n32k8 over HC / 8 steps).
// * O += P V: wgmma takes TF32 B from shared memory K-major only, and V's
//   tile is MN-major for this product, so the producer writes V^T (a row per
//   column of V, the tile's 32 keys along it) with each 8-key step's keys
//   permuted, physical key 2 i + par at position 4 par + i (split_vt): the S
//   accumulator's fragment holds keys 2c and 2c + 1 of a step where the TF32
//   A fragment wants columns c and c + 4, so p's fragment is the A fragment
//   as it stands, split in registers; P never goes through shared memory
//   and no barrier orders the consumers (m64nHCk8 over 4 steps). V lands in
//   the slot of K's small term: the producer writes V^T first, then K's
//   small term over V (a named barrier between), so a stage holds four
//   terms, not five.
// * The online softmax in base 2 with scale log2(e) folded into one FMA; a
//   masked score is -inf, so its p is exactly 0; the mask runs only in tiles
//   that cross Sk, the diagonal or the window's edge; dead tiles are skipped
//   per consumer; the heaviest query blocks run first.
// * HDP 256 (gemma3's hd 240, recurrentgemma's 256): a thread-block cluster
//   pair (the grid's z), block z holding columns 128 z to 128 z + 127 of Q,
//   K, V and O. The halves of S cross by st.async and are added, a + b in
//   both blocks, so both form the same p bits and the two column halves of
//   a row of O use the same probabilities; lse comes from block 0.
// * Every output element has one owner and one order of sums, no atomics:
//   two launches give the same bits. It executes 12 hd TF32 operations a
//   computed pair (chip_smoke.py::flash_floor counts the tiles).

// The forward's ring depth: four stages of T keys at HDP 64, two above (at
// HDP 256 beside the partner's halves of S, 225 KB)
template <int HDP>
__host__ __device__ constexpr int fwd_stages() { return HDP == 64 ? 4 : 2; }
// setmaxnreg: the producer warpgroup transposes and splits V in 56
// registers, each consumer keeps 224 (128 x 56 + 256 x 224 = 384 x 168)
constexpr int kFwdProducerRegs = 56;
constexpr int kFwdConsumerRegs = 224;

// Shared memory of the forward, in bytes from a 1024-aligned base: Q of the
// block's 128 query rows as loaded (HC / 32 128-byte swizzled panels of 32
// columns; HC = HDP up to 128, at 256 the pair of blocks of a cluster holds
// 128 each); a ring of stages, each four T x HC terms: K as loaded, split in
// place into its big term; K's small term (where V lands as loaded); V^T's
// big and small terms (HC rows of T keys, K-major for O += P V); at HDP 256
// the partner block's halves of S, by exchange parity and warpgroup; the
// barriers (Q's, full, ready and empty of each stage, the receipts).
template <int HDP>
struct FwdLayout {
  static constexpr bool kPair = HDP > 128;
  static constexpr int HC = kPair ? 128 : HDP;
  static constexpr int NP = HC / 32, T = kTileRows, NS = fwd_stages<HDP>();
  static constexpr int kQ = 128 * HC * 4;
  static constexpr int kStr = T * HC * 4;     // one term of a K or V tile
  static constexpr int kX = kQ + NS * 4 * kStr;
  static constexpr int kXPart = 64 * T * 4;   // one warpgroup's half of S
  static constexpr int kBar = kX + (kPair ? 2 * 2 * kXPart : 0);
  static constexpr int kBytes = kBar + 8 * (1 + 3 * NS + 4) + 1024;
};

// V's tile as loaded (`vin`: T keys x HC columns, fp32 in 128-byte swizzled
// panels of 32 columns) into V^T's big and small terms (HC rows, one a
// column of V, of the T keys: K-major), each 8-key step's keys in the order
// the S accumulator's fragment holds p, so that it is the TF32 A fragment
// of O += P V as it stands: physical key 2 i + par of a step at logical
// position 4 par + i (a thread holds keys 2c and 2c + 1 of a step, the A
// fragment wants columns c and c + 4). A thread takes a 4-column chunk cc of
// 4 keys (one step kk, one parity) and writes one 16-byte chunk of each of
// the 4 rows; the 8 threads of a 16-byte access phase take distinct banks
// both in the loads and in the stores (cc = 2 j + r0 + 8 r2 and kk = (r1 +
// j) mod 4 for lane j = 0..3 of each parity).
// component e of x (e a constant once unrolled)
__device__ __forceinline__ float elem4(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

template <int HC>
__device__ __forceinline__ void split_vt(const uint8_t* vin, uint8_t* big, uint8_t* small,
                                         int t) {
  constexpr int T = kTileRows;
#pragma unroll
  for (int m = 0; m < HC / 64; ++m) {   // HC T / 16 chunks, 128 threads
    const int u = t + 128 * m;
    const int par = u & 1, j = (u >> 1) & 3, rest = u >> 3;
    const int cc = 2 * j + (rest & 1) + 8 * (rest >> 3);
    const int kk = (((rest >> 1) & 3) + j) & 3;
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = 8 * kk + 2 * i + par;
      x[i] = *reinterpret_cast<const float4*>(vin + (cc >> 3) * (T * 128) + key * 128 +
                                              (((cc & 7) ^ (key & 7)) << 4));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * cc + e;
      uint4 b, s;
      split(elem4(x[0], e), b.x, s.x);
      split(elem4(x[1], e), b.y, s.y);
      split(elem4(x[2], e), b.z, s.z);
      split(elem4(x[3], e), b.w, s.w);
      const int off = n * 128 + (((2 * kk + par) ^ (n & 7)) << 4);
      *reinterpret_cast<uint4*>(big + off) = b;
      *reinterpret_cast<uint4*>(small + off) = s;
    }
  }
}

// o (and lse) of 128 query rows of one (b, h), 64 a consumer warpgroup; at
// HDP 256 a cluster of two blocks (the grid's z) shares the rows, block z
// holding Q, K, V and O's columns 128 z to 128 z + 127 (the halves of S
// cross the pair). The producer warpgroup's thread 0 loads Q once and the
// live K and V tiles into the ring; its 128 threads split K in place and
// write V^T split. Each consumer, for each tile some row of its 64 leaves
// live: S = Q K^T (Q split as it is read), the online softmax in base 2,
// O rescaled, O += P V with p's fragment as the A operand.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_x3_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, float* __restrict__ o, float* __restrict__ lse,
    int Sq, int Sk, int H, int Hkv, int hd, int causal, int window, float scale_log2) {
  using L = FwdLayout<HDP>;
  constexpr int T = L::T, NS = L::NS, HC = L::HC;
  constexpr bool kPair = L::kPair;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gb = smem_raw + (base - raw);
  // stage s, term t (0 K big / as loaded, 1 K small / V as loaded, 2 V^T big,
  // 3 V^T small): offset from base
  auto ring = [](int s, int t) { return L::kQ + (s * 4 + t) * L::kStr; };
  const uint32_t q_full = base + L::kBar;
  auto full = [&](int s) { return q_full + 8 * (1 + s); };
  auto ready = [&](int s) { return q_full + 8 * (1 + NS + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * NS + s); };
  // the partner's half of warpgroup w's S for exchanges of parity x
  auto xbar = [&](int x, int w) { return q_full + 8 * (1 + 3 * NS + 2 * x + w); };

  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  // the block's (b, h), first query row, first of its HC columns and live
  // key tiles, formed in each role after setmaxnreg (fresh)
  int bh, b, h, q0, col0, kt_lo, n_tiles;
  auto block = [&]() {
    bh = fresh(blockIdx.x);
    col0 = kPair ? cluster_rank() * HC : 0;
    b = bh / H;
    h = bh % H;
    q0 = (gridDim.y - 1 - fresh(blockIdx.y)) * 128;  // heaviest (last) tiles first
    const int q_last = min(q0 + 128, Sq) - 1;
    int kt_hi = (Sk - 1) / T;
    kt_lo = 0;
    if (causal) {
      kt_hi = min(q_last, Sk - 1) / T;
      if (window > 0) kt_lo = max(0, q0 - window + 1) / T;
    }
    n_tiles = kt_hi - kt_lo + 1;   // <= 0 when a window lies wholly past Sk
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), 128);
      mbar_init(empty(s), 256);
    }
    if constexpr (kPair)
      for (int x = 0; x < 4; ++x) mbar_init(xbar(x / 2, x % 2), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // at HDP 256 the partner's barriers are set before anything is sent to it
  if constexpr (kPair)
    cluster_sync();
  else
    __syncthreads();

  if (wg == 2) {
    // ---- producer: Q once; then each K/V tile loaded, K split, V^T written ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kFwdProducerRegs));
    block();
    const int hk = h / (H / Hkv);
    if (tw == 0) {
      mbar_expect_tx(q_full, L::kQ);
      for (int p = 0; p < L::NP; ++p)
        tma_load(base + p * 128 * 128, &tq, q_full, col0 + p * 32, h, q0, b);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % NS;
      if (tw == 0) {
        const int k0 = (kt_lo + it) * T;
        mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kStr);
        for (int p = 0; p < L::NP; ++p) {
          tma_load(base + ring(s, 0) + p * T * 128, &tk, full(s), col0 + p * 32, hk, k0, b);
          tma_load(base + ring(s, 1) + p * T * 128, &tv, full(s), col0 + p * 32, hk, k0, b);
        }
      }
      mbar_wait(full(s), (it / NS) & 1);
      split_vt<HC>(gb + ring(s, 1), gb + ring(s, 2), gb + ring(s, 3), tw);
      bar_sync(1, 128);   // V as loaded is read: K's small term goes over it
      split_tile(gb + ring(s, 0), gb + ring(s, 1), T * HC, tw);
      fence_async_smem();
      mbar_arrive(ready(s));
    }
  } else {
    // ---- consumers: 64 query rows each ------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kFwdConsumerRegs));
    block();
    const int lane = tw % 32, warp = tw / 32;
    // this thread's rows of S and O: qp0 and qp0 + 8 (wgmma's fragment)
    const int qp0 = q0 + wg * 64 + warp * 16 + lane / 4, qp1 = qp0 + 8;
    const int w_first = q0 + wg * 64, w_last = min(w_first + 63, Sq - 1);
    float acc[HC / 2];
#pragma unroll
    for (int j = 0; j < HC / 2; ++j) acc[j] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    int nx = 0;   // exchanges of S with the partner block (HDP 256)
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % NS;
      const int k0 = (kt_lo + it) * T;
      mbar_wait(ready(s), (it / NS) & 1);
      bool dead = w_last < w_first;   // every row of this warpgroup lies beyond Sq
      if (causal) {
        dead = dead || k0 > w_last;
        if (window > 0) dead = dead || k0 + T - 1 <= w_first - window;
      }
      if (!dead) {
        // S = Q K^T, 64 x T over HC / 8 steps, Q split as it is read
        float sc[T / 2];
#pragma unroll
        for (int i = 0; i < T / 2; ++i) sc[i] = 0.f;
        const uint32_t kb = base + ring(s, 0);
        mma3<T, HC / 8>(
            sc, [&](int kk, uint32_t* bg, uint32_t* sm) {
              frag_split<128>(gb, wg * 64 + warp * 16, kk, lane, bg, sm);
            },
            [&](int kk, int term) { return kdesc(kb + term * L::kStr, kk, T * 128); });
        if constexpr (kPair) {
          // this block's half of the sum to the partner, the partner's half
          // added here (a + b: both blocks hold the same bits, so the same p)
          const int x = nx & 1;
          const uint32_t part = L::kX + (x * 2 + wg) * L::kXPart;
          if (tw == 0) mbar_expect_tx(xbar(x, wg), L::kXPart);
          const int other = cluster_rank() ^ 1;
          const uint32_t dst = at_rank(base + part, other), bar = at_rank(xbar(x, wg), other);
#pragma unroll
          for (int v = 0; v < T / 8; ++v)
            st_async4(dst + (v * 128 + tw) * 16,
                      make_float4(sc[4 * v], sc[4 * v + 1], sc[4 * v + 2], sc[4 * v + 3]), bar);
          mbar_wait(xbar(x, wg), (nx >> 1) & 1);
          const float4* got = reinterpret_cast<const float4*>(gb + part);
#pragma unroll
          for (int v = 0; v < T / 8; ++v) {
            const float4 g = got[v * 128 + tw];
            sc[4 * v] += g.x;
            sc[4 * v + 1] += g.y;
            sc[4 * v + 2] += g.z;
            sc[4 * v + 3] += g.w;
          }
          ++nx;
        }
        // the mask, only in tiles that cross Sk, the diagonal or the window's edge
        const bool edge =
            k0 + T > Sk ||
            (causal && (k0 + T - 1 > w_first || (window > 0 && k0 <= w_last - window)));
        if (edge) {
#pragma unroll
          for (int i = 0; i < T / 2; ++i) {
            const int key = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
            const int qp = (i & 2) ? qp1 : qp0;
            const bool live =
                key < Sk && (!causal || (key <= qp && (window <= 0 || qp - key < window)));
            if (!live) sc[i] = -INFINITY;
          }
        }
        // online softmax in base 2: rows qp0 (elements with i & 2 == 0) and qp1
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int i = 0; i < T / 2; ++i) {
          if (i & 2) mx1 = fmaxf(mx1, sc[i]);
          else mx0 = fmaxf(mx0, sc[i]);
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float b0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
        const float b1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
        const float c0 = exp2_ftz(m0 * scale_log2 - b0), c1 = exp2_ftz(m1 * scale_log2 - b1);
        m0 = mx0;
        m1 = mx1;
        l0 *= c0;
        l1 *= c1;
#pragma unroll
        for (int j = 0; j < HC / 2; ++j) acc[j] *= (j & 2) ? c1 : c0;
        // p = 2^(s scale log2(e) - m scale log2(e)) (a masked score is -inf:
        // p = 0), split, as step kk's A fragment: a0 (row qp0, key 2c), a1
        // (qp1, 2c), a2 (qp0, 2c + 1), a3 (qp1, 2c + 1)
        uint32_t pb[T / 2], ps[T / 2];
#pragma unroll
        for (int kk = 0; kk < T / 8; ++kk) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = 4 * kk + 2 * (a & 1) + (a >> 1);   // a = 0, 1, 2, 3: i 0, 2, 1, 3
            const float p = exp2_ftz(fmaf(sc[i], scale_log2, (i & 2) ? -b1 : -b0));
            if (i & 2) l1 += p;
            else l0 += p;
            split(p, pb[4 * kk + a], ps[4 * kk + a]);
          }
        }
        // O += P V over T / 8 steps of 8 keys, three TF32 products a step
        const uint32_t vb = base + ring(s, 2), vs = base + ring(s, 3);
        pin<HC / 2>(acc);
        pin<T / 2>(pb);
        pin<T / 2>(ps);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T / 8; ++kk) {
          wgmma_tf32<HC>(acc, pb + 4 * kk, kdesc(vb, kk, 0));
          wgmma_tf32<HC>(acc, pb + 4 * kk, kdesc(vs, kk, 0));
          wgmma_tf32<HC>(acc, ps + 4 * kk, kdesc(vb, kk, 0));
        }
        wgmma_commit();
        wgmma_wait0();
        pin<HC / 2>(acc);
        pin<T / 2>(pb);
        pin<T / 2>(ps);
      }
      mbar_arrive(empty(s));
    }

    // epilogue: the row sums over the quad, then o = acc / l
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    // the natural log-sum-exp of the scaled scores (m is the raw score's
    // max, l the sum of 2^((s - m) scale log2(e))), from block 0 of a pair
    if (lse != nullptr && lane % 4 == 0 && col0 == 0) {
      constexpr float kLn2 = 0.6931471805599453f;
      float* lb = lse + (long long)bh * Sq;
      if (qp0 < Sq) lb[qp0] = l0 > 0.f ? (m0 * scale_log2 + log2f(l0)) * kLn2 : INFINITY;
      if (qp1 < Sq) lb[qp1] = l1 > 0.f ? (m1 * scale_log2 + log2f(l1)) * kLn2 : INFINITY;
    }
    // element j: row qp0 (qp1 when j & 2), column col0 + 8 (j / 4) + 2 (lane
    // % 4) + j % 2; hd is a multiple of 4, so a pair is whole or past hd
    const long long q_stride = (long long)H * hd;
    float* const ob = o + (long long)b * Sq * q_stride + (long long)h * hd;
#pragma unroll
    for (int j = 0; j < HC / 2; j += 2) {
      const int d = col0 + (j / 4) * 8 + (lane % 4) * 2;
      const int qp = (j & 2) ? qp1 : qp0;
      const float den = (j & 2) ? den1 : den0;
      if (qp < Sq && d < hd)
        *reinterpret_cast<float2*>(ob + qp * q_stride + d) =
            make_float2(acc[j] / den, acc[j + 1] / den);
    }
  }
}

template <int HDP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                       float scale, cudaStream_t st) {
  using L = FwdLayout<HDP>;
  constexpr int bytes = L::kBytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_x3_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  if ((long long)Sq > 65535LL * 128) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t e = encode(&tq, q, B, Sq, H, hd, 128, 4);
  if (e == cudaSuccess) e = encode(&tk, k, B, Sk, Hkv, hd, L::T, 4);
  if (e == cudaSuccess) e = encode(&tv, v, B, Sk, Hkv, hd, L::T, 4);
  if (e != cudaSuccess) return e;
  // at HDP 256 the grid's z is the cluster pair that shares each row block
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H, (Sq + 127) / 128, L::kPair ? 2 : 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = L::kPair ? 2 : 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_fwd_x3_kernel<HDP>, tq, tk, tv, static_cast<float*>(o),
                         lse, Sq, Sk, H, Hkv, hd, causal, window, scale * kLog2e);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

cudaError_t dispatch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         int B, int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                         float scale, cudaStream_t st) {
  if (hd <= 64)
    return launch_fwd<64>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, causal, window, scale, st);
  if (hd <= 128)
    return launch_fwd<128>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, causal, window, scale, st);
  return launch_fwd<256>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, causal, window, scale, st);
}

}  // namespace x3

}  // namespace tc

// ---------------------------------------------------------------------------
// backward: dQ (and delta), then dK and dV
// ---------------------------------------------------------------------------
//
// The card's form of the reference's _flash_bwd (src/repro/models/
// attention.py:212-264, jnp; there is no Pallas backward). From q, k, v,
// the forward's o and per-row log-sum-exp lse (B, H, Sq) fp32, and dO:
//   delta_i = sum_d dO_id O_id;  p_ij = exp(s_ij - lse_i), s = q k^T * scale;
//   dp_ij = dO_i . v_j;  ds_ij = p_ij (dp_ij - delta_i) * scale;
//   dQ = ds K,  dK = ds^T Q,  dV = p^T dO.
// The probabilities are recomputed tile by tile from q, k and lse: nothing
// of size Sq x Sk is kept. The mask is the forward's (keys at or past Sk,
// causal j <= i counted from 0, the window only with causal); a masked pair
// has p = 0 exactly, its score never exponentiated (the FMA kernels skip
// it, the tensor-core kernels exponentiate -inf in its place), and a row
// with no live key has lse = +inf, so its p, its dq and its share of dk and
// dv are exactly 0.
// Two kernels, on the stream in this order: the dq kernel (which also
// computes delta, the only place it is computed, into a scratch (B, H, Sq)
// fp32) and the dK/dV kernel, which reads it. Every output element is
// written by one thread and every sum runs in one fixed order: no
// floating-point atomics, so two runs give the same bits (GQA's sum over a
// KV head's query heads is the dK/dV block's own loop). What bounds the
// pair: five products of 2 hd operations a live pair (s, dp, dq, dk, dv),
// against q, k, v, o, dO, lse read once and dq, dk, dv written once: at
// internvl2-2b's training shape (B 2, S 2,304, H 16/8, hd 128, causal)
// 0.11 TFLOP against 0.11 GB, so operations. Each kernel recomputes s and
// dp, so the pair executes more: three routes (flash_attention_bwd_route).
//
// bf16 at any hd up to 256 (it runs at 64, 128 or 256, TMA zero-filling the
// columns past hd), a layout TMA can take: tc::flash_bwd_dq_tc_kernel and
// tc::flash_bwd_dkdv_tc_kernel, every product on the tensor cores (wgmma,
// bf16 in, fp32 accumulate), warp-specialised as flash_fwd_tc_kernel (384
// threads; setmaxnreg gives the two consumer warpgroups 240 registers each,
// the producer 24), operands fed by TMA into 128-byte swizzled panels:
// * dq: a block owns 128 query rows of one (b, h), 64 a consumer. The
//   producer loads Q and dO once and streams the live 64-key K and V tiles
//   through a 2-stage ring. A consumer first forms delta of its rows from O
//   and dO (16-byte loads) and writes it out, then for each tile: S = Q K^T
//   and dP = dO V^T (m64n64k16 from shared memory, K-major both), p and dS
//   in fp32 registers, the tile's dS K with dS as the A operand from
//   registers and K as the MN-major B operand (the forward's P V form).
//   At HDP 256 Q and dO of 128 rows (128 KB) beside the 128 KB ring would
//   pass the 227 KB a block gets, so a block owns 64 rows, and (see
//   Registers below) both consumers form S, dP and dS of every live tile
//   of them; consumer w sums dq's columns 128 w to 128 w + 127, so an
//   element's sum runs in the same order as at HDP 128.
//   The grid doubles (1,024 blocks at gemma3-12b's training shape on 132
//   SMs), and S, dP and the elementwise work are done twice.
// * dk/dv: a block owns 64 keys of one (b, kv head), K and V loaded once;
//   consumer 0 forms dV, consumer 1 dK, each for all 64 keys. The producer
//   streams, for each query head of the group and each 64-query tile some
//   key of the block leaves live, the Q and dO tiles, and copies the tile's
//   lse (base 2) and delta into the same stage. For each
//   tile: S^T = K Q^T (both consumers) and dP^T = V dO^T (dK's), then p^T
//   (and dS^T) in registers, then the tile's p^T dO (or dS^T Q). With one
//   output a warpgroup, a thread's registers hold that output (64 fp32 at
//   hd 128), a tile's sum and the A operand's terms; the price is S^T
//   formed twice. At HDP 256 K, V and a two-stage Q/dO ring take 192 KB,
//   and the grid's third dimension takes the two halves of dk's and dv's
//   columns: a block forms S^T and dP^T over all 256 and sums 128 columns
//   of its output, so S^T and dP^T are formed twice as often.
// * Registers at HDP 256: 64 rows of all 256 fp32 output columns would be
//   128 registers a thread, which beside S and dP (64), the terms (48), a
//   tile's sum (32), some 24 scalars and the wgmma register blocks the
//   compiler lays out do not fit the consumers' 240: ptxas put about a
//   third of the output in local memory, inside the loop, in both
//   kernels. With 128 columns a consumer holds what it holds at HDP 128.
//   Outside the loop, values formed before setmaxnreg (kept through the
//   producer's 24 registers), dq's epilogue base and the dK/dV producer
//   warp's loop state would still spill a few words: fresh() and, in the
//   dK/dV kernel, 32 registers for the producer (232 for each consumer)
//   keep both 256 instances free of any stack frame.
// * Each tile's product goes into a zeroed accumulator and is then added
//   to the running fp32 sum (add_tile_product; dq, dk and dv stay in
//   registers across the whole loop and are written once at the end).
//   Summed on the tensor cores over all of whisper-large-v3's 1,500 keys,
//   dq drifted beyond phase 16's atol there (about 1e-7, 4 x the FMA
//   kernels' error); a tile's 12 steps do not.
// * p and dS enter the products as three bf16 terms, t0 = bf16(x), t1 =
//   bf16(x - t0), t2 = bf16(x - t0 - t1) (split_bf16, kTerms), which keep
//   all 24 of x's significant bits. S and dP come from bf16 operands and are
//   formed in fp32, so only p and dS are split. At that atol one rounding
//   to bf16 puts about a tenth of the gradients beyond the gate, two terms
//   (the forward's hi + lo) a few, three none
//   (tests/test_torch_flash_attention_bwd_tc.py). That makes fourteen
//   products executed a live pair (dq: s, dp, 3 x dq; dk/dv: s twice, dp,
//   3 x dv, 3 x dk) against the bound's five, so the tensor-core floor is
//   about 2.8 times the bound; at HDP 256, with s and dp formed for each
//   half of the columns, nineteen (dq: s and dp twice; dk/dv: s four
//   times, dp twice), 3.8 times. Dead tiles are skipped (per warpgroup in
//   the dq kernel).
// * Besides the products, a consumer issues its tile's elementwise work
//   itself (p, dS, their terms, the tile's sum): with a mask test and a
//   branch for every element the kernels were bound by that issue (1.8x
//   slower on an H100 at internvl2-2b's shape). The mask runs only in
//   tiles that cross Sq, Sk, the diagonal or the window's edge, as a
//   uniform branch around branch-free code, and 2^x is one MUFU.EX2
//   (exp2_ftz).
//
// fp32 at any hd up to 256 in a layout TMA can take (hd a multiple of 4;
// q, k, v, o, dO 16-byte aligned): x3::flash_bwd_dq_x3_kernel and
// x3::flash_bwd_dkdv_x3_kernel, every product on the tensor cores as three
// TF32 products (wgmma m64nNk8 .tf32, fp32 accumulate; 494.7 TFLOP/s dense
// on an H100 SXM, so 165 of fp32-accurate products against the FMA
// pipes' 67):
// * The split. Every operand that enters a product (Q, K, V, dO, p, dS) is
//   big = tf32(x), rounded to nearest with ties away (cvt.rna.tf32.f32's
//   rule, on the bits), and small = tf32(x - big); a product A B is big.big + big.small + small.big into
//   one fp32 accumulator (small.small, 2^-22 below, is dropped). One TF32
//   product a product puts tens of thousands of gradients beyond the
//   reference's 1e-4 at internvl2-2b's shape cut to 1,024 tokens, the split
//   none (tests/test_torch_flash_attention_bwd_tf32.py emulates the
//   order).
// * The layout constraint. wgmma takes .tf32 operands from shared memory
//   K-major only (the transpose bits are for 16-bit types), so the
//   products that contract over a tile's rows (dQ = dS K; dV = P^T dO and
//   dK = dS^T Q) cannot read K, dO or Q as the B operand the way the bf16
//   pair does. They are formed transposed instead: dQ^T = K^T dS^T, dV^T =
//   dO^T P, dK^T = Q^T dS, the natural-layout tile entering as the A
//   operand from registers (a thread loads its fragment from the split tile
//   in any order: a0 row r, column c; a1 row r + 8; a2 column c + 4; a3
//   both), and P or dS written by the consumers into shared memory as
//   K-major B tiles (their rows queries in the dq kernel, keys in the dK/dV
//   kernel). S = Q K^T and dP = dO V^T (S^T = K Q^T, dP^T = V dO^T) take the
//   resident tile as the A operand from registers too, split as it is read
//   (frag_split), and the streamed tile as the K-major B operand.
// * Shared memory. A tile of fp32 is twice a bf16 one, and a B operand
//   needs its big and its small term: 64 x 128 fp32 and its small term are
//   64 KB. So the resident tiles (dq: Q and dO of 64 query rows; dK/dV: K
//   and V of 64 keys) stay as loaded (64 KB at HDP 128) and are split in
//   registers, and only the streamed tiles (K and V, or Q and dO) are split
//   in shared memory, by the producer warpgroup (TMA lands a tile; its 128
//   threads write big over it and small beside it, then release it to the
//   consumers on a second barrier). Tiles of 32 rows, two stages up to HDP
//   128 (dq 217 KB, dK/dV 226 KB).
// * HDP 256: a thread-block cluster of two blocks (the grid's z) shares a
//   row block (dq) or key block (dK/dV); block z holds hd columns 128 z to
//   128 z + 127 of every tile and sums those columns of its output, as a
//   block does at HDP 128. Each forms its half of S and dP's sums over hd,
//   sends it into the other's shared memory (st.async, counted on the
//   other's mbarrier) and adds the half it receives: a + b in both, so both
//   hold the same S, dP and, from them, the same p and dS. One block with
//   all 256 columns had only one stage of 16-row tiles (the raw Q and dO
//   alone take 128 KB), and its dK/dV consumers' 128 fp32 of output
//   spilled, so the grid took column halves and formed S^T and dP^T twice.
//   One stage of 32-row tiles a block (dq 185 KB, dK/dV 193 KB) measured
//   faster than two of 16.
// * Warp roles (384 threads; setmaxnreg 40 for the producer, 232 for each
//   consumer). dq: consumer 0 forms S and p, consumer 1 dP; p crosses in
//   shared memory in the fragment's order; consumer 1 forms dS and writes
//   it split; both then add dQ^T += K^T dS^T for their half of the columns
//   (HDP 64: their half of the 64 queries), K^T from the split K tile.
//   dK/dV: consumer 0 forms S^T, p and writes P split; consumer 1 forms
//   dP^T and, from P's big + small, dS; consumer 0 adds dV^T += dO^T P,
//   consumer 1 dK^T += Q^T dS, each over the block's columns of its 64
//   keys. Named barriers order the exchange; every output element has one
//   owner and one fixed order of sums (tiles ascending; GQA's query heads
//   in turn), no atomics.
// * A product's A fragments run two steps ahead of its wgmma in a ring of
//   three register slots (mma3), so the loads and the split of a step
//   overlap the products before it on the tensor cores.
// * Dead tiles are never loaded (dq: the forward's live key tiles of its
//   64 rows; dK/dV: the live query tiles of its 64 keys), the mask runs
//   only in tiles that cross Sq, Sk, the diagonal or the window's edge, and
//   the heaviest blocks go first, as in the bf16 pair. Twenty-one TF32
//   products a live pair are executed (7 products: s and dp in each kernel,
//   dq, dk, dv; three terms each): chip_smoke.py::flash_bwd_x3_floor counts
//   them over the tiles computed.
//
// fp32 and bf16 in layouts TMA cannot take (a base not 16-byte aligned; hd
// not a multiple of 8 for bf16 or of 4 for fp32; no configuration of the
// repo has one): flash_bwd_dq_kernel and
// flash_bwd_dkdv_kernel, on the FMA pipes, the inputs widened to fp32 in
// shared memory:
// * flash_bwd_dq_kernel: a block owns 64 query rows of one (b, h), 256
//   threads as 16 x 16 as in flash_fwd_kernel (thread (ty, tx): 4 rows,
//   keys tx and tx + 16 of each 32-key tile, dq columns tx + 16 i). It
//   first computes delta for its rows, then walks the forward's live key
//   tiles: s and dp in one pass over hd, ds into shared memory, dq += ds K.
// * flash_bwd_dkdv_kernel: a block owns one (b, kv head) and KB keys (64,
//   or 32 at hd 256 so that dk and dv fit in registers), and loops over the
//   H / Hkv query heads of its group and, for each, over the 32-query tiles
//   that some key of its tile leaves live. Thread (ty, tx) owns KB / 16
//   keys and queries tx and tx + 16 of a tile for s and dp; p and ds go to
//   shared memory; then dv += p^T dO and dk += ds^T q over dk/dv columns
//   tx + 16 i.
// Seven products of 2 hd operations a live pair are executed (s, dp, dq;
// s, dp, dv, dk), on the FMA pipes (67 TFLOP/s); dq, dk, dv come out in the
// input type.

constexpr int kBQB = 32;   // queries per tile of the dK/dV kernel

template <int HDP>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * (size_t)kBQ * (HDP + 4) + 2 * (size_t)kBK * (HDP + 4) +
                          (size_t)kBQ * kPL);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kNT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const float* __restrict__ lse, const T* __restrict__ dout,
    T* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk, int H, int Hkv, int hd,
    int causal, int window, float scale) {
  constexpr int LD = HDP + 4;
  constexpr int kCols = HDP / kTX;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ds = Qs + kBQ * LD;      // dO
  float* Ks = Ds + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ss = Vs + kBK * LD;      // ds

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const long long q_stride = (long long)H * hd;
  const long long kv_stride = (long long)Hkv * hd;
  const long long q_base = (long long)b * Sq * q_stride + (long long)h * hd;
  const T* kb = k + (long long)b * Sk * kv_stride + (long long)hk * hd;
  const T* vb = v + (long long)b * Sk * kv_stride + (long long)hk * hd;

  for (int i = tid; i < kBQ * HDP; i += kNT) {
    const int rr = i / HDP, d = i % HDP, s = q0 + rr;
    const bool in = s < Sq && d < hd;
    Qs[rr * LD + d] = in ? to_f32(q[q_base + s * q_stride + d]) : 0.f;
    Ds[rr * LD + d] = in ? to_f32(dout[q_base + s * q_stride + d]) : 0.f;
  }

  // delta and lse of this thread's rows; delta over hd in the row group's
  // 16 threads, then 4 shuffles
  float dl[kRows], ls[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + ty * kRows + r;
    float acc = 0.f;
    if (qp < Sq)
      for (int d = tx; d < hd; d += kTX)
        acc = fmaf(to_f32(dout[q_base + qp * q_stride + d]),
                   to_f32(o[q_base + qp * q_stride + d]), acc);
#pragma unroll
    for (int off = kTX / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    dl[r] = acc;
    ls[r] = qp < Sq ? lse[(long long)bh * Sq + qp] : INFINITY;
    if (qp < Sq && tx == 0) delta[(long long)bh * Sq + qp] = acc;
  }

  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kt_lo = 0, kt_hi = (Sk - 1) / kBK;
  if (causal) {
    kt_hi = min(q_last, Sk - 1) / kBK;
    if (window > 0) kt_lo = max(0, q0 - window + 1) / kBK;
  }

  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // Q and dO are in; the previous tile's K, V, ds consumed
    for (int i = tid; i < kBK * HDP; i += kNT) {
      const int rr = i / HDP, d = i % HDP, s = k0 + rr;
      const bool in = s < Sk && d < hd;
      Ks[rr * LD + d] = in ? to_f32(kb[s * kv_stride + d]) : 0.f;
      Vs[rr * LD + d] = in ? to_f32(vb[s * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    float sc[kRows][kKeys], dp[kRows][kKeys];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kKeys; ++c) sc[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HDP; d += 4) {
      float4 qv[kRows], gv[kRows], kv[kKeys], vv[kKeys];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        qv[r] = *reinterpret_cast<const float4*>(&Qs[(ty * kRows + r) * LD + d]);
        gv[r] = *reinterpret_cast<const float4*>(&Ds[(ty * kRows + r) * LD + d]);
      }
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        kv[c] = *reinterpret_cast<const float4*>(&Ks[(tx + c * kTX) * LD + d]);
        vv[c] = *reinterpret_cast<const float4*>(&Vs[(tx + c * kTX) * LD + d]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kKeys; ++c) {
          float a = sc[r][c], g = dp[r][c];
          a = fmaf(qv[r].x, kv[c].x, a);
          a = fmaf(qv[r].y, kv[c].y, a);
          a = fmaf(qv[r].z, kv[c].z, a);
          a = fmaf(qv[r].w, kv[c].w, a);
          g = fmaf(gv[r].x, vv[c].x, g);
          g = fmaf(gv[r].y, vv[c].y, g);
          g = fmaf(gv[r].z, vv[c].z, g);
          g = fmaf(gv[r].w, vv[c].w, g);
          sc[r][c] = a;
          dp[r][c] = g;
        }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + ty * kRows + r;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int kp = k0 + tx + c * kTX;
        bool live = kp < Sk && qp < Sq;
        if (causal) {
          live = live && kp <= qp;
          if (window > 0) live = live && kp > qp - window;
        }
        const float p = live ? expf(fmaf(sc[r][c], scale, -ls[r])) : 0.f;
        Ss[(ty * kRows + r) * kPL + tx + c * kTX] = p * (dp[r][c] - dl[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float sr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) sr[r] = Ss[(ty * kRows + r) * kPL + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kvv = Ks[kk * LD + tx + c * kTX];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(sr[r], kvv, acc[r][c]);
      }
    }
  }

  T* dqb = dq + q_base;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + ty * kRows + r;
    if (qp >= Sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + c * kTX;
      if (d < hd) dqb[qp * q_stride + d] = from_f32<T>(acc[r][c]);
    }
  }
}

// keys per block of the FMA dK/dV kernel: 64, or 32 at hd 256 (dk and dv, KB
// x HDP fp32 each, are held by the block's 256 threads in registers); at
// hd 256 that kernel now serves fp32 and the layouts TMA cannot take
template <int HDP>
__host__ __device__ constexpr int dkdv_keys() { return HDP <= 128 ? 64 : 32; }

template <int HDP>
constexpr size_t dkdv_smem_bytes() {
  constexpr int KB = dkdv_keys<HDP>();
  return sizeof(float) * (2 * (size_t)KB * (HDP + 4) + 2 * (size_t)kBQB * (HDP + 4) +
                          2 * (size_t)KB * (kBQB + 1) + 2 * kBQB);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kNT) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
    int Hkv, int hd, int causal, int window, float scale) {
  constexpr int LD = HDP + 4;
  constexpr int KB = dkdv_keys<HDP>();
  constexpr int kKR = KB / kTY;          // keys per thread
  constexpr int kQT = kBQB / kTX;        // queries per thread in the score phase
  constexpr int PL = kBQB + 1;
  constexpr int kCols = HDP / kTX;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + KB * LD;
  float* Qs = Vs + KB * LD;
  float* Ds = Qs + kBQB * LD;            // dO
  float* Ps = Ds + kBQB * LD;            // p, by key row
  float* Ss = Ps + KB * PL;              // ds, by key row
  float* Ls = Ss + KB * PL;              // lse of the query tile
  float* Es = Ls + kBQB;                 // delta of the query tile

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int R = H / Hkv;
  const int k0 = blockIdx.x * KB;
  const long long q_stride = (long long)H * hd;
  const long long kv_stride = (long long)Hkv * hd;
  const long long kv_base = (long long)b * Sk * kv_stride + (long long)hk * hd;

  for (int i = tid; i < KB * HDP; i += kNT) {
    const int rr = i / HDP, d = i % HDP, s = k0 + rr;
    const bool in = s < Sk && d < hd;
    Ks[rr * LD + d] = in ? to_f32(k[kv_base + s * kv_stride + d]) : 0.f;
    Vs[rr * LD + d] = in ? to_f32(v[kv_base + s * kv_stride + d]) : 0.f;
  }

  // the query tiles some key of this tile leaves live, ascending
  const int k_last = min(k0 + KB, Sk) - 1;
  int qt_lo = 0, qt_hi = (Sq - 1) / kBQB;
  if (causal) {
    qt_lo = k0 / kBQB;
    if (window > 0) qt_hi = min(Sq - 1, k_last + window - 1) / kBQB;
  }

  float gk[kKR][kCols], gv[kKR][kCols];
#pragma unroll
  for (int r = 0; r < kKR; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) gk[r][c] = gv[r][c] = 0.f;

  for (int rh = 0; rh < R; ++rh) {
    const int h = hk * R + rh;
    const long long q_base = (long long)b * Sq * q_stride + (long long)h * hd;
    const long long row_base = ((long long)b * H + h) * Sq;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * kBQB;
      __syncthreads();  // the previous tile's Q, dO, p and ds are consumed
      for (int i = tid; i < kBQB * HDP; i += kNT) {
        const int rr = i / HDP, d = i % HDP, s = q0 + rr;
        const bool in = s < Sq && d < hd;
        Qs[rr * LD + d] = in ? to_f32(q[q_base + s * q_stride + d]) : 0.f;
        Ds[rr * LD + d] = in ? to_f32(dout[q_base + s * q_stride + d]) : 0.f;
      }
      if (tid < kBQB) {
        const int s = q0 + tid;
        Ls[tid] = s < Sq ? lse[row_base + s] : INFINITY;
        Es[tid] = s < Sq ? delta[row_base + s] : 0.f;
      }
      __syncthreads();

      float sc[kKR][kQT], dp[kKR][kQT];
#pragma unroll
      for (int r = 0; r < kKR; ++r)
#pragma unroll
        for (int c = 0; c < kQT; ++c) sc[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HDP; d += 4) {
        float4 kv[kKR], vv[kKR], qv[kQT], gq[kQT];
#pragma unroll
        for (int r = 0; r < kKR; ++r) {
          kv[r] = *reinterpret_cast<const float4*>(&Ks[(ty * kKR + r) * LD + d]);
          vv[r] = *reinterpret_cast<const float4*>(&Vs[(ty * kKR + r) * LD + d]);
        }
#pragma unroll
        for (int c = 0; c < kQT; ++c) {
          qv[c] = *reinterpret_cast<const float4*>(&Qs[(tx + c * kTX) * LD + d]);
          gq[c] = *reinterpret_cast<const float4*>(&Ds[(tx + c * kTX) * LD + d]);
        }
#pragma unroll
        for (int r = 0; r < kKR; ++r)
#pragma unroll
          for (int c = 0; c < kQT; ++c) {
            float a = sc[r][c], g = dp[r][c];
            a = fmaf(qv[c].x, kv[r].x, a);
            a = fmaf(qv[c].y, kv[r].y, a);
            a = fmaf(qv[c].z, kv[r].z, a);
            a = fmaf(qv[c].w, kv[r].w, a);
            g = fmaf(gq[c].x, vv[r].x, g);
            g = fmaf(gq[c].y, vv[r].y, g);
            g = fmaf(gq[c].z, vv[r].z, g);
            g = fmaf(gq[c].w, vv[r].w, g);
            sc[r][c] = a;
            dp[r][c] = g;
          }
      }
#pragma unroll
      for (int r = 0; r < kKR; ++r) {
        const int kp = k0 + ty * kKR + r;
#pragma unroll
        for (int c = 0; c < kQT; ++c) {
          const int qi = tx + c * kTX, qp = q0 + qi;
          bool live = kp < Sk && qp < Sq;
          if (causal) {
            live = live && kp <= qp;
            if (window > 0) live = live && kp > qp - window;
          }
          const float p = live ? expf(fmaf(sc[r][c], scale, -Ls[qi])) : 0.f;
          Ps[(ty * kKR + r) * PL + qi] = p;
          Ss[(ty * kKR + r) * PL + qi] = p * (dp[r][c] - Es[qi]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < kBQB; ++qq) {
        float pr[kKR], sr[kKR];
#pragma unroll
        for (int r = 0; r < kKR; ++r) {
          pr[r] = Ps[(ty * kKR + r) * PL + qq];
          sr[r] = Ss[(ty * kKR + r) * PL + qq];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float gd = Ds[qq * LD + tx + c * kTX];
          const float qd = Qs[qq * LD + tx + c * kTX];
#pragma unroll
          for (int r = 0; r < kKR; ++r) {
            gv[r][c] = fmaf(pr[r], gd, gv[r][c]);
            gk[r][c] = fmaf(sr[r], qd, gk[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kKR; ++r) {
    const int kp = k0 + ty * kKR + r;
    if (kp >= Sk) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + c * kTX;
      if (d < hd) {
        dk[kv_base + kp * kv_stride + d] = from_f32<T>(gk[r][c]);
        dv[kv_base + kp * kv_stride + d] = from_f32<T>(gv[r][c]);
      }
    }
  }
}

template <typename T, int HDP>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                          const float* lse, const void* dout, void* dq, float* delta, int B,
                          int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                          float scale, cudaStream_t st) {
  constexpr size_t bytes = dq_smem_bytes<HDP>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_bwd_dq_kernel<T, HDP><<<grid, kNT, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), lse, static_cast<const T*>(dout), static_cast<T*>(dq), delta,
      Sq, Sk, H, Hkv, hd, causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int HDP>
cudaError_t launch_bwd_dkdv(const void* q, const void* k, const void* v, const float* lse,
                            const float* delta, const void* dout, void* dk, void* dv, int B,
                            int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                            float scale, cudaStream_t st) {
  constexpr size_t bytes = dkdv_smem_bytes<HDP>();
  constexpr int KB = dkdv_keys<HDP>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((Sk + KB - 1) / KB, B * Hkv);
  flash_bwd_dkdv_kernel<T, HDP><<<grid, kNT, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lse, delta,
      static_cast<const T*>(dout), static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, Hkv,
      hd, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                            const float* lse, const void* dout, void* dq, float* delta, int B,
                            int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                            float scale, cudaStream_t st) {
  if (hd <= 64)
    return launch_bwd_dq<T, 64>(q, k, v, o, lse, dout, dq, delta, B, Sq, Sk, H, Hkv, hd,
                                causal, window, scale, st);
  if (hd <= 128)
    return launch_bwd_dq<T, 128>(q, k, v, o, lse, dout, dq, delta, B, Sq, Sk, H, Hkv, hd,
                                 causal, window, scale, st);
  return launch_bwd_dq<T, 256>(q, k, v, o, lse, dout, dq, delta, B, Sq, Sk, H, Hkv, hd,
                               causal, window, scale, st);
}

template <typename T>
cudaError_t dispatch_bwd_dkdv(const void* q, const void* k, const void* v, const float* lse,
                              const float* delta, const void* dout, void* dk, void* dv, int B,
                              int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                              float scale, cudaStream_t st) {
  if (hd <= 64)
    return launch_bwd_dkdv<T, 64>(q, k, v, lse, delta, dout, dk, dv, B, Sq, Sk, H, Hkv, hd,
                                  causal, window, scale, st);
  if (hd <= 128)
    return launch_bwd_dkdv<T, 128>(q, k, v, lse, delta, dout, dk, dv, B, Sq, Sk, H, Hkv, hd,
                                   causal, window, scale, st);
  return launch_bwd_dkdv<T, 256>(q, k, v, lse, delta, dout, dk, dv, B, Sq, Sk, H, Hkv, hd,
                                 causal, window, scale, st);
}

bool bad_shape(int B, int Sq, int Sk, int H, int Hkv, int hd) {
  return B < 0 || Sq < 0 || Sk < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || hd < 1 ||
         hd > 256 || (long long)B * H > 65535;
}

}  // namespace

extern "C" {

// o (B, Sq, H, hd) = attention of q (B, Sq, H, hd) over k, v (B, Sk, Hkv, hd),
// all contiguous, fp32 when dtype == 0 and bf16 when dtype == 1; the kernel
// as flash_attention_fwd_route says: fp32 in a layout TMA can take (hd a
// multiple of 4, q, k, v, o 16-byte aligned) runs tc::x3::flash_fwd_x3_kernel
// (3xTF32 on the tensor cores), bf16 in one (hd a multiple of 8, q, k, v
// 16-byte aligned) tc::flash_fwd_tc_kernel, and the rest flash_fwd_kernel
// (FMA). causal != 0 masks keys after the query,
// positions counted from 0 in both; window > 0 (only with causal) also masks
// keys window or more positions before it. Sk >= 1, H a multiple of Hkv,
// 1 <= hd <= 256. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int Sq, int Sk, int H, int Hkv, int hd, int causal,
                        int window, float scale, int dtype, void* stream) {
  if (B < 0 || Sq < 0 || Sk < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || hd < 1 ||
      hd > 256 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc::x3::takes(q, k, v, o, nullptr, hd, dtype))
    return (int)tc::x3::dispatch_fwd(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, causal, window,
                                     scale, st);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, causal, window,
                                scale, st);
  if (dtype == 1 && tc::tma_layout(q, k, v, hd))
    return (int)tc::dispatch(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, causal, window, scale,
                             st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, H, Hkv, hd, causal,
                                        window, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The forward's route for these operands: 2 when flash_attention_fwd launches
// the fp32 3xTF32 tensor-core kernel (fp32, hd a multiple of 4, q, k, v, o
// 16-byte aligned), 1 when it launches the bf16 tensor-core kernel (bf16, hd a
// multiple of 8, q, k, v 16-byte aligned), 0 when it launches the FMA kernel.
int flash_attention_fwd_route(const void* q, const void* k, const void* v, const void* o,
                              int hd, int dtype) {
  if (tc::x3::takes(q, k, v, o, nullptr, hd, dtype)) return 2;
  return dtype == 1 && tc::tma_layout(q, k, v, hd) ? 1 : 0;
}

// The backward's route for these operands: 1 when flash_attention_bwd_dq
// (given o) or flash_attention_bwd_dkdv (o null) launches the bf16
// tensor-core kernel (bf16, every base 16-byte aligned, hd a multiple of
// 8), 2 when it launches the fp32 3xTF32 tensor-core kernel (fp32, every
// base 16-byte aligned, hd a multiple of 4), 0 when it launches the FMA
// kernel.
int flash_attention_bwd_route(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, int hd, int dtype) {
  if (tc::bwd_tensor_cores(q, k, v, o, dout, hd, dtype)) return 1;
  return tc::x3::takes(q, k, v, o, dout, hd, dtype) ? 2 : 0;
}

// Backward, first kernel: dq (B, Sq, H, hd) and delta (B, H, Sq) fp32 (a
// scratch the second kernel reads) from q, k, v, o, lse (B, H, Sq) fp32 as
// flash_attention_fwd wrote it, and dout (B, Sq, H, hd); fp32 when dtype ==
// 0, bf16 when 1, every tensor contiguous; the route as
// flash_attention_bwd_route says. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                           const float* lse, const void* dout, void* dq, float* delta, int B,
                           int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                           float scale, int dtype, void* stream) {
  if (bad_shape(B, Sq, Sk, H, Hkv, hd) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc::bwd_tensor_cores(q, k, v, o, dout, hd, dtype))
    return (int)tc::dispatch_bwd_dq(q, k, v, o, lse, dout, dq, delta, B, Sq, Sk, H, Hkv, hd,
                                    causal, window, scale, st);
  if (tc::x3::takes(q, k, v, o, dout, hd, dtype))
    return (int)tc::x3::dispatch_bwd_dq(q, k, v, o, lse, dout, dq, delta, B, Sq, Sk, H, Hkv,
                                        hd, causal, window, scale, st);
  if (dtype == 0)
    return (int)dispatch_bwd_dq<float>(q, k, v, o, lse, dout, dq, delta, B, Sq, Sk, H, Hkv,
                                       hd, causal, window, scale, st);
  return (int)dispatch_bwd_dq<__nv_bfloat16>(q, k, v, o, lse, dout, dq, delta, B, Sq, Sk, H,
                                             Hkv, hd, causal, window, scale, st);
}

// Backward, second kernel, after flash_attention_bwd_dq on the same stream:
// dk, dv (B, Sk, Hkv, hd) from q, k, v, lse, delta and dout. The same rules.
int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v, const float* lse,
                             const float* delta, const void* dout, void* dk, void* dv, int B,
                             int Sq, int Sk, int H, int Hkv, int hd, int causal, int window,
                             float scale, int dtype, void* stream) {
  if (bad_shape(B, Sq, Sk, H, Hkv, hd) || (dtype != 0 && dtype != 1) ||
      (long long)B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc::bwd_tensor_cores(q, k, v, nullptr, dout, hd, dtype))
    return (int)tc::dispatch_bwd_dkdv(q, k, v, lse, delta, dout, dk, dv, B, Sq, Sk, H, Hkv,
                                      hd, causal, window, scale, st);
  if (tc::x3::takes(q, k, v, nullptr, dout, hd, dtype))
    return (int)tc::x3::dispatch_bwd_dkdv(q, k, v, lse, delta, dout, dk, dv, B, Sq, Sk, H,
                                          Hkv, hd, causal, window, scale, st);
  if (dtype == 0)
    return (int)dispatch_bwd_dkdv<float>(q, k, v, lse, delta, dout, dk, dv, B, Sq, Sk, H,
                                         Hkv, hd, causal, window, scale, st);
  return (int)dispatch_bwd_dkdv<__nv_bfloat16>(q, k, v, lse, delta, dout, dk, dv, B, Sq, Sk,
                                               H, Hkv, hd, causal, window, scale, st);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
