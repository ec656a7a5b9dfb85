// RWKV6 WKV recurrence for Hopper (sm_90a), state resident on chip.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6/wkv6.py::wkv6_pallas
// (body _wkv6_kernel). It computes the same function: for each (batch, head)
// row, from S = 0,
//     coef_t = sum_n r_t[n] u[n] k_t[n]
//     y_t    = coef_t v_t + r_t^T S
//     S      = diag(w_t) S + k_t v_t^T
// with r, k, v (B, T, H, N) in fp32 or bf16, w (B, T, H, N) fp32 (decays
// near 1 would not survive a 2048-step product in bf16), u (H, N) fp32; it
// writes y (B, T, H, N) in r's type and the final S (B, H, N, N) fp32
// (S[n][m]: key n, value m). The arithmetic is elementwise fp32, step by
// step in the reference's order, as the TPU kernel's is; no step of its
// order depends on the launch's CV or splits, so all launches agree to the
// bit. tests/test_torch_wkv6_order.py emulates the order on the CPU.
//
// What bounds it on an H100: per step and row it does about 4 N^2 fp32
// operations on the state against 3 N input elements in r/k/v's type, N in
// fp32 (w) and N written (y). At B=4, T=2048, H=32, N=64 with bf16 r/k/v
// that is the operations (0.066 ms at the fp32 and bf16 peaks), not the
// 0.10 GB of traffic (0.031 ms). This kernel executes 3 fp32 instructions
// per state element and step (an FMA for r.S, a multiply for k.v, an FMA
// for w.S + kv): 3.2e9 lane instructions, about 0.10 ms at the card's fp32
// issue rate. The recurrence is sequential in T, so the design keeps the
// threads that hold the state doing those three instructions and little
// else, with enough of them in flight on every SM:
//
// * The state tile. S[:, j] and y[j] depend only on v[j] and on r, k, w,
//   so a (b, h) row's value columns are independent: they go to `splits`
//   blocks of CG = N / splits columns (blocks of one row adjacent in the
//   grid, so r/k/w come from HBM once), and in a block to state threads
//   that each hold a register tile of kRK = 8 key rows by CV value columns,
//   so each r/k/w value they load serves CV columns. CV and `splits` are
//   launch arguments the wrapper fixes per N (kernels/wkv6/ops.py::CONFIG,
//   the fastest measured); chip_smoke.py times the others.
// * The bonus once per step: coef_t is summed once per step and block
//   (KT = N / 8 lanes of 8 rows each, r.u then an FMA with k, then a fixed
//   xor tree over the lanes), not folded into every element.
// * No reduction inside the step: each state thread writes its CV partial
//   sums of r.S to shared memory and goes on to the next step.
// * Warp specialisation. kHelpers threads (a warpgroup) beside the state
//   threads feed and drain them, one stage of kTS = 32 steps at a time:
//   helper 0 issues the stage's TMA boxes (one per array: kTS rows of r,
//   k, w and of the block's slice of v) into a 2-slot ring completed on
//   mbarriers; all helpers widen bf16 r/k/v to fp32 once (not per use and
//   column tile: 2/CV instructions per element and step) and sum coef for
//   stage s + 1 while the state threads run stage s; then they add stage
//   s's KT partial sums of every output in a fixed order (q = 0, 1, ...),
//   add coef_t v_t with one FMA, and write y with 16-byte stores. The two
//   roles meet at named barriers, two per stage; widened rows, coef and
//   partial sums are double-buffered, so neither waits for the other's
//   latency.
//
// The kernel reads the (B, T, H, N) layout in place through 4-D tensor
// maps: no transposes to per-head rows, no padding of T (rows past T
// arrive as zeros and are never written back). TMA needs 16-byte aligned
// bases; the wrapper hands it fresh copies of tensors that are not (an
// offset view).
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

namespace {

constexpr int kRK = 8;              // key rows per thread
constexpr int kTS = 32;             // steps per stage
constexpr int kStages = 2;          // depth of the input ring
constexpr int kMaxThreads = 256;    // state threads per block
constexpr int kHelpers = 128;       // helper threads per block (4 warps)
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may use
constexpr int kSpinLimit = 1 << 24; // mbarrier polls before a trap (a hang becomes an error)
constexpr int kMaxDevices = 16;     // devices whose shared-memory limit is remembered

// Shared memory, in bytes: 2 mbarriers (in the first 128 bytes); the ring
// (per stage: r, k rows [kTS][N] in r's type, w rows [kTS][N] fp32, v rows
// [kTS][CG] in r's type: one TMA box each); for bf16, two buffers of the
// widened r, k [kTS][N] and v [kTS][CG] in fp32; two of coef [kTS]; two of
// the partial sums [kTS][KT][CG] fp32. Every offset is a multiple of 128.
struct Layout {
  int r, k, w, v, stage, ring;
  int cr, ck, cv, wide, coef, part, part_bytes, total;
};

__host__ __device__ inline Layout layout(int N, int CG, int esz) {
  Layout L;
  L.r = 0;
  L.k = kTS * N * esz;
  L.w = 2 * kTS * N * esz;
  L.v = L.w + kTS * N * 4;
  L.stage = L.v + kTS * CG * esz;
  L.ring = 128;
  // one widened buffer: r, k, v at these offsets from its start
  L.cr = 0;
  L.ck = kTS * N * 4;
  L.cv = 2 * kTS * N * 4;
  const int wide_bytes = esz == 2 ? L.cv + kTS * CG * 4 : 0;
  L.wide = L.ring + kStages * L.stage;
  L.coef = L.wide + 2 * wide_bytes;
  L.part = L.coef + 2 * 128;
  L.part_bytes = kTS * (N / kRK) * CG * 4;
  L.total = L.part + 2 * L.part_bytes;
  return L;
}

// whether wkv6_fwd takes (N, esz, cv, splits): whole 16-byte rows of v per
// block, a multiple of 32 state threads up to kMaxThreads, the shared
// memory of one block (kernels/wkv6/ops.py::configs applies the same rules)
__host__ inline bool config_ok(int N, int esz, int cv, int splits) {
  if (N != 32 && N != 64 && N != 128) return false;
  if (cv != 1 && cv != 2 && cv != 4) return false;
  if (splits < 1 || N % splits) return false;
  const int CG = N / splits;
  if (CG % cv || (CG * esz) % 16) return false;
  const int nt = (N / kRK) * (CG / cv);
  return nt % 32 == 0 && nt <= kMaxThreads && layout(N, CG, esz).total <= kMaxSmem;
}

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

// named barriers 1..: bar.sync waits for `count` threads, bar.arrive
// counts this thread and goes on
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// one box of a 4-D tensor map (columns, heads, T, B) into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(t), "r"(b), "r"(bar)
      : "memory");
}

// 8 bf16 (16 bytes) to fp32
__device__ __forceinline__ void widen8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(wd[i] << 16);
    out[2 * i + 1] = __uint_as_float(wd[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

template <int CV>
__device__ __forceinline__ void load_cols(const float* p, float* out) {
  if constexpr (CV == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  } else if constexpr (CV == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x; out[1] = a.y;
  } else {
    out[0] = p[0];
  }
}

template <int CV>
__device__ __forceinline__ void store_cols(float* p, const float* in) {
  if constexpr (CV == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (CV == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
    p[0] = in[0];
  }
}

// 16 bytes of y: 4 fp32 or 8 bf16
__device__ __forceinline__ void store_y(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store_y(__nv_bfloat16* p, const float* x) {
  uint32_t wd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 pr = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    wd[i] = *reinterpret_cast<const uint32_t*>(&pr);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// One step of a thread's tile: acc = r.S over its kRK rows (in order) for
// each of its CV columns, then S = w.S + k.v
template <int N, int CV>
__device__ __forceinline__ void step(float (&S)[kRK][CV], const float* rs, const float* ks,
                                     const float* ws, const float* vs, float* part, int t,
                                     int q, int ct, int CG) {
  constexpr int KT = N / kRK;
  float rv[kRK], kv[kRK], wv[kRK], vc[CV];
  load8(rs + t * N + q * kRK, rv);
  load8(ks + t * N + q * kRK, kv);
  load8(ws + t * N + q * kRK, wv);
  load_cols<CV>(vs + t * CG + ct * CV, vc);
  float acc[CV];
#pragma unroll
  for (int c = 0; c < CV; ++c) acc[c] = 0.f;
#pragma unroll
  for (int i = 0; i < kRK; ++i) {
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      acc[c] = fmaf(rv[i], S[i][c], acc[c]);
      S[i][c] = fmaf(wv[i], S[i][c], kv[i] * vc[c]);
    }
  }
  store_cols<CV>(part + (t * KT + q) * CG + ct * CV, acc);
}

// Named barriers between the two roles, one pair per buffer b = s & 1:
// kReady + b (helpers -> state threads: stage s is widened, coef written)
// and kDone + b (state threads -> helpers: stage s's partial sums are
// written, its rows read); kHelp among the helpers alone.
constexpr int kReady = 1, kDone = 3, kHelp = 5;

// One block: columns [col0, col0 + CG) of one (b, h) row, over all of T.
// State thread tid = ct + CT * q (tid < NT) owns key rows q*kRK .. + kRK - 1
// and value columns col0 + ct*CV .. + CV - 1 of S, and runs the steps.
// The kHelpers threads after them feed and drain it: helper 0 issues the
// TMA boxes (r, k, w, v through 4-D tensor maps (columns, heads, T, B);
// rows past T arrive as zeros); all of them widen stage s + 1 and sum its
// coef while the state threads run stage s, then sum stage s's partials
// into y.
// (minBlocks 1: ptxas may then give a thread all the registers its tile
// needs; left to itself it capped some instances at 56 and spilled)
template <typename T, int N, int CV>
__global__ void __launch_bounds__(kMaxThreads + kHelpers, 1) wkv6_kernel(
    const __grid_constant__ CUtensorMap tr, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ u, T* __restrict__ y, float* __restrict__ s_out,
    float* __restrict__ states, int T_len, int H, int splits) {
  constexpr int KT = N / kRK;                 // threads per value column
  constexpr int esz = sizeof(T);
  constexpr bool kWiden = esz == 2;
  constexpr int VEC = 16 / esz;               // y elements per 16-byte store
  extern __shared__ __align__(128) unsigned char smem[];

  const int CG = N / splits;
  const int CT = CG / CV;
  const int NT = KT * CT;
  const int ALL = NT + kHelpers;
  const Layout L = layout(N, CG, esz);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x / splits;
  const int col0 = (blockIdx.x % splits) * CG;
  const int b = bh / H, h = bh % H;
  const int n_stages = (T_len + kTS - 1) / kTS;
  const uint32_t bar0 = smem_u32(smem);
  const int wide_bytes = kWiden ? L.cv + kTS * CG * 4 : 0;

  // the fp32 rows of stage s: widened (bf16) or the ring slot itself
  auto rows = [&](int s, const float*& rs, const float*& ks, const float*& ws,
                  const float*& vs) {
    unsigned char* st = smem + L.ring + (s % kStages) * L.stage;
    unsigned char* wd = kWiden ? smem + L.wide + (s & 1) * wide_bytes : st;
    rs = reinterpret_cast<const float*>(wd + (kWiden ? L.cr : L.r));
    ks = reinterpret_cast<const float*>(wd + (kWiden ? L.ck : L.k));
    vs = reinterpret_cast<const float*>(wd + (kWiden ? L.cv : L.v));
    ws = reinterpret_cast<const float*>(st + L.w);
  };

  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < NT) {
    // ---- state threads: the steps, 3 fp32 instructions per element ----
    const int ct = tid % CT, q = tid / CT;
    float S[kRK][CV];
#pragma unroll
    for (int i = 0; i < kRK; ++i)
#pragma unroll
      for (int c = 0; c < CV; ++c) S[i][c] = 0.f;
    for (int s = 0; s < n_stages; ++s) {
      const int steps = min(kTS, T_len - s * kTS);
      const float *rs, *ks, *ws, *vs;
      rows(s, rs, ks, ws, vs);
      float* part = reinterpret_cast<float*>(smem + L.part + (s & 1) * L.part_bytes);
      if (states != nullptr) {
        // the training forward: S at the start of the stage, for the backward
        float* so = states + ((long long)bh * n_stages + s) * N * N + col0 + ct * CV;
#pragma unroll
        for (int i = 0; i < kRK; ++i) store_cols<CV>(so + (q * kRK + i) * N, S[i]);
      }
      bar_sync(kReady + (s & 1), ALL);
      mbar_wait(bar0 + 8 * (s % kStages), (s / kStages) & 1);  // w, observed landed
      // a whole stage unrolled, so every shared address is an immediate
      if (steps == kTS) {
#pragma unroll
        for (int t = 0; t < kTS; ++t) step<N, CV>(S, rs, ks, ws, vs, part, t, q, ct, CG);
      } else {
        for (int t = 0; t < steps; ++t) step<N, CV>(S, rs, ks, ws, vs, part, t, q, ct, CG);
      }
      bar_arrive(kDone + (s & 1), ALL);
    }
    float* so = s_out + (long long)bh * N * N + col0 + ct * CV;
#pragma unroll
    for (int i = 0; i < kRK; ++i) store_cols<CV>(so + (q * kRK + i) * N, S[i]);
    return;
  }

  // ---- helpers: feed, widen, coef, and the partial sums into y ----
  const int hid = tid - NT;
  const long long t_stride = (long long)H * N;
  const long long base = (long long)b * T_len * t_stride + (long long)h * N;
  // helper 0: stage s (4 boxes) into its ring slot
  auto issue = [&](int s) {
    const int slot = s % kStages;
    const uint32_t st = smem_u32(smem + L.ring + slot * L.stage);
    const uint32_t bar = bar0 + 8 * slot;
    mbar_expect_tx(bar, L.stage);
    tma_load(st + L.r, &tr, bar, 0, h, s * kTS, b);
    tma_load(st + L.k, &tk, bar, 0, h, s * kTS, b);
    tma_load(st + L.w, &tw, bar, 0, h, s * kTS, b);
    tma_load(st + L.v, &tv, bar, col0, h, s * kTS, b);
  };
  // u for coef: rows g*kRK .. of every step this helper sums (kHelpers is
  // a multiple of KT, so g is the same in every item it takes)
  const int g = hid % KT;
  float uu[kRK];
#pragma unroll
  for (int i = 0; i < kRK; ++i) uu[i] = u[h * N + g * kRK + i];

  // stage s landed -> coef[s & 1], and (bf16) its rows widened to fp32;
  // a loop uniform per warp (kTS * KT and kHelpers are multiples of 32)
  auto prepare = [&](int s) {
    mbar_wait(bar0 + 8 * (s % kStages), (s / kStages) & 1);
    unsigned char* st = smem + L.ring + (s % kStages) * L.stage;
    unsigned char* wd = smem + L.wide + (s & 1) * wide_bytes;
    float* coef = reinterpret_cast<float*>(smem + L.coef + (s & 1) * 128);
    for (int i = hid; i < kTS * KT; i += kHelpers) {
      const int t = i / KT;
      float rf[kRK], kf[kRK];
      if constexpr (kWiden) {
        const auto* rr = reinterpret_cast<const __nv_bfloat16*>(st + L.r);
        const auto* kk = reinterpret_cast<const __nv_bfloat16*>(st + L.k);
        widen8(rr + t * N + g * kRK, rf);
        widen8(kk + t * N + g * kRK, kf);
        float* cr = reinterpret_cast<float*>(wd + L.cr) + t * N + g * kRK;
        float* ck = reinterpret_cast<float*>(wd + L.ck) + t * N + g * kRK;
        *reinterpret_cast<float4*>(cr) = make_float4(rf[0], rf[1], rf[2], rf[3]);
        *reinterpret_cast<float4*>(cr + 4) = make_float4(rf[4], rf[5], rf[6], rf[7]);
        *reinterpret_cast<float4*>(ck) = make_float4(kf[0], kf[1], kf[2], kf[3]);
        *reinterpret_cast<float4*>(ck + 4) = make_float4(kf[4], kf[5], kf[6], kf[7]);
      } else {
        load8(reinterpret_cast<const float*>(st + L.r) + t * N + g * kRK, rf);
        load8(reinterpret_cast<const float*>(st + L.k) + t * N + g * kRK, kf);
      }
      float cp = 0.f;
#pragma unroll
      for (int j = 0; j < kRK; ++j) cp = fmaf(rf[j] * uu[j], kf[j], cp);
#pragma unroll
      for (int off = KT / 2; off > 0; off >>= 1) cp += __shfl_xor_sync(0xffffffffu, cp, off);
      if (g == 0) coef[t] = cp;
    }
    if constexpr (kWiden) {
      const auto* vv = reinterpret_cast<const __nv_bfloat16*>(st + L.v);
      float* cv = reinterpret_cast<float*>(wd + L.cv);
      for (int i = hid; i < kTS * CG / 8; i += kHelpers) {
        const int t = i / (CG / 8), c = (i % (CG / 8)) * 8;
        float f[8];
        widen8(vv + t * CG + c, f);
        *reinterpret_cast<float4*>(cv + t * CG + c) = make_float4(f[0], f[1], f[2], f[3]);
        *reinterpret_cast<float4*>(cv + t * CG + c + 4) = make_float4(f[4], f[5], f[6], f[7]);
      }
    }
    bar_arrive(kReady + (s & 1), ALL);
  };

  if (hid == 0) {
    for (int s = 0; s < kStages && s < n_stages; ++s) issue(s);
  }
  if (n_stages > 0) prepare(0);
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) prepare(s + 1);
    bar_sync(kDone + (s & 1), ALL);
    // y = coef v + the KT partial sums in order, 16 bytes a thread
    const int t0 = s * kTS;
    const int steps = min(kTS, T_len - t0);
    const float *rs, *ks, *ws, *vs;
    rows(s, rs, ks, ws, vs);
    const float* part = reinterpret_cast<const float*>(smem + L.part + (s & 1) * L.part_bytes);
    const float* coef = reinterpret_cast<const float*>(smem + L.coef + (s & 1) * 128);
    const int CQ = CG / VEC;
    for (int i = hid; i < steps * CQ; i += kHelpers) {
      const int t = i / CQ, c = (i % CQ) * VEC;
      float acc[VEC], vx[VEC];
      const float* p = part + t * KT * CG + c;
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        const float4 a = *reinterpret_cast<const float4*>(p + e);
        acc[e] = a.x; acc[e + 1] = a.y; acc[e + 2] = a.z; acc[e + 3] = a.w;
      }
#pragma unroll
      for (int qq = 1; qq < KT; ++qq) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 a = *reinterpret_cast<const float4*>(p + qq * CG + e);
          acc[e] += a.x; acc[e + 1] += a.y; acc[e + 2] += a.z; acc[e + 3] += a.w;
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        const float4 a = *reinterpret_cast<const float4*>(vs + t * CG + c + e);
        vx[e] = a.x; vx[e + 1] = a.y; vx[e + 2] = a.z; vx[e + 3] = a.w;
      }
      const float cf = coef[t];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(cf, vx[e], acc[e]);
      store_y(y + base + (long long)(t0 + t) * t_stride + col0 + c, acc);
    }
    // the slot of stage s is free once every helper is past its sums
    bar_sync(kHelp, kHelpers);
    if (hid == 0 && s + kStages < n_stages) issue(s + kStages);
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

// (B, T, H, N) of `esz`-byte elements as a 4-D map (N, H, T, B), boxes of
// `cols` columns x 1 head x kTS steps x 1, no swizzle, zero fill past T
cudaError_t encode(CUtensorMap* map, const void* ptr, int esz, int B, int T_len, int H, int N,
                   int cols) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)T_len, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)N * esz, (cuuint64_t)H * N * esz,
                                 (cuuint64_t)T_len * H * N * esz};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)kTS, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, esz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        4, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int N, int CV>
cudaError_t launch_cfg(const void* r, const void* k, const void* v, const float* w,
                       const float* u, void* y, float* s, float* states, int B, int T_len,
                       int H, int splits, cudaStream_t st) {
  const int CG = N / splits;
  const int esz = sizeof(T);
  const Layout L = layout(N, CG, esz);
  const int nt = (N / kRK) * (CG / CV) + kHelpers;
  CUtensorMap tr{}, tk{}, tw{}, tv{};  // T = 0: no stage, never read
  cudaError_t e = cudaSuccess;
  if (T_len > 0) {
    e = encode(&tr, r, esz, B, T_len, H, N, N);
    if (e == cudaSuccess) e = encode(&tk, k, esz, B, T_len, H, N, N);
    if (e == cudaSuccess) e = encode(&tw, w, 4, B, T_len, H, N, N);
    if (e == cudaSuccess) e = encode(&tv, v, esz, B, T_len, H, N, CG);
    if (e != cudaSuccess) return e;
  }
  // the shared-memory limit, once per instance and device (a call costs
  // tens of microseconds of host time, as much as a short launch)
  auto kern = wkv6_kernel<T, N, CV>;
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || !attr_set[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  kern<<<B * H * splits, nt, L.total, st>>>(tr, tk, tw, tv, u, static_cast<T*>(y), s, states,
                                            T_len, H, splits);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_n(const void* r, const void* k, const void* v, const float* w,
                     const float* u, void* y, float* s, float* states, int B, int T_len, int H,
                     int cv, int splits, cudaStream_t st) {
  switch (cv) {
    case 1: return launch_cfg<T, N, 1>(r, k, v, w, u, y, s, states, B, T_len, H, splits, st);
    case 2: return launch_cfg<T, N, 2>(r, k, v, w, u, y, s, states, B, T_len, H, splits, st);
    case 4: return launch_cfg<T, N, 4>(r, k, v, w, u, y, s, states, B, T_len, H, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w,
                   const float* u, void* y, float* s, float* states, int B, int T_len, int H,
                   int N, int cv, int splits, cudaStream_t st) {
  switch (N) {
    case 32: return launch_n<T, 32>(r, k, v, w, u, y, s, states, B, T_len, H, cv, splits, st);
    case 64: return launch_n<T, 64>(r, k, v, w, u, y, s, states, B, T_len, H, cv, splits, st);
    case 128:
      return launch_n<T, 128>(r, k, v, w, u, y, s, states, B, T_len, H, cv, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The backward: the gradient of the recurrence above from a zero state.
//
// Replaces no Pallas kernel: the reference differentiates wkv_scan
// (src/repro/models/rwkv.py:105, or wkv_chunked_scan :76) with jnp's
// autodiff. Per (b, h), with S_t the state after step t and G_t = dL/dS_t
// (G_T = ds, the gradient of the returned S):
//     G_{t-1} = diag(w_t) G_t + r_t^T dy_t
//     dr_t = S_{t-1} dy_t + u * k_t (v_t . dy_t)
//     dk_t = G_t v_t + u * r_t (v_t . dy_t)
//     dv_t = G_t^T k_t + coef_t dy_t
//     dw_t[n] = sum_m S_{t-1}[n][m] G_t[n][m]
//     du = sum_{b,t} r_t * k_t (v_t . dy_t)
//
// What bounds it on an H100: per step and state element 14 fp32 operations
// (the state recomputed, dr, G's update, dk, dv, dw) against r, k, v, dy in
// r's type, w, the stage states and dw in fp32: at B=2, T=2048, H=32, N=64
// in bf16 the operations (0.10 ms at the fp32 peak), not the 0.25 GB of
// traffic (0.075 ms). The kernel issues 9.25 fp32 instructions per state
// element and step (the backward's 6; the recompute's multiply and FMA,
// 1.625 times over) and about as many others (loads, bf16 widening, the
// row sums' shuffles, dv's shares). One launch:
//
// * A block takes kRG key rows (32, or 16 at N = 128) of one (b, h) with
//   all N value columns (key rows are independent in the recurrence:
//   S[n][:] needs only w[n], k[n] and v), and the N / kRG blocks of a
//   (b, h) form a thread-block cluster. dr, dk and dw (sums over value
//   columns) are whole in a block; dv (a sum over key rows) is summed in
//   the block, then across the cluster through distributed shared memory;
//   du (a sum over t and b) is whole for a (b, h) in a block, and the B
//   blocks of one (h, key rows) hand their shares over through an atomic
//   ticket: the last to finish sums them in b order. No atomic takes part
//   in a sum and every sum has a fixed order, so two launches give the
//   same bits; nothing but du's B shares goes through HBM.
// * The state in registers. A thread holds kBR = 2 key rows by kBC = 4
//   adjacent value columns of S and G; the N / kBC threads of a key row are
//   adjacent lanes of one warp. The block walks the stages in reverse, each
//   from the forward's saved state; the walk leaves each kSub-step
//   sub-stage's start in shared memory (each thread its own tile); a
//   sub-stage then recomputes its S_{t-1} into registers (kSub x 8 floats)
//   from its start with the forward's own instruction (fmaf(w, S, k * v)),
//   so the states are the forward's bit for bit, and walks back through it
//   with G in registers, each step's operands loaded a step ahead.
// * Row sums in registers. Each step sums dr's, dw's and dk's terms over the
//   thread's 4 columns (FMAs, columns ascending) into 3 x kBR values; at the
//   sub-stage's end the lanes of a row reduce all 3 x kBR x kSub of them
//   with a reduce-scatter butterfly (each __shfl_xor_sync level halves what
//   a lane carries; lanes fold l + L/2 onto l, then L/4, ..., 1), and each
//   value's owner writes dr, dk, dw.
// * dv without scratch. Each step a thread writes its row pair's share of
//   dv (fmaf(G[1], k1, G[0] * k0)) to shared memory; at the sub-stage's end
//   the block adds its kRG / 2 row pairs in order and sends each column's
//   sum, with its coef share, to the block owning the column: st.async
//   into that block's shared memory, completing on its mbarrier, which its
//   wait then observes (no fence). A block sums its value columns over the
//   cluster's blocks in rank order and adds coef_t dy_t (coef_t likewise:
//   each block's rows, then the ranks in order) one sub-stage later, while
//   the next is computed. A relaxed cluster barrier guards the
//   double-buffered receipts (a release there waited on the block's memory
//   traffic every sub-stage).
// * The stage loads overlap the arithmetic: one thread issues TMA boxes (r,
//   k, w of the block's rows, v and dy of all columns) and a bulk copy of
//   the saved state into a 2-slot ring completed on mbarriers, the next
//   stage while this one runs.
// * Occupancy and placement: the recurrence leaves B x H x N^2 / 8 threads
//   in all (8 elements each): at rwkv6-1.6b's training shape 128 blocks of
//   32 key rows (8 warps), one an SM, in clusters of 2, all at once. With
//   16 rows a block in clusters of 4, the scheduler left SMs idle and
//   stacked three blocks on others, and the kernel ran at their pace.
// tests/test_torch_wkv6_bwd.py emulates this order on the CPU.

constexpr int kSub = 8;                // steps per sub-stage (its S_{t-1} in registers)
constexpr int kNSub = kTS / kSub;      // sub-stages per stage
constexpr int kBR = 2;                 // key rows per thread
constexpr int kBC = 4;                 // value columns per thread
constexpr int kVals = 3 * kBR * kSub;  // row sums a thread carries into the butterfly

// key rows per block (kRG); N / kRG blocks a cluster: 32 rows (8 warps at N
// 64) up to N = 64, 16 at N = 128, where 32 rows' stages would not fit
__host__ __device__ constexpr int rows_per_block(int N) { return N == 128 ? 16 : 32; }

// Shared memory of a backward block, in bytes: the ring's 2 mbarriers,
// the 2 receiving dv's sums, the du ticket (the first 128 bytes); a 2-slot
// ring of stages (r, k [kTS][kRG] in r's type, w [kTS][kRG] fp32, v, dy
// [kTS][N] in r's type, the saved state's rows [kRG][N] fp32: one TMA box
// or bulk copy each); v . dy and coef's block share [2][kTS]; the
// sub-stage starts [kNSub - 1][kRG][N]; dv's row-pair shares
// [2][kPairs][kSub][N]; what the cluster's blocks send for this block's
// kRG value columns: their sums [2][N / kRG][kSub][kRG] and coef shares
// [2][N / kRG][kSub]; du's sub-stage sums [kNSub][kRG]. Every offset is a
// multiple of 64.
struct BwdLayout {
  int r, k, w, v, dy, st, slot, ring, vdy, coef, ckpt, pair, rb, rc, dsub, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int N, int esz) {
  const int kRG = rows_per_block(N), kPairs = kRG / kBR;
  BwdLayout L;
  L.r = 0;
  L.k = kTS * kRG * esz;
  L.w = 2 * kTS * kRG * esz;
  L.v = L.w + kTS * kRG * 4;
  L.dy = L.v + kTS * N * esz;
  L.st = L.dy + kTS * N * esz;
  L.slot = L.st + kRG * N * 4;
  L.ring = 128;
  L.vdy = L.ring + 2 * L.slot;
  L.coef = L.vdy + 2 * kTS * 4;
  L.ckpt = L.coef + 2 * kTS * 4;
  L.pair = L.ckpt + (kNSub - 1) * kRG * N * 4;
  L.rb = L.pair + 2 * kPairs * kSub * N * 4;
  L.rc = L.rb + 2 * (N / kRG) * kSub * kRG * 4;
  L.dsub = L.rc + 2 * (N / kRG) * kSub * 4;
  L.total = L.dsub + kNSub * kRG * 4;
  return L;
}

// values a lane keeps after the butterfly over `lanes` lanes: halved at
// each level while their number is even
__host__ __device__ constexpr int fold_count(int lanes, int nv) {
  return lanes <= 1 ? nv : fold_count(lanes / 2, nv % 2 == 0 ? nv / 2 : nv);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// two adjacent elements (key rows i, i + 1) and four (value columns) of a
// stage row in shared memory, in fp32
__device__ __forceinline__ void ld2(const float* p, float& a, float& b) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  a = x.x;
  b = x.y;
}
__device__ __forceinline__ void ld2(const __nv_bfloat16* p, float& a, float& b) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
  a = __uint_as_float(x << 16);
  b = __uint_as_float(x & 0xffff0000u);
}
__device__ __forceinline__ void ld4(const float* p, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(x.x << 16);
  o[1] = __uint_as_float(x.x & 0xffff0000u);
  o[2] = __uint_as_float(x.y << 16);
  o[3] = __uint_as_float(x.y & 0xffff0000u);
}

// the cluster barrier, split: arrive (relaxed: it orders no memory, and a
// release here waits on the block's memory traffic) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// p's shared-memory address in block `rank` of the cluster
__device__ __forceinline__ uint32_t at_rank(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}
// 16, 8 or 4 bytes into a cluster block's shared memory, counted on that
// block's mbarrier `bar` (its wait then sees them: no fence)
__device__ __forceinline__ void st_async4(uint32_t a, float x, float y, float z, float w,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(a),
      "r"(__float_as_uint(x)), "r"(__float_as_uint(y)), "r"(__float_as_uint(z)),
      "r"(__float_as_uint(w)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async2(uint32_t a, float x, float y, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n"
      ::"r"(a), "r"(__float_as_uint(x)), "r"(__float_as_uint(y)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async1(uint32_t a, float x, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(a), "r"(__float_as_uint(x)), "r"(bar)
               : "memory");
}

// `bytes` of global memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// a 16-byte shared-memory store as a volatile asm without a memory
// clobber: it keeps its place against the barriers, and the compiler may
// still move later loads ahead of it (they never read what it writes
// before the next barrier)
__device__ __forceinline__ void sts4(float* p, float a, float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(smem_u32(p)), "f"(a), "f"(b),
               "f"(c), "f"(d));
}

// CB (2 or 4) adjacent floats of shared memory
template <int CB>
__device__ __forceinline__ void ld_cols(const float* p, float (&o)[4]) {
  if constexpr (CB == 4) {
    ld4(p, o);
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x;
    o[1] = x.y;
  }
}

// The reduce-scatter butterfly over lanes, from lane offset O down to 1, on
// the first NV values of a: while they are even in number a lane keeps one
// half (the upper one if its O bit is set) and adds its partner's copy of
// it; values left odd in number are added whole on both lanes. Either way a
// level adds x[l] and x[l ^ O], so each sum folds lane l + 2 O onto l, then
// l + O, ..., l + 1: the xor tree. The lane then holds values
// [(l / share) * keep, + keep) of the NV (keep = fold_count, share the
// lanes holding the same ones).
template <int O, int NV, int SZ>
__device__ __forceinline__ void fold(float (&a)[SZ], int lane) {
  if constexpr (O >= 1) {
    if constexpr (NV % 2 == 0) {
      constexpr int HV = NV / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < HV; ++i) {
        const float send = up ? a[i] : a[i + HV];
        const float keep = up ? a[i + HV] : a[i];
        a[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      fold<O / 2, HV>(a, lane);
    } else {
#pragma unroll
      for (int i = 0; i < NV; ++i) a[i] += __shfl_xor_sync(0xffffffffu, a[i], O);
      fold<O / 2, NV>(a, lane);
    }
  }
}

// a step's operands in fp32: r, k, w of the thread's two key rows, v and
// dy of its four value columns
struct StepIn {
  float r0, r1, k0, k1, w0, w1, v[kBC], d[kBC];
};
template <typename T, int N>
__device__ __forceinline__ void load_step(StepIn& x, const T* rs, const T* ks, const float* ws,
                                          const T* vs, const T* dys, int t, int i0, int c0) {
  constexpr int kRG = rows_per_block(N);
  ld2(rs + t * kRG + i0, x.r0, x.r1);
  ld2(ks + t * kRG + i0, x.k0, x.k1);
  ld2(ws + t * kRG + i0, x.w0, x.w1);
  ld4(vs + t * N + c0, x.v);
  ld4(dys + t * N + c0, x.d);
}

// One block: key rows [n0, n0 + kRG) of one (b, h) row, n0 = kRG x its
// cluster rank, all N value columns, over all of T in reverse. Thread tid
// holds rows i0, i0 + 1 (i0 = 2 x its row pair) and columns c0 .. c0 + 3
// (c0 = 4 x its lane in the row's N / 4 lanes). (kRG x N / 8 threads, one
// block an SM.)
template <typename T, int N>
__global__ void __launch_bounds__(rows_per_block(N) * N / 8, 1) wkv6_bwd_kernel(
    const __grid_constant__ CUtensorMap tr, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdy, const float* __restrict__ u,
    const float* __restrict__ ds, const float* __restrict__ states, T* __restrict__ dr,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du,
    float* __restrict__ du_part, int* __restrict__ tickets, int B, int T_len, int H) {
  constexpr int kRG = rows_per_block(N);        // key rows per block
  constexpr int kPairs = kRG / kBR;             // row pairs per block
  constexpr int LN = N / kBC;                   // lanes of a key row
  constexpr int LR = 32 / LN;                   // key rows' lane groups in a warp
  constexpr int NT = kPairs * LN;               // threads per block
  constexpr int NW = NT / 32;                   // warps per block
  constexpr int splits = N / kRG;               // blocks per (b, h): the cluster
  constexpr int esz = sizeof(T);
  constexpr int kKeep = fold_count(LN, kVals);  // row sums a lane ends with
  constexpr int kShare = LN * kKeep / kVals;    // lanes that end with the same ones
  constexpr int kOut = (kSub * kRG + NT - 1) / NT;  // dv outputs a thread finishes
  constexpr int kVdy = kTS / NW;                // steps of v . dy a warp sums
  constexpr int kCoef = kTS * kRG / NT;         // steps of coef a half-warp sums
  // bytes the cluster's blocks send a block for a sub-stage: their sums of
  // its kRG columns and their coef shares
  constexpr uint32_t kRecv = splits * kSub * (kRG + 1) * 4;
  constexpr int CB = kSub * N / NT;             // columns of the block's sum a thread takes
  static_assert(CB * NT == kSub * N && (CB == 2 || CB == 4), "the block's sum");
  static_assert(kSub * splits <= NT, "a thread sends one coef share");
  extern __shared__ __align__(128) unsigned char bsmem[];
  const BwdLayout L = bwd_layout(N, esz);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lc = lane % LN;
  const int pair = warp * LR + lane / LN;
  const int i0 = kBR * pair, c0 = kBC * lc;
  const int bh = blockIdx.x / splits, g = blockIdx.x % splits;  // g: the cluster rank
  const int b = bh / H, h = bh % H;
  const int n0 = g * kRG;
  const int n_stages = (T_len + kTS - 1) / kTS;
  // sub-stages in all: kNSub a stage, fewer in the last (ragged) one
  const int n_subs = (n_stages - 1) * kNSub + (T_len - (n_stages - 1) * kTS + kSub - 1) / kSub;
  const long long t_stride = (long long)H * N;
  const long long base = (long long)b * T_len * t_stride + (long long)h * N;
  const uint32_t bar0 = smem_u32(bsmem);       // the ring's 2 mbarriers
  const uint32_t rbar0 = bar0 + 16;            // the 2 receiving dv's sums
  int* ticket = reinterpret_cast<int*>(bsmem + 32);
  float* vdys = reinterpret_cast<float*>(bsmem + L.vdy);    // [2][kTS]
  float* coefs = reinterpret_cast<float*>(bsmem + L.coef);  // [2][kTS], this block's rows
  float* ckpt = reinterpret_cast<float*>(bsmem + L.ckpt);
  float* pairs = reinterpret_cast<float*>(bsmem + L.pair);
  float* dsubs = reinterpret_cast<float*>(bsmem + L.dsub);
  const float* rb = reinterpret_cast<const float*>(bsmem + L.rb);
  const float* rc = reinterpret_cast<const float*>(bsmem + L.rc);
  auto slot = [&](int s) { return bsmem + L.ring + (s & 1) * L.slot; };

  // one thread: stage s's boxes and saved state into its slot
  auto issue = [&](int s) {
    const uint32_t st = smem_u32(slot(s));
    const uint32_t bar = bar0 + 8 * (s & 1);
    mbar_expect_tx(bar, L.slot);
    tma_load(st + L.r, &tr, bar, n0, h, s * kTS, b);
    tma_load(st + L.k, &tk, bar, n0, h, s * kTS, b);
    tma_load(st + L.w, &tw, bar, n0, h, s * kTS, b);
    tma_load(st + L.v, &tv, bar, 0, h, s * kTS, b);
    tma_load(st + L.dy, &tdy, bar, 0, h, s * kTS, b);
    bulk_load(st + L.st, states + (((long long)bh * n_stages + s) * N + n0) * N, kRG * N * 4,
              bar);
  };

  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    mbar_init(rbar0, 1);
    mbar_init(rbar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    issue(n_stages - 1);
    if (n_stages > 1) issue(n_stages - 2);
    // the first two sub-stages' receipts
    mbar_expect_tx(rbar0, kRecv);
    if (n_subs > 1) mbar_expect_tx(rbar0 + 8, kRecv);
  }
  // every block's barriers are set before any block sends to them
  cluster_arrive();
  cluster_wait();

  float G[kBR][kBC];
#pragma unroll
  for (int p = 0; p < kBR; ++p) {
    if (ds != nullptr) {
      ld4(ds + ((long long)bh * N + n0 + i0 + p) * N + c0, G[p]);
    } else {
#pragma unroll
      for (int c = 0; c < kBC; ++c) G[p][c] = 0.f;
    }
  }
  const float u0 = u[h * N + n0 + i0], u1 = u[h * N + n0 + i0 + 1];
  const float uc = u[h * N + n0 + tid % kRG];  // coef's row in the stage prologue
  // the rows' du: a sub-stage's terms summed, the sub-stages' sums into the
  // stage's, the stages' into these (each in reverse)
  float du0 = 0.f, du1 = 0.f;

  // dv of a finished sub-stage, once the cluster's blocks have sent their
  // sums of this block's kRG value columns: the blocks' sums in rank order,
  // plus coef_t (the blocks' shares in rank order) dy_t; dy read before the
  // slot can be refilled
  float xd[kOut];
  auto read_dy = [&](int s, int a) {
    const T* dys = reinterpret_cast<const T*>(slot(s) + L.dy);
#pragma unroll
    for (int e = 0; e < kOut; ++e) {
      const int o = tid + e * NT;
      if (o < kSub * kRG) xd[e] = to_f(dys[(a + o / kRG) * N + n0 + o % kRG]);
    }
  };
  auto finish = [&](int s, int a, int len, int buf) {
#pragma unroll
    for (int e = 0; e < kOut; ++e) {
      const int o = tid + e * NT;
      const int q = o / kRG, c = o % kRG;
      if (o < kSub * kRG) {
        float acc = rb[((buf * splits) * kSub + q) * kRG + c];
        float cq = rc[(buf * splits) * kSub + q];
#pragma unroll
        for (int rk = 1; rk < splits; ++rk) {
          acc += rb[((buf * splits + rk) * kSub + q) * kRG + c];
          cq += rc[(buf * splits + rk) * kSub + q];
        }
        if (q < len)
          dv[base + (long long)(s * kTS + a + q) * t_stride + n0 + c] =
              from_f<T>(fmaf(cq, xd[e], acc));
      }
    }
  };

  int j = 0;                        // sub-stages done
  int p_s = 0, p_a = 0, p_len = 0;  // the last one: its stage, first step, length
  for (int s = n_stages - 1; s >= 0; --s) {
    const int steps = min(kTS, T_len - s * kTS);
    const int nsub = (steps + kSub - 1) / kSub;
    unsigned char* sl = slot(s);
    const T* rs = reinterpret_cast<const T*>(sl + L.r);
    const T* ks = reinterpret_cast<const T*>(sl + L.k);
    float* ws = reinterpret_cast<float*>(sl + L.w);
    const T* vs = reinterpret_cast<const T*>(sl + L.v);
    const T* dys = reinterpret_cast<const T*>(sl + L.dy);
    const float* sts = reinterpret_cast<const float*>(sl + L.st);
    float* vdy = vdys + (s & 1) * kTS;
    float* cf = coefs + (s & 1) * kTS;
    mbar_wait(bar0 + 8 * (s & 1), ((n_stages - 1 - s) >> 1) & 1);

    // v . dy per step: a warp takes steps warp + NW i, each lane over m =
    // lane + 32 j (j ascending), then the xor tree over the lanes (as a
    // reduce-scatter over its steps); coef's share of the block's rows: a
    // half-warp takes steps, (r u) k per row, then the xor tree over its 16
    // lanes. Over all kTS steps (rows past T arrive as zeros), so whole
    // warps meet at every shuffle.
    {
      float x[kVdy];
#pragma unroll
      for (int it = 0; it < kVdy; ++it) {
        const int t = warp + it * NW;
        x[it] = 0.f;
#pragma unroll
        for (int jj = 0; jj < N / 32; ++jj)
          x[it] = fmaf(to_f(vs[t * N + lane + 32 * jj]), to_f(dys[t * N + lane + 32 * jj]),
                       x[it]);
      }
      fold<16, kVdy>(x, lane);
      constexpr int keep = fold_count(32, kVdy), share = 32 * keep / kVdy;
      if (lane % share == 0) {
#pragma unroll
        for (int e = 0; e < keep; ++e) vdy[warp + ((lane / share) * keep + e) * NW] = x[e];
      }
    }
    {
      const int i = tid % kRG;
      float x[kCoef];
#pragma unroll
      for (int it = 0; it < kCoef; ++it) {
        const int t = tid / kRG + it * (NT / kRG);
        x[it] = (to_f(rs[t * kRG + i]) * uc) * to_f(ks[t * kRG + i]);
      }
      fold<kRG / 2, kCoef>(x, i);
      constexpr int keep = fold_count(kRG, kCoef), share = kRG * keep / kCoef;
      if (i % share == 0) {
#pragma unroll
        for (int e = 0; e < keep; ++e)
          cf[tid / kRG + ((i / share) * keep + e) * (NT / kRG)] = x[e];
      }
    }
    // rows past T (zeros) become identity steps: w = 1 with r = k = 0 keeps
    // S and G as they are, so every sub-stage runs all kSub steps (a later
    // TMA box refills the slot: order these writes before it)
    if (steps < kTS) {
      for (int x = steps * kRG + tid; x < kTS * kRG; x += NT) ws[x] = 1.f;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }

    __syncthreads();  // v . dy
    // du's terms (r k)(v . dy) of a row summed over a sub-stage, in reverse
    // (0 past T): one thread a (row, sub-stage)
    if (tid < kNSub * kRG && tid / kRG < nsub) {
      const int row = tid % kRG, js = tid / kRG;
      float sub = 0.f;
#pragma unroll
      for (int q = kSub - 1; q >= 0; --q) {
        const int t = js * kSub + q;
        sub += (to_f(rs[t * kRG + row]) * to_f(ks[t * kRG + row])) * vdy[t];
      }
      dsubs[js * kRG + row] = sub;
    }

    // S at step t + 1 from S at step t (the forward's instruction)
    auto advance = [&](const float (&X)[kBR][kBC], float (&Y)[kBR][kBC], int t) {
      float k0, k1, w0, w1, vq[kBC];
      ld2(ks + t * kRG + i0, k0, k1);
      ld2(ws + t * kRG + i0, w0, w1);
      ld4(vs + t * N + c0, vq);
#pragma unroll
      for (int c = 0; c < kBC; ++c) {
        Y[0][c] = fmaf(w0, X[0][c], k0 * vq[c]);
        Y[1][c] = fmaf(w1, X[1][c], k1 * vq[c]);
      }
    };
    // the walk from the stage's saved state to its sub-stage starts
    {
      float S[kBR][kBC];
#pragma unroll
      for (int p = 0; p < kBR; ++p) ld4(sts + (i0 + p) * N + c0, S[p]);
#pragma unroll 1
      for (int js = 1; js < nsub; ++js) {
#pragma unroll
        for (int q = 0; q < kSub; ++q) advance(S, S, (js - 1) * kSub + q);
#pragma unroll
        for (int p = 0; p < kBR; ++p)
          sts4(ckpt + ((js - 1) * kRG + i0 + p) * N + c0, S[p][0], S[p][1], S[p][2], S[p][3]);
      }
    }
    __syncthreads();  // coef, the identity steps, du's sub-stage sums
    // the rows' du: the sub-stages' sums into the stage's, in reverse
    {
      float ds0 = 0.f, ds1 = 0.f;
      for (int js = nsub - 1; js >= 0; --js) {
        ds0 += dsubs[js * kRG + i0];
        ds1 += dsubs[js * kRG + i0 + 1];
      }
      du0 += ds0;
      du1 += ds1;
    }
#pragma unroll 1
    for (int js = nsub - 1; js >= 0; --js) {
      const int a = js * kSub;
      const int len = min(kSub, steps - a);
      const int buf = j & 1;
      // (A) S_{t-1} of each step of the sub-stage, from its start
      float Sp[kSub][kBR][kBC];
      const float* st0 = js == 0 ? sts : ckpt + (js - 1) * kRG * N;
#pragma unroll
      for (int p = 0; p < kBR; ++p) ld4(st0 + (i0 + p) * N + c0, Sp[0][p]);
#pragma unroll
      for (int q = 1; q < kSub; ++q) advance(Sp[q - 1], Sp[q], a + q - 1);
      // (B) back through the sub-stage, each step's operands loaded a step
      // ahead: dv's row-pair share into shared memory, the row sums' terms,
      // then G_{t-1}
      float vals[kVals];
      float* pr = pairs + (buf * kPairs + pair) * kSub * N + c0;
      StepIn cur, nxt;
      load_step<T, N>(cur, rs, ks, ws, vs, dys, a + kSub - 1, i0, c0);
#pragma unroll
      for (int q = kSub - 1; q >= 0; --q) {
        if (q > 0) load_step<T, N>(nxt, rs, ks, ws, vs, dys, a + q - 1, i0, c0);
        sts4(pr + q * N, fmaf(G[1][0], cur.k1, G[0][0] * cur.k0),
             fmaf(G[1][1], cur.k1, G[0][1] * cur.k0), fmaf(G[1][2], cur.k1, G[0][2] * cur.k0),
             fmaf(G[1][3], cur.k1, G[0][3] * cur.k0));
#pragma unroll
        for (int p = 0; p < kBR; ++p) {
          float ar = Sp[q][p][0] * cur.d[0], aw = Sp[q][p][0] * G[p][0];
          float ak = G[p][0] * cur.v[0];
#pragma unroll
          for (int c = 1; c < kBC; ++c) {
            ar = fmaf(Sp[q][p][c], cur.d[c], ar);
            aw = fmaf(Sp[q][p][c], G[p][c], aw);
            ak = fmaf(G[p][c], cur.v[c], ak);
          }
          vals[(q * kBR + p) * 3] = ar;
          vals[(q * kBR + p) * 3 + 1] = aw;
          vals[(q * kBR + p) * 3 + 2] = ak;
        }
#pragma unroll
        for (int c = 0; c < kBC; ++c) {
          G[0][c] = fmaf(cur.w0, G[0][c], cur.r0 * cur.d[c]);
          G[1][c] = fmaf(cur.w1, G[1][c], cur.r1 * cur.d[c]);
        }
        if (q > 0) cur = nxt;
      }
      // (C) the row sums across the row's lanes
      fold<LN / 2, kVals>(vals, lc);
      if (j > 0) read_dy(p_s, p_a);
      __syncthreads();  // this sub-stage's row-pair shares; the last slot read
      // stage s - 1 into the slot of stage s + 1, whose last reader was read_dy
      if (tid == 0 && js == nsub - 1 && s + 1 < n_stages && s >= 1) issue(s - 1);
      // (D) the block's sum of its row pairs' shares, in order, CB columns
      // a thread; each sum and coef share goes to the block owning its
      // columns, once every block has finished the sub-stage before last
      // (whose buffer it refills)
      {
        const int q = tid / (N / CB), m = (tid % (N / CB)) * CB;
        const float* src = pairs + buf * kPairs * kSub * N + q * N + m;
        float acc[4];
        ld_cols<CB>(src, acc);
#pragma unroll
        for (int pp = 1; pp < kPairs; ++pp) {
          float x[4];
          ld_cols<CB>(src + pp * kSub * N, x);
#pragma unroll
          for (int c = 0; c < CB; ++c) acc[c] += x[c];
        }
        if (j > 0) cluster_wait();
        const int to = m / kRG;
        const uint32_t at = at_rank(rb + ((buf * splits + g) * kSub + q) * kRG + m % kRG, to);
        const uint32_t bar = at_rank(bsmem + 16 + 8 * buf, to);
        if constexpr (CB == 4)
          st_async4(at, acc[0], acc[1], acc[2], acc[3], bar);
        else
          st_async2(at, acc[0], acc[1], bar);
        if (tid < kSub * splits) {
          const int cto = tid / kSub, cq = tid % kSub;
          st_async1(at_rank(rc + (buf * splits + g) * kSub + cq, cto), cf[a + cq],
                    at_rank(bsmem + 16 + 8 * buf, cto));
        }
      }
      // (E) the row sums' owners write dr, dw, dk of their (step, row)
      if (lc % kShare == 0) {
#pragma unroll
        for (int x = 0; x < kKeep / 3; ++x) {
          const int gi = (lc / kShare) * (kKeep / 3) + x;
          const int q = gi / kBR, p = gi % kBR;
          if (q < len) {
            const int t = a + q, i = i0 + p;
            const float vd = vdy[t];
            const float uu = p == 0 ? u0 : u1;
            const long long o = base + (long long)(s * kTS + t) * t_stride + n0 + i;
            dr[o] = from_f<T>(fmaf(uu * to_f(ks[t * kRG + i]), vd, vals[3 * x]));
            dw[o] = vals[3 * x + 1];
            dk[o] = from_f<T>(fmaf(uu * to_f(rs[t * kRG + i]), vd, vals[3 * x + 2]));
          }
        }
      }
      // (F) dv of the sub-stage before, once the blocks' sends have landed;
      // then this sub-stage's receipts are expected on the freed barrier
      if (j > 0) {
        mbar_wait(rbar0 + 8 * (buf ^ 1), ((j - 1) >> 1) & 1);
        finish(p_s, p_a, p_len, buf ^ 1);
        if (tid == 0 && j + 1 < n_subs) mbar_expect_tx(rbar0 + 8 * (buf ^ 1), kRecv);
      }
      // the buffers read in (F) may be refilled once every block arrives:
      // each thread has added up every value it read (a data dependence),
      // so its reads are done when it arrives
      cluster_arrive();
      p_s = s;
      p_a = a;
      p_len = len;
      ++j;
    }
  }
  cluster_wait();
  read_dy(p_s, p_a);
  mbar_wait(rbar0 + 8 * ((j - 1) & 1), ((j - 1) >> 1) & 1);
  finish(p_s, p_a, p_len, (j - 1) & 1);
  cluster_arrive();  // no block leaves while another may still send to it
  cluster_wait();

  // du: this b's share of the block's rows; the last of the B blocks of
  // (h, rows) to finish sums the shares in b order
  if (lc == 0) {
    float* dp = du_part + ((long long)b * H + h) * N + n0 + i0;
    dp[0] = du0;
    dp[1] = du1;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *ticket = atomicAdd(tickets + h * splits + g, 1);
  __syncthreads();
  if (*ticket == B - 1 && tid < kRG) {
    __threadfence();
    float x = __ldcg(du_part + (long long)h * N + n0 + tid);
    for (int bb = 1; bb < B; ++bb) x += __ldcg(du_part + ((long long)bb * H + h) * N + n0 + tid);
    du[h * N + n0 + tid] = x;
  }
}

template <typename T, int N>
cudaError_t launch_bwd(const void* r, const void* k, const void* v, const float* w,
                       const float* u, const void* dy, const float* ds, const float* states,
                       void* dr, void* dk, void* dv, float* dw, float* du, float* du_part,
                       int* tickets, int B, int T_len, int H, cudaStream_t st) {
  constexpr int esz = sizeof(T), kRG = rows_per_block(N);
  const BwdLayout L = bwd_layout(N, esz);
  // one block an SM: left to pair two blocks on an SM, the cluster
  // scheduler did so on some while others idled, and the kernel waited on
  // those (PERF.md)
  const int smem = L.total > kMaxSmem / 2 ? L.total : kMaxSmem / 2 + 1024;
  CUtensorMap tr{}, tk{}, tw{}, tv{}, tdy{};
  cudaError_t e = encode(&tr, r, esz, B, T_len, H, N, kRG);
  if (e == cudaSuccess) e = encode(&tk, k, esz, B, T_len, H, N, kRG);
  if (e == cudaSuccess) e = encode(&tw, w, 4, B, T_len, H, N, kRG);
  if (e == cudaSuccess) e = encode(&tv, v, esz, B, T_len, H, N, N);
  if (e == cudaSuccess) e = encode(&tdy, dy, esz, B, T_len, H, N, N);
  if (e != cudaSuccess) return e;
  auto kern = wkv6_bwd_kernel<T, N>;
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || !attr_set[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  e = cudaMemsetAsync(tickets, 0, sizeof(int) * H * (N / kRG), st);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H * (N / kRG));
  cfg.blockDim = dim3(kRG * N / (kBR * kBC));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N / kRG;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, tr, tk, tw, tv, tdy, u, ds, states, static_cast<T*>(dr),
                         static_cast<T*>(dk), static_cast<T*>(dv), dw, du, du_part, tickets, B,
                         T_len, H);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_n(const void* r, const void* k, const void* v, const float* w,
                         const float* u, const void* dy, const float* ds, const float* states,
                         void* dr, void* dk, void* dv, float* dw, float* du, float* du_part,
                         int* tickets, int B, int T_len, int H, int N, cudaStream_t st) {
  switch (N) {
    case 32:
      return launch_bwd<T, 32>(r, k, v, w, u, dy, ds, states, dr, dk, dv, dw, du, du_part,
                               tickets, B, T_len, H, st);
    case 64:
      return launch_bwd<T, 64>(r, k, v, w, u, dy, ds, states, dr, dk, dv, dw, du, du_part,
                               tickets, B, T_len, H, st);
    case 128:
      return launch_bwd<T, 128>(r, k, v, w, u, dy, ds, states, dr, dk, dv, dw, du, du_part,
                                tickets, B, T_len, H, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// y (B, T, H, N; r's type), s (B, H, N, N; fp32) from r, k, v (B, T, H, N;
// fp32 when dtype == 0, bf16 when dtype == 1), w (B, T, H, N; fp32) and
// u (H, N; fp32), all contiguous, r/k/v/w/y on 16-byte aligned bases.
// `states`, when not null, receives the state at the start of each kTS-step
// stage, (B, H, ceil(T / kTS), N, N) fp32 (the training forward; null gives
// the same y and s, bit for bit, and writes nothing more).
// `cols` value columns per thread (1, 2 or 4) and `splits` blocks per
// (b, h) row pick the launch (kernels/wkv6/ops.py::configs lists those
// taken).
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for a launch it does not take).
int wkv6_fwd(const void* r, const void* k, const void* v, const float* w,
             const float* u, void* y, float* s, float* states, int B, int T_len, int H, int N,
             int dtype, int cols, int splits, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (B < 0 || T_len < 0 || H < 0 || splits < 1 ||
      (long long)B * H * splits > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!config_ok(N, dtype == 1 ? 2 : 4, cols, splits)) return (int)cudaErrorInvalidValue;
  if (!aligned16(r) || !aligned16(k) || !aligned16(v) || !aligned16(w) || !aligned16(y))
    return (int)cudaErrorMisalignedAddress;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(r, k, v, w, u, y, s, states, B, T_len, H, N, cols, splits, st);
  return (int)launch<__nv_bfloat16>(r, k, v, w, u, y, s, states, B, T_len, H, N, cols, splits,
                                    st);
}

// The backward of wkv6_fwd (wkv6_bwd_kernel): dr, dk, dv (B, T, H, N; r's
// type), dw (B, T, H, N; fp32) and du (H, N; fp32) from r, k, v, dy (r's
// type: fp32 when dtype == 0, bf16 when dtype == 1), w (fp32), u (H, N;
// fp32), ds (B, H, N, N; fp32, the gradient of the returned S, or null for
// 0) and `states` (B, H, ceil(T / kTS), N, N; fp32), which wkv6_fwd wrote.
// du_part (B, H, N) fp32 and tickets (H * N / 16) int32 are scratch: du's
// share per b, and the counters that pick the block summing them (zeroed
// here on `stream` first). All contiguous, r/k/v/w/dy/ds/states on 16-byte
// aligned bases, T >= 1. Launches on `stream` (a cluster of N / 16 blocks
// per (b, h)), does not synchronise, and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
int wkv6_bwd(const void* r, const void* k, const void* v, const float* w, const float* u,
             const void* dy, const float* ds, const float* states, void* dr, void* dk,
             void* dv, float* dw, float* du, float* du_part, int* tickets, int B, int T_len,
             int H, int N, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (B < 1 || T_len < 1 || H < 1 || (long long)B * H * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(r) || !aligned16(k) || !aligned16(v) || !aligned16(w) || !aligned16(dy) ||
      !aligned16(states) || (ds != nullptr && !aligned16(ds)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd_n<float>(r, k, v, w, u, dy, ds, states, dr, dk, dv, dw, du, du_part,
                                    tickets, B, T_len, H, N, st);
  return (int)launch_bwd_n<__nv_bfloat16>(r, k, v, w, u, dy, ds, states, dr, dk, dv, dw, du,
                                          du_part, tickets, B, T_len, H, N, st);
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
