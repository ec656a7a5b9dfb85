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
// What bounds it on an H100: per step and state element about 14 fp32
// operations (the state recomputed, dr, G's update, dk, dv, dw), against
// r, k, v, dy in r's type, w, the stage states and dw in fp32: at B=2,
// T=2048, H=32, N=64 in bf16 the operations (0.11 ms at the fp32 peak),
// not the 0.25 GB (0.075 ms). A first design, simple and right; its speed
// is later work:
//
// * The forward (wkv6_kernel with `states`) saves S at the start of every
//   kTS-step stage. Key rows are independent in the recurrence (S[n][:]
//   needs only w[n], k[n] and v), so a block takes kRG = 16 key rows of one
//   (b, h) with all N value columns; dr, dk, dw and du (sums over value
//   columns, or over t) are then whole in the block, and only dv (a sum
//   over key rows) is partial: each block writes its kRG rows' share to a
//   scratch buffer, and a second launch (wkv6_bwd_reduce_kernel, entry
//   wkv6_bwd_reduce) sums the N / kRG shares in a fixed order and adds
//   coef_t dy_t. No atomics, so two launches give the same bits.
// * The block walks the stages in reverse. For each: its rows of r, k, w
//   and all of v and dy, widened to fp32 in shared memory; v . dy once per
//   step; then the stage forward from its saved state, keeping S at the
//   start of each kSub-step sub-stage in registers. For each sub-stage in
//   reverse: (A) its states S_{t-1} recomputed into shared memory; (B) the
//   sub-stage walked backward with G in registers, each G_t written to
//   shared memory; (C) the sums, one output each thread, in a fixed order:
//   dr, dw, dk (and du's term) over the N value columns of a row, and dv's
//   share over the block's kRG rows; du's terms summed a sub-stage, then a
//   stage, at a time. Each thread holds 1 key row by kCC
//   value columns (strided by N / kCC, so neighbouring threads touch
//   neighbouring words); rows of S and G in shared memory are padded to
//   N + 4 floats, so the row sums' 16-byte loads meet no bank conflict.
// * The recompute takes the forward's own instruction (fmaf(w, S, k * v)),
//   so the states inside a stage are the forward's bit for bit.
// tests/test_torch_wkv6_bwd.py emulates this order on the CPU.

constexpr int kRG = 16;   // key rows per backward block
constexpr int kSub = 8;   // steps per sub-stage (states kept in shared memory)
constexpr int kCC = 4;    // value columns per backward thread

struct BwdLayout {
  int ss, gg, r, k, w, v, dy, vdy, dut, total;
};

// Shared memory of the backward block, in bytes: S_{t-1} and G_t of a
// sub-stage [kSub][kRG][N + 4]; the stage's rows of r, k, w [kTS][kRG] and
// all of v, dy [kTS][N], in fp32; v . dy [kTS]; du's terms [kSub][kRG].
// Every offset is a multiple of 16.
__host__ __device__ inline BwdLayout bwd_layout(int N) {
  BwdLayout L;
  const int rows = kSub * kRG * (N + 4) * 4;
  L.ss = 0;
  L.gg = rows;
  L.r = 2 * rows;
  L.k = L.r + kTS * kRG * 4;
  L.w = L.k + kTS * kRG * 4;
  L.v = L.w + kTS * kRG * 4;
  L.dy = L.v + kTS * N * 4;
  L.vdy = L.dy + kTS * N * 4;
  L.dut = L.vdy + kTS * 4;
  L.total = L.dut + kSub * kRG * 4;
  return L;
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

// One block: key rows [n0, n0 + kRG) of one (b, h) row, all N value
// columns, over all of T in reverse. Thread tid holds row i = tid / CT and
// columns ch + j * CT (j < kCC), CT = N / kCC. (Up to 128 registers a
// thread, as many blocks as shared memory lets an SM hold: left to itself
// ptxas capped the N = 64 instances at 64 and spilled.)
template <typename T, int N>
__global__ void __launch_bounds__(kRG * N / kCC, 65536 / (kRG * N / kCC * 128))
    wkv6_bwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const T* __restrict__ dy,
    const float* __restrict__ ds, const float* __restrict__ states, T* __restrict__ dr,
    T* __restrict__ dk, float* __restrict__ dw, float* __restrict__ dv_part,
    float* __restrict__ du_part, int B, int T_len, int H) {
  constexpr int P = N + 4;        // padded row of S and G in shared memory
  constexpr int CT = N / kCC;     // threads per key row
  constexpr int NT = kRG * CT;    // threads per block
  constexpr int splits = N / kRG;
  extern __shared__ __align__(128) unsigned char bsmem[];
  const BwdLayout L = bwd_layout(N);
  float* SS = reinterpret_cast<float*>(bsmem + L.ss);
  float* GG = reinterpret_cast<float*>(bsmem + L.gg);
  float* rs = reinterpret_cast<float*>(bsmem + L.r);
  float* ks = reinterpret_cast<float*>(bsmem + L.k);
  float* ws = reinterpret_cast<float*>(bsmem + L.w);
  float* vs = reinterpret_cast<float*>(bsmem + L.v);
  float* dys = reinterpret_cast<float*>(bsmem + L.dy);
  float* vdys = reinterpret_cast<float*>(bsmem + L.vdy);
  float* dut = reinterpret_cast<float*>(bsmem + L.dut);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / splits, g = blockIdx.x % splits;
  const int b = bh / H, h = bh % H;
  const int n0 = g * kRG;
  const int i = tid / CT, ch = tid % CT;
  const int n_stages = (T_len + kTS - 1) / kTS;
  const long long t_stride = (long long)H * N;
  const long long base = (long long)b * T_len * t_stride + (long long)h * N;
  const long long total = (long long)B * T_len * t_stride;
  float* dvp = dv_part + (long long)g * total;

  float G[kCC];
#pragma unroll
  for (int j = 0; j < kCC; ++j)
    G[j] = ds != nullptr ? ds[((long long)bh * N + n0 + i) * N + ch + j * CT] : 0.f;
  // row n0 + tid's du, for tid < kRG: the terms of a sub-stage summed, its
  // sub-stages' sums into the stage's, the stages' into this (fewer
  // roundings at the size of the whole than one sum over T)
  float du_acc = 0.f;

  for (int s = n_stages - 1; s >= 0; --s) {
    const int t0 = s * kTS;
    const int steps = min(kTS, T_len - t0);
    float du_stage = 0.f;
    // the stage's rows in fp32 (the previous stage's sums are done with them)
    for (int x = tid; x < steps * kRG; x += NT) {
      const int tt = x / kRG, ii = x % kRG;
      const long long o = base + (long long)(t0 + tt) * t_stride + n0 + ii;
      rs[x] = to_f(r[o]);
      ks[x] = to_f(k[o]);
      ws[x] = w[o];
    }
    for (int x = tid; x < steps * N; x += NT) {
      const int tt = x / N, m = x % N;
      const long long o = base + (long long)(t0 + tt) * t_stride + m;
      vs[x] = to_f(v[o]);
      dys[x] = to_f(dy[o]);
    }
    __syncthreads();
    // v . dy per step: a warp a step, each lane over m = lane + 32 j (j
    // ascending), then an xor tree over the lanes
    for (int tt = tid / 32; tt < steps; tt += NT / 32) {
      const int lane = tid % 32;
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < N / 32; ++j)
        a = fmaf(vs[tt * N + lane + 32 * j], dys[tt * N + lane + 32 * j], a);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) vdys[tt] = a;
    }
    // the stage forward from its saved state; S at each sub-stage's start
    const int nsub = (steps + kSub - 1) / kSub;
    const int last = (nsub - 1) * kSub;
    float S[kCC], Sb[kTS / kSub][kCC];
    const float* st = states + (((long long)bh * n_stages + s) * N + n0 + i) * N + ch;
#pragma unroll
    for (int j = 0; j < kCC; ++j) S[j] = st[j * CT];
#pragma unroll
    for (int tt = 0; tt < kTS; ++tt) {
      if (tt <= last) {
        if (tt % kSub == 0) {
#pragma unroll
          for (int j = 0; j < kCC; ++j) Sb[tt / kSub][j] = S[j];
        }
        if (tt < last) {
          const float wv = ws[tt * kRG + i], kv = ks[tt * kRG + i];
#pragma unroll
          for (int j = 0; j < kCC; ++j) S[j] = fmaf(wv, S[j], kv * vs[tt * N + ch + j * CT]);
        }
      }
    }
#pragma unroll
    for (int js = kTS / kSub - 1; js >= 0; --js) {
      if (js >= nsub) continue;
      const int a = js * kSub;
      const int len = min(kSub, steps - a);
      // (A) S_{t-1} of each step of the sub-stage into shared memory
#pragma unroll
      for (int j = 0; j < kCC; ++j) S[j] = Sb[js][j];
#pragma unroll
      for (int tt = 0; tt < kSub; ++tt) {
        if (tt < len) {
          float* row = SS + (tt * kRG + i) * P + ch;
#pragma unroll
          for (int j = 0; j < kCC; ++j) row[j * CT] = S[j];
          const float wv = ws[(a + tt) * kRG + i], kv = ks[(a + tt) * kRG + i];
#pragma unroll
          for (int j = 0; j < kCC; ++j)
            S[j] = fmaf(wv, S[j], kv * vs[(a + tt) * N + ch + j * CT]);
        }
      }
      // (B) backward through the sub-stage: G_t into shared memory, then G_{t-1}
#pragma unroll
      for (int tt = kSub - 1; tt >= 0; --tt) {
        if (tt < len) {
          float* row = GG + (tt * kRG + i) * P + ch;
#pragma unroll
          for (int j = 0; j < kCC; ++j) row[j * CT] = G[j];
          const float wv = ws[(a + tt) * kRG + i], rv = rs[(a + tt) * kRG + i];
#pragma unroll
          for (int j = 0; j < kCC; ++j)
            G[j] = fmaf(wv, G[j], rv * dys[(a + tt) * N + ch + j * CT]);
        }
      }
      __syncthreads();
      // (C) the sums: first a row's dr, dw, dk and du term per (step, row),
      // then dv's share per (step, value column)
      for (int x = tid; x < len * (kRG + N); x += NT) {
        if (x < len * kRG) {
          const int tt = x / kRG, ii = x % kRG;
          const float* srow = SS + (tt * kRG + ii) * P;
          const float* grow = GG + (tt * kRG + ii) * P;
          const float* dyr = dys + (a + tt) * N;
          const float* vr = vs + (a + tt) * N;
          float ar = 0.f, aw = 0.f, ak = 0.f;
#pragma unroll 4
          for (int m = 0; m < N; m += 4) {
            const float4 sv = *reinterpret_cast<const float4*>(srow + m);
            const float4 gv = *reinterpret_cast<const float4*>(grow + m);
            const float4 dv4 = *reinterpret_cast<const float4*>(dyr + m);
            const float4 vv = *reinterpret_cast<const float4*>(vr + m);
            ar = fmaf(sv.x, dv4.x, ar); aw = fmaf(sv.x, gv.x, aw); ak = fmaf(gv.x, vv.x, ak);
            ar = fmaf(sv.y, dv4.y, ar); aw = fmaf(sv.y, gv.y, aw); ak = fmaf(gv.y, vv.y, ak);
            ar = fmaf(sv.z, dv4.z, ar); aw = fmaf(sv.z, gv.z, aw); ak = fmaf(gv.z, vv.z, ak);
            ar = fmaf(sv.w, dv4.w, ar); aw = fmaf(sv.w, gv.w, aw); ak = fmaf(gv.w, vv.w, ak);
          }
          const int nn = n0 + ii;
          const float rv = rs[(a + tt) * kRG + ii], kv = ks[(a + tt) * kRG + ii];
          const float uu = u[h * N + nn], vd = vdys[a + tt];
          const long long o = base + (long long)(t0 + a + tt) * t_stride + nn;
          dr[o] = from_f<T>(fmaf(uu * kv, vd, ar));
          dk[o] = from_f<T>(fmaf(uu * rv, vd, ak));
          dw[o] = aw;
          dut[tt * kRG + ii] = (rv * kv) * vd;
        } else {
          const int y = x - len * kRG;
          const int tt = y / N, m = y % N;
          float acc = 0.f;
#pragma unroll
          for (int ii = 0; ii < kRG; ++ii)
            acc = fmaf(GG[(tt * kRG + ii) * P + m], ks[(a + tt) * kRG + ii], acc);
          dvp[base + (long long)(t0 + a + tt) * t_stride + m] = acc;
        }
      }
      __syncthreads();
      if (tid < kRG) {
        float sub = 0.f;
        for (int tt = len - 1; tt >= 0; --tt) sub += dut[tt * kRG + tid];
        du_stage += sub;
      }
    }
    du_acc += du_stage;
  }
  if (tid < kRG) du_part[(long long)bh * N + n0 + tid] = du_acc;
}

// dv = the N / kRG shares in order + coef_t dy_t, one warp per (b, t, h)
// row: coef_t = sum_n r u k, each lane over n = lane + 32 j (j ascending),
// then an xor tree over the lanes (every lane ends with the same bits).
// The first H * N threads also sum du's shares over b in order.
template <typename T, int N>
__global__ void __launch_bounds__(256) wkv6_bwd_reduce_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const float* __restrict__ u,
    const T* __restrict__ dy, const float* __restrict__ dv_part,
    const float* __restrict__ du_part, T* __restrict__ dv, float* __restrict__ du,
    long long rows, int B, int H) {
  constexpr int splits = N / kRG;
  constexpr int J = N / 32;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = gid / 32;
  const int lane = threadIdx.x % 32;
  if (row < rows) {
    const int h = static_cast<int>(row % H);
    const long long o = row * N;
    const long long total = rows * N;
    float c = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int nn = lane + 32 * j;
      c = fmaf(to_f(r[o + nn]) * u[h * N + nn], to_f(k[o + nn]), c);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const long long e = o + lane + 32 * j;
      float acc = dv_part[e];
#pragma unroll
      for (int gg = 1; gg < splits; ++gg) acc += dv_part[gg * total + e];
      dv[e] = from_f<T>(fmaf(c, to_f(dy[e]), acc));
    }
  }
  if (gid < (long long)H * N) {
    float a = du_part[gid];
    for (int bb = 1; bb < B; ++bb) a += du_part[(long long)bb * H * N + gid];
    du[gid] = a;
  }
}

template <typename T, int N>
cudaError_t launch_bwd(const void* r, const void* k, const void* v, const float* w,
                       const float* u, const void* dy, const float* ds, const float* states,
                       void* dr, void* dk, float* dw, float* dv_part, float* du_part, int B,
                       int T_len, int H, cudaStream_t st) {
  const BwdLayout L = bwd_layout(N);
  auto kern = wkv6_bwd_kernel<T, N>;
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || !attr_set[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  kern<<<B * H * (N / kRG), kRG * N / kCC, L.total, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u,
      static_cast<const T*>(dy), ds, states, static_cast<T*>(dr), static_cast<T*>(dk), dw,
      dv_part, du_part, B, T_len, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_n(const void* r, const void* k, const void* v, const float* w,
                         const float* u, const void* dy, const float* ds, const float* states,
                         void* dr, void* dk, float* dw, float* dv_part, float* du_part, int B,
                         int T_len, int H, int N, cudaStream_t st) {
  switch (N) {
    case 32:
      return launch_bwd<T, 32>(r, k, v, w, u, dy, ds, states, dr, dk, dw, dv_part, du_part, B,
                               T_len, H, st);
    case 64:
      return launch_bwd<T, 64>(r, k, v, w, u, dy, ds, states, dr, dk, dw, dv_part, du_part, B,
                               T_len, H, st);
    case 128:
      return launch_bwd<T, 128>(r, k, v, w, u, dy, ds, states, dr, dk, dw, dv_part, du_part, B,
                                T_len, H, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int N>
cudaError_t launch_bwd_reduce(const void* r, const void* k, const float* u, const void* dy,
                              const float* dv_part, const float* du_part, void* dv, float* du,
                              int B, int T_len, int H, cudaStream_t st) {
  const long long rows = (long long)B * T_len * H;
  const long long threads = rows * 32 > (long long)H * N ? rows * 32 : (long long)H * N;
  const long long blocks = (threads + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  wkv6_bwd_reduce_kernel<T, N><<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), u, static_cast<const T*>(dy), dv_part,
      du_part, static_cast<T*>(dv), du, rows, B, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_reduce_n(const void* r, const void* k, const float* u, const void* dy,
                                const float* dv_part, const float* du_part, void* dv,
                                float* du, int B, int T_len, int H, int N, cudaStream_t st) {
  switch (N) {
    case 32:
      return launch_bwd_reduce<T, 32>(r, k, u, dy, dv_part, du_part, dv, du, B, T_len, H, st);
    case 64:
      return launch_bwd_reduce<T, 64>(r, k, u, dy, dv_part, du_part, dv, du, B, T_len, H, st);
    case 128:
      return launch_bwd_reduce<T, 128>(r, k, u, dy, dv_part, du_part, dv, du, B, T_len, H, st);
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

// The backward of wkv6_fwd, first launch (wkv6_bwd_kernel): dr, dk (B, T,
// H, N; r's type) and dw (B, T, H, N; fp32), and into fp32 scratch dv's
// shares dv_part (N / 16, B, T, H, N) and du's du_part (B, H, N), from r,
// k, v, dy (r's type: fp32 when dtype == 0, bf16 when dtype == 1), w
// (fp32), u (H, N; fp32), ds (B, H, N, N; fp32, the gradient of the
// returned S, or null for 0) and `states` (B, H, ceil(T / kTS), N, N;
// fp32), which wkv6_fwd wrote. All contiguous, T >= 1. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
int wkv6_bwd_blocks(const void* r, const void* k, const void* v, const float* w,
                    const float* u, const void* dy, const float* ds, const float* states,
                    void* dr, void* dk, float* dw, float* dv_part, float* du_part, int B,
                    int T_len, int H, int N, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (B < 1 || T_len < 1 || H < 1 || (long long)B * H * (N / kRG) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd_n<float>(r, k, v, w, u, dy, ds, states, dr, dk, dw, dv_part,
                                    du_part, B, T_len, H, N, st);
  return (int)launch_bwd_n<__nv_bfloat16>(r, k, v, w, u, dy, ds, states, dr, dk, dw, dv_part,
                                          du_part, B, T_len, H, N, st);
}

// The backward's second launch (wkv6_bwd_reduce_kernel), after
// wkv6_bwd_blocks on the same operands: dv (B, T, H, N; r's type) = the
// N / 16 shares of dv_part in order + coef_t dy_t, and du (H, N; fp32) =
// du_part summed over b in order. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
int wkv6_bwd_reduce(const void* r, const void* k, const float* u, const void* dy,
                    const float* dv_part, const float* du_part, void* dv, float* du, int B,
                    int T_len, int H, int N, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (B < 1 || T_len < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd_reduce_n<float>(r, k, u, dy, dv_part, du_part, dv, du, B, T_len, H,
                                           N, st);
  return (int)launch_bwd_reduce_n<__nv_bfloat16>(r, k, u, dy, dv_part, du_part, dv, du, B,
                                                 T_len, H, N, st);
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
