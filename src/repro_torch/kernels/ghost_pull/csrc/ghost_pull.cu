// One-pass ghost pull for Hopper (sm_90a): a client's tau-gated sync of its
// ghost rows (FedAIS Algorithm 1, lines 15-17) as one copy kernel.
//
// For ghost slot s (g slots) with need[s] > 0 the new layer-0 ghost row is
// the owner's round-start feature row times the slot's mask,
// feats_all[max(owner[s], 0), row[s]] * ghost_mask[s]; otherwise the old row
// ghost_feat[s]. The new layer-1 table is hist1 with its ghost row n_max + s
// chosen the same way from hist1_all, and its own rows 0..n_max-1 copied.
// Both outputs are new buffers; the inputs are left as they were. No TPU
// kernel corresponds to it: the reference gathers, masks and selects with
// jnp, which the port's plain version (ref.py) does with PyTorch ops.
//
// What bounds it: the bytes. The plain version gathers every source row,
// multiplies the gather by the mask and selects between it and the old
// table, so the 12,390 x 6,805 fp32 ghost table of Coauthor (337 MB) moves
// about three times over. Here each output row is written once and each
// row that feeds it (the source if pulled, the old row if not) is read
// once: a warp owns one output row, reads the slot's owner, row, need and
// mask once, and streams the row.
//
// Alignment. A row of 6,805 fp32 is 27,220 bytes, so rows start only 4-byte
// aligned (at 4 r mod 16) and a source row and its destination are out of
// phase in general. The warp peels the row to the destination's 16-byte
// boundary and stores float4 there. It loads the source as the aligned
// float4s that cover it and shifts each lane's pair of neighbours into place
// with two warp shuffles (the shift is the source's phase against the
// destination's, the same for the whole row, so the branch is uniform).
// Eight float4 a lane are in flight per step. The loads go through the
// read-only cache (ld.global.nc) with the default eviction: a step's first
// and last 32-byte sectors are shared with its neighbour steps, which an
// evict-first load (ld.global.cs) may drop before they are read again. On an
// H100 at Coauthor's shape (704 MB moved) this reads 0.2556 ms, 82% of the
// bytes at 3.35 TB/s and 94% of the rate of a plain device copy of as many
// bytes (0.2403 ms); four float4 a lane read 0.2611, evict-first loads and
// stores 0.2755 (unroll 6, 12 or 16, two warps a row, or blocks of 2 to 16
// warps: all within 1% of 0.2556). The plain design, each lane keeping 4 to
// 32 coalesced 4-byte loads in flight with no realignment (blocks of 4 to 16
// warps), reads 0.2945-0.3032 ms there, 15% slower than this one (at
// Pubmed's 500-wide rows 0.0355 against 0.0370). The aligned loads at a
// row's two ends reach at most 12 bytes past it, inside the 16-byte granule
// that holds the row's end.
//
// The multiply by the mask is the plain version's fp32 multiply, and a row
// not pulled is copied as its bits, so the result equals the plain version's
// bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py). The entry point has
//        a plain C interface, loaded with ctypes.

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // warps (output rows in flight) per block
constexpr int kUnroll = 8;   // float4 a lane per step

__device__ __forceinline__ float4 shift(float4 lo, float4 hi, int b) {
  switch (b) {
    case 1: return make_float4(lo.y, lo.z, lo.w, hi.x);
    case 2: return make_float4(lo.z, lo.w, hi.x, hi.y);
    case 3: return make_float4(lo.w, hi.x, hi.y, hi.z);
    default: return lo;
  }
}

__device__ __forceinline__ float4 shfl4(float4 v, int src_lane) {
  return make_float4(__shfl_sync(0xffffffffu, v.x, src_lane),
                     __shfl_sync(0xffffffffu, v.y, src_lane),
                     __shfl_sync(0xffffffffu, v.z, src_lane),
                     __shfl_sync(0xffffffffu, v.w, src_lane));
}

__device__ __forceinline__ float4 shfl4_down(float4 v) {
  return make_float4(__shfl_down_sync(0xffffffffu, v.x, 1),
                     __shfl_down_sync(0xffffffffu, v.y, 1),
                     __shfl_down_sync(0xffffffffu, v.z, 1),
                     __shfl_down_sync(0xffffffffu, v.w, 1));
}

// dst[0:n] = src[0:n] (times scale where `scaled`), by one warp.
__device__ __forceinline__ void copy_row(const float* __restrict__ src,
                                         float* __restrict__ dst, int n, bool scaled,
                                         float scale, int lane) {
  int head = (int)((16u - (unsigned)(reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u) >> 2;
  if (head > n) head = n;
  if (lane < head) {
    const float v = src[lane];
    dst[lane] = scaled ? v * scale : v;
  }
  src += head;
  dst += head;
  n -= head;
  const int nb = n >> 2;    // whole float4 of the destination
  const int b = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3u);
  const float4* sa = reinterpret_cast<const float4*>(src - b);
  float4* da = reinterpret_cast<float4*>(dst);
  // the last float4's shift needs the aligned float4 after it
  const int nload = nb + (b != 0);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nb; c += 32 * kUnroll) {
    float4 v[kUnroll + 1];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = c + 32 * u + lane;
      v[u] = i < nload ? __ldg(sa + i) : zero;
    }
    if (b != 0) {
      // the first float4 of the next step, for lane 31's shift
      const int i = c + 32 * kUnroll;
      v[kUnroll] = (lane == 0 && i < nload) ? __ldg(sa + i) : zero;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float4 w = v[u];
      if (b != 0) {
        const float4 down = shfl4_down(v[u]);
        const float4 next = shfl4(v[u + 1], 0);
        w = shift(v[u], lane == 31 ? next : down, b);
      }
      const int i = c + 32 * u + lane;
      if (i < nb) {
        if (scaled) {
          w.x *= scale;
          w.y *= scale;
          w.z *= scale;
          w.w *= scale;
        }
        da[i] = w;
      }
    }
  }
  const int tail = n & 3;
  if (lane < tail) {
    const float v = src[4 * nb + lane];
    dst[4 * nb + lane] = scaled ? v * scale : v;
  }
}

// Warp w < g writes ghost row w of out_feat; warp g + t writes row t of
// out_hist1 (t < n_max: the client's own row, copied; else ghost slot
// t - n_max). The wide ghost rows come first in the grid.
__global__ void __launch_bounds__(kWarps * 32)
ghost_pull_kernel(const float* __restrict__ feats_all, const float* __restrict__ hist1_all,
                  const int* __restrict__ owner, const int* __restrict__ row,
                  const float* __restrict__ mask, const float* __restrict__ need,
                  const float* __restrict__ ghost_feat, const float* __restrict__ hist1,
                  float* __restrict__ out_feat, float* __restrict__ out_hist1,
                  int k_feat, int feat_rows, int k_hist, int hist_rows, int g, int n_max,
                  int F, int H) {
  const int w = blockIdx.x * kWarps + (int)(threadIdx.x >> 5);
  const int lane = (int)(threadIdx.x & 31);
  const int n_tot = n_max + g;
  if (w >= g + n_tot) return;
  const bool wide = w < g;
  const int t = wide ? w : w - g;
  const int s = wide ? w : t - n_max;
  if (!wide && t < n_max) {
    copy_row(hist1 + (size_t)t * H, out_hist1 + (size_t)t * H, H, false, 1.f, lane);
    return;
  }
  const bool pulled = need[s] > 0.f;
  const float m = mask[s];
  const int o = max(owner[s], 0);
  const int r = row[s];
  const float* src;
  if (wide) {
    if (pulled) assert(o < k_feat && r >= 0 && r < feat_rows);
    src = pulled ? feats_all + ((size_t)o * feat_rows + r) * F : ghost_feat + (size_t)s * F;
    copy_row(src, out_feat + (size_t)s * F, F, pulled, m, lane);
  } else {
    if (pulled) assert(o < k_hist && r >= 0 && r < hist_rows);
    src = pulled ? hist1_all + ((size_t)o * hist_rows + r) * H : hist1 + (size_t)t * H;
    copy_row(src, out_hist1 + (size_t)t * H, H, pulled, m, lane);
  }
}

}  // namespace

extern "C" {

// out_feat (g, F) and out_hist1 (n_max + g, H), from feats_all (k_feat,
// feat_rows, F), hist1_all (k_hist, hist_rows, H), the slots' owner, row
// (int32), ghost_mask and need (fp32) (g,), ghost_feat (g, F) and hist1
// (n_max + g, H); every array contiguous, the outputs apart from the
// inputs. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
int ghost_pull_f32(const float* feats_all, const float* hist1_all, const int* owner,
                   const int* row, const float* mask, const float* need,
                   const float* ghost_feat, const float* hist1, float* out_feat,
                   float* out_hist1, int k_feat, int feat_rows, int k_hist, int hist_rows,
                   int g, int n_max, int F, int H, void* stream) {
  if (g < 0 || n_max < 0 || F < 0 || H < 0 || k_feat < 0 || feat_rows < 0 || k_hist < 0 ||
      hist_rows < 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)g + n_max + g;
  if (rows == 0) return (int)cudaSuccess;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ghost_pull_kernel<<<(unsigned)blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      feats_all, hist1_all, owner, row, mask, need, ghost_feat, hist1, out_feat, out_hist1,
      k_feat, feat_rows, k_hist, hist_rows, g, n_max, F, H);
  return (int)cudaGetLastError();
}

const char* ghost_pull_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
