// Conversion-masked mismatch count core for Hopper (sm_90a).
//
// Replaces the TPU kernel `_count_kernel` with its drivers `_counts_core`
// and `extend_counts_pallas_blob` (basal_tpu/ops/extend_pallas.py), which
// carve the wave blob and gather the reference window in XLA and then run
// the funnel shift, rule mask and popcount in Pallas.  Here one kernel does
// all of it straight from the wave blob (layout: basal_tpu_torch/ops/
// extend.py:carve_blob), so no [C, W+1] gathered window, no per-candidate
// row id and no derived validity plane ever reaches device memory.
//
// One thread per candidate:
//   1. decode loc and strand plane from the packed loc word,
//   2. find the candidate's row: searchsorted(row_off, i, 'right') - 1,
//   3. decode rowmeta (readlen, N-count, exception-row index),
//   4. funnel-shift W+1 gathered reference words onto the read grid,
//   5. apply the rule (oneway / multiway / nt3) under the validity mask,
//   6. popcount the 2-bit mismatch lanes, add the N-count, clamp to 255.
//
// What bounds it on the card: the random (W+1) x 4-byte reference gathers,
// one or two 32-byte sectors per candidate.  They are served from L2 while
// the packed reference (both planes, 4 bits per base) fits there, and from
// device memory for a mammalian genome.  The blob's loc words are read
// coalesced; a row's read planes and rowmeta are shared by its consecutive
// candidates and are served from L1/L2.  The arithmetic is a few dozen
// integer instructions per word and is not the limit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kA32 = 0xAAAAAAAAu;
constexpr uint32_t kFives = 0x55555555u;
constexpr int kThreads = 256;

enum Mode { kOneway = 0, kMultiway = 1, kNt3 = 2 };

__device__ __forceinline__ uint32_t xc32(uint32_t t) {
  return ((~t) << 1) | t | kFives;
}

__device__ __forceinline__ uint32_t xt32(uint32_t t) {
  return t - ((t << 1) & t & kA32);
}

__device__ __forceinline__ uint32_t m2_judge32(uint32_t t) {
  return t & (((t & kA32) >> 1) | ((t & kFives) << 1));
}

// 0b11 per in-length base of word w, first base at bits 31:30; 16 full
// lanes are special-cased because a shift by 32 is undefined.
__device__ __forceinline__ uint32_t lenmask_word(int readlen, int w) {
  int lanes = min(max(readlen - 16 * w, 0), 16);
  return lanes >= 16 ? 0xFFFFFFFFu : ~(0xFFFFFFFFu >> (2 * lanes));
}

// gather index clamped to the reference (its margins keep real candidates
// inside; the clamp keeps a bad loc from reading out of bounds)
__device__ __forceinline__ int64_t clamp_index(int64_t j, int64_t last) {
  return j < last ? j : last;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
count_blob_kernel(const uint32_t* __restrict__ ref32, int n_ref,
                  const int32_t* __restrict__ blob,
                  uint8_t* __restrict__ out, int C, int U, int W, int nw) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= C) return;

  const uint32_t locp = static_cast<uint32_t>(blob[i]);
  const int64_t plane = locp >> 31;
  const int64_t loc = locp & 0x7FFFFFFFu;

  // largest row with row_off[row] <= i (padded tail entries equal C)
  const int32_t* row_off = blob + C;
  int lo = 0, hi = U + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row_off[mid] <= i) lo = mid + 1; else hi = mid;
  }
  const int row = min(max(lo - 1, 0), U - 1);

  const uint32_t nl = static_cast<uint32_t>(blob[C + U + 1 + row]);
  const int readlen = nl & 1023u;
  const int ncnt = (nl >> 10) & 1023u;
  const int exc = (nl >> 20) & 0xFFFu;

  const uint32_t* planes =
      reinterpret_cast<const uint32_t*>(blob + C + 2 * U + 1);
  const uint32_t* base = planes + static_cast<int64_t>(row) * W;
  const uint32_t* mread = planes + static_cast<int64_t>(U + row) * W;
  const int64_t k = (MODE == kMultiway) ? 2 : 1;
  const uint32_t* excv =
      planes + k * U * W + static_cast<int64_t>(max(exc - 1, 0)) * W;

  const int sh = static_cast<int>((loc & 15) << 1);
  const int64_t g = plane * nw + (loc >> 4);
  const int64_t last = n_ref - 1;
  uint32_t cur = __ldg(ref32 + clamp_index(g, last));
  int cnt = 0;
  for (int w = 0; w < W; ++w) {
    const uint32_t nxt = __ldg(ref32 + clamp_index(g + w + 1, last));
    // (cur << sh) | (nxt >> (32 - sh)); equals cur for sh == 0
    const uint32_t a = __funnelshift_l(nxt, cur, sh);
    cur = nxt;
    const uint32_t b = base[w];
    uint32_t flags;
    if (MODE == kOneway) {
      flags = (b & xc32(a)) ^ a;
    } else if (MODE == kMultiway) {
      const uint32_t m2 = xc32(a) | mread[w];
      const uint32_t m3 = m2_judge32(m2);
      flags = ((~m3 & m2) | (m3 & b)) ^ a;
    } else {
      flags = b ^ xt32(a);
    }
    const uint32_t v = exc ? excv[w] : lenmask_word(readlen, w);
    const uint32_t mm = flags & v;
    cnt += __popc((mm | (mm >> 1)) & kFives);
  }
  out[i] = static_cast<uint8_t>(min(ncnt + cnt, 255));
}

}  // namespace

// Plain C entry for ctypes.  Launches on `stream` and returns the launch's
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int bt_count_blob(const void* ref32, int n_ref, const void* blob,
                             void* out, int C, int U, int W, int nw, int mode,
                             void* stream) {
  if (C <= 0) return 0;
  const dim3 grid((C + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const uint32_t*>(ref32);
  const auto* b = static_cast<const int32_t*>(blob);
  auto* o = static_cast<uint8_t*>(out);
  if (mode == kOneway) {
    count_blob_kernel<kOneway><<<grid, kThreads, 0, s>>>(r, n_ref, b, o, C,
                                                         U, W, nw);
  } else if (mode == kMultiway) {
    count_blob_kernel<kMultiway><<<grid, kThreads, 0, s>>>(r, n_ref, b, o, C,
                                                           U, W, nw);
  } else if (mode == kNt3) {
    count_blob_kernel<kNt3><<<grid, kThreads, 0, s>>>(r, n_ref, b, o, C, U,
                                                      W, nw);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
