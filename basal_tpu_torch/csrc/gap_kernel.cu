// Gapped candidate extension for Hopper (sm_90a): counts plus the mismatch
// position lists that the gapped scan replays.
//
// Replaces the TPU kernel `_gap_kernel` with `_positions_block`, driven by
// `_gap_core` and `extend_gap_pallas_blob` (basal_tpu/ops/extend_pallas.py),
// which carve the wave blob and gather a [C, W+3] reference window in XLA,
// then in Pallas shift the window onto the read grid for the main alignment
// and the 2*gap shifted ones and pull K = 14 positions out of each with K
// min-extract passes over a [tile, 16*W] lane matrix.  Here one thread per
// candidate does all of it straight from the wave blob (layout:
// basal_tpu_torch/ops/extend.py:carve_blob), and walks the set bits of the
// lane-flag words instead of sorting lanes:
//   1. decode loc / plane, find the row (binary search over row_off),
//      decode rowmeta (readlen, N-count, exception-row index),
//   2. load the W+3 window words once, from one word before loc >> 4,
//   3. main alignment: funnel-shift, rule mask, popcount under the validity
//      mask -> count; set lanes under the length mask, walked from the
//      first word with __clz -> pos0, the first 14 positions ascending,
//   4. shifted alignments s = -1, +1, -2, +2, ...: word offset and bit
//      shift re-derived from 2*(loc & 15) + 2s; lanes walked from the last
//      word with __ffs -> pos1, the first 14 as distance from the read end,
//   5. lists shorter than 14 are padded with readlen, as sorted()[:14] of
//      the plain version pads them.
//
// What bounds it on the card: the output.  Each candidate writes
// 1 + 2*14 + 2*gap*14*2 bytes (197 at gap 3), 206.6 MB per 2^20 candidates,
// against 4 bytes of loc read coalesced and a (W+3)-word window gathered
// from the packed reference (both planes fit in the 50 MB L2 up to ~200 Mbp
// of genome).  At 3.35 TB/s the stores alone take 0.063 ms per 2^20
// candidates at gap 3; the arithmetic, about 1,200 integer instructions
// per candidate (seven alignments of W = 7 words, the bit walks), is
// ~0.04 ms at the card's integer rate.
//
// The design against that bound:
//   - Outputs are staged in shared memory.  A block of 128 candidates owns
//     contiguous spans of all three outputs (128 B of counts, 3,584 B of
//     pos0, 7,168*gap B of pos1); each thread writes its count and lists
//     into tiles laid out as those spans, and after __syncthreads() the
//     block copies each span out with 16-byte stores, consecutive threads
//     on consecutive chunks.  The spans start 16-byte aligned (i0 is a
//     multiple of 128); the last block of a wave copies only its C - i0
//     candidates, and the tail that is not a whole 16 bytes byte by byte.
//     Before, each thread stored its 98 positions one at a time, 28 and 168
//     bytes from its neighbour's: ~10^8 partial sector writes per 2^20.
//   - The window sits in shared memory, W+3 words per thread at a stride
//     of 33 words (odd: a warp reading one word index hits 32 banks).
//     Indexed by a runtime W and a per-thread shift offset, a per-thread
//     array lived in local memory before, and 2,048 threads x 33 words per
//     SM overflow L1 into L2.  Shared memory keeps one instantiation per
//     rule mode, where a register window would need one per W as well.
//     Static shared memory per block: 16,896 B of windows + 128 + 3,584 +
//     21,504 B of output tiles = 42,112 B, under the 48 KB that needs no
//     opt-in; 5 blocks (640 threads) fit on an SM.
// What is left: one thread extracts all of a candidate's positions, so the
// bit walks diverge within a warp; a warp-cooperative extraction, and the
// read row's words (re-read from L1 by every alignment) held once per row,
// are the next steps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kA32 = 0xAAAAAAAAu;
constexpr uint32_t kFives = 0x55555555u;
constexpr int kThreads = 128;
constexpr int kMaxW = 30;  // 480-base reads (AlignParams.max_readlen)
constexpr int kMaxGap = 3;
constexpr int kPos = 14;   // K_POS: MAXSNPS - 1
constexpr int kWinStride = kMaxW + 3;  // words per thread; odd

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

__device__ __forceinline__ uint32_t lenmask_word(int readlen, int w) {
  int lanes = min(max(readlen - 16 * w, 0), 16);
  return lanes >= 16 ? 0xFFFFFFFFu : ~(0xFFFFFFFFu >> (2 * lanes));
}

// mismatch flags of read word w against aligned reference word a; the
// mread plane exists only in multiway blobs
template <int MODE>
__device__ __forceinline__ uint32_t rule_flags(const uint32_t* base,
                                               const uint32_t* mread, int w,
                                               uint32_t a) {
  const uint32_t b = base[w];
  if (MODE == kOneway) return (b & xc32(a)) ^ a;
  if (MODE == kMultiway) {
    const uint32_t m2 = xc32(a) | mread[w];
    const uint32_t m3 = m2_judge32(m2);
    return ((~m3 & m2) | (m3 & b)) ^ a;
  }
  return b ^ xt32(a);
}

// one bit per mismatching lane, at the lane's low position (bit 30 - 2j)
__device__ __forceinline__ uint32_t lane_bits(uint32_t f) {
  return (f | (f >> 1)) & kFives;
}

// The block's copy of n bytes from a shared tile to device memory, both
// 16-byte aligned: 16-byte stores by consecutive threads, then the tail
// that is not a whole 16 bytes one byte per thread.
__device__ __forceinline__ void store_span(void* dst, const void* src,
                                           int n) {
  const int n16 = n >> 4;
  int4* d = static_cast<int4*>(dst);
  const int4* s = static_cast<const int4*>(src);
  for (int k = threadIdx.x; k < n16; k += kThreads) d[k] = s[k];
  const int j = 16 * n16 + static_cast<int>(threadIdx.x);
  if (j < n) {
    static_cast<uint8_t*>(dst)[j] = static_cast<const uint8_t*>(src)[j];
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
gap_blob_kernel(const uint32_t* __restrict__ ref32, int n_ref,
                const int32_t* __restrict__ blob, uint8_t* __restrict__ cnt,
                int16_t* __restrict__ pos0, int16_t* __restrict__ pos1,
                int C, int U, int W, int nw, int gap) {
  __shared__ __align__(16) uint32_t s_win[kThreads * kWinStride];
  __shared__ __align__(16) uint8_t s_cnt[kThreads];
  __shared__ __align__(16) int16_t s_pos0[kThreads * kPos];
  __shared__ __align__(16) int16_t s_pos1[kThreads * 2 * kMaxGap * kPos];

  const int t = threadIdx.x;
  const int i0 = blockIdx.x * kThreads;
  const int n_live = min(kThreads, C - i0);
  const int i = i0 + t;

  if (t < n_live) {
    const uint32_t locp = static_cast<uint32_t>(blob[i]);
    const int64_t plane = locp >> 31;
    const int64_t loc = locp & 0x7FFFFFFFu;

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

    // window: W+3 words from one word before loc >> 4, clamped to the
    // reference at both ends (the margins keep real candidates inside)
    uint32_t* win = s_win + t * kWinStride;
    const int64_t g = plane * nw + (loc >> 4) - 1;
    const int64_t last = n_ref - 1;
    for (int w = 0; w < W + 3; ++w) {
      const int64_t j = g + w;
      win[w] = __ldg(ref32 + (j < 0 ? 0 : (j > last ? last : j)));
    }
    const int sh2 = static_cast<int>((loc & 15) << 1);

    // main alignment: word offset 1, shift sh2
    int16_t* p0 = s_pos0 + t * kPos;
    int count = 0, n0 = 0;
    for (int w = 0; w < W; ++w) {
      const uint32_t a = __funnelshift_l(win[w + 2], win[w + 1], sh2);
      const uint32_t f = rule_flags<MODE>(base, mread, w, a);
      const uint32_t v = exc ? excv[w] : lenmask_word(readlen, w);
      count += __popc(lane_bits(f & v));
      uint32_t bits = lane_bits(f & lenmask_word(readlen, w));
      while (bits && n0 < kPos) {        // ascending lanes: highest bit first
        const int z = __clz(bits);       // 1 + 2j for lane j
        p0[n0++] = static_cast<int16_t>(16 * w + (z >> 1));
        bits &= ~(0x80000000u >> z);
      }
    }
    for (; n0 < kPos; ++n0) p0[n0] = static_cast<int16_t>(readlen);
    s_cnt[t] = static_cast<uint8_t>(min(ncnt + count, 255));

    // shifted alignments, in the order of the plain version: tt odd -> -t,
    // tt even -> +t
    for (int tt = 1; tt <= 2 * gap; ++tt) {
      const int st = (tt + 1) >> 1;
      const int s = (tt & 1) ? -st : st;
      const int sh2s = sh2 + 2 * s + 32;   // in [26, 68]: non-negative
      const int off = sh2s >> 5;           // 1 + floor((sh2 + 2s) / 32)
      const int sh = sh2s & 31;
      int16_t* p1 = s_pos1 + (t * 2 * gap + tt - 1) * kPos;
      int n1 = 0;
      for (int w = W - 1; w >= 0 && n1 < kPos; --w) {
        const uint32_t a = __funnelshift_l(win[off + w + 1], win[off + w], sh);
        const uint32_t f = rule_flags<MODE>(base, mread, w, a);
        uint32_t bits = lane_bits(f & lenmask_word(readlen, w));
        while (bits && n1 < kPos) {      // descending lanes: lowest bit first
          const int j = (31 - __ffs(bits)) >> 1;
          p1[n1++] = static_cast<int16_t>(readlen - 1 - (16 * w + j));
          bits &= bits - 1;
        }
      }
      for (; n1 < kPos; ++n1) p1[n1] = static_cast<int16_t>(readlen);
    }
  }
  __syncthreads();

  // the tiles are the block's spans of the outputs, row for row
  store_span(cnt + i0, s_cnt, n_live);
  store_span(pos0 + static_cast<int64_t>(i0) * kPos, s_pos0,
             n_live * kPos * 2);
  store_span(pos1 + static_cast<int64_t>(i0) * 2 * gap * kPos, s_pos1,
             n_live * 2 * gap * kPos * 2);
}

}  // namespace

// Plain C entry for ctypes.  Launches on `stream` and returns the launch's
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// the kernel does not take; never synchronises.
extern "C" int bt_gap_blob(const void* ref32, int n_ref, const void* blob,
                           void* cnt, void* pos0, void* pos1, int C, int U,
                           int W, int nw, int gap, int mode, void* stream) {
  if (W < 1 || W > kMaxW || gap < 1 || gap > kMaxGap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the block's output spans are copied with 16-byte stores
  if ((reinterpret_cast<uintptr_t>(cnt) | reinterpret_cast<uintptr_t>(pos0) |
       reinterpret_cast<uintptr_t>(pos1)) & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (C <= 0) return 0;
  const dim3 grid((C + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const uint32_t*>(ref32);
  const auto* b = static_cast<const int32_t*>(blob);
  auto* c = static_cast<uint8_t*>(cnt);
  auto* q0 = static_cast<int16_t*>(pos0);
  auto* q1 = static_cast<int16_t*>(pos1);
  if (mode == kOneway) {
    gap_blob_kernel<kOneway><<<grid, kThreads, 0, s>>>(r, n_ref, b, c, q0, q1,
                                                       C, U, W, nw, gap);
  } else if (mode == kMultiway) {
    gap_blob_kernel<kMultiway><<<grid, kThreads, 0, s>>>(r, n_ref, b, c, q0,
                                                         q1, C, U, W, nw, gap);
  } else if (mode == kNt3) {
    gap_blob_kernel<kNt3><<<grid, kThreads, 0, s>>>(r, n_ref, b, c, q0, q1, C,
                                                    U, W, nw, gap);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
