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
// Per candidate: decode loc and strand plane from the packed loc word; find
// its row, searchsorted(row_off, i, 'right') - 1 clamped to [0, U-1];
// decode rowmeta (readlen, N-count, exception-row index); funnel-shift the
// W+1 reference words at plane*nw + (loc >> 4) onto the read grid; apply the
// rule (oneway / multiway / nt3) under the validity mask; popcount the 2-bit
// mismatch lanes, add the N-count, clamp to 255.
//
// What bounds it.  Per candidate the call must read 4 bytes of loc and a
// window of W+1 words (32 B at W 7) at a random offset, which touches about
// 1.9 32-byte sectors (a 32-byte window crosses a sector boundary 7 times
// in 8); the blob's rows are shared by consecutive candidates.  While the
// packed reference (both planes, 4 bits per base) fits in the 50 MB L2 the
// sectors come from L2, and the limits are how many distinct lines the L1
// must look up per load instruction and the instructions per candidate: the
// row lookup, the gather's addressing and some 16 integer operations per
// compared word are of the same order as the sector traffic, so the
// arithmetic is not negligible here.  For a mammalian genome shard (1 GB
// of words at 2 Gbp) every window is a random read from device memory, and
// the limit is the sectors in flight.
//
// The design against that, per warp of 32 candidates (a tile):
//   - Warp-cooperative gather.  The warp copies its 32 windows into shared
//     memory with consecutive lanes on consecutive words of one window (a
//     window's start is shared from its candidate's lane with __shfl_sync),
//     so one load instruction touches 32 / (W+1) windows' sectors (4 at W 7)
//     instead of 32 unrelated lines: W+1 instructions of a few L1 lookups
//     each, against W+1 instructions of 32 lookups each when every thread
//     read its own window.  Each thread then reads its window from shared
//     memory at an odd word stride S = (W+1) | 1, so a warp's reads fall in
//     32 distinct banks.
//   - Overlap.  The copies are 4-byte cp.async into a 2-stage ring per warp:
//     tile t+1's random reads are in flight while tile t does its row
//     lookup, shifts, masks and popcounts.  A warp walks a contiguous run of
//     tiles (the grid is sized from the SM count and the occupancy, so every
//     warp is resident), and the loc words are loaded two tiles ahead.
//     A build of this kernel with plain loads and shared-memory stores in
//     place of the cp.async copies (the same pipeline otherwise) measured
//     0.0281 ms per 2^20 candidates against 0.0242-0.0245 for cp.async at
//     C 2^20, W 7, U 8192 over a 50 Mbp reference, and 0.0513-0.0516
//     against 0.0485 over 2 Gbp (device-side, chip_smoke.py phase 2 of the
//     tree that still carried that build; NVIDIA H100 80GB HBM3, 700 W), so
//     cp.async stays and the plain-loads build was removed.
//   - One row lookup per tile.  The candidates of a tile almost always share
//     one to three rows.  A warp knows c0 = #{row_off <= i0} for its tile's
//     first candidate i0 and loads row_off[c0 .. c0+31] in one coalesced
//     instruction.  When none of them lies in the tile, every candidate is in
//     row c0 - 1; when fewer than 32 do (the usual case otherwise), they are
//     staged in shared memory and each thread finds its row there (at most 5
//     steps); the next tile's c0 follows from a ballot.  Only the first tile
//     of a run, or a tile with 32 or more row starts (empty rows repeat
//     row_off entries, and their runs have no length limit), searches
//     row_off in global memory: a warp search that probes 32 entries per
//     round (3 dependent rounds at U 8192), or for the thread's own row a
//     binary search.  Before, every thread ran a 14-step dependent binary
//     search before its first reference load.
//   - The length mask of word w is one clamped funnel shift of
//     2*readlen - 32w bits.
//   - TMA does not apply: each window is an unaligned run of 32-36 bytes
//     at a random offset, and one bulk copy per window cannot pay its cost.
//     Tensor cores do not apply: there is no product to compute.
// Resources (ptxas -v, nvcc 12.8, sm_90a): 40 registers (oneway, nt3) and
// 48 (multiway), no stack frame, no spills.  Dynamic shared memory per
// block of 4 warps: 2 stages x 128 windows x S words + a 32-entry row_off
// slice per warp; 9,728 B at W 7, 32,256 B at W 30.  Above 48 KB (W > 46)
// the C entry opts in.
//
// What is left: the reference stays resident in L2 only by chance; an
// access-policy window that keeps it there, and one launch for several
// waves (the main path's waves are small), are later steps.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kA32 = 0xAAAAAAAAu;
constexpr uint32_t kFives = 0x55555555u;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kTile = 32;    // candidates per warp tile
constexpr int kWarps = 4;
constexpr int kThreads = kTile * kWarps;
constexpr int kStages = 2;
constexpr int kMaxW = 64;    // rowmeta's 10-bit read length: at most 64 words
constexpr int kMaxDevices = 64;

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

// gather index clamped to the reference (its margins keep real candidates
// inside; the clamp keeps a bad loc from reading out of bounds)
__device__ __forceinline__ int clamp_index(int j, int last) {
  return j < last ? j : last;
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the most recent group of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// #{r < n : a[r] <= x} for non-decreasing a, given a[r] <= x for r < lo.
// Warp-uniform arguments; each round probes 32 entries at once and leaves a
// range of less than 1/32 of the last.
__device__ __forceinline__ int warp_count(const int32_t* a, int lo, int n,
                                          int x) {
  const int lane = threadIdx.x & 31;
  int hi = n;  // a[r] > x for r >= hi
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    const int k = __popc(__ballot_sync(kFull, p < hi && a[p] <= x));
    if (k == 0) return lo;
    hi = min(hi, lo + k * step);
    lo += (k - 1) * step + 1;
  }
  return lo;
}

// window start (a word index < 2^31: the wrapper checks 2*nw < 2^31)
__device__ __forceinline__ int window_start(uint32_t locp, int nw) {
  return static_cast<int>(locp >> 31) * nw +
         static_cast<int>((locp & 0x7FFFFFFFu) >> 4);
}

// The warp's copy of its tile's windows into dst (window c at c*S): lane l
// copies flat word f = l + 32r of round r, word f % wn of window f / wn,
// whose start the window's own lane holds in g.  Windows c >= n_live are
// not read.
__device__ __forceinline__ void gather_windows(uint32_t* dst,
                                               const uint32_t* ref32, int last,
                                               int g, int n_live, int wn,
                                               int S) {
  const int lane = threadIdx.x & 31;
  const int c_step = kTile / wn, j_step = kTile % wn;
  int c = lane / wn, j = lane % wn;
  for (int r = 0; r < wn; ++r) {
    const int gc = __shfl_sync(kFull, g, c & 31);
    if (c < n_live) {
      cp_async4(dst + c * S + j, ref32 + clamp_index(gc + j, last));
    }
    c += c_step;
    j += j_step;
    if (j >= wn) {
      j -= wn;
      ++c;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
count_blob_kernel(const uint32_t* __restrict__ ref32, int n_ref,
                  const int32_t* __restrict__ blob,
                  uint8_t* __restrict__ out, int C, int U, int W, int nw) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wn = W + 1;
  const int S = wn | 1;
  const int stage_words = kTile * S;
  uint32_t* win = smem + warp * kStages * stage_words;
  int32_t* s_off = reinterpret_cast<int32_t*>(smem + kWarps * kStages *
                                              stage_words) + warp * kTile;

  // this warp's contiguous run of tiles [t_begin, t_end)
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t n_tiles = (static_cast<int64_t>(C) + kTile - 1) / kTile;
  const int t_begin = static_cast<int>(gw * n_tiles / n_warps);
  const int t_end = static_cast<int>((gw + 1) * n_tiles / n_warps);
  if (t_begin >= t_end) return;

  const int32_t* row_off = blob + C;
  const uint32_t* planes =
      reinterpret_cast<const uint32_t*>(blob + C + 2 * U + 1);
  const int64_t k = (MODE == kMultiway) ? 2 : 1;
  const int last = n_ref - 1;
  auto loc_word = [&](int t) -> uint32_t {
    const int i = t * kTile + lane;
    return i < C ? static_cast<uint32_t>(__ldg(blob + i)) : 0u;
  };

  uint32_t lp_cur = loc_word(t_begin);
  gather_windows(win, ref32, last, window_start(lp_cur, nw),
                 C - t_begin * kTile, wn, S);
  cp_async_commit();
  uint32_t lp_next = t_begin + 1 < t_end ? loc_word(t_begin + 1) : 0u;
  int c0 = warp_count(row_off, 0, U + 1, t_begin * kTile);

  for (int t = t_begin; t < t_end; ++t) {
    const int i0 = t * kTile;
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      gather_windows(win + (stage ^ 1) * stage_words, ref32, last,
                     window_start(lp_next, nw), C - i0 - kTile, wn, S);
    }
    cp_async_commit();  // an empty group at the last tile keeps the count
    const uint32_t lp_after = t + 2 < t_end ? loc_word(t + 2) : 0u;

    // row: count = #{row_off <= i}; the entries of (i0, i1] start at c0
    const int i = i0 + lane;
    const int i1 = min(i0 + kTile - 1, C - 1);
    const int e = c0 + lane <= U ? row_off[c0 + lane] : INT_MAX;
    const unsigned in_tile = __ballot_sync(kFull, e <= i1);
    int count = c0;  // no row starts in the tile: one row for all
    if (in_tile == 0) {
    } else if (in_tile != kFull) {
      s_off[lane] = e;
      __syncwarp();
      int lo = 0, hi = __popc(in_tile);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_off[mid] <= i) lo = mid + 1; else hi = mid;
      }
      count = c0 + lo;
    } else {  // 32 or more row starts in the tile: search device memory
      int lo = c0, hi = U + 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (row_off[mid] <= i) lo = mid + 1; else hi = mid;
      }
      count = lo;
    }
    const int row = min(max(count - 1, 0), U - 1);
    if (t + 1 < t_end) {
      const unsigned m = __ballot_sync(kFull, e <= i0 + kTile);
      c0 = m != kFull ? c0 + __popc(m)
                      : warp_count(row_off, c0 + kTile, U + 1, i0 + kTile);
    }

    cp_async_wait_prior();
    __syncwarp();  // every lane's copies of this tile are visible
    if (i < C) {
      const uint32_t nl = static_cast<uint32_t>(blob[C + U + 1 + row]);
      const int readlen = nl & 1023u;
      const int ncnt = (nl >> 10) & 1023u;
      const int exc = (nl >> 20) & 0xFFFu;
      const uint32_t* base = planes + static_cast<int64_t>(row) * W;
      const uint32_t* mread = planes + static_cast<int64_t>(U + row) * W;
      const uint32_t* excv =
          planes + k * U * W + static_cast<int64_t>(max(exc - 1, 0)) * W;
      const uint32_t* wv = win + stage * stage_words + lane * S;
      const int sh = static_cast<int>((lp_cur & 15u) << 1);
      uint32_t cur = wv[0];
      int cnt = 0, len2 = 2 * readlen;
      for (int w = 0; w < W; ++w) {
        const uint32_t nxt = wv[w + 1];
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
        // the length mask: the top 2*clamp(readlen - 16w, 0, 16) bits
        const uint32_t lm = ~__funnelshift_rc(0xFFFFFFFFu, 0u, max(len2, 0));
        len2 -= 32;
        const uint32_t v = exc ? excv[w] : lm;
        const uint32_t mm = flags & v;
        cnt += __popc((mm | (mm >> 1)) & kFives);
      }
      out[i] = static_cast<uint8_t>(min(ncnt + cnt, 255));
    }
    __syncwarp();  // this stage and the row_off slice are free again
    lp_cur = lp_next;
    lp_next = lp_after;
  }
}

size_t smem_bytes(int W) {
  return sizeof(uint32_t) *
         (static_cast<size_t>(kWarps) * kStages * kTile * ((W + 1) | 1) +
          kWarps * kTile);
}

std::atomic<int> g_sms[kMaxDevices];

// Resident blocks per SM of this instantiation at this W on this device
// (*n), queried once and cached; also opts the kernel in to more than 48 KB
// of dynamic shared memory where W needs it.
template <int MODE>
cudaError_t blocks_per_sm(int dev, int W, int* n) {
  static std::atomic<int> cache[kMaxDevices][kMaxW + 1];
  *n = cache[dev][W].load(std::memory_order_relaxed);
  if (*n) return cudaSuccess;
  const size_t smem = smem_bytes(W);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(count_blob_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(kMaxW)));
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, count_blob_kernel<MODE>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (*n < 1) return cudaErrorInvalidConfiguration;
  cache[dev][W].store(*n, std::memory_order_relaxed);
  return cudaSuccess;
}

template <int MODE>
int launch(const void* ref32, int n_ref, const void* blob, void* out, int C,
           int U, int W, int nw, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int sms = g_sms[dev].load(std::memory_order_relaxed);
  if (!sms) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sms[dev].store(sms, std::memory_order_relaxed);
  }
  int bps = 0;
  err = blocks_per_sm<MODE>(dev, W, &bps);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (static_cast<int64_t>(C) + kTile - 1) / kTile;
  const int64_t want = (tiles + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(want < static_cast<int64_t>(sms) * bps
                                        ? want
                                        : static_cast<int64_t>(sms) * bps);
  count_blob_kernel<MODE><<<grid, kThreads, smem_bytes(W), stream>>>(
      static_cast<const uint32_t*>(ref32), n_ref,
      static_cast<const int32_t*>(blob), static_cast<uint8_t*>(out), C, U, W,
      nw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes.  Launches on `stream` and returns the launch's
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a mode or
// W the kernel does not take; never synchronises.
extern "C" int bt_count_blob(const void* ref32, int n_ref, const void* blob,
                             void* out, int C, int U, int W, int nw, int mode,
                             void* stream) {
  if (C <= 0) return 0;
  if (W < 1 || W > kMaxW) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == kOneway) {
    return launch<kOneway>(ref32, n_ref, blob, out, C, U, W, nw, s);
  }
  if (mode == kMultiway) {
    return launch<kMultiway>(ref32, n_ref, blob, out, C, U, W, nw, s);
  }
  if (mode == kNt3) {
    return launch<kNt3>(ref32, n_ref, blob, out, C, U, W, nw, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
