// The dense seed index's tables on the card (sm_90a).
//
// basal_tpu builds its seed index on the host (index/seedindex.py:
// build_index, with the C++ counting sort bt_build_seed_index); this file
// builds the same four tables on the card for
// basal_tpu_torch/index/device_build.py, which holds them against the host
// build and against its plain PyTorch version on CPU tensors.
//
// The probed positions form one stream: chain 0 (the forward planes'
// blocks) then chain 1, blocks in (id, begin) order, each block from
// floor(begin/I)*I to floor((end-s)/I)*I step I, plus its sequence's anchor.
// A block with positions is a run (first stream index, first position);
// the runs are sorted by first index, so a position is a binary search away
// from its stream index.
//
//   bt_index_seeds: one thread per stream entry: its run, its position, the
//     16-base window at the position (two words of its plane), the window's
//     base-3 value over the collapsed lanes truncated to s digits (the seed,
//     bits.seeds_from_words' arithmetic in u32), keys[i] = seed,
//     vals[i] = position, and per k-mer the count and the chain-0 count by
//     atomicAdd (integer adds: the result does not depend on their order).
//   bt_index_sort: one stable radix sort of (keys, vals) by key over the
//     key's bits: within a k-mer the entries keep their stream order, so the
//     sorted vals are locs as the host lays it out (chain 0 first, each chain
//     in traversal order); starts is the exclusive prefix sum of the counts,
//     0 where a k-mer has none.
//
// Why hand-written and not torch ops: the plain version (device_build's
// _seeds_plain and _sort_plain) launches a dozen kinds of torch kernel, and
// the first use of each on the card loads its library module into the
// process: 9-100 MB of host memory each, 466 MB in all on an H100 machine,
// which the run then holds to its end.  These kernels live in the library
// the aligners load anyway (2 MB).  The radix sort and the scan are CUB's,
// built here for the one key, value and count type the index uses.
//
// At 400 Mbp (200 M entries, s 16, I 4; NVIDIA H100 80GB HBM3, 700 W) the
// seeds kernel takes 12.3 ms: it writes 8 bytes per entry and adds to two
// random counters, and the words stream through L2 at I bases a step.  The
// sort takes 5.8 ms: four 8-bit digit passes over 26 key bits, each
// reading and writing 8 bytes per entry, about 2.2 TB/s.  Both are small
// beside the 0.85 s the four tables take to come back to the host.

#include <cstdint>

#include <cub/cub.cuh>

namespace {

constexpr int kThreads = 256;

// Collapse the 16 2-bit lanes of a word (convert-to 11 -> 01) and read them
// as a base-3 number, first lane most significant (bits.xt16_base3).
__device__ __forceinline__ uint32_t base3_16(uint32_t tt) {
  tt -= (tt << 1) & tt & 0xAAAAAAAAu;
  tt -= (tt >> 2) & 0x33333333u;
  uint32_t ss = (tt & 0xF0F0F0F0u) >> 1;
  tt -= ss - (ss >> 3);
  ss = (tt & 0xFF00FF00u) >> 2;
  tt = (tt & 0x00FF00FFu) + ss + (ss >> 2) + (ss >> 6);
  return (tt & 0xFFFFu) + (tt >> 16) * 6561u;
}

__global__ void seeds_kernel(const uint32_t* __restrict__ ref0,
                             const uint32_t* __restrict__ ref1,
                             const int64_t* __restrict__ first,
                             const int64_t* __restrict__ base, int nruns0,
                             int nruns1, int64_t n0, int64_t n, int step,
                             uint32_t div, uint32_t* __restrict__ keys,
                             uint32_t* __restrict__ vals,
                             int32_t* __restrict__ counts,
                             int32_t* __restrict__ n1) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const bool chain0 = i < n0;
    const int64_t j = chain0 ? i : i - n0;
    const int64_t* f = chain0 ? first : first + nruns0;
    const int64_t* b = chain0 ? base : base + nruns0;
    int lo = 0, hi = chain0 ? nruns0 : nruns1;  // last run with f <= j
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (f[mid] <= j) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    const int64_t pos = b[lo] + step * (j - f[lo]);
    const uint32_t* r = chain0 ? ref0 : ref1;
    const int64_t w = pos >> 4;
    const uint32_t sh = static_cast<uint32_t>(pos & 15);
    const uint64_t d = (static_cast<uint64_t>(r[w]) << 32) | r[w + 1];
    const uint32_t key = base3_16(static_cast<uint32_t>(d >> (32 - 2 * sh))) /
                         div;
    keys[i] = key;
    vals[i] = static_cast<uint32_t>(pos);
    atomicAdd(counts + key, 1);
    if (chain0) atomicAdd(n1 + key, 1);
  }
}

__global__ void empty_starts_kernel(const int32_t* __restrict__ counts,
                                    int64_t* __restrict__ starts,
                                    int64_t nk) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       k < nk; k += stride) {
    if (counts[k] == 0) starts[k] = 0;
  }
}

struct Add {
  __host__ __device__ int64_t operator()(int64_t a, int64_t b) const {
    return a + b;
  }
};

int grid_for(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  return static_cast<int>(want < (1 << 20) ? want : (1 << 20));
}

}  // namespace

// Plain C entries for ctypes.  Each launches on `stream`, never
// synchronises, and returns 0 or the CUDA error.

// Zeroes counts and n1 ([nk] each), then fills keys and vals ([n], n0 of
// them chain 0) and the counts.  first/base hold chain 0's runs, then
// chain 1's, each chain's first indices starting at 0.
extern "C" int bt_index_seeds(const void* ref0, const void* ref1,
                              const void* first, const void* base,
                              int nruns0, int nruns1, int64_t n0, int64_t n,
                              int step, int seed_size, void* keys, void* vals,
                              void* counts, void* n1, int64_t nk,
                              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, nk * sizeof(int32_t), s);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(n1, 0, nk * sizeof(int32_t), s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (seed_size < 1 || seed_size > 16 || nruns0 < 0 || nruns1 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  uint32_t div = 1;
  for (int k = seed_size; k < 16; ++k) div *= 3u;
  seeds_kernel<<<grid_for(n), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(ref0), static_cast<const uint32_t*>(ref1),
      static_cast<const int64_t*>(first), static_cast<const int64_t*>(base),
      nruns0, nruns1, n0, n, step, div, static_cast<uint32_t*>(keys),
      static_cast<uint32_t*>(vals), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(n1));
  return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch bt_index_sort needs for n entries of end_bit key bits
// and nk k-mer slots; -1 when n or nk exceeds what one call takes.
extern "C" int64_t bt_index_temp_bytes(int64_t n, int64_t nk, int end_bit) {
  if (n > INT32_MAX || nk > INT32_MAX) return -1;
  size_t sort_bytes = 0, scan_bytes = 0;
  cub::DoubleBuffer<uint32_t> k(nullptr, nullptr), v(nullptr, nullptr);
  if (cub::DeviceRadixSort::SortPairs(nullptr, sort_bytes, k, v,
                                      static_cast<int>(n), 0, end_bit) !=
      cudaSuccess) {
    return -1;
  }
  if (cub::DeviceScan::ExclusiveScan(
          nullptr, scan_bytes, static_cast<const int32_t*>(nullptr),
          static_cast<int64_t*>(nullptr), Add(), int64_t{0},
          static_cast<int>(nk)) != cudaSuccess) {
    return -1;
  }
  return static_cast<int64_t>(sort_bytes > scan_bytes ? sort_bytes
                                                      : scan_bytes);
}

// Sorts (keys0, vals0) by key, stably, over bits [0, end_bit), with keys1
// and vals1 as the second buffers, and fills starts [nk] from counts.
// Returns which vals buffer holds the sorted values (0 or 1), or minus the
// CUDA error.
extern "C" int bt_index_sort(void* keys0, void* keys1, void* vals0,
                             void* vals1, int64_t n, int end_bit,
                             const void* counts, void* starts, int64_t nk,
                             void* temp, int64_t temp_bytes, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n > INT32_MAX || nk > INT32_MAX || temp_bytes < 0) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  int selector = 0;
  cudaError_t err = cudaSuccess;
  if (n > 0) {
    cub::DoubleBuffer<uint32_t> k(static_cast<uint32_t*>(keys0),
                                  static_cast<uint32_t*>(keys1));
    cub::DoubleBuffer<uint32_t> v(static_cast<uint32_t*>(vals0),
                                  static_cast<uint32_t*>(vals1));
    size_t bytes = static_cast<size_t>(temp_bytes);
    err = cub::DeviceRadixSort::SortPairs(temp, bytes, k, v,
                                          static_cast<int>(n), 0, end_bit, s);
    if (err != cudaSuccess) return -static_cast<int>(err);
    selector = v.selector;
  }
  size_t bytes = static_cast<size_t>(temp_bytes);
  err = cub::DeviceScan::ExclusiveScan(
      temp, bytes, static_cast<const int32_t*>(counts),
      static_cast<int64_t*>(starts), Add(), int64_t{0}, static_cast<int>(nk),
      s);
  if (err != cudaSuccess) return -static_cast<int>(err);
  empty_starts_kernel<<<grid_for(nk), kThreads, 0, s>>>(
      static_cast<const int32_t*>(counts), static_cast<int64_t*>(starts), nk);
  err = cudaGetLastError();
  return err == cudaSuccess ? selector : -static_cast<int>(err);
}
