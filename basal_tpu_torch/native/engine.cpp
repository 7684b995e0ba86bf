// basal_tpu native host engine (C ABI, loaded via ctypes).
//
// Implements the sequential, order-sensitive host half of the aligner at
// native speed; the mismatch counting itself runs on the TPU.  Semantics are
// an exact twin of the Python modules (basal_tpu.align.candidates /
// basal_tpu.align.replay), which remain the golden reference in tests, and
// both replicate the upstream BASAL logic:
//   seed scheduling    ReorderSeed/AdjustSeedStartArray/CountSeeds
//                                             (ref: align.cpp:468-546)
//   candidate expand   SnpAlign probe loop    (ref: align.cpp:274-316)
//   scan replay        AddHit/GapAlign/RunAlign (ref: align.cpp:228-466)
//
// Build: g++ -O2 -shared -fPIC engine.cpp -o libbasal_engine.so

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <unordered_set>
#include <thread>
#include <cstdio>

#if defined(__AVX512F__) && defined(__AVX512VPOPCNTDQ__) && defined(__AVX512VL__)
#include <immintrin.h>
#define BT_SIMD512 1
#endif
#if defined(__BMI2__)
#include <immintrin.h>
#define BT_BMI2 1
#endif

using u8 = uint8_t;
using i8 = int8_t;
using u32 = uint32_t;
using i32 = int32_t;
using u64 = uint64_t;
using i64 = int64_t;

#ifdef BT_PROF_TIMES
#include <x86intrin.h>
#include <atomic>
#endif

namespace {

#ifdef BT_PROF_TIMES  // attribution builds only (tools/aligntimes.py):
// per-phase rdtsc cycle accumulators for the fused SE host pass.  Padded
// per-thread rows (worker threads are short-lived; ids wrap mod 64 and the
// reader sums every row) — a shared atomic per scope contends across the
// 4 workers and inflates the measured phases.  Production builds compile
// none of this.
struct alignas(64) BtProfRow { u64 c[5]; };  // 0=fill 1=sched 2=enum 3=scan 4=emit
BtProfRow bt_prof_rows[64] = {};
std::atomic<int> bt_prof_ntid{0};
thread_local int bt_prof_tid = -1;
struct BtProfScope {
    int slot; u64 t0;
    BtProfScope(int s) : slot(s), t0(__rdtsc()) {}
    ~BtProfScope() {
        if (bt_prof_tid < 0) bt_prof_tid = bt_prof_ntid++ & 63;
        bt_prof_rows[bt_prof_tid].c[slot] += __rdtsc() - t0;
    }
};
#define BT_PROF_SCOPE(slot) BtProfScope bt_prof_scope_##slot(slot)
#else
#define BT_PROF_SCOPE(slot)
#endif

constexpr int MAXSNPS = 15;
constexpr int KPOS = 14;

// Reference xseed_array/xseedreg_array capacity (align.h:90: fixed
// [2][FIXSIZE - SEGLEN] = [2][480] per-thread buffers).  Reads write only
// offsets [0, L-s]; a read with (map_len - I + 1) % s == 0 skips the
// best-offset search, so the previous read's start offset leaks into
// AdjustSeedStartArray (align.cpp:500-524) and its probes index the buffer
// BEYOND the current read's range — consuming the previous longer read's
// seed values (zeros on first touch: the oracle's SingleAlign heap pages
// arrive zeroed).  The persistent seed_state/reg_state buffers replicate
// that serial behavior exactly.
constexpr i32 STALE_N = 480;

struct Shared {
    // read batch
    i32 B;
    i32 S;                 // seed-offset array stride
    const u32* seedval;    // [B,2,S]
    const u8* has_n;       // [B,2,S]
    const i32* n_offsets;  // [B]
    const i32* map_len;    // [B]
    const i32* seedseg;    // [B]
    const u8* xflag;       // [B,2]
    const u8* filtered;    // [B]
    const u32* read_index; // [B]
    // seed index
    const i64* starts;
    const i32* counts;
    const i32* n1;
    const u32* locs;
    // params
    i32 I, s, gap, gap_edge, max_num_hits, nt3;
    i64 max_kmer_num;
    u32 randseed;
    const i64* profile;    // [16,16] row-major
    i64 prof_stride;
};

// myrand splittable hash (ref: utilities.cpp:38-48)
static inline u32 myrand_hash(u32 idx, u32 randseed) {
    u64 v = (u64)idx + (u32)(randseed * 1000000u);
    v = v * 3935559000370003845ULL + 2691343689449507681ULL;
    v ^= v >> 21; v ^= v << 37; v ^= v >> 4;
    v *= 4768777513237032717ULL;
    v ^= v << 20; v ^= v >> 41; v ^= v << 5;
    return (u32)(v & 0xffffffffULL);
}

// CountSeeds (ref: align.cpp:526-540): u32-wrapping sum, sticky <<12 N
// weight.  ``cc`` is the per-read prefetched counts cache (counts[] is a
// 3^16-slot table; uncached lookups are ~100 DRAM misses per read).
// Offsets beyond the read's own range [0, L-s] read the persistent stale
// buffers st_sd/st_hn (see STALE_N) — uncached counts lookups, but the
// stale path is rare (mixed-length batches only).
static inline u32 count_seeds(const Shared& sh, const u32* cc, const u8* hn,
                              const u32* st_sd, const u8* st_hn,
                              i32 n_off, i32 seg, i32 start) {
    u32 total = 0;
    u32 k = 0;
    for (i32 i = 0; i < sh.I; ++i) {
        i64 off = sh.profile[seg * sh.prof_stride + i] + start - i;
        if (off < 0 || off >= STALE_N) continue;  // past even the ref buffer
        u32 c;
        if (off < n_off) {
            if (hn[off]) k = 12;
            c = cc[off];
        } else {
            if (st_hn[off]) k = 12;
            c = (u32)sh.counts[st_sd[off]];
        }
        total += c << k;
    }
    if (total == 0) total = 9999999u;
    return total;
}

// gather counts[sv[lo..hi]] (cf. the reference's PREFETCH_CAL_UNIT pattern,
// refbase.cpp:303-325).  Hardware gathers keep 16 loads in flight — the
// counts table is 3^16 slots and every access is effectively a DRAM+TLB
// miss, so load-level parallelism is the whole game here.
static inline void gather_counts(const i32* counts, const u32* sv,
                                 i32 lo, i32 hi_incl, u32* cc) {
#if defined(BT_SIMD512) && defined(BT_GATHER_COUNTS)
    for (i32 i = lo; i <= hi_incl; i += 16) {
        i32 n = hi_incl + 1 - i;
        __mmask16 m = n >= 16 ? (__mmask16)0xFFFF : (__mmask16)((1u << n) - 1);
        __m512i idx = _mm512_maskz_loadu_epi32(m, sv + i);
        __m512i v = _mm512_mask_i32gather_epi32(_mm512_setzero_si512(), m,
                                                idx, counts, 4);
        _mm512_mask_storeu_epi32(cc + i, m, v);
    }
#else
    const i32 PF = 12;
    for (i32 i = lo; i <= hi_incl; ++i) {
        if (i + PF <= hi_incl) __builtin_prefetch(counts + sv[i + PF], 0, 0);
        cc[i] = (u32)counts[sv[i]];
    }
#endif
}

// Fill only the offsets the scheduler can touch: for each segment,
// profile[seg][i] + start - i with start in [0, cap] where cap bounds every
// probed start (max_offset, plus the incoming sticky state — when
// max_offset == 0 the best-offset search is skipped and the previous
// read's offset leaks through, so starts up to that stale value occur).
static inline void fill_count_cache(const Shared& sh, const u32* sv,
                                    i32 n_off, i32 segnum, i32 cap,
                                    u32* cc) {
    BT_PROF_SCOPE(0);
#ifdef BT_PROF_NOGATHER  // attribution builds only (tools/buildprof.py)
    for (i32 i = 0; i < n_off; ++i) cc[i] = 1;
    if (true) return;
#endif
    i32 ranges[2 * (MAXSNPS + 1)];
    i32 nr = 0;
    for (i32 seg = 0; seg < segnum && seg <= MAXSNPS; ++seg) {
        i64 lo = INT64_MAX, hi = INT64_MIN;
        for (i32 i = 0; i < sh.I; ++i) {
            i64 v = sh.profile[seg * sh.prof_stride + i] - i;
            if (v < lo) lo = v;
            if (v + cap > hi) hi = v + cap;
        }
        if (lo < 0) lo = 0;
        if (hi > n_off - 1) hi = n_off - 1;
        if (lo <= hi) { ranges[nr++] = (i32)lo; ranges[nr++] = (i32)hi; }
    }
    // prefetch everything first (the short per-segment ranges defeat a
    // per-range prefetch pipeline; issuing all misses up front restores
    // the memory-level parallelism of the old full-range sweep)
    for (i32 k = 0; k < nr; k += 2)
        for (i32 i = ranges[k]; i <= ranges[k + 1]; ++i)
            __builtin_prefetch(sh.counts + sv[i], 0, 0);
    for (i32 k = 0; k < nr; k += 2)
        gather_counts(sh.counts, sv, ranges[k], ranges[k + 1], cc);
}

struct Sched {
    i32 start_arr[MAXSNPS + 1];
    i32 order[MAXSNPS + 1];
    bool active;
};

// NOTE (negative A/B, aligntimes): issuing the NEXT read's count-table
// prefetches right after schedule_read (a 1-deep software pipeline) made
// the fused pass SLOWER (0.71 -> 0.85 us/read instrumented): the extra
// stream competes with the enumerate/scan prefetches for the core's ~12
// fill buffers, and loading the next read's seedval row to compute the
// addresses stalls up front.  fill_count_cache's own up-front batched
// prefetch + hardware gather already extracts the available MLP.

// ReorderSeed + AdjustSeedStartArray (ref: align.cpp:468-524)
// ``cc2`` receives each chain's counts cache for reuse by the caller.
// ``seed_state``/``reg_state`` are the [2][STALE_N] stale buffers (see
// STALE_N comment), read-only here.
static void schedule_read(const Shared& sh, i32 r, i32* start_offset_state,
                          const u32* seed_state, const u8* reg_state,
                          Sched out[2], u32* cc2) {
    i32 L = sh.map_len[r];
    i32 segnum = sh.seedseg[r];
    i32 max_offset = (L - sh.I + 1) % sh.s;
    for (int chain = 0; chain < 2; ++chain) {
        out[chain].active = sh.xflag[r * 2 + chain] != 0;
        if (!out[chain].active) continue;
        const u32* sv = sh.seedval + ((i64)r * 2 + chain) * sh.S;
        const u8* hn = sh.has_n + ((i64)r * 2 + chain) * sh.S;
        const u32* st_sd = seed_state + (i64)chain * STALE_N;
        const u8* st_hn = reg_state + (i64)chain * STALE_N;
        i32 n_off = sh.n_offsets[r];
        u32* cc = cc2 + (i64)chain * sh.S;
        i32 cap = std::max(max_offset, start_offset_state[chain]);
        fill_count_cache(sh, sv, n_off, segnum, cap, cc);
#ifdef BT_PROF_NOSCHED  // attribution builds only (tools/buildprof.py)
        for (i32 i = 0; i < segnum; ++i) {
            out[chain].start_arr[i] = 0;
            out[chain].order[i] = i;
        }
        continue;
#endif
        BT_PROF_SCOPE(1);
        if (max_offset > 0) {
            u32 best = 0xffffffffu;
            for (i32 i = 0; i < max_offset; ++i) {
                u32 tt = 0;
                for (i32 seg = 0; seg < segnum; ++seg)
                    tt += count_seeds(sh, cc, hn, st_sd, st_hn, n_off, seg, i);
                if (tt < best) { best = tt; start_offset_state[chain] = i; }
            }
        }
        i32* sa = out[chain].start_arr;
        for (i32 i = 0; i < segnum; ++i) sa[i] = start_offset_state[chain];
        // outside-in relaxation
        for (i32 i = 0; i < segnum; ++i) {
            i32 ptr = (i % 2 == 0) ? i / 2 : segnum - 1 - i / 2;
            i32 lo = (ptr == 0) ? 0 : sa[ptr - 1];
            i32 hi = (ptr == segnum - 1) ? max_offset : sa[ptr + 1];
            u32 total = 0xffffffffu;
            sa[ptr] = lo;
            for (i32 ii = lo; ii <= hi; ++ii) {
                u32 tt = count_seeds(sh, cc, hn, st_sd, st_hn, n_off, ptr, ii);
                if (tt < total) { total = tt; sa[ptr] = ii; }
            }
        }
        // sort segments by (count-as-int, segid)
        std::pair<i32, i32> keys[MAXSNPS + 1];
        for (i32 seg = 0; seg < segnum; ++seg)
            keys[seg] = { (i32)count_seeds(sh, cc, hn, st_sd, st_hn, n_off, seg, sa[seg]), seg };
        std::sort(keys, keys + segnum);
        for (i32 seg = 0; seg < segnum; ++seg) out[chain].order[seg] = keys[seg].second;
    }
}

// Candidate group (one seed probe); mirrors basal_tpu.align.candidates.CandGroup
// ``loff`` = starts[seed] resolved AT BUILD TIME: stale-path probes (see
// schedule_read) read seed values from the persistent stale buffer, which
// later reads overwrite — consumers must not re-derive the seed from
// enc.seedval[h].
struct Group {
    i64 read, chain, mode, seg, h, start, m, mc, jj0, loff;
};
static_assert(sizeof(Group) == 10 * 8, "group layout");

}  // namespace

extern "C" {

#ifdef BT_PROF_TIMES  // attribution builds only (tools/aligntimes.py)
void bt_prof_times(u64* out5, i32 reset) {
    for (int i = 0; i < 5; ++i) out5[i] = 0;
    for (int t = 0; t < 64; ++t)
        for (int i = 0; i < 5; ++i) {
            out5[i] += bt_prof_rows[t].c[i];
            if (reset) bt_prof_rows[t].c[i] = 0;
        }
}
#endif

// Pass 1 (fill=0): returns needed candidate capacity, sets *out_ngroups.
// Pass 2 (fill=1): fills cand/group buffers.  start_offset_state must hold
// the same initial values for both passes (caller snapshots/restores).
i64 bt_build_candidates(
    i32 B, i32 S,
    const u32* seedval, const u8* has_n, const i32* n_offsets,
    const i32* map_len, const i32* seedseg, const u8* xflag,
    const u8* filtered, const u32* read_index,
    const i64* starts, const i32* counts, const i32* n1, const u32* locs,
    i32 I, i32 s, i64 max_kmer_num, u32 randseed,
    const i64* profile, i64 prof_stride,
    i32* start_offset_state,
    u32* seed_state /*[2*STALE_N]*/, u8* reg_state /*[2*STALE_N]*/,
    i32 fill,
    i32* cand_loc, i8* cand_plane, i32* cand_row,
    Group* groups, i64* group_offsets /*[B+1]*/, i64* out_ngroups)
{
    Shared sh{B, S, seedval, has_n, n_offsets, map_len, seedseg, xflag,
              filtered, read_index, starts, counts, n1, locs,
              I, s, 0, 0, 0, 0, max_kmer_num, randseed, profile, prof_stride};
    i64 flat = 0, ng = 0;
    Sched sc[2];
    std::vector<u32> cc2((i64)2 * S);
    for (i32 r = 0; r < B; ++r) {
        if (group_offsets) group_offsets[r] = ng;
        if (filtered[r]) continue;
        // ConvertBinarySeq effect (align.cpp:153-226): every unfiltered
        // read overwrites the enabled chains' buffers at [0, L-s] — even
        // reads with no seed segments (RunAlign converts before probing).
        {
            i32 nc = std::min(n_offsets[r], STALE_N);
            for (int chain = 0; chain < 2; ++chain) {
                if (!xflag[r * 2 + chain] || nc <= 0) continue;
                memcpy(seed_state + (i64)chain * STALE_N,
                       seedval + ((i64)r * 2 + chain) * S, (size_t)nc * 4);
                memcpy(reg_state + (i64)chain * STALE_N,
                       has_n + ((i64)r * 2 + chain) * S, (size_t)nc);
            }
        }
        if (seedseg[r] <= 0) {
            // ReorderSeed still runs with 0 segments: GetTotalSeedLoc
            // returns 0 for every probe start, so the best-offset search
            // (when max_offset > 0) resets the sticky start to 0
            // (align.cpp:475-480).
            if ((map_len[r] - I + 1) % s > 0)
                for (int chain = 0; chain < 2; ++chain)
                    if (xflag[r * 2 + chain]) start_offset_state[chain] = 0;
            continue;
        }
        schedule_read(sh, r, start_offset_state, seed_state, reg_state,
                      sc, cc2.data());
        u32 rv = myrand_hash(read_index[r], randseed);
        for (int chain = 0; chain < 2; ++chain) {
            if (!sc[chain].active) continue;
            const u32* sv = seedval + ((i64)r * 2 + chain) * S;
            const u32* cc = cc2.data() + (i64)chain * S;
            const u32* st_sd = seed_state + (i64)chain * STALE_N;
            i32 n_off = n_offsets[r];
            for (i32 mode = 0; mode < seedseg[r]; ++mode) {
                i32 seg = sc[chain].order[mode];
                for (i32 i = 0; i < I; ++i) {
                    i64 off = profile[seg * prof_stride + i]
                              + sc[chain].start_arr[seg] - i;
                    u32 sd;
                    i64 m;
                    if (off < n_off) {
                        sd = sv[off];
                        m = cc[off];
                    } else if (off < STALE_N) {
                        sd = st_sd[off];  // stale-buffer probe (see STALE_N)
                        m = counts[sd];
                    } else {
                        continue;  // past even the reference's 480 entries
                    }
                    if (m == 0 || m > max_kmer_num) continue;
                    i64 h = off;  // h == seed offset in read (profile+start-i)
                    if (fill == 1) {
                        const u32* lp = locs + starts[sd];
                        for (i64 j = 0; j < m; ++j) {
                            cand_loc[flat + j] = (i32)((i64)lp[j] - h);
                            cand_plane[flat + j] = (i8)(j >= n1[sd] ? 1 : 0);
                            cand_row[flat + j] = r * 2 + chain;
                        }
                    }
                    if (fill)  // 1: full, 2: groups only (lazy)
                        groups[ng] = Group{r, chain, mode, seg, h, flat, m,
                                           (i64)n1[sd] - 1, (i64)(rv % (u32)m),
                                           starts[sd]};
                    flat += m;
                    ++ng;
                }
            }
        }
    }
    if (group_offsets) group_offsets[B] = ng;
    *out_ngroups = ng;
    return flat;
}

// RRBS candidate build (SnpAlign RRBS branch + ReorderSeed RRBS branch,
// align.cpp:233-273, 473, 486-487): start offset fixed at (L % s) * chain,
// no Adjust pass, ONE probe per segment (profile[seg][0] + start), and
// every index entry of the probed k-mer becomes a candidate — entries whose
// (mode, orientation) do not match or whose loc < h are emitted SKIPPED
// (cand_skip=1, loc=12800 inside the margins) so the random-start rotation
// indexes stay aligned with the reference's scan.  The index arrays are
// the RRBS layout: starts/n1 per k-mer entry CSR, chrmode packing
// chr_plane | mode<<16 | opp<<24, locs plane-local (index/rrbs.py).
// counts for CountSeeds are index n1 (align.cpp:534).  Serial over reads
// (the stale-buffer refresh is order-dependent exactly like WGBS).
// pass fill=0: returns needed candidate capacity + *out_ngroups; caller
// snapshots/restores seed_state/reg_state between passes.
i64 bt_build_candidates_rrbs(
    i32 B, i32 S,
    const u32* seedval, const u8* has_n, const i32* n_offsets,
    const i32* map_len, const i32* seedseg, const u8* xflag,
    const u8* filtered, const u32* read_index,
    const i64* starts, const i32* counts, const i32* n1, const u32* locs,
    i32 I, i32 s, i64 max_kmer_num, u32 randseed,
    const i64* profile, i64 prof_stride,
    i32* start_offset_state,
    u32* seed_state /*[2*STALE_N]*/, u8* reg_state /*[2*STALE_N]*/,
    const u32* chrmode, const i64* anchors,
    i32 fill,
    i32* cand_loc, i8* cand_plane, u8* cand_skip, i32* cand_row,
    Group* groups, i64* group_offsets /*[B+1]*/, i64* out_ngroups)
{
    (void)start_offset_state;  // RRBS start is fixed; no sticky state
    Shared sh{B, S, seedval, has_n, n_offsets, map_len, seedseg, xflag,
              filtered, read_index, starts, counts, n1, locs,
              I, s, 0, 0, 0, 0, max_kmer_num, randseed, profile, prof_stride};
    i64 flat = 0, ng = 0;
    std::vector<u32> cc((i64)S);
    for (i32 r = 0; r < B; ++r) {
        if (group_offsets) group_offsets[r] = ng;
        if (filtered[r]) continue;
        {   // ConvertBinarySeq effect (see bt_build_candidates)
            i32 nc = std::min(n_offsets[r], STALE_N);
            for (int chain = 0; chain < 2; ++chain) {
                if (!xflag[r * 2 + chain] || nc <= 0) continue;
                memcpy(seed_state + (i64)chain * STALE_N,
                       seedval + ((i64)r * 2 + chain) * S, (size_t)nc * 4);
                memcpy(reg_state + (i64)chain * STALE_N,
                       has_n + ((i64)r * 2 + chain) * S, (size_t)nc);
            }
        }
        i32 segnum = seedseg[r];
        if (segnum <= 0) continue;
        i32 L = map_len[r];
        u32 rv = myrand_hash(read_index[r], randseed);
        i32 n_off = n_offsets[r];
        for (int chain = 0; chain < 2; ++chain) {
            if (!xflag[r * 2 + chain]) continue;
            const u32* sv = seedval + ((i64)r * 2 + chain) * S;
            const u8* hn = has_n + ((i64)r * 2 + chain) * S;
            const u32* st_sd = seed_state + (i64)chain * STALE_N;
            const u8* st_hn = reg_state + (i64)chain * STALE_N;
            i32 start = (L % s) * chain;
            fill_count_cache(sh, sv, n_off, segnum, start, cc.data());
            std::pair<i32, i32> keys[MAXSNPS + 1];
            for (i32 seg = 0; seg < segnum; ++seg)
                keys[seg] = { (i32)count_seeds(sh, cc.data(), hn, st_sd,
                                               st_hn, n_off, seg, start),
                              seg };
            std::sort(keys, keys + segnum);
            for (i32 mode = 0; mode < segnum; ++mode) {
                i32 seg = keys[mode].second;
                i32 cmode = chain == 0 ? seg : L / s - 1 - seg;
                i64 off = profile[seg * prof_stride + 0] + start;
                u32 sd;
                if (off < n_off) sd = sv[off];
                else if (off < STALE_N) sd = st_sd[off];
                else continue;  // past even the reference's 480 entries
                i64 lo = starts[sd];
                i64 m = n1[sd];
                if (m == 0) continue;
                if (fill) {
                    Group& g = groups[ng];
                    g.read = r; g.chain = chain; g.mode = mode; g.seg = seg;
                    g.h = off; g.start = flat; g.m = m; g.mc = m;
                    g.jj0 = (i64)(rv % (u32)m); g.loff = lo;
                    for (i64 e = 0; e < m; ++e) {
                        u32 cm = chrmode[lo + e];
                        u32 lc = locs[lo + e];
                        bool ok = (i32)((cm ^ ((u32)chain << 24)) >> 16)
                                      == cmode
                                  && (i64)lc >= off;
                        u32 chrplane = cm & 0xFFFFu;
                        cand_loc[flat + e] =
                            ok ? (i32)(anchors[chrplane >> 1]
                                       + (i64)lc - off)
                               : 12800;
                        cand_plane[flat + e] = (i8)(chrplane & 1u);
                        cand_skip[flat + e] = ok ? 0 : 1;
                        cand_row[flat + e] = 2 * r + chain;
                    }
                }
                ++ng;
                flat += m;
            }
        }
    }
    if (group_offsets) group_offsets[B] = ng;
    *out_ngroups = ng;
    return flat;
}

// Lazily materialize the candidate arrays of a SUBSET of groups into a
// compact buffer (the repeat-heavy genomes make eager full enumeration
// prohibitively large; waves only ever evaluate a fraction).
// pass 0: return total compact size.  pass 1: fill cand arrays and write
// out_off[gi] = base + compact offset for each selected group.
i64 bt_fill_groups(
    const Group* groups, const i64* sel, i64 n_sel,
    const u32* locs,
    i32 pass, i64 base,
    i32* cand_loc, i8* cand_plane, i32* cand_row,
    i64* out_off)
{
    i64 cur = 0;
    for (i64 k = 0; k < n_sel; ++k) {
        i64 gi = sel[k];
        const Group& g = groups[gi];
        if (pass == 1) {
            const u32* lp = locs + g.loff;  // seed resolved at build time
            for (i64 j = 0; j < g.m; ++j) {
                cand_loc[cur + j] = (i32)((i64)lp[j] - g.h);
                cand_plane[cur + j] = (i8)(j > g.mc ? 1 : 0);
                cand_row[cur + j] = (i32)(g.read * 2 + g.chain);
            }
            out_off[gi] = base + cur;
        }
        cur += g.m;
    }
    return cur;
}

// ---- scan-state machinery shared by the SE and PE replays ----------------
// (kept inside extern "C" but with internal linkage via static)

// On-demand candidate evaluation context (nullable).  When a group was
// never bulk-materialized (counts_off[gi] < 0), the scan computes each
// candidate's mismatch count AT VISIT TIME with these tables — so the
// scan's own abort logic (w-caps, pigeonhole stop, max_num_hits) bounds
// the evaluated volume exactly like the reference's per-candidate extension
// (align.cpp:274-316), instead of eagerly evaluating whole mega-groups.
// Gapped scans additionally need lenmaskP/readlen (non-null) for the lazy
// MismatchPattern0/1 extraction in gap_align_ev.
struct EvalCtx {
    const u32* ref32;                     // [2, nw] both planes
    i64 nw;
    const u32 *baseP, *validP, *mreadP;   // [2B, W] read planes
    const i32* ncnt;                      // [2B] N-count additive term
    i32 W, mode;                          // 0 oneway, 1 multiway, 2 nt3
    const u32* locs;                      // index CSR locations (group.loff
                                          // holds the resolved list start)
    const u32* lenmaskP = nullptr;        // [2B, W] read-length mask plane
    const i32* readlen = nullptr;         // [2B] map_readlen per row
};

struct RefCtx {
    const i64 *anchors, *rc_off, *sizes;
    i32 n_chr;
    const i32 *counts_dev, *pos0, *pos1;
    const i32* cand_loc;
    i32 seed_size, gap, gap_edge, max_num_hits, nt3;
    const EvalCtx* ev = nullptr;
    // RRBS (SnpAlign RRBS branch, align.cpp:233-273): per-candidate ref
    // plane (entries can land on either strand) and entry skip mask
    // (mode/orientation mismatch or loc < h) — null for WGBS scans
    const i8* rr_plane = nullptr;
    const u8* rr_skip = nullptr;
};

static inline u32 sxc32_(u32 t) { return ((~t) << 1) | t | 0x55555555u; }
static inline u32 sm2j_(u32 t) {
    return t & (((t & 0xAAAAAAAAu) >> 1) | ((t & 0x55555555u) << 1));
}
static inline u32 sxt32_(u32 t) { return t - ((t << 1) & t & 0xAAAAAAAAu); }
static inline i32 sxm32_(u32 t) {
    u32 x = (t | (t >> 1)) & 0x55555555u;
    x = (x + (x >> 2)) & 0x33333333u;
    x = (x + (x >> 4)) & 0x0F0F0F0Fu;
    return (i32)((x * 0x01010101u) >> 24);
}

// conversion-rule mismatch flags for one aligned word (the scalar core of
// CountMismatch[_new], align.h:118-239): mode 0 oneway, 1 multiway, 2 nt3
static inline u32 sflag_(u32 a, u32 b, u32 mr, i32 mode) {
    if (mode == 0) return (b & sxc32_(a)) ^ a;
    if (mode == 1) {
        u32 m2 = sxc32_(a) | mr;
        u32 m3 = sm2j_(m2);
        return (((~m3) & m2) | (m3 & b)) ^ a;
    }
    return b ^ sxt32_(a);
}

#ifdef BT_SIMD512
// Vectorized W-word conversion-masked mismatch count for ONE candidate:
// lanes = u32 words of the read register file.  Bit-identical algebra to
// the scalar loop; no early exit — full accumulation then clamp at 255
// gives the same result as the scalar's `cnt > 255` break.  Loads are
// lane-masked, and the packed reference carries 800-u32-word margins on
// both sides (index/reference.py, REF_MARGIN), so R[w+1] stays in bounds.
static inline i32 count_words_simd(const u32* R, u32 sh,
                                   const u32* b, const u32* v, const u32* mr,
                                   i32 W, i32 mode, i32 cnt) {
    const __m512i c5 = _mm512_set1_epi32(0x55555555);
    const __m512i cA = _mm512_set1_epi32((int)0xAAAAAAAAu);
    const __m512i ones = _mm512_set1_epi32(-1);
    const __m512i vsh = _mm512_set1_epi32((int)sh);
    const __m512i vsh2 = _mm512_set1_epi32((int)(32 - sh));  // 32 -> srlv = 0
    __m512i acc = _mm512_setzero_si512();
    for (i32 w = 0; w < W; w += 16) {
        __mmask16 m = (W - w >= 16) ? (__mmask16)0xFFFF
                                    : (__mmask16)((1u << (W - w)) - 1);
        __m512i r0 = _mm512_maskz_loadu_epi32(m, R + w);
        __m512i r1 = _mm512_maskz_loadu_epi32(m, R + w + 1);
        __m512i a = _mm512_or_si512(_mm512_sllv_epi32(r0, vsh),
                                    _mm512_srlv_epi32(r1, vsh2));
        __m512i bw = _mm512_maskz_loadu_epi32(m, b + w);
        __m512i vw = _mm512_maskz_loadu_epi32(m, v + w);
        __m512i f;
        if (mode == 0) {
            // xc(a) = ((~a)<<1) | a | 0x5555...
            __m512i xc = _mm512_or_si512(_mm512_or_si512(
                _mm512_slli_epi32(_mm512_andnot_si512(a, ones), 1), a), c5);
            f = _mm512_xor_si512(_mm512_and_si512(bw, xc), a);
        } else if (mode == 1) {
            __m512i mrw = _mm512_maskz_loadu_epi32(m, mr + w);
            __m512i xc = _mm512_or_si512(_mm512_or_si512(
                _mm512_slli_epi32(_mm512_andnot_si512(a, ones), 1), a), c5);
            __m512i m2 = _mm512_or_si512(xc, mrw);
            // m2j(t) = t & (((t&A)>>1) | ((t&5)<<1))
            __m512i m3 = _mm512_and_si512(m2, _mm512_or_si512(
                _mm512_srli_epi32(_mm512_and_si512(m2, cA), 1),
                _mm512_slli_epi32(_mm512_and_si512(m2, c5), 1)));
            f = _mm512_xor_si512(_mm512_or_si512(
                _mm512_andnot_si512(m3, m2), _mm512_and_si512(m3, bw)), a);
        } else {
            // xt(a) = a - ((a<<1) & a & A)
            __m512i t = _mm512_and_si512(
                _mm512_and_si512(_mm512_slli_epi32(a, 1), a), cA);
            f = _mm512_xor_si512(bw, _mm512_sub_epi32(a, t));
        }
        __m512i t2 = _mm512_and_si512(f, vw);
        __m512i x = _mm512_and_si512(
            _mm512_or_si512(t2, _mm512_srli_epi32(t2, 1)), c5);
        acc = _mm512_add_epi32(acc, _mm512_popcnt_epi32(x));
    }
    cnt += _mm512_reduce_add_epi32(acc);
    return cnt > 255 ? 255 : cnt;
}
#endif

static inline i32 eval_cand(const EvalCtx* ev, i32 lc, int plane, i64 r) {
    const u32* R = ev->ref32 + (plane ? ev->nw : 0) + (lc >> 4);
    u32 sh = ((u32)lc & 15u) << 1;
    const u32* b = ev->baseP + r * ev->W;
    const u32* v = ev->validP + r * ev->W;
    const u32* mr = ev->mreadP + r * ev->W;
    i32 cnt = ev->ncnt[r];
#ifdef BT_SIMD512
    return count_words_simd(R, sh, b, v, mr, ev->W, ev->mode, cnt);
#endif
    for (i32 w = 0; w < ev->W; ++w) {
        u32 a = sh ? ((R[w] << sh) | (R[w + 1] >> (32 - sh))) : R[w];
        u32 f;
        if (ev->mode == 0) {
            f = (b[w] & sxc32_(a)) ^ a;
        } else if (ev->mode == 1) {
            u32 m2 = sxc32_(a) | mr[w];
            u32 m3 = sm2j_(m2);
            f = (((~m3) & m2) | (m3 & b[w])) ^ a;
        } else {
            f = b[w] ^ sxt32_(a);
        }
        cnt += sxm32_(f & v[w]);
        if (cnt > 255) break;
    }
    return cnt > 255 ? 255 : cnt;
}

// Lazy mismatch-position extraction for gapped visit-time evaluation
// (MismatchPattern0/1, align.h:133-196), value-identical to the device
// kernel's pos0/pos1 (ops/extend.py _first_positions): positions of set
// mismatch lanes masked by the read-length plane, ascending read position
// (pattern 0) or ascending distance-from-end (pattern 1, reported as
// L-1-p), first KPOS, padded with map_readlen.
static inline void mm_pattern0(const EvalCtx* ev, i32 lc, int plane, i64 r,
                               i32* out) {
    const u32* R = ev->ref32 + (plane ? ev->nw : 0) + (lc >> 4);
    u32 sh = ((u32)lc & 15u) << 1;
    const u32* b = ev->baseP + r * ev->W;
    const u32* mr = ev->mreadP + r * ev->W;
    const u32* lm = ev->lenmaskP + r * ev->W;
    const i32 L = ev->readlen[r];
    i32 n = 0;
    for (i32 w = 0; w < ev->W && n < KPOS; ++w) {
        u32 a = sh ? ((R[w] << sh) | (R[w + 1] >> (32 - sh))) : R[w];
        u32 f = sflag_(a, b[w], mr[w], ev->mode) & lm[w];
        u32 x = (f | (f >> 1)) & 0x55555555u;
        while (x && n < KPOS) {
            i32 clz = __builtin_clz(x);         // lane 0 = bits 31:30
            out[n++] = w * 16 + ((clz - 1) >> 1);
            x &= ~(0x80000000u >> clz);
        }
    }
    for (; n < KPOS; ++n) out[n] = L;
}

static inline void mm_pattern1(const EvalCtx* ev, i32 lc, int plane, i64 r,
                               i32* out) {
    const u32* R = ev->ref32 + (plane ? ev->nw : 0) + (lc >> 4);
    u32 sh = ((u32)lc & 15u) << 1;
    const u32* b = ev->baseP + r * ev->W;
    const u32* mr = ev->mreadP + r * ev->W;
    const u32* lm = ev->lenmaskP + r * ev->W;
    const i32 L = ev->readlen[r];
    i32 n = 0;
    for (i32 w = ev->W - 1; w >= 0 && n < KPOS; --w) {
        u32 a = sh ? ((R[w] << sh) | (R[w + 1] >> (32 - sh))) : R[w];
        u32 f = sflag_(a, b[w], mr[w], ev->mode) & lm[w];
        u32 x = (f | (f >> 1)) & 0x55555555u;
        while (x && n < KPOS) {
            i32 ctz = __builtin_ctz(x);         // highest lane index first
            out[n++] = L - 1 - (w * 16 + ((30 - ctz) >> 1));
            x &= x - 1;
        }
    }
    for (; n < KPOS; ++n) out[n] = L;
}

struct H { i32 chr, loc, gsz, gpos; };

struct ScanState {
    const RefCtx* cx;
    const Group* groups;
    const i64* counts_off = nullptr;  // logical group -> compact buffer base
    i64 g_lo, g_hi;
    i32 L, rms, snp_thres, segnum;
    i64 n_eval = 0;                   // visit-time evaluations (stats only)
    std::vector<H> buckets[2][MAXSNPS + 1];
    std::unordered_set<u64> seen;
    bool last_abort = false;

    void init(const RefCtx* c, const Group* gr, i64 lo, i64 hi,
              i32 L_, i32 rms_, i32 segnum_) {
        cx = c; groups = gr; g_lo = lo; g_hi = hi;
        L = L_; rms = rms_; snp_thres = rms_; segnum = segnum_;
        for (int ch = 0; ch < 2; ++ch)
            for (int w = 0; w <= MAXSNPS; ++w) buckets[ch][w].clear();
        seen.clear();
        last_abort = false;
    }

    // int2hit (ref: align.cpp:319-346)
    void resolve(i32 loc_cat, int plane, i32 gsz, i32 gpos, H& out_h) const {
        i32 lo = 0, hi = cx->n_chr;
        while (lo < hi - 1) {
            i32 mid = (lo + hi) / 2;
            if ((i64)loc_cat >= cx->anchors[mid]) lo = mid; else hi = mid;
        }
        i64 local = (i64)loc_cat - cx->anchors[lo];
        i32 gp = gpos;
        if (plane) {
            local = cx->rc_off[lo] - L - local;
            gp = L + (gsz < 0 ? gsz : 0) - gpos;
            local -= gsz;
        }
        out_h = H{(i32)(2 * lo + plane), (i32)local, gsz, gp};
    }

    // AddHit (ref: align.cpp:329-347); 1 => abort current SnpAlign call
    int add_hit(int chain, i32 w, const H& h) {
        if (h.loc < 0) return 0;
        if ((u32)h.loc + (u32)L > (u64)cx->sizes[h.chr >> 1]) return 0;
        u64 key = ((u64)(h.gsz != 0) << 63) | ((u64)(u32)(h.chr >> 1) << 32)
                  | (u64)(u32)h.loc;
        if (!seen.insert(key).second) return 0;
        buckets[chain][w].push_back(h);
        if ((i32)(buckets[0][w].size() + buckets[1][w].size())
            >= cx->max_num_hits) {
            if (w == 0) return 1;
            snp_thres = w - 1;
        }
        return 0;
    }

    // GapAlign (ref: align.cpp:348-410).  ``p1_of(pctx, tt)`` supplies the
    // shifted-window mismatch pattern for shift index tt — a pointer into
    // the materialized pos1 buffer, or a lazily computed stack buffer for
    // visit-time evaluation (gap_align_ev).  (Function pointer, not a
    // template: this block has C linkage.)
    int gap_align_core(const i32* p0,
                       const i32* (*p1_of)(void*, i32), void* pctx,
                       int chain, int plane,
                       i32 loc_cat, i64 seed_pos) {
        if (snp_thres < 2) return 0;
        i32 ret0 = p0[snp_thres - 2];
        if (ret0 < (i32)(seed_pos + cx->seed_size)) return 0;
        const i32 gap2 = 2 * cx->gap;
        for (i32 tt = 1; tt <= gap2; ++tt) {
            i32 t = (tt + 1) / 2;
            i32 shift = (1 - (tt % 2) * 2) * t;
            i32 shift1 = shift < 0 ? shift : 0;
            if (snp_thres < 1 + t) break;
            i32 rl = L - t - 1;
            const i32* mmi2 = p1_of(pctx, tt);
            for (i32 i = 0; i < snp_thres - t; ++i) {
                i32 gpos = p0[i];
                if (gpos < cx->gap_edge || gpos >= rl) continue;
                for (i32 j = 0; j < snp_thres - t - i; ++j) {
                    i32 m2 = mmi2[j];
                    if (m2 < cx->gap_edge || m2 >= rl) continue;
                    if (gpos + m2 - shift1 < L) continue;
                    i32 gap_snp = i + j + t;
                    i32 clip = gpos + cx->gap_edge - L - shift1;
                    if (clip > 0) gpos -= clip;
                    H h;
                    resolve(loc_cat, plane, shift, gpos, h);
                    return add_hit(chain, gap_snp, h);
                }
            }
        }
        return 0;
    }

    struct P1Mat { const RefCtx* cx; i64 ci; };
    static const i32* p1_mat_(void* p, i32 tt) {
        P1Mat* m = (P1Mat*)p;
        return m->cx->pos1 + (m->ci * 2 * m->cx->gap + (tt - 1)) * KPOS;
    }

    struct P1Lazy {
        const EvalCtx* ev; i32 lc; int plane; i64 r2; i32* buf;
    };
    static const i32* p1_lazy_(void* p, i32 tt) {
        P1Lazy* z = (P1Lazy*)p;
        i32 t = (tt + 1) / 2;
        i32 shift = (1 - (tt % 2) * 2) * t;
        mm_pattern1(z->ev, z->lc + shift, z->plane, z->r2, z->buf);
        return z->buf;
    }

    int gap_align(i64 ci, int chain, int plane, i64 seed_pos) {
        P1Mat m{cx, ci};
        return gap_align_core(cx->pos0 + ci * KPOS, p1_mat_, &m,
                              chain, plane, cx->cand_loc[ci], seed_pos);
    }

    // visit-time variant: patterns extracted on demand, bounded by the
    // same snp_thres aborts the reference's per-candidate GapAlign has
    int gap_align_ev(i32 lc, int chain, int plane, i64 seed_pos, i64 r2) {
        if (snp_thres < 2) return 0;   // skip pattern-0 work entirely
        const EvalCtx* ev = cx->ev;
        i32 p0buf[KPOS], p1buf[KPOS];
        mm_pattern0(ev, lc, plane, r2, p0buf);
        P1Lazy z{ev, lc, plane, r2, p1buf};
        return gap_align_core(p0buf, p1_lazy_, &z,
                              chain, plane, lc, seed_pos);
    }

    // SnpAlign(mode) candidate visits (ref: align.cpp:274-316)
    void step_mode(i32 mode) {
        last_abort = false;
        if (mode >= segnum) return;
        for (i64 gi = g_lo; gi < g_hi; ++gi) {
            const Group& g = groups[gi];
            if (g.mode != mode) continue;
            i64 cbase = counts_off ? counts_off[gi] : g.start;
            i64 m = g.m, jj = g.jj0;
            if (cbase < 0) {
                // group never bulk-materialized: evaluate at visit time
                // (cx->ev must be set; gapped scans also need
                // ev->lenmaskP/readlen for the lazy patterns)
                const EvalCtx* ev = cx->ev;
                i64 r2 = g.read * 2 + g.chain;
                const u32* lp = ev->locs + g.loff;  // seed resolved at build
                n_eval += m;
                for (i64 it = 0; it < m; ++it) {
                    if (it + 4 < m) {  // hide the ref-window DRAM latency
                        i64 jp = jj + 4 >= m ? jj + 4 - m : jj + 4;
                        i32 lcp = (i32)((i64)lp[jp] - g.h);
                        __builtin_prefetch(
                            ev->ref32 + (jp > g.mc ? ev->nw : 0)
                            + (lcp >> 4));
                    }
                    int plane = jj > g.mc ? 1 : 0;
                    i32 lc = (i32)((i64)lp[jj] - g.h);
                    i32 cnt = eval_cand(ev, lc, plane, r2);
                    if (cnt <= snp_thres) {
                        H h;
                        resolve(lc, plane, 0, 0, h);
                        if (add_hit((int)g.chain, cnt, h)) {
                            last_abort = true;
                            return;
                        }
                    }
                    if (cx->gap > 0)
                        if (gap_align_ev(lc, (int)g.chain, plane, g.h,
                                         r2)) {
                            last_abort = true;
                            return;
                        }
                    if (++jj >= m) jj -= m;
                }
                continue;
            }
            for (i64 it = 0; it < m; ++it) {
                i64 ci = cbase + jj;
                if (cx->rr_skip && cx->rr_skip[ci]) {
                    if (++jj >= m) jj -= m;
                    continue;
                }
                int plane = cx->rr_plane ? (int)cx->rr_plane[ci]
                                         : (jj > g.mc ? 1 : 0);
                i32 cnt = cx->counts_dev[ci];
                if (cnt <= snp_thres) {
                    H h;
                    resolve(cx->cand_loc[ci], plane, 0, 0, h);
                    if (add_hit((int)g.chain, cnt, h)) { last_abort = true; return; }
                }
                if (cx->gap > 0)
                    if (gap_align(ci, (int)g.chain, plane, g.h)) {
                        last_abort = true; return;
                    }
                if (++jj >= m) jj -= m;
            }
        }
    }

    bool has_hits_le(i32 mode) const {
        for (i32 ii = 0; ii <= std::min(mode, rms); ++ii)
            if (!buckets[0][ii].empty() || !buckets[1][ii].empty()) return true;
        return false;
    }

    // SortHits4PE (ref: align.cpp:412-416)
    void sort_bucket(i32 n) {
        if (n > rms) return;
        for (int c = 0; c < 2; ++c)
            std::sort(buckets[c][n].begin(), buckets[c][n].end(),
                      [](const H& a, const H& b) {
                          return a.chr < b.chr
                                 || (a.chr == b.chr && a.loc < b.loc);
                      });
    }

    // SingleAlign::RunAlign stratum loop (ref: align.cpp:459-466)
    void run_all() {
        for (i32 mode = 0; mode < segnum; ++mode) {
            step_mode(mode);
            if (last_abort) break;
            if (!cx->nt3 && has_hits_le(mode)) break;
        }
    }

    i32 best_stratum() const {
        for (i32 ii = 0; ii <= rms; ++ii)
            if (!buckets[0][ii].empty() || !buckets[1][ii].empty()) return ii;
        return rms + 1;
    }
};

// write one scan's best-stratum buckets into the flat hit arrays
static i64 emit_best(const ScanState& sc, i32* out_stratum, i32* out_n0,
                     i32* out_n1, i64& hw, i64 hit_cap,
                     i32* hit_chr, i32* hit_loc, i32* hit_gsz, i32* hit_gpos,
                     u8* hit_chain) {
    i32 best = sc.best_stratum();
    *out_stratum = best;
    *out_n0 = 0; *out_n1 = 0;
    if (best > sc.rms) return 0;
    i64 need = (i64)(sc.buckets[0][best].size() + sc.buckets[1][best].size());
    if (hw + need > hit_cap) return -1;
    *out_n0 = (i32)sc.buckets[0][best].size();
    *out_n1 = (i32)sc.buckets[1][best].size();
    for (int c = 0; c < 2; ++c)
        for (const H& h : sc.buckets[c][best]) {
            hit_chr[hw] = h.chr; hit_loc[hw] = h.loc;
            hit_gsz[hw] = h.gsz; hit_gpos[hw] = h.gpos;
            hit_chain[hw] = (u8)c;
            ++hw;
        }
    return 0;
}

// SE scan replay (ref: align.cpp:228-466).  Outputs best-stratum buckets.
// Returns 0 ok, -1 if hit_cap insufficient (caller enlarges and retries).
i64 bt_replay_se(
    i32 B,
    const Group* groups, const i64* group_offsets,
    const i32* counts_dev,
    const i32* pos0,            // [C,KPOS] or nullptr
    const i32* pos1,            // [C,2*gap,KPOS] or nullptr
    const i32* cand_loc, const i8* cand_plane,
    const i8* rr_plane, const u8* rr_skip,  // RRBS: per-candidate plane/skip
    const i64* anchors, i32 n_chr, const i64* rc_off, const i64* sizes,
    const i32* map_len, const i32* read_max_snp, const i32* seedseg,
    const u8* filtered,
    i32 seed_size, i32 gap, i32 gap_edge, i32 max_num_hits, i32 nt3,
    i32 mode_limit,             // scan only modes < limit; reads that would
                                // continue past it report stratum -2
    const i64* counts_off,      // nullable: lazy compact-buffer offsets
    // nullable on-demand eval tables: groups with counts_off[gi] < 0 are
    // evaluated at visit time (ungapped; see EvalCtx)
    const u32* ev_ref32, i64 ev_nw,
    const u32* ev_base, const u32* ev_valid, const u32* ev_mread,
    const i32* ev_ncnt, i32 ev_W, i32 ev_mode,
    const u32* ev_locs,
    const u32* ev_lenmask, const i32* ev_readlen,   // gapped visit-time
    // outputs
    i32* out_stratum, i32* out_n0, i32* out_n1,
    i64 hit_cap,
    i32* hit_chr, i32* hit_loc, i32* hit_gsz, i32* hit_gpos, u8* hit_chain,
    i64* hit_offsets /*[B+1]*/,
    i32 n_threads)
{
    (void)cand_plane;
    RefCtx cx{anchors, rc_off, sizes, n_chr, counts_dev, pos0, pos1, cand_loc,
              seed_size, gap, gap_edge, max_num_hits, nt3};
    cx.rr_plane = rr_plane;
    cx.rr_skip = rr_skip;
    EvalCtx ev{ev_ref32, ev_nw, ev_base, ev_valid, ev_mread, ev_ncnt,
               ev_W, ev_mode, ev_locs, ev_lenmask, ev_readlen};
    if (ev_ref32) cx.ev = &ev;
    // reads are independent: thread over contiguous read chunks with
    // per-thread hit sinks, then stitch in read order (bit-identical to
    // the serial scan; the reference parallelizes the same way with its
    // -p worker pool, main.cpp:56-130)
    i32 nt = n_threads <= 0 ? 1 : n_threads;
    if (B < 512) nt = 1;
    if (nt > B) nt = B > 0 ? B : 1;
    struct Sink {
        std::vector<i32> chr, loc, gsz, gpos;
        std::vector<u8> chain;
    };
    std::vector<Sink> sinks(nt);
    i32 per = (B + nt - 1) / nt;
    auto work = [&](i32 t) {
        Sink& hs = sinks[t];
        ScanState sc;
        for (i32 r = t * per, r1 = std::min(B, (t + 1) * per); r < r1; ++r) {
            out_stratum[r] = 0; out_n0[r] = 0; out_n1[r] = 0;
            if (filtered[r]) { out_stratum[r] = -1; continue; }
            sc.init(&cx, groups, group_offsets[r], group_offsets[r + 1],
                    map_len[r], read_max_snp[r], seedseg[r]);
            sc.counts_off = counts_off;
            // RunAlign stratum loop, truncated at mode_limit (wave 1)
            bool resolved = true;
            {
                i32 lim = std::min(sc.segnum, mode_limit);
                bool stopped = false;
                for (i32 mode = 0; mode < lim; ++mode) {
                    sc.step_mode(mode);
                    if (sc.last_abort) { stopped = true; break; }
                    if (!nt3 && sc.has_hits_le(mode)) {
                        stopped = true;
                        break;
                    }
                }
                if (!stopped && sc.segnum > mode_limit)
                    resolved = false;   // needs wave 2
            }
            if (!resolved) { out_stratum[r] = -2; continue; }
            i32 best = sc.best_stratum();
            out_stratum[r] = best;
            if (best > sc.rms) continue;
            out_n0[r] = (i32)sc.buckets[0][best].size();
            out_n1[r] = (i32)sc.buckets[1][best].size();
            for (int c = 0; c < 2; ++c)
                for (const H& h : sc.buckets[c][best]) {
                    hs.chr.push_back(h.chr); hs.loc.push_back(h.loc);
                    hs.gsz.push_back(h.gsz); hs.gpos.push_back(h.gpos);
                    hs.chain.push_back((u8)c);
                }
        }
    };
    if (nt == 1) {
        work(0);
    } else {
        std::vector<std::thread> ts;
        for (i32 t = 0; t < nt; ++t) ts.emplace_back(work, t);
        for (auto& th : ts) th.join();
    }
    i64 total = 0;
    for (auto& s : sinks) total += (i64)s.chr.size();
    if (total > hit_cap) return -1;
    i64 hw = 0;
    for (i32 r = 0; r < B; ++r) {
        hit_offsets[r] = hw;
        hw += out_n0[r] + out_n1[r];
    }
    hit_offsets[B] = hw;
    i64 base = 0;
    for (auto& s : sinks) {
        i64 n = (i64)s.chr.size();
        if (n) {
            std::memcpy(hit_chr + base, s.chr.data(), n * sizeof(i32));
            std::memcpy(hit_loc + base, s.loc.data(), n * sizeof(i32));
            std::memcpy(hit_gsz + base, s.gsz.data(), n * sizeof(i32));
            std::memcpy(hit_gpos + base, s.gpos.data(), n * sizeof(i32));
            std::memcpy(hit_chain + base, s.chain.data(), n);
        }
        base += n;
    }
    return 0;
}

// GetPairs (ref: pairs.cpp:29-130) over two scans' sorted buckets.
struct PairRec { i32 chain, na, nb, insert; H a, b; };

static i32 get_pairs(const ScanState& sa, const ScanState& sb, i32 na, i32 nb,
                     std::vector<PairRec>* pairhits, i32 max_num_hits,
                     i64 min_insert, i64 max_insert) {
    if (na > sa.rms || nb > sb.rms) return 0;
    i32 la = sa.L, lb = sb.L;
    i32 npair = 0;
    std::vector<PairRec>& bucket = pairhits[na + nb];
    for (int chain = 0; chain < 2; ++chain) {
        const std::vector<H>& alist = chain == 0 ? sa.buckets[0][na]
                                                 : sa.buckets[1][na];
        const std::vector<H>& blist = chain == 0 ? sb.buckets[1][nb]
                                                 : sb.buckets[0][nb];
        i64 chra = -1;
        size_t bstart = 0, bend = 0;
        for (const H& ah : alist) {
            if (chra != ah.chr) {
                chra = ah.chr;
                bstart = bend;
                while (bstart < blist.size() && blist[bstart].chr < chra)
                    ++bstart;
                bend = bstart;
                while (bend < blist.size() && blist[bend].chr <= chra)
                    ++bend;
            }
            for (size_t j = bstart; j < bend; ++j) {
                const H& bh = blist[j];
                i64 seg_start, seg_end;
                if ((chra & 1) == chain) {
                    seg_start = ah.loc; seg_end = (i64)bh.loc + lb;
                } else {
                    seg_start = bh.loc; seg_end = (i64)ah.loc + la;
                }
                u32 insert = (u32)(seg_end - seg_start);
                if (insert >= (u32)min_insert && insert <= (u32)max_insert) {
                    bucket.push_back(PairRec{chain, na, nb, (i32)insert,
                                             ah, bh});
                    ++npair;
                    if ((i32)bucket.size() >= max_num_hits) return npair;
                }
            }
        }
    }
    return npair;
}

// PE lockstep replay (PairAlign::RunAlign, ref: pairs.cpp:132-177).
// Outputs per pair: the first nonempty pairhits bucket (flattened 12-i32
// records) + both ends' best-stratum buckets (for the unpaired fallback).
// Returns 0 ok, -1 if a capacity is insufficient.
i64 bt_replay_pe(
    i32 B,
    // end A
    const Group* groups_a, const i64* goff_a, const i32* counts_a,
    const i32* pos0_a, const i32* pos1_a, const i32* cand_loc_a,
    const i32* map_len_a, const i32* rms_a, const i32* seedseg_a,
    const u8* filtered_a,
    // end B
    const Group* groups_b, const i64* goff_b, const i32* counts_b,
    const i32* pos0_b, const i32* pos1_b, const i32* cand_loc_b,
    const i32* map_len_b, const i32* rms_b, const i32* seedseg_b,
    const u8* filtered_b,
    // shared
    const i64* anchors, i32 n_chr, const i64* rc_off, const i64* sizes,
    i32 seed_size, i32 gap, i32 gap_edge, i32 max_num_hits, i32 nt3,
    i64 min_insert, i64 max_insert,
    i32 mode_limit,             // scan only modes < limit; pairs that would
                                // continue past it report out_paired -2
    const i64* counts_off_a,    // nullable: lazy compact-buffer offsets
    const i64* counts_off_b,
    // nullable on-demand eval tables (shared genome/index; per-end planes)
    const u32* ev_ref32, i64 ev_nw,
    const u32* ev_locs, i32 ev_mode,
    const u32* ev_base_a, const u32* ev_valid_a, const u32* ev_mread_a,
    const i32* ev_ncnt_a, i32 ev_W_a,
    const u32* ev_lenmask_a, const i32* ev_readlen_a,
    const u32* ev_base_b, const u32* ev_valid_b, const u32* ev_mread_b,
    const i32* ev_ncnt_b, i32 ev_W_b,
    const u32* ev_lenmask_b, const i32* ev_readlen_b,
    // pair outputs
    i32* out_paired,            // [B] RunAlign return (0/1/n)
    i32* out_pair_cnt,          // [B] count in first nonempty bucket
    i64 pair_cap, i32* pair_data /* [pair_cap, 12] */,
    i64* pair_offsets /* [B+1] */,
    // per-end outputs (same layout as bt_replay_se)
    i32* stat_a, i32* n0_a, i32* n1_a,
    i32* stat_b, i32* n0_b, i32* n1_b,
    i64 hit_cap,
    i32* hchr_a, i32* hloc_a, i32* hgsz_a, i32* hgpos_a, u8* hchain_a,
    i64* hoff_a,
    i32* hchr_b, i32* hloc_b, i32* hgsz_b, i32* hgpos_b, u8* hchain_b,
    i64* hoff_b,
    // RRBS per-candidate plane/skip (nullable; see bt_replay_se)
    const i8* rr_plane_a, const u8* rr_skip_a,
    const i8* rr_plane_b, const u8* rr_skip_b,
    i32 n_threads)
{
    RefCtx cxa{anchors, rc_off, sizes, n_chr, counts_a, pos0_a, pos1_a,
               cand_loc_a, seed_size, gap, gap_edge, max_num_hits, nt3};
    RefCtx cxb{anchors, rc_off, sizes, n_chr, counts_b, pos0_b, pos1_b,
               cand_loc_b, seed_size, gap, gap_edge, max_num_hits, nt3};
    cxa.rr_plane = rr_plane_a; cxa.rr_skip = rr_skip_a;
    cxb.rr_plane = rr_plane_b; cxb.rr_skip = rr_skip_b;
    EvalCtx eva{ev_ref32, ev_nw, ev_base_a, ev_valid_a, ev_mread_a,
                ev_ncnt_a, ev_W_a, ev_mode, ev_locs, ev_lenmask_a,
                ev_readlen_a};
    EvalCtx evb{ev_ref32, ev_nw, ev_base_b, ev_valid_b, ev_mread_b,
                ev_ncnt_b, ev_W_b, ev_mode, ev_locs, ev_lenmask_b,
                ev_readlen_b};
    if (ev_ref32) { cxa.ev = &eva; cxb.ev = &evb; }
    // pairs are independent: thread over contiguous pair chunks with
    // per-thread sinks (pair records + both ends' hits), stitched in pair
    // order — bit-identical to the serial lockstep
    i32 nt = n_threads <= 0 ? 1 : n_threads;
    if (B < 256) nt = 1;
    if (nt > B) nt = B > 0 ? B : 1;
    struct HSink {
        std::vector<i32> chr, loc, gsz, gpos;
        std::vector<u8> chain;
    };
    struct Sink { std::vector<i32> pairdat; HSink a, b; };
    std::vector<Sink> sinks(nt);
    i32 per = (B + nt - 1) / nt;
    auto emit_sink = [](const ScanState& s, i32* stat, i32* pn0, i32* pn1,
                        HSink& hs) {
        i32 best = s.best_stratum();
        *stat = best;
        if (best > s.rms) return;
        *pn0 = (i32)s.buckets[0][best].size();
        *pn1 = (i32)s.buckets[1][best].size();
        for (int c = 0; c < 2; ++c)
            for (const H& h : s.buckets[c][best]) {
                hs.chr.push_back(h.chr); hs.loc.push_back(h.loc);
                hs.gsz.push_back(h.gsz); hs.gpos.push_back(h.gpos);
                hs.chain.push_back((u8)c);
            }
    };
    auto work = [&](i32 t) {
        Sink& sk = sinks[t];
        ScanState sa, sb;
        std::vector<PairRec> pairhits[2 * MAXSNPS + 1];
        for (i32 r = t * per, r1 = std::min(B, (t + 1) * per); r < r1; ++r) {
            out_paired[r] = 0; out_pair_cnt[r] = 0;
            stat_a[r] = -1; stat_b[r] = -1;
            n0_a[r] = n1_a[r] = n0_b[r] = n1_b[r] = 0;
            bool fa = filtered_a[r], fb = filtered_b[r];
            if (!fa) {
                sa.init(&cxa, groups_a, goff_a[r], goff_a[r + 1],
                        map_len_a[r], rms_a[r], seedseg_a[r]);
                sa.counts_off = counts_off_a;
            }
            if (!fb) {
                sb.init(&cxb, groups_b, goff_b[r], goff_b[r + 1],
                        map_len_b[r], rms_b[r], seedseg_b[r]);
                sb.counts_off = counts_off_b;
            }
            i32 paired = 0;
            bool incomplete = false;
            if (!fa && !fb) {
                for (int i = 0; i <= 2 * MAXSNPS; ++i) pairhits[i].clear();
                i32 n = 0;
                i32 maxi = std::max(sa.rms, sb.rms);
                for (i32 i = 0; i <= maxi; ++i) {
                    // mode i needs its candidates materialized on any end
                    // that still has segment i to scan
                    if (i >= mode_limit && (i < sa.segnum || i < sb.segnum)) {
                        incomplete = true;
                        break;
                    }
                    sa.step_mode(i);
                    sb.step_mode(i);
                    sa.sort_bucket(i);
                    sb.sort_bucket(i);
                    n += get_pairs(sa, sb, i, i, pairhits, max_num_hits,
                                   min_insert, max_insert);
                    for (i32 j = 0; j < i; ++j) {
                        n += get_pairs(sa, sb, i, j, pairhits, max_num_hits,
                                       min_insert, max_insert);
                        n += get_pairs(sa, sb, j, i, pairhits, max_num_hits,
                                       min_insert, max_insert);
                    }
                    if (nt3) continue;
                    if (n > 0) { paired = 1; break; }
                }
                if (!paired) paired = n;
                if (incomplete) { out_paired[r] = -2; continue; }
                if (paired) {
                    for (int i = 0; i <= 2 * MAXSNPS; ++i) {
                        if (pairhits[i].empty()) continue;
                        out_pair_cnt[r] = (i32)pairhits[i].size();
                        for (const PairRec& pr : pairhits[i]) {
                            i32 d[12] = {pr.chain, pr.na, pr.nb, pr.insert,
                                         pr.a.chr, pr.a.loc, pr.a.gsz,
                                         pr.a.gpos,
                                         pr.b.chr, pr.b.loc, pr.b.gsz,
                                         pr.b.gpos};
                            sk.pairdat.insert(sk.pairdat.end(), d, d + 12);
                        }
                        break;
                    }
                }
            } else {
                // orphan end: SE-style scan, truncated at mode_limit
                auto run_lim = [&](ScanState& s) {
                    i32 lim = std::min(s.segnum, mode_limit);
                    bool stopped = false;
                    for (i32 mode = 0; mode < lim; ++mode) {
                        s.step_mode(mode);
                        if (s.last_abort) { stopped = true; break; }
                        if (!cxa.nt3 && s.has_hits_le(mode)) {
                            stopped = true;
                            break;
                        }
                    }
                    if (!stopped && s.segnum > mode_limit) incomplete = true;
                };
                if (!fa) run_lim(sa);
                if (!fb) run_lim(sb);
                if (incomplete) { out_paired[r] = -2; continue; }
            }
            out_paired[r] = paired;
            if (!fa) emit_sink(sa, stat_a + r, n0_a + r, n1_a + r, sk.a);
            if (!fb) emit_sink(sb, stat_b + r, n0_b + r, n1_b + r, sk.b);
        }
    };
    if (nt == 1) {
        work(0);
    } else {
        std::vector<std::thread> ts;
        for (i32 t = 0; t < nt; ++t) ts.emplace_back(work, t);
        for (auto& th : ts) th.join();
    }
    i64 tp = 0, ta = 0, tb = 0;
    for (auto& s : sinks) {
        tp += (i64)s.pairdat.size() / 12;
        ta += (i64)s.a.chr.size();
        tb += (i64)s.b.chr.size();
    }
    if (tp > pair_cap || ta > hit_cap || tb > hit_cap) return -1;
    i64 pw = 0, hwa = 0, hwb = 0;
    for (i32 r = 0; r < B; ++r) {
        pair_offsets[r] = pw;
        hoff_a[r] = hwa; hoff_b[r] = hwb;
        pw += out_pair_cnt[r];
        hwa += n0_a[r] + n1_a[r];
        hwb += n0_b[r] + n1_b[r];
    }
    pair_offsets[B] = pw;
    hoff_a[B] = hwa; hoff_b[B] = hwb;
    i64 bp = 0, ba = 0, bb = 0;
    for (auto& s : sinks) {
        i64 n = (i64)s.pairdat.size();
        if (n) std::memcpy(pair_data + bp, s.pairdat.data(),
                           n * sizeof(i32));
        bp += n;
        auto put = [](HSink& h, i32* chr, i32* loc, i32* gsz, i32* gpos,
                      u8* chain, i64 b) {
            i64 m = (i64)h.chr.size();
            if (!m) return m;
            std::memcpy(chr + b, h.chr.data(), m * sizeof(i32));
            std::memcpy(loc + b, h.loc.data(), m * sizeof(i32));
            std::memcpy(gsz + b, h.gsz.data(), m * sizeof(i32));
            std::memcpy(gpos + b, h.gpos.data(), m * sizeof(i32));
            std::memcpy(chain + b, h.chain.data(), m);
            return m;
        };
        ba += put(s.a, hchr_a, hloc_a, hgsz_a, hgpos_a, hchain_a, ba);
        bb += put(s.b, hchr_b, hloc_b, hgsz_b, hgpos_b, hchain_b, bb);
    }
    (void)bp;
    return 0;
}

// FASTQ chunk scanner (zero-string read path; replaces the per-read
// Python line/split/decode loop in reads/io.py).  Token semantics match
// the reference's ``fin >> seq`` reads (reads.cpp:42-82): a field ends at
// the first whitespace; the rest of the line is skipped.  Empty lines are
// skipped (reference: getline loop).  Parses complete 4-line records from
// buf[0..n); a record at EOF may end without a trailing newline when
// final != 0.  Returns the number of records parsed (up to cap);
// *consumed = bytes of buf fully consumed by parsed records (the caller
// carries the remainder into the next chunk).
extern "C" i64 bt_scan_fastq(
    const u8* buf, i64 n, i32 final_chunk, i64 cap,
    i64* name_off, i32* name_len,
    i64* seq_off, i32* seq_len,
    i64* qual_off, i32* qual_len,
    i64* consumed)
{
    i64 p = 0, nrec = 0;
    auto skip_ws_lines = [&](i64& q) {
        while (q < n && (buf[q] == '\n' || buf[q] == '\r')) ++q;
    };
    auto token = [&](i64& q, i64& off, i32& len) -> bool {
        // token start at q; returns false if the line is incomplete
        off = q;
        while (q < n && buf[q] > ' ') ++q;
        len = (i32)(q - off);
        while (q < n && buf[q] != '\n') ++q;   // rest of line
        if (q >= n) return final_chunk != 0;
        ++q;  // consume '\n'
        return true;
    };
    while (nrec < cap) {
        i64 q = p;
        skip_ws_lines(q);
        if (q >= n) { p = q; break; }
        // header line: '@name ...' (name excludes the '@')
        i64 hoff; i32 hlen;
        i64 q0 = q;
        if (!token(q, hoff, hlen)) break;
        (void)q0;
        i64 soff, plus_off, qoff; i32 slen, plus_len, qlen;
        skip_ws_lines(q);
        if (q >= n || !token(q, soff, slen)) break;
        skip_ws_lines(q);
        if (q >= n || !token(q, plus_off, plus_len)) break;
        skip_ws_lines(q);
        if (q >= n || !token(q, qoff, qlen)) break;
        name_off[nrec] = hoff + 1;            // skip '@'
        name_len[nrec] = hlen > 0 ? hlen - 1 : 0;
        seq_off[nrec] = soff; seq_len[nrec] = slen;
        qual_off[nrec] = qoff; qual_len[nrec] = qlen;
        ++nrec;
        p = q;
    }
    *consumed = p;
    return nrec;
}

// Pack one 2-bit field from 16 consecutive fused bytes into a u32, first
// byte in the most significant lane — the twin of the scalar
// (w << 2) | ((s[j] >> shift) & 3) loop.  BMI2: bswap puts byte 0 in the
// MSB, pext gathers the selected 2 bits of each byte.  `bits` is the
// per-byte field mask (0x03 / 0x0c / 0x30).
static inline u32 pack16_sel(const u8* s, u8 bits) {
#ifdef BT_BMI2
    u64 lo, hi;
    std::memcpy(&lo, s, 8);
    std::memcpy(&hi, s + 8, 8);
    const u64 M = 0x0101010101010101ull * bits;
    return (u32)((_pext_u64(__builtin_bswap64(lo), M) << 16)
                 | _pext_u64(__builtin_bswap64(hi), M));
#else
    int sh = __builtin_ctz(bits);
    u32 w = 0;
    for (int j = 0; j < 16; ++j) w = (w << 2) | ((s[j] >> sh) & 3u);
    return w;
#endif
}

#if defined(__AVX512VBMI__) && defined(__AVX512BW__)
#define BT_VBMI 1
#endif

// 256-entry byte LUT over a buffer.  VBMI: four 64-entry vpermb tables
// selected by the index's top two bits (permutexvar uses the low 6 bits).
static inline void lut256_apply(const u8* lut, const u8* in, u8* out,
                                i32 n) {
    i32 i = 0;
#ifdef BT_VBMI
    __m512i t0 = _mm512_loadu_si512(lut);
    __m512i t1 = _mm512_loadu_si512(lut + 64);
    __m512i t2 = _mm512_loadu_si512(lut + 128);
    __m512i t3 = _mm512_loadu_si512(lut + 192);
    for (; i + 64 <= n; i += 64) {
        __m512i c = _mm512_loadu_si512(in + i);
        __mmask64 k6 = _mm512_test_epi8_mask(c, _mm512_set1_epi8(0x40));
        __mmask64 k7 = _mm512_movepi8_mask(c);
        __m512i r01 = _mm512_mask_blend_epi8(
            k6, _mm512_permutexvar_epi8(c, t0),
            _mm512_permutexvar_epi8(c, t1));
        __m512i r23 = _mm512_mask_blend_epi8(
            k6, _mm512_permutexvar_epi8(c, t2),
            _mm512_permutexvar_epi8(c, t3));
        _mm512_storeu_si512(out + i, _mm512_mask_blend_epi8(k7, r01, r23));
    }
#endif
    for (; i < n; ++i) out[i] = lut[in[i]];
}

// Batch read encoder: chars -> device planes + per-offset seed arrays.
// Twin of basal_tpu.reads.encode.encode_batch's packing half
// (ref: ConvertBina[r]ySeq, align.cpp:79-226) in one multithreaded pass.
//  chars:   u8 [B, lmax] read characters, 'N' beyond each read's length
//  planes:  u32 [2B, W] base/valid/mread/lenmask (row = 2*read + chain)
//  seedval: u32 [B, 2, S]  (S = lmax - seed_size + 1), has_n: u8 same shape
i64 bt_encode_batch(
    i32 B, i32 lmax, i32 W, i32 seed_size, i32 nt3,
    const u8* chars,            // [B, lmax] dense, or ragged base when
    const i64* seq_off,         // seq_off != null (chars + seq_off[r],
                                // L chars; beyond-L treated as 'N')
    const i32* map_len,         // [B]
    const u8* alphabet, const u8* rev_alphabet,
    const u8* mread_fwd, const u8* mread_rev, const u8* reg,
    u32* base, u32* valid, u32* mread, u32* lenmask,  // [2B, W]
    u32* seedval, u8* has_n,    // [B, 2, S]
    i32* ncnt_out,              // [B] nullable: #invalid chars in [0, L)
    i32 n_threads)
{
    const i32 S = lmax - seed_size + 1;
    const i32 lpad = W * 16;  // packed words cover [0, W*16); pad the
                              // per-read byte buffers so the 16-at-a-time
                              // packers never read past the end
    // fused per-direction LUTs: code | valid<<2 | mread<<4 in one byte —
    // one table walk (vectorized in lut256_apply) instead of three, and
    // the planes pack straight out of the fused buffer via pext masks
    u8 lut_f[256], lut_r[256];
    for (int c = 0; c < 256; ++c) {
        lut_f[c] = (u8)(alphabet[c] | (reg[c] << 2) | (mread_fwd[c] << 4));
        lut_r[c] = (u8)(rev_alphabet[c] | (reg[c] << 2)
                        | (mread_rev[c] << 4));
    }
    auto work = [&](i32 r0, i32 r1) {
        // fused bytes; [lmax, ...) stays 0 (padded for 64B-vector overshoot)
        std::vector<u8> fb(lpad + 160, 0);
        std::vector<u8> chbuf(lmax), rbuf(lmax);
        // double-and-add window-hash scratch (see the seed section below);
        // zero-initialized so over-span reads (bounded, never stored into
        // sv[0..S)) see zeros, not uninitialized memory
        std::vector<u8> dbuf(lpad + 160, 0), badbuf(lpad + 160, 0);
        std::vector<u32> h4buf(lpad + 160), gbuf(lpad + 160);
        std::vector<u32> wtmp(lpad + 160);
        std::vector<i32> prebuf(lpad + 160);
#ifdef BT_PROF_SEEDL1
        std::vector<u32> l1sv(lpad + 16);
        std::vector<u8> l1hn(lpad + 16);
#endif
        for (i32 r = r0; r < r1; ++r) {
            i32 L = map_len[r];
            const u8* ch;
            if (seq_off) {
                memcpy(chbuf.data(), chars + seq_off[r], (size_t)L);
                memset(chbuf.data() + L, 'N', (size_t)(lmax - L));
                ch = chbuf.data();
            } else {
                ch = chars + (i64)r * lmax;
            }
            for (int chain = 0; chain < 2; ++chain) {
                // chain 0: as-is through alphabet; chain 1: reversed read
                // through rev_alphabet (align.cpp:193-199)
                if (chain == 0) {
                    lut256_apply(lut_f, ch, fb.data(), lmax);
                    if (ncnt_out) {
                        i32 nbad_r = 0;
                        for (i32 i = 0; i < L; ++i)
                            nbad_r += ((fb[i] & 12) == 0);
                        ncnt_out[r] = nbad_r;
                    }
                } else {
#ifdef BT_PROF_NOREV  // attribution builds only
                    lut256_apply(lut_r, ch, fb.data(), lmax);
#else
                    for (i32 i = 0; i < L; ++i) rbuf[i] = ch[L - 1 - i];
                    if (L < lmax)
                        memset(rbuf.data() + L, 'N', (size_t)(lmax - L));
                    lut256_apply(lut_r, rbuf.data(), fb.data(), lmax);
#endif
                }
                i64 row = (i64)r * 2 + chain;
                u32* bp = base + row * W;
                u32* vp = valid + row * W;
                u32* mp = mread + row * W;
                u32* lp = lenmask + row * W;
#ifdef BT_PROF_NOPACK  // attribution builds only
                memset(bp, 0, (size_t)W * 4);
                memset(vp, 0, (size_t)W * 4);
                memset(mp, 0, (size_t)W * 4);
                memset(lp, 0, (size_t)W * 4);
#else
                for (i32 w = 0; w < W; ++w) {
                    i32 p0 = w * 16;
                    u32 bw = pack16_sel(fb.data() + p0, 0x03);
                    u32 vw = pack16_sel(fb.data() + p0, 0x0c);
                    u32 mw = pack16_sel(fb.data() + p0, 0x30);
                    // lenmask: 3s for positions < L, MSB-first
                    i32 rem = L - p0;
                    u32 lw = rem >= 16 ? 0xFFFFFFFFu
                           : rem <= 0 ? 0u
                           : 0xFFFFFFFFu << (32 - 2 * rem);
                    if (nt3) bw -= (bw << 1) & bw & 0xAAAAAAAAu;  // XT32
                    bp[w] = bw; vp[w] = vw; mp[w] = mw; lp[w] = lw;
                }
#endif
                // rolling base-3 seed values + N flags (align.cpp:162-175)
                u32* sv = seedval + ((i64)r * 2 + chain) * S;
                u8* hn = has_n + ((i64)r * 2 + chain) * S;
#ifdef BT_PROF_NOSEED  // attribution builds only (tools/encodeprof.py)
                memset(sv, 0, (size_t)S * 4);
                memset(hn, 0, (size_t)S);
                continue;
#endif
                // sv[i] is the sliding ss-digit base-3 window hash
                //   sv[i] = sum_{j<ss} d[i+j] * 3^(ss-1-j)   (mod 2^32)
                // (align.cpp:162-175).  The reference's rolling update is
                // a ~8-cycle loop-carried mul dependency per offset; over
                // the same ring Z/2^32 the identity
                //   W_{m+n}(i) = W_m(i) * 3^n + W_n(i+m)
                // lets double-and-add build all S values in log2(ss)
                // dependency-free elementwise passes (vectorizable), with
                // no recurrence at all.  Bit-identical: u32 wraparound
                // arithmetic throughout, same as the old loop.
                const i32 ss = seed_size;
#ifdef BT_PROF_SEEDL1  // attribution: same compute, L1-local stores
                sv = l1sv.data(); hn = l1hn.data();
#endif
                u8* d = dbuf.data();
                u8* bad = badbuf.data();
                i32* preb = prebuf.data();
                {
                    i32 i = 0;
#ifdef BT_VBMI
                    // d[i] = (fb[i]&3)==3 ? 1 : fb[i]&3;
                    // bad[i] = (fb[i]&12)==0
                    __m512i m3 = _mm512_set1_epi8(3);
                    __m512i mC = _mm512_set1_epi8(12);
                    __m512i one = _mm512_set1_epi8(1);
                    // fb is padded well past lmax with zeros; the <= 63
                    // bytes of overshoot write d=0/bad=1, never read for
                    // offsets >= lmax (and d is re-zeroed below)
                    for (; i < lmax; i += 64) {
                        __m512i c = _mm512_loadu_si512(fb.data() + i);
                        __m512i lo = _mm512_and_si512(c, m3);
                        __mmask64 is3 = _mm512_cmpeq_epi8_mask(lo, m3);
                        _mm512_storeu_si512(
                            d + i, _mm512_mask_blend_epi8(is3, lo, one));
                        __mmask64 isbad = _mm512_testn_epi8_mask(c, mC);
                        _mm512_storeu_si512(
                            bad + i,
                            _mm512_maskz_mov_epi8(isbad, one));
                    }
#else
                    for (; i < lmax; ++i) {
                        u8 c = fb[i] & 3;
                        d[i] = (u8)(c == 3 ? 1 : c);
                        bad[i] = (fb[i] & 12) == 0;
                    }
#endif
                }
                preb[0] = 0;
                for (i32 i = 0; i < lmax; ++i)
                    preb[i + 1] = preb[i] + bad[i];
                if (ss <= 32) {
                    memset(d + lmax, 0, 96);  // passes read past lmax;
                    // zeros there only feed sv[i >= S], never stored
                    const i32 n = lmax + 64;  // generous valid span
                    u32* __restrict Wp = h4buf.data();
                    u32* __restrict R = gbuf.data();
                    u32* __restrict T = wtmp.data();
                    {
                        i32 i = 0;
#ifdef BT_SIMD512
                        for (; i + 16 <= n + 32; i += 16)
                            _mm512_storeu_si512(
                                Wp + i,
                                _mm512_cvtepu8_epi32(
                                    _mm_loadu_si128((const __m128i*)(d + i))));
#endif
                        for (; i < n + 32; ++i) Wp[i] = d[i];
                    }
                    // combine(dst, a, c, b_shifted): dst[i] = a[i]*c + b[i]
                    auto combine = [n](u32* __restrict dst,
                                       const u32* __restrict a, u32 c,
                                       const u32* __restrict b) {
                        i32 i = 0;
#ifdef BT_SIMD512
                        __m512i vc = _mm512_set1_epi32((int)c);
                        for (; i + 16 <= n; i += 16) {
                            __m512i va = _mm512_loadu_si512(a + i);
                            __m512i vb = _mm512_loadu_si512(b + i);
                            _mm512_storeu_si512(
                                dst + i,
                                _mm512_add_epi32(
                                    _mm512_mullo_epi32(va, vc), vb));
                        }
#endif
                        for (; i < n; ++i) dst[i] = a[i] * c + b[i];
                    };
                    i32 p2 = 1;
                    u32 pow_p2 = 3;   // 3^p2
                    u32 pow_r = 1;    // 3^rlen
                    i32 rlen = 0;
                    i32 rem = ss;
                    while (true) {
                        if (rem & 1) {
                            if (rlen == 0) {
                                std::swap(Wp, R);
                                if (rem > 1)  // Wp still needed: copy back
                                    memcpy(Wp, R, sizeof(u32) * (n + 32));
                            } else {
                                combine(T, Wp, pow_r, R + p2);
                                std::swap(T, R);
                            }
                            pow_r *= pow_p2;
                            rlen += p2;
                        }
                        rem >>= 1;
                        if (!rem) break;
                        combine(T, Wp, pow_p2, Wp + p2);
                        std::swap(T, Wp);
                        p2 <<= 1;
                        pow_p2 *= pow_p2;
                    }
                    memcpy(sv, R, sizeof(u32) * S);
                } else {
                    // rare wide-seed fallback: the reference's rolling
                    // update, exact
                    u32 val = 0, pow_top = 1;
                    for (i32 j = 0; j < ss - 1; ++j) pow_top *= 3;
                    for (i32 j = 0; j < ss && j < lmax; ++j)
                        val = val * 3 + d[j];
                    for (i32 i = 0; i < S; ++i) {
                        sv[i] = val;
                        if (i + 1 < S)
                            val = (val - (u32)d[i] * pow_top) * 3
                                  + d[i + ss];
                    }
                }
                {
                    i32 j = 0;
#if defined(BT_SIMD512) && defined(__AVX512BW__)
                    for (; j + 16 <= S; j += 16) {
                        __m512i a = _mm512_loadu_si512(preb + j + ss);
                        __m512i b2 = _mm512_loadu_si512(preb + j);
                        __mmask16 m = _mm512_cmpgt_epi32_mask(a, b2);
                        _mm_storeu_si128(
                            (__m128i*)(hn + j),
                            _mm_and_si128(_mm_movm_epi8(m),
                                          _mm_set1_epi8(1)));
                    }
#endif
                    for (; j < S; ++j)
                        hn[j] = preb[j + ss] > preb[j];
                }
            }
        }
    };
    if (n_threads <= 1 || B < 256) {
        work(0, B);
    } else {
        std::vector<std::thread> ts;
        i32 per = (B + n_threads - 1) / n_threads;
        for (i32 t = 0; t < n_threads; ++t) {
            i32 a = t * per, b = std::min(B, a + per);
            if (a < b) ts.emplace_back(work, a, b);
        }
        for (auto& t : ts) t.join();
    }
    return 0;
}

}  // extern "C"
// --------------------------------------------------------------------------
// SE SAM record formatting (s_OutHit + StringAlign dispatch,
// ref: align.cpp:583-669).  Consumes the replay's best-stratum buckets and
// writes final SAM text into one buffer.  Returns bytes written, or
// -(needed) if cap is too small.  counters: [aligned, unique, multiple].
struct SeFmtArgs {
    const u8* names; const i64* name_off; const i32* name_len;
    const u8* seqs; const i64* seq_off; const i32* seq_len;
    const u8* quals; const i64* qual_off; const i32* qual_len;
    const i32* map_len; const u32* read_index; const i32* readset;
    const i32* stratum; const i32* n0; const i32* n1v;
    const i32* hchr; const i32* hloc; const i32* hgsz; const i32* hgpos;
    const i64* hoff;
    const u8* title_names; const i64* title_off; i32 n_titles;
    const u32* ref32_fwd; const i64* anchors;
    const u8* useful_nt;
    const u8* rev_char_tab;
    u32 randseed; i32 report_repeat_hits; i32 out_unmap; i32 out_ref;
    // RRBS ZP/ZL (CCGG_seglen, refbase.cpp:456-482): per-chr-pair CSR of
    // digestion sites (position, rev_off); null for WGBS
    const i64* cc_pos = nullptr;
    const i64* cc_rev = nullptr;
    const i64* cc_off = nullptr;  // [n_titles+1]
};

// RefSeq::CCGG_seglen twin (refbase.cpp:456-482; Python golden
// index/rrbs.py::ccgg_seglen): fragment (ZP, ZL) for a hit at plane-local
// position p with read length rl over one chr pair's sorted site list.
static inline void ccgg_seglen_c(const i64* pos, const i64* rev, i64 n,
                                 i64 p, i64 rl, i64* zp, i64* zl)
{
    if (n == 0) { *zp = 1; *zl = 0; return; }
    i64 left = 0, right = n - 1;
    while (left < right - 1) {
        i64 mid = (left + right) / 2;
        i64 mv = pos[mid];
        if (mv == p) { left = mid; right = mid + 1; break; }
        if (mv < p) left = mid; else right = mid;
    }
    i64 seg_start = pos[left];
    while (right < n && pos[right] + rev[right] < p + rl) ++right;
    i64 seg_end = (right < n) ? pos[right] + rev[right]
                              : pos[n - 1] + rev[n - 1];
    *zp = seg_start + 1;
    *zl = seg_end - seg_start;
}

// Formats reads [r0, r1) into (out, cap); returns bytes needed (may exceed
// cap — caller grows and reruns) and OVERWRITES cnt[0..2] with the range's
// aligned/unique/multiple counts.  Pure function of its inputs (the RNG is
// the per-read myrand hash), so any read partition stitches bit-identically
// to the serial pass.
static i64 format_se_range(const SeFmtArgs& A, i32 r0, i32 r1,
                           u8* out, i64 cap, i64* cnt)
{
    const u8* names = A.names; const i64* name_off = A.name_off;
    const i32* name_len = A.name_len;
    const u8* seqs = A.seqs; const i64* seq_off = A.seq_off;
    const i32* seq_len = A.seq_len;
    const u8* quals = A.quals; const i64* qual_off = A.qual_off;
    const i32* qual_len = A.qual_len;
    const i32* map_len = A.map_len; const u32* read_index = A.read_index;
    const i32* readset = A.readset;
    const i32* stratum = A.stratum; const i32* n0 = A.n0;
    const i32* hchr = A.hchr; const i32* hloc = A.hloc;
    const i32* hgsz = A.hgsz; const i32* hgpos = A.hgpos;
    const i64* hoff = A.hoff;
    const u8* title_names = A.title_names; const i64* title_off = A.title_off;
    const u32* ref32_fwd = A.ref32_fwd; const i64* anchors = A.anchors;
    const u8* useful_nt = A.useful_nt;
    const u8* rev_char_tab = A.rev_char_tab;
    u32 randseed = A.randseed;
    i32 report_repeat_hits = A.report_repeat_hits;
    i32 out_unmap = A.out_unmap, out_ref = A.out_ref;

    i64 w = 0;
    i64 aligned = 0, unique = 0, multiple = 0;
    auto put = [&](const char* s, i64 n) {
        if (w + n <= cap) memcpy(out + w, s, n);
        w += n;
    };
    auto put_str = [&](const u8* s, i64 n) { put((const char*)s, n); };
    char tmp[64];
    auto put_int = [&](i64 v) { int n = snprintf(tmp, 64, "%lld", (long long)v); put(tmp, n); };
    auto put_ch = [&](char c) { if (w < cap) out[w] = c; ++w; };

    for (i32 r = r0; r < r1; ++r) {
        const u8* name = names + name_off[r];
        i64 name_n = name_len[r];
        const u8* seq = seqs + seq_off[r];
        i64 seq_n = seq_len[r];
        const u8* qual = quals + qual_off[r];
        i64 qual_n = qual_len[r];
        i32 L = map_len[r];
        i32 st = stratum[r];
        i64 a = hoff[r], b = hoff[r + 1];
        i32 total = (i32)(b - a);
        i32 k0 = n0[r];

        auto out_unmapped = [&](int flagbits) {
            if (!out_unmap) return;
            i32 flag = 0x40 * readset[r] | flagbits;
            put_str(name, name_n); put_ch('\t'); put_int(flag);
            put("\t*\t0\t0\t*\t*\t0\t0\t", 15);
            put_str(seq, seq_n); put_ch('\t'); put_str(qual, qual_n);
            put_ch('\n');
        };
        auto out_hit = [&](int chain, i32 n, i64 hidx) {
            i32 chr_ = hchr[hidx], loc = hloc[hidx];
            i32 gsz = hgsz[hidx], gpos = hgpos[hidx];
            int rev = chain ^ (chr_ & 1);
            i32 flag = 0x40 * readset[r];
            if (n != 1) flag |= 0x100;
            if (rev) flag |= 0x010;
            put_str(name, name_n); put_ch('\t'); put_int(flag); put_ch('\t');
            put_str(title_names + title_off[chr_ >> 1],
                    title_off[(chr_ >> 1) + 1] - title_off[chr_ >> 1]);
            put_ch('\t'); put_int((i64)loc + 1); put("\t255\t", 5);
            if (gsz == 0) { put_int(L); put_ch('M'); }
            else if (gsz > 0) {
                put_int(gpos); put_ch('M'); put_int(gsz); put_ch('D');
                put_int(L - gpos); put_ch('M');
            } else {
                put_int(gpos); put_ch('M'); put_int(-gsz); put_ch('I');
                put_int(L - gpos + gsz); put_ch('M');
            }
            put("\t*\t0\t0\t", 7);
            if (rev) {
                for (i64 i = seq_n - 1; i >= 0; --i) put_ch((char)rev_char_tab[seq[i]]);
                put_ch('\t');
                for (i64 i = qual_n - 1; i >= 0; --i) put_ch((char)qual[i]);
            } else {
                put_str(seq, seq_n); put_ch('\t'); put_str(qual, qual_n);
            }
            put("\tNM:i:", 6); put_int(st);
            if (out_ref) {
                put("\tXR:Z:", 6);
                i64 base0 = anchors[chr_ >> 1];
                for (int ii = 2; ii > 0; --ii) {
                    if (loc < ii) continue;
                    i64 pp = base0 + loc - ii;
                    u32 code = (ref32_fwd[pp >> 4] >> (30 - (pp & 15) * 2)) & 3;
                    put_ch((char)useful_nt[code + 4]);
                }
                for (i64 ii = 0; ii < (i64)L + 2; ++ii) {
                    i64 pp = base0 + loc + ii;
                    u32 code = (ref32_fwd[pp >> 4] >> (30 - (pp & 15) * 2)) & 3;
                    char c = (char)useful_nt[code];
                    if (ii >= L) c = (char)(c + 32);  // lowercase flanks
                    put_ch(c);
                }
            }
            if (A.cc_pos) {  // RRBS ZP/ZL fragment tags (align.cpp:660-664)
                i64 a0 = A.cc_off[chr_ >> 1];
                i64 b0 = A.cc_off[(chr_ >> 1) + 1];
                i64 zp, zl;
                ccgg_seglen_c(A.cc_pos + a0, A.cc_rev + a0, b0 - a0,
                              loc, L, &zp, &zl);
                put("\tZP:i:", 6); put_int(zp);
                put("\tZL:i:", 6); put_int(zl);
            }
            put("\tZS:Z:", 6);
            put_ch(chr_ & 1 ? '-' : '+');
            put_ch(chain ? '-' : '+');
            put_ch('\n');
        };

        if (st < 0) { out_unmapped(0x204); continue; }     // QC
        if (total == 0) { out_unmapped(0x4); continue; }   // NM
        if (total == 1) {
            ++aligned; ++unique;
            out_hit(k0 ? 0 : 1, 1, a);
            continue;
        }
        ++multiple;
        if (report_repeat_hits == 1) {
            ++aligned;
            u32 j = myrand_hash(read_index[r], randseed) % (u32)total;
            out_hit(j < (u32)k0 ? 0 : 1, total, a + j);
        } else if (report_repeat_hits == 2) {
            ++aligned;
            for (i64 j = a; j < b; ++j)
                out_hit(j - a < k0 ? 0 : 1, total, j);
        } else {
            out_unmapped(0x4);
        }
    }
    cnt[0] = aligned; cnt[1] = unique; cnt[2] = multiple;
    return w;
}

extern "C" i64 bt_format_se(
    i32 B,
    const u8* names, const i64* name_off, const i32* name_len,  // [B] slices
    const u8* seqs, const i64* seq_off, const i32* seq_len,     // (off, len)
    const u8* quals, const i64* qual_off, const i32* qual_len,
    const i32* map_len, const u32* read_index, const i32* readset,
    const i32* stratum, const i32* n0, const i32* n1v,
    const i32* hchr, const i32* hloc, const i32* hgsz, const i32* hgpos,
    const i64* hoff,
    const u8* title_names, const i64* title_off, i32 n_titles,
    const u32* ref32_fwd, const i64* anchors,   // for -R XR context
    const u8* useful_nt,                        // 8 chars
    const u8* rev_char_tab,                     // 256
    u32 randseed, i32 report_repeat_hits, i32 out_unmap, i32 out_ref,
    const i64* cc_pos, const i64* cc_rev, const i64* cc_off,  // RRBS ZP/ZL
    u8* out, i64 cap, i64* counters, i32 n_threads)
{
    SeFmtArgs A{names, name_off, name_len, seqs, seq_off, seq_len,
                quals, qual_off, qual_len, map_len, read_index, readset,
                stratum, n0, n1v, hchr, hloc, hgsz, hgpos, hoff,
                title_names, title_off, n_titles, ref32_fwd, anchors,
                useful_nt, rev_char_tab,
                randseed, report_repeat_hits, out_unmap, out_ref,
                cc_pos, cc_rev, cc_off};
    if (n_threads <= 1 || B < 4096) {
        i64 c[3];
        i64 w = format_se_range(A, 0, B, out, cap, c);
        if (w > cap) return -w;  // caller retries: don't double-count
        counters[0] += c[0]; counters[1] += c[1]; counters[2] += c[2];
        return w;
    }
    // Threaded: contiguous read chunks into per-thread growable buffers,
    // stitched in order (record order == serial order; each chunk's bytes
    // are bit-identical to the serial pass over the same range).
    i32 T = std::min<i64>(n_threads, (B + 2047) / 2048);
    i64 tmax = 0;  // longest title: per-record size upper bound component
    for (i32 t = 0; t < n_titles; ++t)
        tmax = std::max(tmax, title_off[t + 1] - title_off[t]);
    std::vector<std::vector<u8>> bufs(T);
    std::vector<i64> ws(T, 0);
    std::vector<i64> cs(3 * T, 0);
    std::vector<std::thread> ts;
    for (i32 t = 0; t < T; ++t) {
        i32 r0 = (i32)((i64)B * t / T), r1 = (i32)((i64)B * (t + 1) / T);
        ts.emplace_back([&, t, r0, r1]() {
            i64 est = 0;
            for (i32 r = r0; r < r1; ++r) {
                i64 nrec = 1;
                if (report_repeat_hits == 2)
                    nrec = std::max<i64>(hoff[r + 1] - hoff[r], 1);
                i64 per = name_len[r] + 2 * (i64)seq_len[r] + tmax + 112
                          + (out_ref ? map_len[r] + 14 : 0)
                          + (cc_pos ? 56 : 0);  // RRBS ZP/ZL tags
                est += nrec * per;
            }
            std::vector<u8>& buf = bufs[t];
            buf.resize(est);
            for (;;) {  // grow-and-rerun backstop (estimate is an upper
                        // bound for every current record layout)
                i64 w = format_se_range(A, r0, r1, buf.data(),
                                        (i64)buf.size(), &cs[3 * t]);
                ws[t] = w;
                if (w <= (i64)buf.size()) break;
                buf.resize(w);
            }
        });
    }
    for (auto& th : ts) th.join();
    i64 total = 0;
    for (i32 t = 0; t < T; ++t) total += ws[t];
    if (total > cap) return -total;
    i64 w = 0;
    for (i32 t = 0; t < T; ++t) {
        memcpy(out + w, bufs[t].data(), ws[t]);
        w += ws[t];
        counters[0] += cs[3 * t]; counters[1] += cs[3 * t + 1];
        counters[2] += cs[3 * t + 2];
    }
    return w;
}

// --------------------------------------------------------------------------
// Paired-end SAM formatting (StringAlignPair / StringAlignUnpair /
// s_OutHitPair / s_OutHitUnpair / FixPairReadName, pairs.cpp:204-507).
// Exact C++ twin of PairEmitter (pairs/pipeline.py:44-221): consumes the
// flat pair/hit arrays bt_replay_pe produced and writes the SAM body in
// one pass.  counters[0..2]: aligned/unique/multiple pairs;
// counters[3..8]: per-end a/b aligned/unique/multiple.
// Returns bytes written; -bytes when cap was too small (caller re-sizes
// and retries); -2 on a FixPairReadName mismatch (caller raises).

struct PeEnd {
    const u8 *names, *seqs, *quals;
    const i64 *name_off, *seq_off, *qual_off;
    const i32 *name_len, *seq_len, *qual_len;
    const i32 *map_len; const u32* ridx; const i32* rset;
    const u8* filtered; const i32* rms;
    const i32 *stat, *n0, *n1;
    const i32 *hchr, *hloc, *hgsz, *hgpos;
    const i64* hoff;
};

struct PeFmtArgs {
    PeEnd E[2];
    const i32* paired; const i32* pair_data; const i64* pair_off;
    const u8* title_names; const i64* title_off;
    const u32* ref32_fwd; const i64* anchors;
    const u8* useful_nt; const u8* rev_char_tab;
    u32 randseed; i32 report_repeat_hits; i32 out_unmap; i32 out_ref;
    // RRBS ZP/ZL (nullable): per-chr-pair CSR of CCGG fragment sites,
    // same layout as SeFmtArgs (refbase.cpp:456-482)
    const i64* cc_pos = nullptr;
    const i64* cc_rev = nullptr;
    const i64* cc_off = nullptr;
};

// Formats pairs [r0, r1) into (out, cap); returns bytes needed (may exceed
// cap), or -2 on a FixPairReadName mismatch, and OVERWRITES cnt[0..8]
// (pair aligned/unique/multiple + per-end a/b counters).  Per-pair pure
// (myrand is the per-read hash), so read partitions stitch bit-identically.
static i64 format_pe_range(const PeFmtArgs& A, i32 r0, i32 r1,
                           u8* out, i64 cap, i64* cnt)
{
    const PeEnd* E = A.E;
    const i32* paired = A.paired;
    const i32* pair_data = A.pair_data;
    const i64* pair_off = A.pair_off;
    const u8* title_names = A.title_names; const i64* title_off = A.title_off;
    const u32* ref32_fwd = A.ref32_fwd; const i64* anchors = A.anchors;
    const u8* useful_nt = A.useful_nt; const u8* rev_char_tab = A.rev_char_tab;
    u32 randseed = A.randseed;
    i32 report_repeat_hits = A.report_repeat_hits;
    i32 out_unmap = A.out_unmap, out_ref = A.out_ref;
    i64 w = 0;
    i64 al_p = 0, un_p = 0, mu_p = 0;
    i64 endc[6] = {0, 0, 0, 0, 0, 0};  // a: aligned/unique/multiple, b: ...
    auto put = [&](const char* s, i64 n) {
        if (w + n <= cap) memcpy(out + w, s, n);
        w += n;
    };
    auto put_str = [&](const u8* s, i64 n) { put((const char*)s, n); };
    char tmp[64];
    auto put_int = [&](i64 v) {
        int n = snprintf(tmp, 64, "%lld", (long long)v); put(tmp, n);
    };
    auto put_ch = [&](char c) { if (w < cap) out[w] = c; ++w; };
    auto put_cigar = [&](i32 L, i32 gsz, i32 gpos) {
        if (gsz == 0) { put_int(L); put_ch('M'); }
        else if (gsz > 0) {
            put_int(gpos); put_ch('M'); put_int(gsz); put_ch('D');
            put_int(L - gpos); put_ch('M');
        } else {
            put_int(gpos); put_ch('M'); put_int(-gsz); put_ch('I');
            put_int(L - gpos + gsz); put_ch('M');
        }
    };
    auto put_title = [&](i32 chr_) {
        put_str(title_names + title_off[chr_ >> 1],
                title_off[(chr_ >> 1) + 1] - title_off[chr_ >> 1]);
    };
    auto put_seqqual = [&](const PeEnd& e, i32 r, int rev) {
        const u8* seq = e.seqs + e.seq_off[r];
        const u8* qual = e.quals + e.qual_off[r];
        i64 sn = e.seq_len[r], qn = e.qual_len[r];
        if (rev) {
            for (i64 i = sn - 1; i >= 0; --i)
                put_ch((char)rev_char_tab[seq[i]]);
            put_ch('\t');
            for (i64 i = qn - 1; i >= 0; --i) put_ch((char)qual[i]);
        } else {
            put_str(seq, sn); put_ch('\t'); put_str(qual, qn);
        }
    };
    auto put_xr = [&](i32 chr_, i32 loc, i32 L) {
        put("\tXR:Z:", 6);
        i64 base0 = anchors[chr_ >> 1];
        for (int ii = 2; ii > 0; --ii) {
            if (loc < ii) continue;
            i64 pp = base0 + loc - ii;
            u32 code = (ref32_fwd[pp >> 4] >> (30 - (pp & 15) * 2)) & 3;
            put_ch((char)useful_nt[code + 4]);
        }
        for (i64 ii = 0; ii < (i64)L + 2; ++ii) {
            i64 pp = base0 + loc + ii;
            u32 code = (ref32_fwd[pp >> 4] >> (30 - (pp & 15) * 2)) & 3;
            char c = (char)useful_nt[code];
            if (ii >= L) c = (char)(c + 32);
            put_ch(c);
        }
    };
    auto put_zs = [&](i32 chr_, i32 chain) {
        put("\tZS:Z:", 6);
        put_ch((chr_ & 1) ? '-' : '+');
        put_ch(chain ? '-' : '+');
        put_ch('\n');
    };

    for (i32 r = r0; r < r1; ++r) {
        // FixPairReadName (pairs.cpp:487-507): common prefix up to the
        // last digit; identical names pass through whole
        const u8* na = E[0].names + E[0].name_off[r];
        const u8* nb = E[1].names + E[1].name_off[r];
        i64 la = E[0].name_len[r], lb = E[1].name_len[r];
        i64 fixed = -1;  // -1 = names equal, else cut length for both
        if (la != lb || memcmp(na, nb, la) != 0) {
            i64 i0 = la < lb ? la : lb, d = -1, i = 0;
            for (; i < i0; ++i) {
                if (na[i] != nb[i]) break;
                if (na[i] >= '0' && na[i] <= '9') d = i;
            }
            if (i == 0) return -2;
            if (d < 0) d = i - 1;
            fixed = d + 1;
        }
        i64 name_n[2] = {fixed < 0 ? la : fixed, fixed < 0 ? lb : fixed};
        const u8* name_p[2] = {na, nb};
        i32 L2[2] = {E[0].map_len[r], E[1].map_len[r]};

        // s_OutHitPair: one proper-pair record per end
        auto out_hit_pair = [&](const i32* d, i32 n) {
            i32 chain = d[0];
            for (int end = 0; end < 2; ++end) {
                const i32* h = end == 0 ? d + 4 : d + 8;
                const i32* mate_h = end == 0 ? d + 8 : d + 4;
                i32 nm = end == 0 ? d[1] : d[2];
                i32 ch = end == 0 ? chain : 1 - chain;
                i32 insert = d[3];
                int rev = ch ^ (h[0] & 1);
                i32 flag = 0x3;
                if (n > 1) flag |= 0x100;
                i64 pp_insert = insert;
                if (rev) { flag |= 0x10; pp_insert = -pp_insert; }
                else flag |= 0x20;
                flag |= 0x40 * E[end].rset[r];
                put_str(name_p[end], name_n[end]); put_ch('\t');
                put_int(flag); put_ch('\t');
                put_title(h[0]); put_ch('\t');
                put_int((i64)h[1] + 1); put("\t255\t", 5);
                put_cigar(L2[end], h[2], h[3]);
                put("\t=\t", 3); put_int((i64)mate_h[1] + 1); put_ch('\t');
                put_int(pp_insert); put_ch('\t');
                put_seqqual(E[end], r, rev);
                put("\tNM:i:", 6); put_int(nm);
                if (out_ref) put_xr(h[0], h[1], L2[end]);
                if (A.cc_pos) {
                    // RRBS PE proper pair: ZP = leftmost mate pos,
                    // ZL = insert (s_OutHitPair, pairs.cpp:355-358)
                    i64 zp = rev ? (i64)mate_h[1] + 1 : (i64)h[1] + 1;
                    put("\tZP:i:", 6); put_int(zp);
                    put("\tZL:i:", 6); put_int((i64)insert);
                }
                put_zs(h[0], ch);
            }
        };

        // s_OutHitUnpair: one end's record with mate fields from the
        // other end's pick (h may be null when this end is unmapped)
        auto out_hit_unpair = [&](int end, i32 chain_a, i32 chain_b,
                                  i32 ma, i32 na_, const i32* h,
                                  i32 mb, const i32* hb, i64 hb_idx) {
            const PeEnd& e = E[end];
            i32 flag = 1 | 0x40 * e.rset[r];
            if (ma <= 0) {
                if (!out_unmap) return;
                if (ma < 0) flag |= 0x204;
                if (ma == 0) flag |= 0x004;
                if (mb <= 0) {
                    flag |= 0x008;
                    put_str(name_p[end], name_n[end]); put_ch('\t');
                    put_int(flag);
                    put("\t*\t0\t0\t*\t*\t0\t0\t", 15);
                    put_str(e.seqs + e.seq_off[r], e.seq_len[r]);
                    put_ch('\t');
                    put_str(e.quals + e.qual_off[r], e.qual_len[r]);
                    put_ch('\n');
                } else {
                    i32 bchr = hb[0], bloc = hb[1];
                    (void)hb_idx;
                    if (chain_b ^ (bchr & 1)) flag |= 0x020;
                    put_str(name_p[end], name_n[end]); put_ch('\t');
                    put_int(flag);
                    put("\t*\t0\t0\t*\t", 9);
                    put_title(bchr); put_ch('\t');
                    put_int((i64)bloc + 1); put("\t0\t", 3);
                    put_str(e.seqs + e.seq_off[r], e.seq_len[r]);
                    put_ch('\t');
                    put_str(e.quals + e.qual_off[r], e.qual_len[r]);
                    put_ch('\n');
                }
                return;
            }
            int rev_seq = chain_a ^ (h[0] & 1);
            if (ma > 1) flag |= 0x100;
            if (rev_seq) flag |= 0x010;
            if (mb <= 0) flag |= 0x008;
            else if (chain_b ^ (hb[0] & 1)) flag |= 0x020;
            put_str(name_p[end], name_n[end]); put_ch('\t');
            put_int(flag); put_ch('\t');
            put_title(h[0]); put_ch('\t');
            put_int((i64)h[1] + 1); put("\t255\t", 5);
            put_cigar(L2[end], h[2], h[3]);
            if (mb <= 0) put("\t*\t0\t0\t", 7);
            else {
                put_ch('\t'); put_title(hb[0]); put_ch('\t');
                put_int((i64)hb[1] + 1); put("\t0\t", 3);
            }
            put_seqqual(E[end], r, rev_seq);
            put("\tNM:i:", 6); put_int(na_);
            if (out_ref) put_xr(h[0], h[1], L2[end]);
            if (A.cc_pos) {  // RRBS unpaired end (s_OutHitUnpair tags)
                i64 a0c = A.cc_off[h[0] >> 1];
                i64 b0c = A.cc_off[(h[0] >> 1) + 1];
                i64 zp, zl;
                ccgg_seglen_c(A.cc_pos + a0c, A.cc_rev + a0c, b0c - a0c,
                              h[1], L2[end], &zp, &zl);
                put("\tZP:i:", 6); put_int(zp);
                put("\tZL:i:", 6); put_int(zl);
            }
            put_zs(h[0], chain_a);
        };

        // StringAlignPair (pairs.cpp:204-230)
        i32 pair_reported = 0;
        if (paired[r]) {
            i64 a0 = pair_off[r], b0 = pair_off[r + 1];
            i32 cnt = (i32)(b0 - a0);
            if (cnt == 1) {
                ++un_p; ++al_p;
                out_hit_pair(pair_data + a0 * 12, 1);
                pair_reported = 1;
            } else if (cnt > 1) {
                ++mu_p;
                if (report_repeat_hits == 1) {
                    ++al_p;
                    u32 j = myrand_hash(E[0].ridx[r], randseed) % (u32)cnt;
                    out_hit_pair(pair_data + (a0 + j) * 12, cnt);
                    pair_reported = 1;
                } else if (report_repeat_hits == 2) {
                    ++al_p;
                    for (i64 j = a0; j < b0; ++j)
                        out_hit_pair(pair_data + j * 12, cnt);
                    pair_reported = 1;
                }
            }
        }
        if (pair_reported && paired[r]) continue;

        // StringAlignUnpair (pairs.cpp:232-305): per-end picks first
        i32 pm[2], pn[2], pc[2];
        i32 ph[2][4];
        const i32* php[2] = {nullptr, nullptr};
        for (int end = 0; end < 2; ++end) {
            const PeEnd& e = E[end];
            if (e.filtered[r]) { pm[end] = -1; pn[end] = 0; pc[end] = 0;
                                 continue; }
            i64 a = e.hoff[r], b = e.hoff[r + 1];
            i32 m = (i32)(b - a);
            if (m > 0 && e.stat[r] >= 0) {
                u32 rr = myrand_hash(e.ridx[r], randseed) % (u32)m;
                i32 k0 = e.n0[r];
                pc[end] = rr < (u32)k0 ? 0 : 1;
                i64 hi = a + rr;
                ph[end][0] = e.hchr[hi]; ph[end][1] = e.hloc[hi];
                ph[end][2] = e.hgsz[hi]; ph[end][3] = e.hgpos[hi];
                php[end] = ph[end];
                pm[end] = m;
                pn[end] = e.stat[r] % (e.rms[r] + 1);
            } else {
                pm[end] = 0; pn[end] = 0; pc[end] = 0;
            }
        }
        i32 ma1 = (pm[0] > 1 && report_repeat_hits == 0) ? 0 : pm[0];
        i32 mb1 = (pm[1] > 1 && report_repeat_hits == 0) ? 0 : pm[1];
        for (int end = 0; end < 2; ++end) {
            const PeEnd& e = E[end];
            i32 m = pm[end], n_ = pn[end], c = pc[end];
            const i32* h = php[end];
            i32 om1 = end == 0 ? mb1 : ma1;
            const i32* oh = php[1 - end];
            i32 oc = pc[1 - end];
            if (m <= 0) {
                if (out_unmap)
                    out_hit_unpair(end, 0, oc, m, 0, h, om1, oh, 0);
            } else if (m == 1) {
                ++endc[end * 3 + 0]; ++endc[end * 3 + 1];
                out_hit_unpair(end, c, oc, 1, n_, h, om1, oh, 0);
            } else {
                ++endc[end * 3 + 2];
                if (report_repeat_hits == 1) {
                    ++endc[end * 3 + 0];
                    out_hit_unpair(end, c, oc, m, n_, h, om1, oh, 0);
                } else if (report_repeat_hits == 2) {
                    ++endc[end * 3 + 0];
                    i64 a = e.hoff[r], b = e.hoff[r + 1];
                    i32 k0 = e.n0[r];
                    for (i64 j = a; j < b; ++j) {
                        i32 hh[4] = {e.hchr[j], e.hloc[j], e.hgsz[j],
                                     e.hgpos[j]};
                        out_hit_unpair(end, j - a < k0 ? 0 : 1, oc, m, n_,
                                       hh, om1, oh, 0);
                    }
                } else if (out_unmap) {
                    out_hit_unpair(end, 0, oc, 0, 0, h, om1, oh, 0);
                }
            }
        }
    }
    cnt[0] = al_p; cnt[1] = un_p; cnt[2] = mu_p;
    for (int k = 0; k < 6; ++k) cnt[3 + k] = endc[k];
    return w;
}

extern "C" i64 bt_format_pe(
    i32 B,
    // end a (read1 slices + replay outputs), then end b
    const u8* names_a, const i64* nameoff_a, const i32* namelen_a,
    const u8* seqs_a, const i64* seqoff_a, const i32* seqlen_a,
    const u8* quals_a, const i64* qualoff_a, const i32* quallen_a,
    const i32* maplen_a, const u32* ridx_a, const i32* rset_a,
    const u8* filt_a, const i32* rms_a,
    const i32* stat_a, const i32* n0_a, const i32* n1_a,
    const i32* hchr_a, const i32* hloc_a, const i32* hgsz_a,
    const i32* hgpos_a, const i64* hoff_a,
    const u8* names_b, const i64* nameoff_b, const i32* namelen_b,
    const u8* seqs_b, const i64* seqoff_b, const i32* seqlen_b,
    const u8* quals_b, const i64* qualoff_b, const i32* quallen_b,
    const i32* maplen_b, const u32* ridx_b, const i32* rset_b,
    const u8* filt_b, const i32* rms_b,
    const i32* stat_b, const i32* n0_b, const i32* n1_b,
    const i32* hchr_b, const i32* hloc_b, const i32* hgsz_b,
    const i32* hgpos_b, const i64* hoff_b,
    // pair results (bt_replay_pe layout: 12 i32 per record)
    const i32* paired, const i32* pair_data, const i64* pair_off,
    // reference / params
    const u8* title_names, const i64* title_off, i32 n_titles,
    const u32* ref32_fwd, const i64* anchors,
    const u8* useful_nt, const u8* rev_char_tab,
    u32 randseed, i32 report_repeat_hits, i32 out_unmap, i32 out_ref,
    const i64* cc_pos, const i64* cc_rev, const i64* cc_off,  // RRBS ZP/ZL
    u8* out, i64 cap, i64* counters, i32 n_threads)
{
    (void)n_titles;
    PeFmtArgs A{{
        {names_a, seqs_a, quals_a, nameoff_a, seqoff_a, qualoff_a,
         namelen_a, seqlen_a, quallen_a, maplen_a, ridx_a, rset_a,
         filt_a, rms_a, stat_a, n0_a, n1_a, hchr_a, hloc_a, hgsz_a,
         hgpos_a, hoff_a},
        {names_b, seqs_b, quals_b, nameoff_b, seqoff_b, qualoff_b,
         namelen_b, seqlen_b, quallen_b, maplen_b, ridx_b, rset_b,
         filt_b, rms_b, stat_b, n0_b, n1_b, hchr_b, hloc_b, hgsz_b,
         hgpos_b, hoff_b}},
        paired, pair_data, pair_off,
        title_names, title_off, ref32_fwd, anchors,
        useful_nt, rev_char_tab,
        randseed, report_repeat_hits, out_unmap, out_ref,
        cc_pos, cc_rev, cc_off};
    if (n_threads <= 1 || B < 4096) {
        i64 c[9];
        i64 w = format_pe_range(A, 0, B, out, cap, c);
        if (w == -2) return -2;
        if (w > cap) return -w;  // caller retries: don't double-count
        for (int k = 0; k < 9; ++k) counters[k] += c[k];
        return w;
    }
    // Threaded over contiguous pair chunks, order-stitched (see
    // bt_format_se; identical rationale and bit-exactness argument).
    i32 T = std::min<i64>(n_threads, (B + 2047) / 2048);
    i64 tmax = 0;
    for (i32 t = 0; t < n_titles; ++t)
        tmax = std::max(tmax, title_off[t + 1] - title_off[t]);
    std::vector<std::vector<u8>> bufs(T);
    std::vector<i64> ws(T, 0);
    std::vector<i64> cs(9 * T, 0);
    std::vector<std::thread> ts;
    for (i32 t = 0; t < T; ++t) {
        i32 r0 = (i32)((i64)B * t / T), r1 = (i32)((i64)B * (t + 1) / T);
        ts.emplace_back([&, t, r0, r1]() {
            i64 est = 0;
            for (i32 r = r0; r < r1; ++r) {
                i64 nrec = 2;
                if (report_repeat_hits == 2)
                    nrec = 2 * std::max<i64>(pair_off[r + 1] - pair_off[r], 1)
                           + (hoff_a[r + 1] - hoff_a[r])
                           + (hoff_b[r + 1] - hoff_b[r]);
                i64 per = namelen_a[r] + namelen_b[r]
                          + 2 * (i64)(seqlen_a[r] + seqlen_b[r])
                          + 2 * tmax + 160
                          + (out_ref ? maplen_a[r] + maplen_b[r] + 28 : 0)
                          + (cc_pos ? 112 : 0);  // RRBS ZP/ZL, both ends
                est += nrec * per;
            }
            std::vector<u8>& buf = bufs[t];
            buf.resize(est);
            for (;;) {
                i64 w = format_pe_range(A, r0, r1, buf.data(),
                                        (i64)buf.size(), &cs[9 * t]);
                ws[t] = w;
                if (w == -2 || w <= (i64)buf.size()) break;
                buf.resize(w);
            }
        });
    }
    for (auto& th : ts) th.join();
    i64 total = 0;
    for (i32 t = 0; t < T; ++t) {
        if (ws[t] == -2) return -2;
        total += ws[t];
    }
    if (total > cap) return -total;
    i64 w = 0;
    for (i32 t = 0; t < T; ++t) {
        memcpy(out + w, bufs[t].data(), ws[t]);
        w += ws[t];
        for (int k = 0; k < 9; ++k) counters[k] += cs[9 * t + k];
    }
    return w;
}

// --------------------------------------------------------------------------
// Host-side candidate evaluation (adaptive fallback).
//
// Same conversion-mask algebra as ops/bitops.py on u32 lanes (ref:
// CountMismatch[_new], align.h:118-239), ungapped only.  The pipeline
// dispatches a wave here instead of the accelerator when the candidate
// upload would exceed the link budget (remote-TPU tunnels; on locally
// attached chips the device always wins).  Multithreaded over candidates.
static inline u32 xc32_(u32 t) { return ((~t) << 1) | t | 0x55555555u; }
static inline u32 m2j_(u32 t) {
    return t & (((t & 0xAAAAAAAAu) >> 1) | ((t & 0x55555555u) << 1));
}
static inline u32 xt32_(u32 t) { return t - ((t << 1) & t & 0xAAAAAAAAu); }
static inline i32 xm32_(u32 t) {
    return __builtin_popcount((t | (t >> 1)) & 0x55555555u);
}

extern "C" i64 bt_eval_candidates(
    const u32* ref32, i64 nw,
    const i32* loc, const i8* plane, const i32* row, i64 C,
    const u32* base, const u32* valid, const u32* mread,
    const i32* ncnt, i32 W, i32 mode,   // 0 oneway, 1 multiway, 2 nt3
    u8* out_counts, i32 n_threads)
{
    auto work = [&](i64 c0, i64 c1) {
        for (i64 c = c0; c < c1; ++c) {
            const u32* R = ref32 + (i64)(u8)plane[c] * nw + (loc[c] >> 4);
            u32 sh = ((u32)loc[c] & 15u) << 1;
            i64 r = row[c];
            const u32* b = base + r * W;
            const u32* v = valid + r * W;
            const u32* mr = mread + r * W;
            i32 cnt = ncnt[r];
#ifdef BT_SIMD512
            out_counts[c] = (u8)count_words_simd(R, sh, b, v, mr, W, mode,
                                                 cnt);
            continue;
#endif
            for (i32 w = 0; w < W; ++w) {
                u32 a = sh ? ((R[w] << sh) | (R[w + 1] >> (32 - sh))) : R[w];
                u32 f;
                if (mode == 0) {
                    f = (b[w] & xc32_(a)) ^ a;
                } else if (mode == 1) {
                    u32 m2 = xc32_(a) | mr[w];
                    u32 m3 = m2j_(m2);
                    f = (((~m3) & m2) | (m3 & b[w])) ^ a;
                } else {
                    f = b[w] ^ xt32_(a);
                }
                cnt += xm32_(f & v[w]);
                if (cnt > 255) break;
            }
            out_counts[c] = (u8)(cnt > 255 ? 255 : cnt);
        }
    };
    if (n_threads <= 1 || C < 65536) {
        work(0, C);
    } else {
        std::vector<std::thread> ts;
        i64 per = (C + n_threads - 1) / n_threads;
        for (i32 t = 0; t < n_threads; ++t) {
            i64 a = t * per, b2 = std::min(C, a + per);
            if (a < b2) ts.emplace_back(work, a, b2);
        }
        for (auto& t : ts) t.join();
    }
    return 0;
}

// Gapped host evaluation (CountMismatch_new + MismatchPattern0/1,
// align.h:133-327): per candidate, the full mismatch count PLUS the first
// KPOS mismatch positions left-to-right (pos0) and, for each of the 2*gap
// shifted windows, right-to-left as distance-from-read-end (pos1[tt-1]).
// Bit-identical to the device kernel's gapped outputs (ops/extend.py
// _first_positions): positions masked by the read-length plane, ascending,
// padded with map_readlen.  This is what lets host placement serve gap>0
// waves (BID-seq -M T:- -g 3) without round-tripping i16 position lists
// through the device link.
extern "C" i64 bt_eval_candidates_gap(
    const u32* ref32, i64 nw,
    const i32* loc, const i8* plane, const i32* row, i64 C,
    const u32* base, const u32* valid, const u32* mread, const u32* lenmask,
    const i32* ncnt, const i32* readlen, i32 W, i32 mode, i32 gap,
    u8* out_counts, i32* out_pos0, i32* out_pos1, i32 n_threads)
{
    const i32 gap2 = 2 * gap;
    EvalCtx ev{ref32, nw, base, valid, mread, ncnt, W, mode,
               nullptr, lenmask, readlen};
    auto work = [&](i64 c0, i64 c1) {
        for (i64 c = c0; c < c1; ++c) {
            int pl = (int)(u8)plane[c];
            i64 r = row[c];
            out_counts[c] = (u8)eval_cand(&ev, loc[c], pl, r);
            mm_pattern0(&ev, loc[c], pl, r, out_pos0 + c * KPOS);
            for (i32 tt = 1; tt <= gap2; ++tt) {
                i32 t = (tt + 1) / 2;
                i32 shift = (1 - (tt % 2) * 2) * t;  // odd -> -t, even -> +t
                mm_pattern1(&ev, loc[c] + shift, pl, r,
                            out_pos1 + (c * gap2 + (tt - 1)) * KPOS);
            }
        }
    };
    if (n_threads <= 1 || C < 16384) {
        work(0, C);
    } else {
        std::vector<std::thread> ts;
        i64 per = (C + n_threads - 1) / n_threads;
        for (i32 t = 0; t < n_threads; ++t) {
            i64 a = t * per, b2 = std::min(C, a + per);
            if (a < b2) ts.emplace_back(work, a, b2);
        }
        for (auto& t : ts) t.join();
    }
    return 0;
}

// Fused candidate materialize + ungapped evaluation for one ladder wave
// (the split fill -> copy -> evaluate round-trips ~9 B/candidate through
// DRAM three times; fusing keeps each candidate in registers).  Semantics
// are bt_fill_groups(pass=1) + bt_eval_candidates in one pass: cand_loc and
// clamped counts are written at [pre(k)..), out_off[sel[k]] = base + pre(k).
// counts are i32 (the ladder's count buffer) but clamp at 255 exactly like
// the u8 device downlink.  Threads split the selected groups at
// equal-candidate boundaries.
extern "C" i64 bt_fill_eval_groups(
    const Group* groups, const i64* sel, i64 n_sel,
    const u32* locs,
    i64 base,
    const u32* ref32, i64 nw,
    const u32* baseP, const u32* validP, const u32* mreadP,
    const i32* ncnt, i32 W, i32 mode,
    i32* cand_loc, i32* counts, i64* out_off, i32 n_threads)
{
    std::vector<i64> pre(n_sel + 1);
    pre[0] = 0;
    for (i64 k = 0; k < n_sel; ++k) pre[k + 1] = pre[k] + groups[sel[k]].m;
    const i64 total = pre[n_sel];
    auto work = [&](i64 k0, i64 k1) {
        for (i64 k = k0; k < k1; ++k) {
            const Group& g = groups[sel[k]];
            i64 cur = pre[k];
            out_off[sel[k]] = base + cur;
            const u32* lp = locs + g.loff;  // seed resolved at build time
            i64 r = (i64)g.read * 2 + g.chain;
            const u32* b = baseP + r * W;
            const u32* v = validP + r * W;
            const u32* mr = mreadP + r * W;
            const i32 nc = ncnt[r];
            const i64 nn1 = g.mc + 1;
            for (i64 j = 0; j < g.m; ++j) {
                if (j + 8 < g.m) {  // hide the ref-window DRAM latency
                    i32 lcp = (i32)((i64)lp[j + 8] - g.h);
                    __builtin_prefetch(
                        ref32 + (j + 8 >= nn1 ? nw : 0) + (lcp >> 4));
                }
                i32 lc = (i32)((i64)lp[j] - g.h);
                cand_loc[cur + j] = lc;
                const u32* R = ref32 + (j >= nn1 ? nw : 0) + (lc >> 4);
                u32 sh = ((u32)lc & 15u) << 1;
                i32 cnt = nc;
#ifdef BT_SIMD512
                counts[cur + j] = count_words_simd(R, sh, b, v, mr, W, mode,
                                                   cnt);
                continue;
#endif
                for (i32 w = 0; w < W; ++w) {
                    u32 a = sh ? ((R[w] << sh) | (R[w + 1] >> (32 - sh)))
                               : R[w];
                    u32 f;
                    if (mode == 0) {
                        f = (b[w] & xc32_(a)) ^ a;
                    } else if (mode == 1) {
                        u32 m2 = xc32_(a) | mr[w];
                        u32 m3 = m2j_(m2);
                        f = (((~m3) & m2) | (m3 & b[w])) ^ a;
                    } else {
                        f = b[w] ^ xt32_(a);
                    }
                    cnt += xm32_(f & v[w]);
                    if (cnt > 255) break;
                }
                counts[cur + j] = cnt > 255 ? 255 : cnt;
            }
        }
    };
    if (n_threads <= 1 || total < 65536) {
        work(0, n_sel);
    } else {
        std::vector<std::thread> ts;
        i64 k0 = 0;
        for (i32 t = 1; t <= n_threads && k0 < n_sel; ++t) {
            i64 want = total * t / n_threads;
            i64 k1 = (t == n_threads)
                ? n_sel
                : (std::upper_bound(pre.begin(), pre.end(), want)
                   - pre.begin() - 1);
            if (k1 > k0) { ts.emplace_back(work, k0, k1); k0 = k1; }
        }
        for (auto& t : ts) t.join();
    }
    return total;
}

// Unmasked-region scan (RefSeq::UnmaskRegion, refbase.cpp:103-128): one
// pass over the raw sequence chars emitting [begin, end) runs that start
// at a useful (ACGTacgt) char and end at the next N/X/n/x char, keeping
// runs >= 16 bp.  Chars that are neither (other IUPAC letters) neither
// start nor end a run.  Exact twin of the numpy transition scan in
// index/reference.py::_unmask_region (which cost ~3.5 s in 200 MB
// boolean temporaries at 200 Mbp).  Returns the run count, or -needed
// when cap is too small (caller grows and retries).
extern "C" i64 bt_unmask_blocks(const u8* seq, i64 n,
                                const u8* useful_tab, const u8* nx_tab,
                                i64* out_begin, i64* out_end, i64 cap)
{
    i64 m = 0;
    i64 i = 0;
    while (i < n) {
        while (i < n && !useful_tab[seq[i]]) ++i;
        if (i >= n) break;
        i64 begin = i;
        i64 j = begin;
        while (j < n && !nx_tab[seq[j]]) ++j;
        if (j - begin >= 16) {
            if (m < cap) { out_begin[m] = begin; out_end[m] = j; }
            ++m;
        }
        i = j;
    }
    if (m > cap) return -m;
    return m;
}

// Fused alphabet-map + 2-bit pack of a reference plane (refbase.cpp:58-101
// behavior): chars go through a 256-entry code table and pack 16 bases per
// u32 word, first base in bits 31:30.  reverse=1 reads chars back-to-front
// (the RC plane packs the padded sequence reversed through the complement
// table).  n must be a multiple of 16.
// Top-K values of the dense k-mer count table (descending), one memory
// pass with a tiny insertion buffer — the k-mer cutoff quantile sits
// ~nk*5e-7 slots from the top (refbase.cpp:362-363), so K=64 covers the
// default; callers fall back to a full selection for exotic -k ratios.
extern "C" i64 bt_top_counts(const i32* counts, i64 n, i32 K, i32* out)
{
    for (i32 i = 0; i < K; ++i) out[i] = -1;
    i32 floor_ = -1;  // smallest value currently in the top-K buffer
    for (i64 i = 0; i < n; ++i) {
        i32 v = counts[i];
        if (v <= floor_) continue;
        i32 j = K - 1;
        while (j > 0 && out[j - 1] < v) { out[j] = out[j - 1]; --j; }
        out[j] = v;
        floor_ = out[K - 1];
    }
    for (i32 i = 0; i < K; ++i) if (out[i] < 0) out[i] = 0;
    return 0;
}

extern "C" i64 bt_pack_ref(const u8* chars, i64 n, const u8* table,
                           i32 reverse, u32* out, i32 n_threads)
{
    const i64 nwords = n / 16;
    auto work = [&](i64 w0, i64 w1) {
        if (!reverse) {
            for (i64 w = w0; w < w1; ++w) {
                const u8* c = chars + w * 16;
                u32 v = 0;
                for (int j = 0; j < 16; ++j) v = (v << 2) | table[c[j]];
                out[w] = v;
            }
        } else {
            for (i64 w = w0; w < w1; ++w) {
                const u8* c = chars + (n - 1 - w * 16);
                u32 v = 0;
                for (int j = 0; j < 16; ++j) v = (v << 2) | table[*(c - j)];
                out[w] = v;
            }
        }
    };
    if (n_threads <= 1 || nwords < 1 << 16) {
        work(0, nwords);
    } else {
        std::vector<std::thread> ts;
        i64 per = (nwords + n_threads - 1) / n_threads;
        for (i32 t = 0; t < n_threads; ++t) {
            i64 a = t * per, b = std::min(nwords, a + per);
            if (a < b) ts.emplace_back(work, a, b);
        }
        for (auto& t : ts) t.join();
    }
    return nwords;
}

// Threaded sequential memset for large np.empty tables (e.g. the RRBS
// index build's 3^s-slot CSR tables): np.zeros defers to lazily-faulted
// mmap zero pages, and the scatter fill then pays random-order first-touch
// faults; sequential threaded memsets fault with fault-around batching.
extern "C" void bt_memset_mt(void* p, i64 bytes, i32 n_threads)
{
    i32 nt = n_threads > 1 ? n_threads : 1;
    if (nt == 1 || bytes < (1 << 20)) {
        std::memset(p, 0, (size_t)bytes);
        return;
    }
    std::vector<std::thread> ts;
    size_t per = ((size_t)bytes + nt - 1) / nt;
    per = (per + 63) & ~size_t(63);
    for (i32 t = 0; t < nt; ++t) {
        size_t a = (size_t)t * per;
        if (a >= (size_t)bytes) break;
        size_t m = std::min(per, (size_t)bytes - a);
        ts.emplace_back([p, a, m] { std::memset((char*)p + a, 0, m); });
    }
    for (auto& t : ts) t.join();
}

// CSR seed-index build (RefSeq::CalKmerFreq/AllocIndex/FillIndex,
// refbase.cpp:254-448) as a counting sort: seed per probed position, dense
// histogram over the 3^s key space, prefix sum, stable scatter (ascending
// input order = chain-0 entries before chain-1, each in traversal order —
// the reference's two-thread fill layout).  pos arrays hold anchored base
// coords; seeds use the XT 3-letter collapse (param.h:107-116) packed
// base-3, first base most significant, truncated to seed_size digits.
// starts/counts/n1 must arrive zero-filled.
extern "C" i64 bt_build_seed_index(
    const u32* ref0, const u32* ref1, i64 nw,
    const i64* pos0, i64 n0, const i64* pos1, i64 n1_,
    i32 seed_size, i64 nk,
    i64* starts, i32* counts, i32* n1, u32* locs, i32 n_threads)
{
    const i64 n = n0 + n1_;
    const bool prof = getenv("BT_BUILD_PROF") != nullptr;
    auto now = []() {
        struct timespec ts;
        clock_gettime(CLOCK_MONOTONIC, &ts);
        return ts.tv_sec + 1e-9 * ts.tv_nsec;
    };
    double t0 = prof ? now() : 0.0, tz = 0, te = 0, th = 0, ts_ = 0;
    // zero the dense tables here, threaded: the caller hands np.empty
    // buffers because zeroing 43M-slot tables via np.zeros pays
    // random-order first-touch faults during the fill (measured 0.4-1.1s
    // of the 2Mbp build); sequential threaded memsets fault with
    // fault-around batching instead
    {
        auto zero = [&](void* p, size_t bytes) {
            i32 nt = n_threads > 1 ? n_threads : 1;
            std::vector<std::thread> ts;
            size_t per = (bytes + nt - 1) / nt;
            per = (per + 63) & ~size_t(63);
            for (i32 t = 0; t < nt; ++t) {
                size_t a = t * per;
                if (a >= bytes) break;
                size_t m = std::min(per, bytes - a);
                ts.emplace_back([p, a, m] {
                    std::memset((char*)p + a, 0, m);
                });
            }
            for (auto& t : ts) t.join();
        };
        zero(starts, (size_t)nk * sizeof(i64));
        zero(counts, (size_t)nk * sizeof(i32));
        zero(n1, (size_t)nk * sizeof(i32));
    }
    if (prof) { tz = now(); }
    // byte LUT: 4 packed 2-bit codes -> base-3 value of the 4 collapsed
    // digits (code 3 collapses to 1)
    u32 lut[256];
    for (int b = 0; b < 256; ++b) {
        u32 v = 0;
        for (int j = 3; j >= 0; --j) {
            u32 c = ((u32)b >> (2 * j)) & 3u;
            if (c == 3u) c = 1u;
            v = v * 3u + c;
        }
        lut[b] = v;
    }
    u32 div = 1;
    for (i32 j = 0; j < 16 - seed_size; ++j) div *= 3u;
    std::vector<u32> seeds(n);
    auto seed_at = [&](const u32* R, i64 p) -> u32 {
        i64 w = p >> 4;
        u32 sh = (u32)(p & 15);
        u64 d = ((u64)R[w] << 32) | R[w + 1];
        u32 win = (u32)(d >> (32 - 2 * sh)) ;
        u32 v = ((lut[(win >> 24) & 0xFF] * 81u + lut[(win >> 16) & 0xFF])
                 * 81u + lut[(win >> 8) & 0xFF]) * 81u + lut[win & 0xFF];
        return v / div;
    };
    auto work = [&](i64 a, i64 b) {
        for (i64 i = a; i < b; ++i)
            seeds[i] = (i < n0) ? seed_at(ref0, pos0[i])
                                : seed_at(ref1, pos1[i - n0]);
    };
    if (n_threads <= 1 || n < 65536) {
        work(0, n);
    } else {
        std::vector<std::thread> ts;
        i64 per = (n + n_threads - 1) / n_threads;
        for (i32 t = 0; t < n_threads; ++t) {
            i64 a = t * per, b = std::min(n, a + per);
            if (a < b) ts.emplace_back(work, a, b);
        }
        for (auto& t : ts) t.join();
    }
    // histogram + scatter are the cost at scale (each probe is a random
    // slot touch in 172-344 MB tables: ~250M cache misses at 200 Mbp ran
    // 12-14 s serial).  Partition by KEY RANGE: every thread scans the
    // whole seeds[] stream (sequential, cheap) but touches only keys in
    // its own range — per-key increment/scatter order is exactly the
    // serial order, so the CSR layout is bit-identical, and each thread's
    // table working set shrinks to 1/T of the slots.  Hot keys (repeat
    // genomes) concentrate in one thread but stay L1-resident there, so
    // the miss load self-balances.
    if (prof) { te = now(); }
    i32 T = (n_threads > 1 && n >= (1 << 20)) ? n_threads : 1;
    if (T == 1) {
        for (i64 i = 0; i < n; ++i) counts[seeds[i]]++;
        for (i64 i = 0; i < n0; ++i) n1[seeds[i]]++;
    } else {
        std::vector<std::thread> ts;
        for (i32 t = 0; t < T; ++t) {
            u32 k0 = (u32)(nk * t / T), k1 = (u32)(nk * (t + 1) / T);
            ts.emplace_back([&, k0, k1]() {
                const i32 PF = 24;
                // chain-0 prefix: count into BOTH tables in one seeds scan
                for (i64 i = 0; i < n0; ++i) {
                    if (i + PF < n0) {
                        u32 sp = seeds[i + PF];
                        __builtin_prefetch(counts + sp, 1, 0);
                        __builtin_prefetch(n1 + sp, 1, 0);
                    }
                    u32 sd = seeds[i];
                    if (sd >= k0 && sd < k1) { counts[sd]++; n1[sd]++; }
                }
                for (i64 i = n0; i < n; ++i) {
                    if (i + PF < n) __builtin_prefetch(counts + seeds[i + PF], 1, 0);
                    u32 sd = seeds[i];
                    if (sd >= k0 && sd < k1) counts[sd]++;
                }
            });
        }
        for (auto& t : ts) t.join();
    }
    if (prof) { th = now(); }
    i64 acc = 0;
    for (i64 k = 0; k < nk; ++k) { acc += counts[k]; starts[k] = acc; }
    // stable scatter, descending input order: each slot cursor walks back
    // from its end, so equal keys keep ascending input order and the cursor
    // finishes at the slot begin — starts needs no separate temp
    if (T == 1) {
        for (i64 i = n - 1; i >= 0; --i)
            locs[--starts[seeds[i]]] = (u32)((i < n0) ? pos0[i]
                                                      : pos1[i - n0]);
    } else {
        // mass-balanced key boundaries from the freshly built prefix sum
        // (starts[k] = end offset of slot k): each thread owns a disjoint
        // key range AND the disjoint locs region its keys scatter into
        std::vector<u32> bnd(T + 1);
        bnd[0] = 0; bnd[T] = (u32)nk;
        for (i32 t = 1; t < T; ++t) {
            i64 want = n * t / T;
            bnd[t] = (u32)(std::upper_bound(starts, starts + nk, want)
                           - starts);
            if (bnd[t] < bnd[t - 1]) bnd[t] = bnd[t - 1];
        }
        std::vector<std::thread> ts;
        for (i32 t = 0; t < T; ++t) {
            u32 k0 = bnd[t], k1 = bnd[t + 1];
            if (k0 >= k1) continue;
            ts.emplace_back([&, k0, k1]() {
                const i32 PF = 24;
                for (i64 i = n - 1; i >= 0; --i) {
                    if (i - PF >= 0) __builtin_prefetch(starts + seeds[i - PF], 1, 0);
                    u32 sd = seeds[i];
                    if (sd >= k0 && sd < k1)
                        locs[--starts[sd]] = (u32)((i < n0) ? pos0[i]
                                                            : pos1[i - n0]);
                }
            });
        }
        for (auto& t : ts) t.join();
    }
    if (prof) {
        ts_ = now();
        fprintf(stderr,
                "[bt_build] zero %.2f extract %.2f hist %.2f scatter %.2f\n",
                tz - t0, te - tz, th - te, ts_ - th);
    }
    for (i64 k = 0; k < nk; ++k)
        if (!counts[k]) starts[k] = 0;  // python twin zero-fills empty slots
    return n;
}

// Parallel groups-only candidate build.  The per-read scheduler state
// (xseed start offset) is cross-read sticky ONLY for reads with
// (L-I+1) % s == 0 (the stale-seed-array quirk: the best-offset search is
// skipped, so the previous read's offset leaks through).  When no
// unfiltered read in the batch hits that case, every scheduled read fully
// overwrites the state before use and the batch is embarrassingly
// parallel; otherwise fall back to the exact serial build.
extern "C" i64 bt_build_groups_mt(
    i32 B, i32 S,
    const u32* seedval, const u8* has_n, const i32* n_offsets,
    const i32* map_len, const i32* seedseg, const u8* xflag,
    const u8* filtered, const u32* read_index,
    const i64* starts, const i32* counts, const i32* n1, const u32* locs,
    i32 I, i32 s, i64 max_kmer_num, u32 randseed,
    const i64* profile, i64 prof_stride,
    i32* start_offset_state,
    u32* seed_state /*[2*STALE_N]*/, u8* reg_state /*[2*STALE_N]*/,
    Group* groups, i64* group_offsets /*[B+1]*/, i64* out_ngroups,
    i32 n_threads)
{
    bool par = n_threads > 1 && B >= 2048;
    if (par) {
        for (i32 r = 0; r < B; ++r)
            if (!filtered[r] && seedseg[r] > 0
                && (map_len[r] - I + 1) % s == 0) {
                par = false;
                break;
            }
    }
    if (!par)
        return bt_build_candidates(
            B, S, seedval, has_n, n_offsets, map_len, seedseg, xflag,
            filtered, read_index, starts, counts, n1, locs, I, s,
            max_kmer_num, randseed, profile, prof_stride,
            start_offset_state, seed_state, reg_state,
            2, nullptr, nullptr, nullptr,
            groups, group_offsets, out_ngroups);

    Shared sh{B, S, seedval, has_n, n_offsets, map_len, seedseg, xflag,
              filtered, read_index, starts, counts, n1, locs,
              I, s, 0, 0, 0, 0, max_kmer_num, randseed, profile, prof_stride};
    i32 T = n_threads;
    std::vector<std::vector<Group>> lg(T);
    std::vector<std::vector<i64>> lgoff(T);   // per-read local ng
    std::vector<i64> lflat(T, 0);
    std::vector<i32> lstate(T * 2);
    std::vector<u8> lset(T * 2, 0);
    i64 per = (B + T - 1) / T;
    auto work = [&](i32 t) {
        i32 r0 = (i32)std::min<i64>((i64)t * per, B);
        i32 r1 = (i32)std::min<i64>(r0 + per, B);
        auto& gv = lg[t];
        auto& go = lgoff[t];
        go.resize(r1 - r0 + 1);
        i32 st[2] = {start_offset_state[0], start_offset_state[1]};
        Sched sc[2];
        std::vector<u32> cc2((i64)2 * S);
        i64 flat = 0, ng = 0;
        for (i32 r = r0; r < r1; ++r) {
            go[r - r0] = ng;
            if (filtered[r]) continue;
            if (seedseg[r] <= 0) {
                // ReorderSeed with 0 segments resets the sticky start to 0
                // when max_offset > 0 (see bt_build_candidates)
                if ((map_len[r] - I + 1) % s > 0)
                    for (int chain = 0; chain < 2; ++chain)
                        if (xflag[r * 2 + chain]) {
                            st[chain] = 0;
                            lset[t * 2 + chain] = 1;
                            lstate[t * 2 + chain] = 0;
                        }
                continue;
            }
            schedule_read(sh, r, st, seed_state, reg_state, sc, cc2.data());
            for (int chain = 0; chain < 2; ++chain)
                if (sc[chain].active && (map_len[r] - I + 1) % s != 0) {
                    lset[t * 2 + chain] = 1;
                    lstate[t * 2 + chain] = st[chain];
                }
            u32 rv = myrand_hash(read_index[r], randseed);
            for (int chain = 0; chain < 2; ++chain) {
                if (!sc[chain].active) continue;
                const u32* sv = seedval + ((i64)r * 2 + chain) * S;
                const u32* cc = cc2.data() + (i64)chain * S;
                for (i32 mode = 0; mode < seedseg[r]; ++mode) {
                    i32 seg = sc[chain].order[mode];
                    for (i32 i = 0; i < I; ++i) {
                        i64 off = profile[seg * prof_stride + i]
                                  + sc[chain].start_arr[seg] - i;
                        u32 sd = sv[off];  // par mode: off always in-range
                        i64 m = cc[off];
                        if (m == 0 || m > max_kmer_num) continue;
                        gv.push_back(Group{r, chain, mode, seg, off, flat, m,
                                           (i64)n1[sd] - 1,
                                           (i64)(rv % (u32)m), starts[sd]});
                        flat += m;
                        ++ng;
                    }
                }
            }
        }
        go[r1 - r0] = ng;
        lflat[t] = flat;
    };
    {
        std::vector<std::thread> ts;
        for (i32 t = 0; t < T; ++t) ts.emplace_back(work, t);
        for (auto& th : ts) th.join();
    }
    // merge: prefix offsets, copy groups with start/read-offset rebase
    i64 flat = 0, ng = 0;
    for (i32 t = 0; t < T; ++t) {
        i32 r0 = (i32)std::min<i64>((i64)t * per, B);
        i32 r1 = (i32)std::min<i64>(r0 + per, B);
        for (i32 r = r0; r < r1; ++r)
            group_offsets[r] = ng + lgoff[t][r - r0];
        for (const Group& g : lg[t]) {
            Group gg = g;
            gg.start += flat;
            groups[ng++] = gg;
        }
        flat += lflat[t];
    }
    group_offsets[B] = ng;
    for (int chain = 0; chain < 2; ++chain)
        for (i32 t = T - 1; t >= 0; --t)
            if (lset[t * 2 + chain]) {
                start_offset_state[chain] = lstate[t * 2 + chain];
                break;
            }
    // outgoing stale buffers: index k holds the seed of the LAST unfiltered
    // chain-enabled read with L - s >= k — reconstructed by a backwards
    // cover scan (each read overwrites a prefix, so later reads mask
    // earlier ones); entries above the batch's total cover keep the
    // carried-in values.  Equivalent to the serial per-read refresh.
    for (int chain = 0; chain < 2; ++chain) {
        i32 cover = 0;
        for (i32 r = B - 1; r >= 0 && cover < STALE_N; --r) {
            if (filtered[r] || !xflag[r * 2 + chain]) continue;
            i32 n = std::min(n_offsets[r], STALE_N);
            if (n > cover) {
                memcpy(seed_state + (i64)chain * STALE_N + cover,
                       seedval + ((i64)r * 2 + chain) * S + cover,
                       (size_t)(n - cover) * 4);
                memcpy(reg_state + (i64)chain * STALE_N + cover,
                       has_n + ((i64)r * 2 + chain) * S + cover,
                       (size_t)(n - cover));
                cover = n;
            }
        }
    }
    *out_ngroups = ng;
    return flat;
}

// ---------------------------------------------------------------------------
// Fused single-pass SE host alignment: per read, seed scheduling + candidate
// group build + the full RunAlign scan with VISIT-TIME evaluation (EvalCtx),
// in one cache-hot pass.  Replaces the build_groups -> fill_eval -> replay
// triple when placement is the host evaluator: no Group/loc/count buffers
// round-trip through DRAM, and candidates of modes past each read's
// resolution stratum are never evaluated at all (the reference's pigeonhole
// early stop, align.cpp:459-466, applied to evaluation cost — the split
// pipeline eagerly evaluated every wave-1 candidate).
//
// Threading mirrors bt_build_groups_mt: parallel over read chunks only when
// no unfiltered read has (map_len - I + 1) % s == 0 (the stale-seed-buffer
// quirk makes scheduling cross-read sequential otherwise); the serial path
// keeps exact per-read stale-buffer updates.  Hit output uses the same
// order-stitched per-thread sinks as bt_replay_se (bit-identical to serial).
//
// Returns 0 ok, -1 if hit_cap is insufficient — the caller must restore
// start_offset_state/seed_state/reg_state from a snapshot and retry.
// out_ncand[0] += candidates enumerated, out_ncand[1] += evaluated.
extern "C" i64 bt_align_se_host(
    i32 B, i32 S,
    const u32* seedval, const u8* has_n, const i32* n_offsets,
    const i32* map_len, const i32* seedseg, const u8* xflag,
    const u8* filtered, const u32* read_index,
    const i64* starts, const i32* counts, const i32* n1, const u32* locs,
    i32 I, i32 s, i64 max_kmer_num, u32 randseed,
    const i64* profile, i64 prof_stride,
    i32* start_offset_state,
    u32* seed_state /*[2*STALE_N]*/, u8* reg_state /*[2*STALE_N]*/,
    // scan/ref context
    const i64* anchors, i32 n_chr, const i64* rc_off, const i64* sizes,
    const i32* read_max_snp,
    i32 seed_size, i32 gap, i32 gap_edge, i32 max_num_hits, i32 nt3,
    // eval tables (always required here: every candidate evaluates at visit)
    const u32* ev_ref32, i64 ev_nw,
    const u32* ev_base, const u32* ev_valid, const u32* ev_mread,
    const i32* ev_ncnt, i32 ev_W, i32 ev_mode,
    const u32* ev_lenmask, const i32* ev_readlen,
    // outputs (bt_replay_se layout)
    i32* out_stratum, i32* out_n0, i32* out_n1,
    i64 hit_cap,
    i32* hit_chr, i32* hit_loc, i32* hit_gsz, i32* hit_gpos, u8* hit_chain,
    i64* hit_offsets /*[B+1]*/,
    i64* out_ncand /*[2]*/,
    i32 n_threads)
{
    Shared sh{B, S, seedval, has_n, n_offsets, map_len, seedseg, xflag,
              filtered, read_index, starts, counts, n1, locs,
              I, s, 0, 0, 0, 0, max_kmer_num, randseed, profile, prof_stride};
    RefCtx cx{anchors, rc_off, sizes, n_chr, nullptr, nullptr, nullptr,
              nullptr, seed_size, gap, gap_edge, max_num_hits, nt3};
    EvalCtx ev{ev_ref32, ev_nw, ev_base, ev_valid, ev_mread, ev_ncnt,
               ev_W, ev_mode, locs, ev_lenmask, ev_readlen};
    cx.ev = &ev;

    bool par = n_threads > 1 && B >= 2048;
    if (par) {
        for (i32 r = 0; r < B; ++r)
            if (!filtered[r] && seedseg[r] > 0
                && (map_len[r] - I + 1) % s == 0) {
                par = false;
                break;
            }
    }
    i32 nt = par ? n_threads : 1;
    if (nt > B) nt = B > 0 ? B : 1;

    // alignas(64): adjacent threads' hot per-read counters (ncand/neval)
    // must not share a cache line — the unaligned layout cost ~hundreds of
    // cycles/read of coherence traffic in the enumerate loop (aligntimes)
    struct alignas(64) Sink {
        std::vector<i32> chr, loc, gsz, gpos;
        std::vector<u8> chain;
        i64 ncand = 0, neval = 0;
        i32 st[2];
        i32 lstate[2] = {0, 0};
        u8 lset[2] = {0, 0};
    };
    std::vector<Sink> sinks(nt);
    i64 per = ((i64)B + nt - 1) / nt;

    auto work = [&](i32 t) {
        Sink& sk = sinks[t];
        i32 r0 = (i32)std::min<i64>((i64)t * per, B);
        i32 r1 = (i32)std::min<i64>(r0 + per, B);
        sk.st[0] = start_offset_state[0];
        sk.st[1] = start_offset_state[1];
        Sched sc[2];
        std::vector<u32> cc2((i64)2 * S);
        std::vector<Group> lg;
        lg.reserve(64);
        ScanState scan;
        for (i32 r = r0; r < r1; ++r) {
            out_stratum[r] = 0; out_n0[r] = 0; out_n1[r] = 0;
            if (filtered[r]) { out_stratum[r] = -1; continue; }
            if (!par) {
                // exact serial stale-buffer refresh (ConvertBinarySeq
                // effect — see bt_build_candidates)
                i32 nc = std::min(n_offsets[r], STALE_N);
                for (int chain = 0; chain < 2; ++chain) {
                    if (!xflag[r * 2 + chain] || nc <= 0) continue;
                    memcpy(seed_state + (i64)chain * STALE_N,
                           seedval + ((i64)r * 2 + chain) * S,
                           (size_t)nc * 4);
                    memcpy(reg_state + (i64)chain * STALE_N,
                           has_n + ((i64)r * 2 + chain) * S, (size_t)nc);
                }
            }
            if (seedseg[r] <= 0) {
                if ((map_len[r] - I + 1) % s > 0)
                    for (int chain = 0; chain < 2; ++chain)
                        if (xflag[r * 2 + chain]) {
                            sk.st[chain] = 0;
                            sk.lset[chain] = 1;
                            sk.lstate[chain] = 0;
                        }
                continue;
            }
            schedule_read(sh, r, sk.st, seed_state, reg_state, sc,
                          cc2.data());
            if (par)
                for (int chain = 0; chain < 2; ++chain)
                    if (sc[chain].active && (map_len[r] - I + 1) % s != 0) {
                        sk.lset[chain] = 1;
                        sk.lstate[chain] = sk.st[chain];
                    }
            u32 rv = myrand_hash(read_index[r], randseed);
            lg.clear();
            {
            BT_PROF_SCOPE(2);
            // Two-phase enumerate (aligntimes attribution): the probe loop
            // itself is ~250 cyc/read, but each accepted probe costs two
            // serialized DRAM misses into the 3^s-slot n1[]/starts[]
            // tables (~350 cyc per group at ~5 groups/read).  Phase A
            // filters probes and issues all groups' n1/starts prefetches
            // up front so the misses overlap; phase B builds the Groups in
            // the identical order — bit-exact by construction.
            struct Probe { i32 chain, mode, seg; i64 off; u32 sd; i64 m; };
            Probe pbuf[2 * 16 * (MAXSNPS + 1)];
            int npb = 0;
            for (int chain = 0; chain < 2; ++chain) {
                if (!sc[chain].active) continue;
                const u32* sv = seedval + ((i64)r * 2 + chain) * S;
                const u32* cc = cc2.data() + (i64)chain * S;
                const u32* st_sd = seed_state + (i64)chain * STALE_N;
                i32 n_off = n_offsets[r];
                for (i32 mode = 0; mode < seedseg[r]; ++mode) {
                    i32 seg = sc[chain].order[mode];
                    const i64* prow = profile + seg * prof_stride;
                    i32 start = sc[chain].start_arr[seg];
                    for (i32 i = 0; i < I; ++i) {
                        i64 off = prow[i] + start - i;
                        u32 sd;
                        i64 m;
                        if (off < n_off) {
                            sd = sv[off];
                            m = cc[off];
                        } else if (off < STALE_N) {
                            sd = st_sd[off];  // stale probe (serial only)
                            m = counts[sd];
                        } else {
                            continue;
                        }
                        if (m == 0 || m > max_kmer_num) continue;
#ifdef BT_PROF_NOPUSH  // attribution builds only (tools/aligntimes.py)
                        sk.ncand += m + sd;
                        continue;
#endif
                        __builtin_prefetch(n1 + sd, 0, 0);
                        __builtin_prefetch(starts + sd, 0, 0);
                        pbuf[npb++] = Probe{chain, mode, seg, off, sd, m};
                    }
                }
            }
            for (int j = 0; j < npb; ++j) {
                const Probe& pb = pbuf[j];
                i64 loff = starts[pb.sd];
                // m == 1 (~80% of groups on the random profile) makes the
                // rotation trivially 0 — skip the 20+-cycle division
                i64 jj0 = pb.m == 1 ? 0 : (i64)(rv % (u32)pb.m);
                // warm the scan's first visit: group visits start at the
                // random rotation index jj0
                __builtin_prefetch(locs + loff + jj0, 0, 0);
                // start = -1 marks never-materialized: the scan evaluates
                // these candidates at visit time
                lg.push_back(Group{r, pb.chain, pb.mode, pb.seg, pb.off, -1,
                                   pb.m, (i64)n1[pb.sd] - 1, jj0, loff});
                sk.ncand += pb.m;
            }
            }
            if (lg.empty()) continue;
#ifdef BT_PROF_NOSCAN  // attribution builds only (tools/alignprof.py)
            continue;
#endif
            {
            BT_PROF_SCOPE(3);
            scan.init(&cx, lg.data(), 0, (i64)lg.size(),
                      map_len[r], read_max_snp[r], seedseg[r]);
            scan.counts_off = nullptr;
            scan.n_eval = 0;
            scan.run_all();
            }
            sk.neval += scan.n_eval;
            i32 best = scan.best_stratum();
            out_stratum[r] = best;
            if (best > scan.rms) continue;
            BT_PROF_SCOPE(4);
            out_n0[r] = (i32)scan.buckets[0][best].size();
            out_n1[r] = (i32)scan.buckets[1][best].size();
            for (int c = 0; c < 2; ++c)
                for (const H& h : scan.buckets[c][best]) {
                    sk.chr.push_back(h.chr); sk.loc.push_back(h.loc);
                    sk.gsz.push_back(h.gsz); sk.gpos.push_back(h.gpos);
                    sk.chain.push_back((u8)c);
                }
        }
    };
    if (nt == 1) {
        work(0);
    } else {
        std::vector<std::thread> ts;
        for (i32 t = 0; t < nt; ++t) ts.emplace_back(work, t);
        for (auto& th : ts) th.join();
    }

    i64 total = 0;
    for (auto& s2 : sinks) total += (i64)s2.chr.size();
    if (total > hit_cap) return -1;
    i64 hw = 0;
    for (i32 r = 0; r < B; ++r) {
        hit_offsets[r] = hw;
        hw += out_n0[r] + out_n1[r];
    }
    hit_offsets[B] = hw;
    i64 bw = 0;
    for (auto& s2 : sinks) {
        i64 n = (i64)s2.chr.size();
        if (n) {
            std::memcpy(hit_chr + bw, s2.chr.data(), n * sizeof(i32));
            std::memcpy(hit_loc + bw, s2.loc.data(), n * sizeof(i32));
            std::memcpy(hit_gsz + bw, s2.gsz.data(), n * sizeof(i32));
            std::memcpy(hit_gpos + bw, s2.gpos.data(), n * sizeof(i32));
            std::memcpy(hit_chain + bw, s2.chain.data(), n);
        }
        bw += n;
        out_ncand[0] += s2.ncand;
        out_ncand[1] += s2.neval;
    }
    if (par) {
        // outgoing sticky start: last thread that set it wins (serial order)
        for (int chain = 0; chain < 2; ++chain)
            for (i32 t = nt - 1; t >= 0; --t)
                if (sinks[t].lset[chain]) {
                    start_offset_state[chain] = sinks[t].lstate[chain];
                    break;
                }
        // outgoing stale buffers: backwards cover scan (see
        // bt_build_groups_mt)
        for (int chain = 0; chain < 2; ++chain) {
            i32 cover = 0;
            for (i32 r = B - 1; r >= 0 && cover < STALE_N; --r) {
                if (filtered[r] || !xflag[r * 2 + chain]) continue;
                i32 n = std::min(n_offsets[r], STALE_N);
                if (n > cover) {
                    memcpy(seed_state + (i64)chain * STALE_N + cover,
                           seedval + ((i64)r * 2 + chain) * S + cover,
                           (size_t)(n - cover) * 4);
                    memcpy(reg_state + (i64)chain * STALE_N + cover,
                           has_n + ((i64)r * 2 + chain) * S + cover,
                           (size_t)(n - cover));
                    cover = n;
                }
            }
        }
    } else {
        start_offset_state[0] = sinks[0].st[0];
        start_offset_state[1] = sinks[0].st[1];
    }
    return 0;
}

// ---------------------------------------------------------------------------
// SAM -> BAM record encoder (toolkit/bamio.py:encode_bam_record twin).
// The reference pipes SAM text to a samtools child for -o *.bam
// (main.cpp:504-513); our in-process writer encoded records in Python at
// ~45 us/record — this C twin encodes the whole chunk in one pass.
// Returns bytes written into out, -1 if out_cap would overflow, -2 on a
// malformed record (caller falls back to the Python encoder for the chunk).

namespace {

inline i32 bam_reg2bin(i64 beg, i64 end) {
    --end;
    if (beg >> 14 == end >> 14) return (i32)(((1 << 15) - 1) / 7 + (beg >> 14));
    if (beg >> 17 == end >> 17) return (i32)(((1 << 12) - 1) / 7 + (beg >> 17));
    if (beg >> 20 == end >> 20) return (i32)(((1 << 9) - 1) / 7 + (beg >> 20));
    if (beg >> 23 == end >> 23) return (i32)(((1 << 6) - 1) / 7 + (beg >> 23));
    if (beg >> 26 == end >> 26) return (i32)(((1 << 3) - 1) / 7 + (beg >> 26));
    return 0;
}

struct RefTab {
    const u8* names;      // concatenated name bytes
    const i64* off;       // [n+1] offsets into names
    i32 n;
    i32 find(const u8* s, i64 len) const {
        for (i32 i = 0; i < n; ++i)
            if (off[i + 1] - off[i] == len
                && !memcmp(names + off[i], s, (size_t)len))
                return i;
        return -1;
    }
};

}  // namespace

extern "C" i64 bt_sam_to_bam(
    const u8* text, i64 n,
    const u8* ref_names, const i64* name_off, i32 n_refs,
    u8* out, i64 out_cap)
{
    // "=ACMGRSVTWYHKDBN" (+ lowercase) -> 0..15, everything else 15
    // (bamio._NT16_CODE); "MIDNSHP=X" -> 0..8 (bamio._CIGAR_CODE)
    struct Tabs {
        i8 nt16[256];
        i8 cig[256];
        Tabs() {
            memset(nt16, 15, sizeof nt16);
            const char* s = "=ACMGRSVTWYHKDBN";
            for (int i = 0; i < 16; ++i) {
                nt16[(u8)s[i]] = (i8)i;
                nt16[(u8)(s[i] | 32)] = (i8)i;  // lowercase letters
            }
            nt16[(u8)'='] = 0;                  // '=' | 32 is '=' anyway
            memset(cig, -1, sizeof cig);
            const char* c = "MIDNSHP=X";
            for (int i = 0; i < 9; ++i)
                cig[(u8)c[i]] = (i8)i;
        }
    };
    static const Tabs T;
    const i8* NT16 = T.nt16;
    const i8* CIG = T.cig;
    RefTab refs{ref_names, name_off, n_refs};
    i64 p = 0, w = 0;
    const u8* f[64];   // field starts
    i64 fl[64];        // field lengths
    while (p < n) {
        i64 eol = p;
        while (eol < n && text[eol] != '\n') ++eol;
        i64 len = eol - p;
        if (len == 0) { p = eol + 1; continue; }
        // split fields
        int nf = 0;
        i64 a = p;
        for (i64 i = p; i <= eol; ++i) {
            if (i == eol || text[i] == '\t') {
                if (nf >= 64) return -2;  // >64 fields: Python fallback
                f[nf] = text + a;
                fl[nf] = i - a;
                ++nf;
                a = i + 1;
            }
        }
        if (nf < 11) return -2;
        auto atoi_f = [&](int k, bool* ok) -> i64 {
            const u8* s = f[k];
            i64 L = fl[k], v = 0, i = 0;
            bool neg = false;
            if (L && (s[0] == '-' || s[0] == '+')) { neg = s[0] == '-'; i = 1; }
            if (i == L || L - i > 18) { *ok = false; return 0; }
            for (; i < L; ++i) {
                if (s[i] < '0' || s[i] > '9') { *ok = false; return 0; }
                v = v * 10 + (s[i] - '0');
            }
            *ok = true;
            return neg ? -v : v;
        };
        bool ok = true;
        i64 flag = atoi_f(1, &ok); if (!ok) return -2;
        i64 pos = atoi_f(3, &ok) - 1; if (!ok) return -2;
        i64 mapq = atoi_f(4, &ok); if (!ok) return -2;
        i64 pnext = atoi_f(7, &ok) - 1; if (!ok) return -2;
        i64 tlen = atoi_f(8, &ok); if (!ok) return -2;
        i32 refid = (fl[2] == 1 && f[2][0] == '*')
            ? -1 : refs.find(f[2], fl[2]);
        i32 nrefid;
        if (fl[6] == 1 && f[6][0] == '=') nrefid = refid;
        else if (fl[6] == 1 && f[6][0] == '*') nrefid = -1;
        else nrefid = refs.find(f[6], fl[6]);
        // cigar
        u32 cig[64];
        int ncig = 0;
        i64 span = 0;
        if (!(fl[5] == 1 && f[5][0] == '*')) {
            u32 num = 0;
            for (i64 i = 0; i < fl[5]; ++i) {
                u8 c = f[5][i];
                if (c >= '0' && c <= '9') { num = num * 10 + (c - '0'); continue; }
                i8 code = CIG[c];
                if (code < 0 || ncig >= 64) return -2;
                cig[ncig++] = (num << 4) | (u32)code;
                // M D N = X consume the reference
                if (code == 0 || code == 2 || code == 3 || code == 7
                    || code == 8)
                    span += num;
                num = 0;
            }
        }
        i64 l_seq = (fl[9] == 1 && f[9][0] == '*') ? 0 : fl[9];
        // narrowing guards: the Python twin (struct.pack) RAISES on these,
        // so the native path must punt (-2) rather than silently truncate
        if (fl[0] + 1 > 255 || mapq < 0 || mapq > 255
            || flag < 0 || flag > 65535
            || pos < INT32_MIN || pos > INT32_MAX
            || pnext < INT32_MIN || pnext > INT32_MAX
            || tlen < INT32_MIN || tlen > INT32_MAX)
            return -2;
        i64 end = ncig ? pos + span : pos + 1;
        i32 bin = bam_reg2bin(pos >= 0 ? pos : 0, end > pos ? end : pos + 1);
        i64 name_len = fl[0] + 1;
        // fixed 32B + name + cigar + seq/2 + qual + generous aux bound
        i64 need = 36 + name_len + 4 * ncig + (l_seq + 1) / 2 + l_seq;
        for (int k = 11; k < nf; ++k) need += fl[k] + 8;
        if (w + need > out_cap) return -1;
        u8* rec = out + w + 4;          // block_size backpatched below
        u8* q = rec;
        auto put_i32 = [&](i32 v) { memcpy(q, &v, 4); q += 4; };
        put_i32(refid);
        put_i32((i32)pos);
        *q++ = (u8)name_len;
        *q++ = (u8)mapq;
        // BAM fixed layout: refID,pos,l_read_name,mapq,bin,n_cigar,flag,
        // l_seq,next_refID,next_pos,tlen (bin/n_cigar/flag are u16)
        auto put_u16 = [&](u32 v) {
            q[0] = (u8)(v & 0xFF); q[1] = (u8)(v >> 8); q += 2;
        };
        put_u16((u32)bin);
        put_u16((u32)ncig);
        put_u16((u32)flag);
        put_i32((i32)l_seq);
        put_i32(nrefid);
        put_i32((i32)pnext);
        put_i32((i32)tlen);
        memcpy(q, f[0], fl[0]); q += fl[0];
        *q++ = 0;
        memcpy(q, cig, 4 * (size_t)ncig); q += 4 * ncig;
        for (i64 i = 0; i + 1 < l_seq; i += 2)
            *q++ = (u8)((NT16[f[9][i]] << 4) | NT16[f[9][i + 1]]);
        if (l_seq & 1)
            *q++ = (u8)(NT16[f[9][l_seq - 1]] << 4);
        bool star_q = (fl[10] == 1 && f[10][0] == '*');
        if (star_q || l_seq == 0) {
            memset(q, 0xff, (size_t)l_seq); q += l_seq;
        } else {
            if (fl[10] != l_seq) return -2;
            for (i64 i = 0; i < l_seq; ++i) {
                int v = (int)f[10][i] - 33;
                if (v < 0) v = 0;
                if (v > 93) v = 93;
                *q++ = (u8)v;
            }
        }
        for (int k = 11; k < nf; ++k) {
            // tag:typ:val
            if (fl[k] < 5 || f[k][2] != ':' || f[k][4] != ':') return -2;
            u8 typ = f[k][3];
            const u8* val = f[k] + 5;
            i64 vl = fl[k] - 5;
            *q++ = f[k][0]; *q++ = f[k][1];
            if (typ == 'i') {
                i64 v = 0, i = 0; bool neg = false;
                if (vl && (val[0] == '-' || val[0] == '+')) {
                    neg = val[0] == '-'; i = 1;
                }
                if (i == vl || vl - i > 18) return -2;
                for (; i < vl; ++i) {
                    if (val[i] < '0' || val[i] > '9') return -2;
                    v = v * 10 + (val[i] - '0');
                }
                if (neg) v = -v;
                if (v < INT32_MIN || v > INT32_MAX) return -2;
                *q++ = 'i';
                i32 v32 = (i32)v;
                memcpy(q, &v32, 4); q += 4;
            } else if (typ == 'A') {
                *q++ = 'A';
                *q++ = vl ? val[0] : 0;
            } else if (typ == 'f') {
                // float aux never produced by the aligner; punt to Python
                return -2;
            } else {  // Z and everything else passes through as Z
                *q++ = 'Z';
                memcpy(q, val, (size_t)vl); q += vl;
                *q++ = 0;
            }
        }
        i32 bs = (i32)(q - rec);
        memcpy(out + w, &bs, 4);
        w += 4 + bs;
        p = eol + 1;
    }
    return w;
}

// ---------------------------------------------------------------------------
// BAM record stream -> SAM text (toolkit/bamio.py:decode_bam_to_sam twin,
// exact byte-for-byte output).  The Python decoder costs ~30 us/record
// (per-base joins); BAM is the toolkit's primary input (avgmod/mergeBAM/
// bamutil read the aligner's -o *.bam), so the decode rides this C pass.
// Returns bytes written, -1 if out_cap would overflow, -2 on a float aux
// (Python repr() formatting is decoder-defined there — caller falls back
// to the Python decoder for the whole file).

extern "C" i64 bt_bam_to_sam(
    const u8* data, i64 n,
    const u8* ref_names, const i64* name_off, i32 n_refs,
    u8* out, i64 out_cap)
{
    static const char NT16S[17] = "=ACMGRSVTWYHKDBN";
    static const char CIGS[10] = "MIDNSHP=X";
    i64 p = 0, w = 0;
    char numbuf[24];
    auto put = [&](const void* s, i64 len) -> bool {
        if (w + len > out_cap) return false;
        memcpy(out + w, s, (size_t)len);
        w += len;
        return true;
    };
    auto put_int = [&](i64 v) -> bool {
        int len = snprintf(numbuf, sizeof numbuf, "%lld", (long long)v);
        return put(numbuf, len);
    };
    auto put_ref = [&](i32 rid) -> bool {
        if (rid < 0 || rid >= n_refs) return put("*", 1);
        return put(ref_names + name_off[rid],
                   name_off[rid + 1] - name_off[rid]);
    };
    while (p + 4 <= n) {
        i32 sz;
        memcpy(&sz, data + p, 4);
        p += 4;
        if (sz < 32 || p + sz > n) return -2;
        const u8* d = data + p;
        p += sz;
        if (d[8] < 1) return -2;  // l_read_name includes the NUL
        i32 refid, pos, l_seq, nrefid, npos, tlen;
        memcpy(&refid, d, 4);
        memcpy(&pos, d + 4, 4);
        u8 l_rn = d[8], mapq = d[9];
        u32 n_cig = (u32)d[12] | ((u32)d[13] << 8);
        u32 flag = (u32)d[14] | ((u32)d[15] << 8);
        memcpy(&l_seq, d + 16, 4);
        memcpy(&nrefid, d + 20, 4);
        memcpy(&npos, d + 24, 4);
        memcpy(&tlen, d + 28, 4);
        i64 off = 32;
        if (l_seq < 0
            || 32 + (i64)l_rn + 4 * (i64)n_cig + ((i64)l_seq + 1) / 2
               + (i64)l_seq > sz)
            return -2;  // malformed: Python twin fails loudly
        // qname \t flag \t rname \t pos+1 \t mapq \t cigar
        if (!put(d + off, l_rn - 1) || !put("\t", 1)) return -1;
        off += l_rn;
        if (!put_int(flag) || !put("\t", 1)) return -1;
        if (!put_ref(refid) || !put("\t", 1)) return -1;
        if (!put_int((i64)pos + 1) || !put("\t", 1)) return -1;
        if (!put_int(mapq) || !put("\t", 1)) return -1;
        if (n_cig == 0) {
            if (!put("*", 1)) return -1;
        } else {
            for (u32 i = 0; i < n_cig; ++i) {
                u32 v;
                memcpy(&v, d + off + 4 * i, 4);
                if ((v & 0xF) > 8) return -2;  // twin would IndexError
                if (!put_int(v >> 4)) return -1;
                if (!put(&CIGS[v & 0xF], 1)) return -1;
            }
        }
        off += 4 * (i64)n_cig;
        if (!put("\t", 1)) return -1;
        // rnext \t pnext+1 \t tlen \t seq \t qual
        if (nrefid == refid && nrefid >= 0) {
            if (!put("=", 1)) return -1;
        } else if (!put_ref(nrefid)) {
            return -1;
        }
        if (!put("\t", 1) || !put_int((i64)npos + 1) || !put("\t", 1)
            || !put_int(tlen) || !put("\t", 1))
            return -1;
        if (l_seq == 0) {
            if (!put("*", 1)) return -1;
        } else {
            if (w + l_seq > out_cap) return -1;
            for (i32 i = 0; i < l_seq; ++i)
                out[w + i] = NT16S[(d[off + i / 2] >> (i % 2 ? 0 : 4)) & 0xF];
            w += l_seq;
        }
        off += ((i64)l_seq + 1) / 2;
        if (!put("\t", 1)) return -1;
        if (l_seq > 0) {
            bool all_ff = true;
            for (i32 i = 0; i < l_seq && all_ff; ++i)
                all_ff = d[off + i] == 0xFF;
            if (all_ff) {
                if (!put("*", 1)) return -1;
            } else {
                if (w + l_seq > out_cap) return -1;
                for (i32 i = 0; i < l_seq; ++i) {
                    if (d[off + i] >= 223) return -2;  // chr(q+33) > 255:
                    out[w + i] = (u8)(d[off + i] + 33); // twin emits wide
                }                                       // codepoints there
                w += l_seq;
            }
        }
        // qual is the empty string when l_seq == 0 (Python twin emits an
        // empty field there)
        off += l_seq;
        // aux tags
        while (off + 3 <= sz) {
            const u8* t = d + off;
            u8 typ = t[2];
            off += 3;
            char tagbuf[8] = {(char)t[0], (char)t[1], ':', 'i', ':'};
            i64 val = 0;
            bool is_int = true;
            // bound the value bytes (the Python twin raises on short aux)
            i64 vlen = (typ == 'C' || typ == 'c' || typ == 'A') ? 1
                       : (typ == 'S' || typ == 's') ? 2
                       : (typ == 'I' || typ == 'i' || typ == 'f') ? 4 : 0;
            if (off + vlen > sz) return -2;
            if (typ == 'C') { val = d[off]; off += 1; }
            else if (typ == 'c') { val = (i8)d[off]; off += 1; }
            else if (typ == 'S') {
                val = (u32)d[off] | ((u32)d[off + 1] << 8); off += 2;
            } else if (typ == 's') {
                val = (int16_t)((u32)d[off] | ((u32)d[off + 1] << 8));
                off += 2;
            } else if (typ == 'I') {
                u32 v; memcpy(&v, d + off, 4); val = v; off += 4;
            } else if (typ == 'i') {
                i32 v; memcpy(&v, d + off, 4); val = v; off += 4;
            } else if (typ == 'A') {
                tagbuf[3] = 'A';
                if (!put("\t", 1) || !put(tagbuf, 5)
                    || !put(d + off, 1)) return -1;
                off += 1;
                is_int = false;
            } else if (typ == 'Z') {
                i64 end = off;
                while (end < sz && d[end] != 0) ++end;
                tagbuf[3] = 'Z';
                if (!put("\t", 1) || !put(tagbuf, 5)
                    || !put(d + off, end - off)) return -1;
                off = end + 1;
                is_int = false;
            } else if (typ == 'f') {
                return -2;  // Python repr() formatting: punt to Python
            } else {
                break;      // unknown aux type: drop the rest (twin does)
            }
            if (is_int) {
                if (!put("\t", 1) || !put(tagbuf, 5) || !put_int(val))
                    return -1;
            }
        }
        if (!put("\n", 1)) return -1;
    }
    return w;
}

// ---------------------------------------------------------------------------
// Bulk BAM read-record decode for the aligner's BAM INPUT path
// (reads/io.py:BamReader) — name/seq/qual of up to `want` records into one
// flat buffer with offset arrays (RawBatch layout), replacing the
// ~15 us/record Python loop.  Returns nrec (>=0); *consumed = bytes of
// complete records eaten.  Returns -1 if out_cap would overflow, -2 on a
// 0xFF qual byte (unaligned-BAM "no qual": Python's chr(q+33) semantics
// exceed byte range there — caller falls back to the Python loop).

extern "C" i64 bt_bam_reads(
    const u8* data, i64 n, i64 want, i32 maxlen,
    u8* out, i64 out_cap,
    i64* noff, i32* nlen, i64* soff, i32* slen, i64* qoff, i32* qlen,
    i64* consumed)
{
    static const char NT16S[17] = "=ACMGRSVTWYHKDBN";
    i64 p = 0, w = 0, r = 0;
    while (r < want && p + 4 <= n) {
        i32 sz;
        memcpy(&sz, data + p, 4);
        if (sz < 32) return -2;                // corrupt: loud Python path
        if (p + 4 + sz > n) break;             // partial record: stop
        const u8* d = data + p + 4;
        u8 l_rn = d[8];
        if (l_rn < 1) return -2;
        u32 n_cig = (u32)d[12] | ((u32)d[13] << 8);
        i32 l_seq;
        memcpy(&l_seq, d + 16, 4);
        i64 off = 32;
        if (l_seq < 0
            || 32 + (i64)l_rn + 4 * (i64)n_cig + ((i64)l_seq + 1) / 2
               + (i64)l_seq > sz)
            return -2;
        i64 keep = l_seq < maxlen ? l_seq : maxlen;
        if (w + (l_rn - 1) + 2 * keep > out_cap) return -1;
        noff[r] = w;
        nlen[r] = l_rn - 1;
        memcpy(out + w, d + off, (size_t)(l_rn - 1));
        w += l_rn - 1;
        off += l_rn + 4 * (i64)n_cig;
        soff[r] = w;
        slen[r] = (i32)keep;
        for (i64 i = 0; i < keep; ++i)
            out[w + i] = NT16S[(d[off + i / 2] >> (i % 2 ? 0 : 4)) & 0xF];
        w += keep;
        off += ((i64)l_seq + 1) / 2;
        qoff[r] = w;
        qlen[r] = (i32)keep;
        for (i64 i = 0; i < keep; ++i) {
            if (d[off + i] >= 223) return -2;  // incl. 0xFF no-qual: the
            out[w + i] = (u8)(d[off + i] + 33); // twin emits chr > 255
        }
        w += keep;
        p += 4 + sz;
        ++r;
    }
    *consumed = p;
    return r;
}
