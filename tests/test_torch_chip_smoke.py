"""chip_smoke.py's own logic on the CPU: the ptxas report parser, the phase-1
local-memory gate, the bound of a wave and the profiler sessions' retry.

chip_smoke.py imports only the standard library at its top, as this file
does; torch is imported inside the tests that need it.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# ptxas -v of both kernels in all three modes, as the build keeps it
# (ops/_build.py, ptxas.log): nvcc 12.8 for sm_90a, an NVIDIA H100 machine
PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__04008aa5_15_count_kernel_cu_90298ea917count_blob_kernelILi2EEEvPKjiPKiPhiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__04008aa5_15_count_kernel_cu_90298ea917count_blob_kernelILi2EEEvPKjiPKiPhiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers
ptxas info    : Compile time = 59.942 ms
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__04008aa5_15_count_kernel_cu_90298ea917count_blob_kernelILi1EEEvPKjiPKiPhiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__04008aa5_15_count_kernel_cu_90298ea917count_blob_kernelILi1EEEvPKjiPKiPhiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 0 barriers
ptxas info    : Compile time = 64.759 ms
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__04008aa5_15_count_kernel_cu_90298ea917count_blob_kernelILi0EEEvPKjiPKiPhiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__04008aa5_15_count_kernel_cu_90298ea917count_blob_kernelILi0EEEvPKjiPKiPhiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers
ptxas info    : Compile time = 63.288 ms
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__2da625aa_13_gap_kernel_cu_e6c3f4a815gap_blob_kernelILi2EEEvPKjiPKiPhPsS6_iiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__2da625aa_13_gap_kernel_cu_e6c3f4a815gap_blob_kernelILi2EEEvPKjiPKiPhPsS6_iiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 78 registers, used 1 barriers, 42112 bytes smem
ptxas info    : Compile time = 59.083 ms
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__2da625aa_13_gap_kernel_cu_e6c3f4a815gap_blob_kernelILi1EEEvPKjiPKiPhPsS6_iiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__2da625aa_13_gap_kernel_cu_e6c3f4a815gap_blob_kernelILi1EEEvPKjiPKiPhPsS6_iiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 78 registers, used 1 barriers, 42112 bytes smem
ptxas info    : Compile time = 50.841 ms
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__2da625aa_13_gap_kernel_cu_e6c3f4a815gap_blob_kernelILi0EEEvPKjiPKiPhPsS6_iiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__2da625aa_13_gap_kernel_cu_e6c3f4a815gap_blob_kernelILi0EEEvPKjiPKiPhPsS6_iiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 78 registers, used 1 barriers, 42112 bytes smem
ptxas info    : Compile time = 59.421 ms
"""

NAMES = [f"{k}<{m}>" for k in ("count_blob_kernel", "gap_blob_kernel")
         for m in range(3)]


def _gate_trips(resources) -> bool:
    try:
        chip_smoke.local_memory_gate(resources)
    except AssertionError:
        return True
    return False


def test_kernel_resources_reads_both_kernels():
    res = chip_smoke.kernel_resources(PTXAS)
    assert sorted(res) == sorted(NAMES)
    assert res["count_blob_kernel<1>"] == dict(
        stack=0, spill_st=0, spill_ld=0, registers=56, smem=0)
    for m in range(3):
        assert res[f"gap_blob_kernel<{m}>"] == dict(
            stack=0, spill_st=0, spill_ld=0, registers=78, smem=42112)


def test_local_memory_gate_passes_on_zeros():
    assert not _gate_trips(chip_smoke.kernel_resources(PTXAS))


def test_local_memory_gate_trips_on_count_stack_frame():
    text = PTXAS.replace(
        "count_blob_kernelILi1EEEvPKjiPKiPhiiii\n    0 bytes stack frame",
        "count_blob_kernelILi1EEEvPKjiPKiPhiiii\n    16 bytes stack frame")
    assert text != PTXAS
    res = chip_smoke.kernel_resources(text)
    assert res["count_blob_kernel<1>"]["stack"] == 16
    assert _gate_trips(res)


def test_local_memory_gate_trips_on_count_spills():
    for field, value in (("spill_st", 8), ("spill_ld", 4)):
        res = chip_smoke.kernel_resources(PTXAS)
        res["count_blob_kernel<0>"][field] = value
        assert _gate_trips(res), field


def test_local_memory_gate_trips_on_gap_spills():
    text = PTXAS.replace(
        "gap_blob_kernelILi2EEEvPKjiPKiPhPsS6_iiiii\n    0 bytes stack "
        "frame, 0 bytes spill stores",
        "gap_blob_kernelILi2EEEvPKjiPKiPhPsS6_iiiii\n    0 bytes stack "
        "frame, 24 bytes spill stores")
    assert text != PTXAS
    assert _gate_trips(chip_smoke.kernel_resources(text))


def test_local_memory_gate_trips_on_a_missing_instantiation():
    res = chip_smoke.kernel_resources(PTXAS)
    del res["count_blob_kernel<2>"]
    assert _gate_trips(res)
    assert _gate_trips({})


def _tiny_wave():
    """C = 3 candidates, W = 2, U = 1, E = 1 over nw = 8 words per plane:
    plane 0 loc 0 (first word 0), plane 0 loc 20 (word 1), plane 1 loc 115
    (word 8 + 7 = 15, the last word: its window clamps there)."""
    import torch
    loc = [0, 20, 115 | (1 << 31)]
    blob = torch.tensor(loc, dtype=torch.int64)
    blob = (blob - ((blob >> 31) << 32)).to(torch.int32)       # u32 view
    rest = torch.tensor([0, 3,                  # row_off
                         100,                   # rowmeta
                         7, 9,                  # base [U*W]
                         0, 0], dtype=torch.int32)   # exc_valid [E*W]
    return torch.cat([blob, rest]), dict(mode="oneway", W=2, nw=8, C=3,
                                         U=1, E=1)


def test_bound_count_wave_by_hand():
    """Windows: words 0-2, 1-3 and 15 (15-17 clamped), so 5 distinct
    reference words (20 B); the blob is 10 words (40 B); 3 count bytes.
    63 B at 3.35 TB/s beat 3 x 2 words x 16 operations at 67 T/s."""
    blob, shape = _tiny_wave()
    assert blob.numel() == 10
    ms, by = chip_smoke.bound(blob, shape)
    assert by == "bytes"
    assert abs(ms - 63 / 3.35e12 * 1e3) < 1e-15


def test_bound_gap_wave_by_hand():
    """Gap 1 windows run from one word before to one past the count
    kernel's: words 0-3 (-1 clamped), 0-4 and 14-15, so 7 distinct words
    (28 B); outputs 3 x (1 + 28 + 56) = 255 B; with the 40 B blob 323 B,
    against 3 x 2 x 3 x 16 + 3 x 14 x 3 x 4 = 792 operations."""
    blob, shape = _tiny_wave()
    ms, by = chip_smoke.bound(blob, shape, gap=1)
    assert by == "bytes"
    assert abs(ms - 323 / 3.35e12 * 1e3) < 1e-15


def test_bound_by_operations():
    """4096 candidates on one window of W = 64 words: 65 distinct words,
    but 4096 x 64 x 16 operations, which take longer at 67 T/s than the
    blob's (4096 + 3 + 128) words and the 4096 count bytes at 3.35 TB/s."""
    import torch
    C, W = 4096, 64
    blob = torch.cat([torch.full((C,), 160, dtype=torch.int32),
                      torch.tensor([0, C, 1000], dtype=torch.int32),
                      torch.zeros(2 * W, dtype=torch.int32)])
    shape = dict(mode="oneway", W=W, nw=1024, C=C, U=1, E=1)
    ms, by = chip_smoke.bound(blob, shape)
    assert by == "operations"
    assert abs(ms - C * W * 16 / 67e12 * 1e3) < 1e-15
    t_bytes = ((C + 3 + 2 * W) * 4 + 65 * 4 + C) / 3.35e12 * 1e3
    assert t_bytes < ms


def _sessions(counts):
    """A profiler session stand-in that records counts[k] launches of 1 ms
    on its k-th run and returns k as its result."""
    runs = []

    def session():
        k = len(runs)
        runs.append(k)
        return k, [1.0] * counts[k]
    return session, runs


def _recorded(counts):
    """(result, durations, sessions run) of recorded over want = 4, or
    None where it raised."""
    session, runs = _sessions(counts)
    try:
        res, durs = chip_smoke.recorded(session, "k", 4)
    except AssertionError:
        return None
    return res, len(durs), len(runs)


def test_recorded_stops_at_a_whole_session():
    assert _recorded([4, 4]) == (0, 4, 1)


def test_recorded_repeats_a_session_that_dropped_an_event():
    assert _recorded([3, 4]) == (1, 4, 2)


def test_recorded_keeps_the_best_of_three_partial_sessions():
    assert _recorded([2, 3, 2]) == (1, 3, 3)


def test_recorded_raises_under_half_of_the_launches():
    assert _recorded([1, 0, 1]) is None


def test_recorded_raises_on_more_launches_than_made():
    assert _recorded([5]) is None
