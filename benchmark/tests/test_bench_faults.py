"""Whole runs on the CPU at a size a test holds, with the look for a card
skipped: a sound run comes out correct, and each fault that a cell can
have underneath the timed path, and the control, come out not correct.

The faults: a count altered where the kernel returns it; half of each
batch's records left out; each record's POS moved by one; every read
reported unmapped; each read's best candidate dropped after the kernel,
so that the replay takes the next one; each hit moved by one base with
its NM recounted there, so that every record agrees with itself."""

import numpy as np
import pytest

from benchkit import control, core

SMALL = dict(reads=250_000, warmup_writes=4, sample_per_wave=256,
             sample_per_write=64)
SIZES = {
    "glori_se100.mrna": dict(config=dict(genome_bp=1_000_000), cell=SMALL,
                             params=dict(batch_reads=1000)),
}
SECONDS = dict.fromkeys(SIZES, 1.0)
CELLS = sorted(SIZES)


def run(root, cell, seconds=None, **kw):
    return core.run_cell(root, cell, 2 ** 31 + 11, seconds or SECONDS[cell],
                         False, device="cpu", sizes=SIZES[cell], **kw)


def values(out):
    return {k: v["value"] for k, v in out["checks"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench_root, cell):
    out = run(bench_root, cell)
    v = values(out)
    assert out["correct"], v
    assert out["failed"] == 0 and out["attempted"] > 0
    assert v["kernel_outputs_checked"] > 0 and v["sam_records_checked"] > 0
    assert v["unmapped_within_limit_pct"] == 0 and v["off_origin_pct"] == 0
    assert out["metrics"]["reads_per_s"]["value"] > 0
    assert list(out)[-1] == "checks"


def _alter_counts(fn):
    def altered(*a, **kw):
        out = fn(*a, **kw)
        if isinstance(out, tuple):
            out[0][::2] += 1
            return out
        out[::2] += 1
        return out
    return altered


@pytest.mark.parametrize("cell", CELLS)
def test_kernel_output_altered(bench_root, cell, monkeypatch):
    from basal_tpu_torch.align import pipeline
    for name in ("extend_counts_blob", "extend_gap_blob"):
        monkeypatch.setattr(pipeline, name,
                            _alter_counts(getattr(pipeline, name)))
    out = run(bench_root, cell)
    assert not out["correct"]
    assert values(out)["kernel_outputs_wrong"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_each_batch_left_out(bench_root, cell, monkeypatch):
    from basal_tpu_torch.align.aligner import SingleEndAligner
    finish = SingleEndAligner.finish_batch

    def half(self, state):
        lines = finish(self, state).split(b"\n")
        return b"\n".join(lines[:len(lines) // 2]) + b"\n"
    monkeypatch.setattr(SingleEndAligner, "finish_batch", half)
    out = run(bench_root, cell)
    assert not out["correct"] and out["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_record_altered_where_written(bench_root, cell, monkeypatch):
    from basal_tpu_torch.align.aligner import SingleEndAligner
    emit = SingleEndAligner._emit_native

    def shifted(self, enc, waves):
        out = []
        for line in emit(self, enc, waves).split(b"\n"):
            f = line.split(b"\t")
            if len(f) > 3 and f[3] != b"0":
                f[3] = str(int(f[3]) + 1).encode()
            out.append(b"\t".join(f))
        return b"\n".join(out)
    monkeypatch.setattr(SingleEndAligner, "_emit_native", shifted)
    out = run(bench_root, cell)
    assert not out["correct"]
    assert values(out)["sam_records_wrong"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_every_read_unmapped(bench_root, cell, monkeypatch):
    from basal_tpu_torch.align.aligner import SingleEndAligner
    emit = SingleEndAligner._emit_native

    def unmapped(self, enc, waves):
        waves = [(m, (np.full_like(r[0], -1),) + tuple(r[1:]))
                 for m, r in waves]
        return emit(self, enc, waves)
    monkeypatch.setattr(SingleEndAligner, "_emit_native", unmapped)
    out = run(bench_root, cell)
    v = values(out)
    assert not out["correct"]
    assert v["unmapped_within_limit_pct"] > 90
    assert v["kernel_outputs_wrong"] == 0 and v["sam_records_wrong"] == 0


def drop_best(fetched, arrs):
    """Counts with each read row's best candidate (every copy of its
    location and plane) set past any limit."""
    counts, pos0, pos1 = fetched
    loc, plane, row = (np.asarray(a, np.int64) for a in arrs)
    counts = np.array(counts)
    key = (loc << 1) | plane
    order = np.lexsort((counts, row))
    first = np.ones(order.size, bool)
    first[1:] = row[order][1:] != row[order][:-1]
    best = dict(zip(row[order][first].tolist(),
                    key[order][first].tolist()))
    hit = key == np.array([best[r] for r in row.tolist()], np.int64)
    counts[hit] = 255
    return counts, pos0, pos1


@pytest.mark.parametrize("cell", CELLS)
def test_best_hit_replaced_by_the_next(bench_root, cell, monkeypatch):
    from basal_tpu_torch.align.aligner import SingleEndAligner
    finish = SingleEndAligner._finish_with

    def next_best(self, state, fetched):
        if fetched is None:
            fetched = self.prefetch_state(state)
        if fetched is not None and state[5] is not None:
            fetched = drop_best(fetched, state[5])
        return finish(self, state, fetched)
    monkeypatch.setattr(SingleEndAligner, "_finish_with", next_best)
    out = run(bench_root, cell)
    v = values(out)
    assert not out["correct"]
    assert v["unmapped_within_limit_pct"] + v["off_origin_pct"] > 90
    assert v["kernel_outputs_wrong"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_hit_moved_with_its_nm_recounted(bench_root, cell, monkeypatch):
    from basal_tpu_torch.align.aligner import SingleEndAligner

    from benchkit import data
    from benchkit import reference as ref
    emit = SingleEndAligner._emit_native
    run(bench_root, cell)                   # makes the genome
    (gdir,) = (bench_root / "benchmark" / ".cache").glob("genome-*")
    genome = data.load_ref(gdir).chars
    rule = ref.Rule("A:G")

    def moved(self, enc, waves):
        out = []
        for line in emit(self, enc, waves).split(b"\n"):
            f = line.split(b"\t")
            if len(f) > 11 and not int(f[1]) & 4:
                pos = int(f[3]) + 1
                seq = np.frombuffer(f[9], np.uint8)
                nm = ref.mismatches(rule, seq,
                                    genome[pos - 1:pos - 1 + seq.size],
                                    int(f[1]) & 16 > 0)
                f[3] = str(pos).encode()
                f = [b"NM:i:%d" % nm if x.startswith(b"NM:i:") else x
                     for x in f]
            out.append(b"\t".join(f))
        return b"\n".join(out)
    monkeypatch.setattr(SingleEndAligner, "_emit_native", moved)
    out = run(bench_root, cell, seconds=10.0)   # a slower emitter
    v = values(out)
    assert not out["correct"]
    assert v["off_origin_pct"] > 90
    assert v["sam_records_wrong"] == 0 and v["kernel_outputs_wrong"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench_root, cell):
    # the reference in the program's place is slower: a longer window
    out = run(bench_root, cell, seconds=10.0, control=control.install)
    v = values(out)
    assert not out["correct"]
    assert v["kernel_outputs_wrong"] > 0
    assert v["sam_records_wrong"] == 0      # 4 bits change no record
    assert v["unmapped_within_limit_pct"] == 0


def test_result_numbers_are_finite(bench_root):
    out = core.run_cell(bench_root, "glori_se100.mrna", 5, 1.0, True,
                        device="cpu", sizes=SIZES["glori_se100.mrna"])
    for m in out["metrics"].values():
        assert np.isfinite(m["value"])
    assert "device.idle_pct" not in out["metrics"]   # no card: no trace
