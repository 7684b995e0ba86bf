"""The port's dp x rs mesh (basal_tpu_torch.parallel.mesh) against basal_tpu.

``ShardedTorchDeviceContext`` over a list of CPU devices runs the plain
count and gap cores once per reference shard; its merged results must equal
the port's single context and basal_tpu's ShardedDeviceContext (8 virtual
CPU devices from conftest, XLA) element for element, on
test_mesh_equivalence's repeat genome plus candidates placed on shard
edges.  Everything compared is an integer: equality is exact.
"""

import numpy as np
import pytest
import torch

from conftest import convert_reads, make_fastq, make_ref
from test_mesh_equivalence import _candidates, _repeat_genome

CPU = torch.device("cpu")


def _edge_candidates(ref, table, gap, n_rs_all=(2, 4)):
    """The table plus candidates whose window starts on the first word of
    the reference, in the last words of a shard (reaching into its halo)
    and on the first words of the next shard, on both planes, for every
    rs split in ``n_rs_all``; all on the table's last row (rows stay
    non-decreasing)."""
    nw = ref.ref32.shape[1]
    k_lo = 1 if gap else 0          # gapped windows start a word earlier
    locs = [16 * k_lo + s for s in (0, 7, 15)]
    for n_rs in n_rs_all:
        shard_w = -(-nw // n_rs)
        for j in range(1, n_rs):
            b = j * shard_w
            for k in (b - 3, b - 1, b, b + 2):
                locs += [16 * (k + k_lo) + s for s in (0, 9, 15)]
    locs = np.array(locs, np.int64)
    n = locs.size
    loc = np.concatenate([table.loc, locs, locs]).astype(table.loc.dtype)
    plane = np.concatenate([table.plane, np.zeros(n, table.plane.dtype),
                            np.ones(n, table.plane.dtype)])
    row = np.concatenate([table.row,
                          np.full(2 * n, table.row[-1], table.row.dtype)])
    return loc, plane, row


@pytest.mark.parametrize("conversion,gap", [("C:T", 0), ("T:-", 3)])
def test_sharded_equals_single_and_basal_tpu(tmp_path, rng, conversion, gap):
    import jax

    from basal_tpu.parallel.mesh import ShardedDeviceContext
    from basal_tpu.parallel.mesh import make_mesh as jmesh
    from basal_tpu_torch.align.pipeline import TorchDeviceContext
    from basal_tpu_torch.parallel.mesh import (ShardedTorchDeviceContext,
                                               make_mesh)

    assert len(jax.devices()) >= 8, "conftest gives 8 virtual devices"
    p, ref, enc, table = _candidates(tmp_path, rng, conversion, gap)
    loc, plane, row = _edge_candidates(ref, table, gap)
    want = TorchDeviceContext(ref, p, CPU).extend(enc, loc, plane, row)
    for n_dp, n_rs in ((8, 1), (4, 2), (2, 4)):
        ctx = ShardedTorchDeviceContext(ref, p,
                                        make_mesh(n_dp, n_rs, [CPU] * 8))
        got = ctx.extend(enc, loc, plane, row)
        jgot = ShardedDeviceContext(ref, p, jmesh(n_dp, n_rs)).extend(
            enc, loc, plane, row)
        n = 3 if gap else 1
        for part in range(n):
            np.testing.assert_array_equal(
                got[part], want[part],
                err_msg=f"part {part} vs single context, mesh {n_dp}x{n_rs}")
            np.testing.assert_array_equal(
                got[part], np.asarray(jgot[part]),
                err_msg=f"part {part} vs basal_tpu, mesh {n_dp}x{n_rs}")
            assert got[part].dtype == np.int32
        if not gap:
            assert got[1] is None and got[2] is None
        # every dp slice's waves ran once on each shard
        assert ctx.up_waves >= n_dp
        assert (got[0] < 256).all()       # every candidate owned by a shard


@pytest.mark.parametrize("nw", [1, 5, 63, 64, 65, 1000, 1001])
@pytest.mark.parametrize("n_rs", [1, 2, 3, 4, 8])
def test_shard_reference_equals_basal_tpu(nw, n_rs):
    from basal_tpu.parallel.mesh import shard_reference as jshard
    from basal_tpu_torch.parallel.mesh import shard_reference
    ref32 = np.random.default_rng(nw * 10 + n_rs).integers(
        0, 1 << 32, (2, nw), dtype=np.uint32)
    for halo in (0, 3, 64):
        try:
            want, ws = jshard(ref32, n_rs, halo)
        except ValueError:  # more shards than words: both refuse
            with pytest.raises(ValueError):
                shard_reference(ref32, n_rs, halo)
            continue
        got, gs = shard_reference(ref32, n_rs, halo)
        assert got.dtype == want.dtype and gs.dtype == ws.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(gs, ws)


def test_auto_mesh_shape_equals_basal_tpu():
    from basal_tpu.parallel.mesh import auto_mesh_shape as jshape
    from basal_tpu_torch.parallel.mesh import auto_mesh_shape
    for n in range(1, 9):
        for words in (1, 1 << 20, 200_000_000, 800_000_000, 3 << 30):
            assert auto_mesh_shape(n, words) == jshape(n, words)
            for hbm in (1 << 30, 80 << 30):
                assert auto_mesh_shape(n, words, hbm) == jshape(n, words, hbm)


def _tiny_ref(tmp_path, rng):
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.index.reference import load_reference
    make_ref(tmp_path / "ref.fa", [("chr1", _repeat_genome(rng, 4000,
                                                           copies=4))])
    p = AlignParams(conversion="C:T", randseed=1)
    return p, load_reference(str(tmp_path / "ref.fa"), p)


def test_make_sharded_context_mesh_rules(tmp_path, rng, monkeypatch):
    """BASAL_TPU_MESH: "0" disables, "DPxRS" forces a shape, none picks
    auto_mesh_shape; None below 2 devices or above the number given."""
    from basal_tpu_torch.parallel.mesh import (ShardedTorchDeviceContext,
                                               make_sharded_context,
                                               mesh_devices)
    p, ref = _tiny_ref(tmp_path, rng)
    cases = [("0", 8, None), ("2x2", 4, (2, 2)), ("1x4", 8, (1, 4)),
             ("4x2", 4, None), ("1x1", 4, None), ("", 1, None),
             ("", 4, (4, 1)), ("", 0, None)]
    for spec, n, shape in cases:
        monkeypatch.setenv("BASAL_TPU_MESH", spec)
        ctx = make_sharded_context(ref, p, [CPU] * n)
        if shape is None:
            assert ctx is None, (spec, n)
        else:
            assert isinstance(ctx, ShardedTorchDeviceContext)
            assert (ctx.n_dp, ctx.n_rs) == shape, (spec, n)
    # a CPU aligner, or a card named by index, gets no mesh
    assert mesh_devices(CPU) == []
    assert mesh_devices(torch.device("cuda", 1)) == []


def test_mesh_rejects_malformed_grids():
    from basal_tpu_torch.parallel.mesh import TorchMesh
    with pytest.raises(ValueError, match="process group"):
        TorchMesh([[CPU, None]])
    with pytest.raises(ValueError, match="same rs shards"):
        TorchMesh([[CPU, None], [None, CPU]], group=object())
    with pytest.raises(ValueError, match="local device"):
        TorchMesh([[None]], group=object())


def test_cli_with_mesh_selected_writes_single_context_sam(tmp_path, rng,
                                                          monkeypatch):
    """With a device list patched in (as if 8 cards were visible), the
    port's CLI runs its waves through the 4x2 mesh and writes the SAM of
    the single-context run."""
    from basal_tpu_torch import cli
    from basal_tpu_torch.parallel import mesh

    ref_txt = _repeat_genome(rng, n_unique=12000, copies=12)
    make_ref(tmp_path / "ref.fa", [("chr1", ref_txt)])
    make_fastq(tmp_path / "reads.fq",
               convert_reads(rng, ref_txt, 200, 80, rule="C:T",
                             revcomp_frac=0.5, sub_rate=0.01))
    launches = []
    launch_row = mesh.ShardedTorchDeviceContext._launch_row

    def counted(self, *a, **kw):
        launches.append((self.n_dp, self.n_rs))
        return launch_row(self, *a, **kw)

    monkeypatch.setattr(mesh.ShardedTorchDeviceContext, "_launch_row",
                        counted)
    monkeypatch.setattr(mesh, "mesh_devices", lambda device: [CPU] * 8)
    monkeypatch.setenv("BASAL_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("BASAL_TPU_HOST_EVAL", "0")
    monkeypatch.chdir(tmp_path)
    outs = {}
    for spec in ("0", "4x2"):
        monkeypatch.setenv("BASAL_TPU_MESH", spec)
        cli.main(["-d", "ref.fa", "-a", "reads.fq", "-M", "C:T", "-S", "9",
                  "-V", "0", "-u", "-o", f"out_{spec}.sam"])
        outs[spec] = [ln for ln in (tmp_path / f"out_{spec}.sam")
                      .read_text().splitlines() if not ln.startswith("@PG")]
    assert launches and set(launches) == {(4, 2)}
    assert outs["0"] == outs["4x2"]
    assert sum(not ln.startswith("@") for ln in outs["0"]) >= 200


def test_pe_aligner_takes_the_mesh(tmp_path, rng, monkeypatch):
    """The PE aligner's dev goes through the same selection."""
    from basal_tpu_torch.index.seedindex import build_index
    from basal_tpu_torch.pairs.pipeline import TorchPairEndAligner
    from basal_tpu_torch.parallel import mesh
    p, ref = _tiny_ref(tmp_path, rng)
    al = TorchPairEndAligner(p, ref, build_index(ref, p), device=CPU)
    monkeypatch.setattr(mesh, "mesh_devices", lambda device: [CPU] * 4)
    monkeypatch.setenv("BASAL_TPU_MESH", "2x2")
    assert isinstance(al.dev, mesh.ShardedTorchDeviceContext)
    assert (al.dev.n_dp, al.dev.n_rs) == (2, 2)
