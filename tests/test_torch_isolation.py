"""The port stands alone: it imports nothing of basal_tpu and never jax.

- No module of ``basal_tpu_torch`` and not ``chip_smoke.py`` imports
  ``basal_tpu`` or jax, at top level, inside a function or by a string
  handed to ``importlib`` (an AST scan of every file).
- The port's CLI, run on the CPU with every wave forced through its device
  context, single-end ``-g 2`` and paired-end, ends with neither
  ``basal_tpu`` nor ``jax`` in ``sys.modules``.
- The port's C++ engine is built under ``build/basal_tpu_torch/host/``,
  never into the package, and concurrent builds leave one whole library.
- Each copied host module is its original, apart from the members the
  module's docstring names; ``native/engine.cpp`` is byte-identical.
- The port's ``RawBatch`` is its own class, and a batch the port reads
  encodes to basal_tpu's planes.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "basal_tpu_torch"
SCANNED = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

# importing either of these pulls basal_tpu in
FORBIDDEN = ("basal_tpu", "jax", "__graft_entry__")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _offences(path: Path, root: Path = ROOT):
    tree = ast.parse(path.read_text(), str(path))
    depth = len(path.relative_to(root).parts) - 1   # packages above the file
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if _forbidden(a.name):
                    yield node.lineno, f"import {a.name}"
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _forbidden(node.module or ""):
                yield node.lineno, f"from {node.module} import"
            if node.level > depth:
                yield node.lineno, "relative import above basal_tpu_torch"
        elif isinstance(node, ast.Call):
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else "")
            if name in ("import_module", "__import__", "find_spec"):
                for arg in node.args:
                    if (isinstance(arg, ast.Constant)
                            and isinstance(arg.value, str)
                            and _forbidden(arg.value)):
                        yield node.lineno, f"{name}({arg.value!r})"


@pytest.mark.parametrize("path", SCANNED,
                         ids=[str(p.relative_to(ROOT)) for p in SCANNED])
def test_no_import_of_basal_tpu_or_jax(path):
    bad = [f"{path.relative_to(ROOT)}:{ln}: {what}"
           for ln, what in _offences(path)]
    assert not bad, "\n".join(bad)


def test_scan_catches_every_form(tmp_path):
    """The scan's own check: each form it must refuse, and the port's own
    package name, which it must let through."""
    pkg = tmp_path / "basal_tpu_torch"
    pkg.mkdir()
    cases = {
        "import basal_tpu": 1, "import basal_tpu.config as c": 1,
        "from basal_tpu import cli": 1, "from basal_tpu.reads.io import x": 1,
        "import jax.numpy": 1, "from jax import numpy": 1,
        "def f():\n    import jax": 1,
        "import importlib\nimportlib.import_module('basal_tpu.native')": 1,
        "__import__('jax')": 1, "from ... import x": 1,
        "import basal_tpu_torch.cli": 0, "from basal_tpu_torch import cli": 0,
        "from .config import AlignParams": 0, "import jaxlib_free": 0,
    }
    for i, (src, want) in enumerate(cases.items()):
        f = pkg / f"m{i}.py"
        f.write_text(src + "\n")
        assert len(list(_offences(f, tmp_path))) == want, src


def _genome(rng, n):
    return rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)


def _reads(rng, g, n, ln, frm, to):
    pos = rng.integers(0, len(g) - ln - 4, n)
    reads = g[pos[:, None] + np.arange(ln)[None, :]].copy()
    conv = (reads == ord(frm)) & (rng.random(reads.shape) < 0.5)
    reads[conv] = ord(to)
    out = []
    for i, r in enumerate(reads):
        if i % 3 == 0:                     # a planted deletion of 1-2 bases
            j = int(rng.integers(20, ln - 20))
            r = np.delete(r, np.arange(j, j + 1 + i % 2))
        out.append(r.tobytes())
    return out


def _write_fastq(path, seqs, mate=None):
    tag = b"" if mate is None else b"/%d" % mate
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@r%d%s\n%s\n+\n%s\n" % (i, tag, s, b"I" * len(s)))


def _cli_data(tmp_path):
    rng = np.random.default_rng(41)
    g = _genome(rng, 7000)
    (tmp_path / "ref.fa").write_bytes(b">c1\n" + g.tobytes() + b"\n")
    _write_fastq(tmp_path / "reads.fq", _reads(rng, g, 60, 90, "C", "T"))
    comp = np.zeros(256, np.uint8)
    comp[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)
    pos = rng.integers(0, len(g) - 300, 40)
    r1 = [g[p:p + 80].tobytes() for p in pos]
    r2 = [comp[g[p + 220:p + 300]][::-1].tobytes() for p in pos]
    _write_fastq(tmp_path / "r1.fq", r1, mate=1)
    _write_fastq(tmp_path / "r2.fq", r2, mate=2)


CLI_RUN = """
import sys
from basal_tpu_torch import cli
cli.main(sys.argv[1:])
bad = sorted(m for m in sys.modules if m in ("basal_tpu", "jax")
             or m.startswith(("basal_tpu.", "jax.")))
print("IMPORTED", bad)
"""


@pytest.mark.parametrize("argv", [
    ["-a", "reads.fq", "-M", "C:T", "-g", "2"],
    ["-a", "r1.fq", "-b", "r2.fq", "-M", "C:T"],
], ids=["se-g2", "pe"])
def test_cli_run_imports_neither_basal_tpu_nor_jax(tmp_path, argv):
    _cli_data(tmp_path)
    env = {**os.environ, "PYTHONPATH": str(ROOT),
           "BASAL_TPU_TORCH_DEVICE": "cpu", "BASAL_TPU_HOST_EVAL": "0"}
    r = subprocess.run(
        [sys.executable, "-c", CLI_RUN, *argv, "-d", "ref.fa", "-S", "3",
         "-u", "-V", "2", "-o", "out.sam"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "IMPORTED []" in r.stdout, r.stdout
    assert "eval: device 0 " not in r.stderr      # waves went to the device
    body = [ln for ln in (tmp_path / "out.sam").read_text().splitlines()
            if not ln.startswith("@")]
    assert len(body) >= 60


def test_engine_builds_under_build_dir():
    from basal_tpu_torch import native
    lib = native.get_lib()
    assert lib is not None
    so = native.library_path()
    assert so.is_file()
    assert so.parent.parent == ROOT / "build" / "basal_tpu_torch" / "host"
    assert Path(lib._name) == so
    assert not list(PORT.rglob("*.so"))


BUILD_RUN = """
import sys
from pathlib import Path
from basal_tpu_torch import native
native.BUILD_ROOT = Path(sys.argv[1])
assert native.get_lib() is not None
print(native.library_path())
"""


def test_concurrent_engine_builds_leave_one_library(tmp_path):
    """Three processes build the engine into one empty directory at once:
    each writes its own temporary file and moves it into place, so every
    one loads a whole library and no temporary file is left."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    env.pop("BASAL_TPU_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_RUN,
                               str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    files = sorted(f.name for f in tmp_path.rglob("*") if f.is_file())
    assert files == ["libbasal_engine.so"]


# copies whose every member is the original's
VERBATIM = ["config.py", "bits.py", "index/reference.py",
            "index/seedindex.py", "index/sharded.py", "index/rrbs.py",
            "reads/io.py", "reads/encode.py", "align/rng.py",
            "align/candidates.py", "align/replay.py", "align/sam.py",
            "pairs/pairing.py", "toolkit/bamio.py", "toolkit/bamutil.py",
            "toolkit/cram.py", "toolkit/shiftd.py",
            "toolkit/mergebam.py", "toolkit/multitest.py", "toolkit/fdr.py",
            "toolkit/regmod.py", "toolkit/cli.py"]
# (copy, original, members of the copy that differ or are new)
EDITED = [
    ("__init__.py", "__init__.py", set()),
    ("native/__init__.py", "native/__init__.py",
     {"get_lib", "_build", "_load", "library_path", "BUILD_ROOT", "_FLAGS",
      "_build_lock"}),
    ("toolkit/bamindex.py", "toolkit/bamindex.py", {"fetch_sam_lines"}),
    ("toolkit/avgmod.py", "toolkit/avgmod.py", {"_member_lut"}),
    ("align/aligner.py", "align/pipeline.py", set()),
    ("pairs/aligner.py", "pairs/pipeline.py", set()),
    ("parallel/routed.py", "parallel/multihost.py",
     {"RoutedSeedIndex._fill"}),
]


def _members(path: Path) -> dict:
    """Source of each top-level function, class member and assignment, by
    qualified name; a class's own entry holds its docstring only."""
    src = path.read_text()
    tree = ast.parse(src)
    out = {}

    def seg(node):
        return ast.get_source_segment(src, node)

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = seg(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = ast.get_docstring(node)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = seg(sub)
                elif isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    out[f"{node.name}.{seg(sub).split('=')[0].strip()}"] = \
                        seg(sub)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            out[seg(node).split("=")[0].strip()] = seg(node)
    return out


def _body(path: Path) -> str:
    """The file without its module docstring."""
    src = path.read_text()
    doc = ast.parse(src).body[0]
    lines = src.splitlines(keepends=True)
    return "".join(lines[doc.end_lineno:])


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_equals_original(rel):
    assert _body(PORT / rel) == _body(ROOT / "basal_tpu" / rel)


def test_engine_source_is_byte_identical():
    assert (PORT / "native" / "engine.cpp").read_bytes() == \
        (ROOT / "basal_tpu" / "native" / "engine.cpp").read_bytes()


@pytest.mark.parametrize("rel,orig,changed", EDITED,
                         ids=[e[0] for e in EDITED])
def test_edited_copy_keeps_original_members(rel, orig, changed):
    """Every member the copy keeps is the original's, source for source,
    apart from ``changed``; what it removed, it removed whole."""
    got = _members(PORT / rel)
    want = _members(ROOT / "basal_tpu" / orig)
    differ = sorted(k for k in got if k not in changed
                    and got[k] != want.get(k))
    assert not differ, differ
    assert changed <= set(got)


def test_cli_parser_is_the_originals():
    got = _members(PORT / "cli.py")
    want = _members(ROOT / "basal_tpu" / "cli.py")
    for name in ("VERSION", "_usage", "parse_args"):
        assert got[name] == want[name], name


def test_raw_batch_is_the_ports_own_and_encodes_alike(tmp_path):
    """A batch read by the port is the port's RawBatch (basal_tpu's host
    code tells the two apart with isinstance), and the port's encoder
    gives basal_tpu's planes and seed arrays on the same FASTQ."""
    import basal_tpu.reads.io as jio
    from basal_tpu.config import AlignParams as JaxParams
    from basal_tpu.reads.encode import encode_batch as jax_encode
    from basal_tpu_torch.config import AlignParams
    from basal_tpu_torch.reads import io as tio
    from basal_tpu_torch.reads.encode import encode_batch

    assert tio.RawBatch is not jio.RawBatch
    rng = np.random.default_rng(5)
    g = _genome(rng, 5000)
    seqs = _reads(rng, g, 200, 100, "A", "G")
    seqs[7] = seqs[7][:40] + b"N" + seqs[7][41:]
    _write_fastq(tmp_path / "reads.fq", seqs)
    kw = dict(conversion="A:G", randseed=1)
    encs = []
    for params, io_mod, enc_fn in ((AlignParams(**kw), tio, encode_batch),
                                   (JaxParams(**kw), jio, jax_encode)):
        rd = io_mod.open_reads(str(tmp_path / "reads.fq"), params)
        batch = rd.next_batch()
        rd.close()
        assert isinstance(batch, io_mod.RawBatch)
        encs.append(enc_fn(params, batch))
    got, want = encs
    for field in ("filtered", "map_len", "raw_len", "read_max_snp",
                  "xflag_chain", "n_count", "seedseg_num", "base", "valid",
                  "mread", "lenmask", "seedval", "seed_has_n", "n_offsets"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.W == want.W
    assert isinstance(got.reads, tio.RawBatch)
