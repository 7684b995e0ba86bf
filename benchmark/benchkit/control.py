"""The control of the output check: the plain reference put in the
program's place, counting in the nearest precision below the program's
u8 counts (4 bits: a count saturates at 15).  A run under it must come
out not correct.

It replaces ``TorchDeviceContext.extend_async`` / ``fetch`` for one run:
each wave is evaluated by ``reference.extend`` on the run's device, from
the benchmark's own genome and reads; a gapped wave by
``reference.extend_gap``, whose position lists it hands on as they are
(the counts alone go to 4 bits).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

BITS = 4


def install(root, cell, paths, seed, params):
    """Put the 4-bit reference in place; returns the function that takes
    it out again."""
    import torch

    from basal_tpu_torch.align import pipeline

    from . import data
    from . import reference as ref
    from .core import _read_ids
    refd = data.load_ref(Path(paths["ref_dir"]))
    rd = data.make_reads(refd, cell.mix, cell.config["reads"],
                         int(cell.params["reads"]), seed)
    reads, lens = rd.chars, rd.lens
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    genome = ref.Genome(refd.chars, refd.seqs, dev)
    rule = ref.Rule(params.conversion, nt3=params.nt3)
    top = (1 << BITS) - 1
    cls = pipeline.TorchDeviceContext
    saved = (cls.extend_async, cls.fetch)

    gap = params.gap
    empty = [np.zeros(0, np.int32)] + (
        [np.zeros((0, ref.K_POS), np.int32),
         np.zeros((0, 2 * gap, ref.K_POS), np.int32)] if gap else [])

    def extend_async(self, enc, loc, plane, row):
        row = np.asarray(row).astype(np.int64)
        ids = _read_ids(enc, row)
        outs = [empty]
        for a in range(0, row.size, 1 << 18):
            s = slice(a, a + (1 << 18))
            args = (rule, genome,
                    torch.from_numpy(np.asarray(loc[s], np.int64)),
                    torch.from_numpy(np.asarray(plane[s], np.int64)),
                    torch.from_numpy(ref.chains(reads[ids[s]], lens[ids[s]],
                                                row[s] & 1)),
                    torch.from_numpy(lens[ids[s]]))
            got = (ref.extend_gap(*args, gap, n_mis=params.n_mis) if gap
                   else (ref.extend(*args, n_mis=params.n_mis),))
            outs.append([g.cpu().numpy() for g in got])
        res = [np.concatenate(parts) for parts in zip(*outs)]
        res[0] = np.minimum(res[0], top)
        return [("control", tuple(res) if gap else (res[0], None, None))]

    def fetch(self, waves):
        if not waves:
            return saved[1](self, waves)
        return waves[0][1]

    cls.extend_async, cls.fetch = extend_async, fetch

    def undo():
        cls.extend_async, cls.fetch = saved
    return undo
