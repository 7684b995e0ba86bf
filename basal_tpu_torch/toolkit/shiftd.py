"""shiftD — BID-seq CIGAR normalization.

Re-implementation of BASALkit ``shiftD`` (basalkit.py:235-250,
basalkit_functions.py:234-295): when a deletion sits inside a homopolymer of
the convert-from base, re-assign it to the rightmost base of the run using
the XR:Z: reference context (requires ``basal -R``); rewrites ``aMbDcM``,
possibly splitting the D run.  Output goes straight to BAM via our own codec
(the reference shells out to samtools).

Copied from ``basal_tpu/toolkit/shiftd.py`` at b9f8fd4: the port imports
nothing of basal_tpu.  Changes: none.
"""

from __future__ import annotations

import re
import sys

from .avgmod import disp, reverse_complement

_CIGAR_RE = re.compile(r"\d+[a-zA-Z]")


def rightmost_d(cigar: str, xr: str, convert_from: str) -> str:
    """rightmostD (basalkit_functions.py:234-263), exact port of behavior."""
    old = []
    dsize = 0
    for m in _CIGAR_RE.findall(cigar):
        n, op = int(m[:-1]), m[-1]
        if op == "D":
            dsize = n
        old.append(n)
        old.append(op)
    new = list(old)
    d1 = old[0] + old[2] - 1  # last ref position of the D run (0-based in XR)
    if d1 < len(xr) and xr[d1] == convert_from:
        shift = 0
        for j in range(1, len(xr) - d1):
            if xr[d1 + j] == convert_from:
                shift = j
            else:
                break
        if shift > 0:
            run_all_from = (
                dsize == 1
                or (dsize == 2 and xr[d1 - 1] == convert_from)
                or (dsize == 3 and xr[d1 - 1] == convert_from
                    and xr[d1 - 2] == convert_from))
            if run_all_from:  # deletion is T/TT/TTT: slide the whole D right
                new[0] = old[0] + shift
                new[4] = old[4] - shift
            else:
                if (dsize == 2 and xr[d1 - 1] != convert_from) or \
                        (dsize == 3 and xr[d1 - 1] == convert_from
                         and xr[d1 - 2] != convert_from):
                    new[2] = 1  # XT / XTT: only the trailing T moves
                elif dsize == 3 and xr[d1 - 1] != convert_from:
                    new[2] = 2  # TXT / XXT
                new.insert(4, shift)
                new.insert(5, "M")
                new.insert(6, dsize - new[2])
                new.insert(7, "D")
                new[8] = old[4] - shift
    if new[-2] <= 0:
        new.pop()
        new.pop()
    return "".join(map(str, new))


def shift_d(alignments: str, output_prefix: str, convert_from: str = "T"):
    from .avgmod import iter_sam_lines
    from .bamio import BamWriter, decode_bam_to_sam

    up = alignments.upper()
    if up.endswith(".SAM"):
        lines = open(alignments)
    elif up.endswith(".BAM"):
        lines = decode_bam_to_sam(alignments).splitlines(keepends=True)
    else:
        disp("Input Alignment must be sam or bam file")
        sys.exit(1)

    out_bam = output_prefix + ".bam"
    disp(f"Load Alignments in: {alignments}")
    with BamWriter(out_bam) as bw:
        for line in lines:
            if line.startswith("@"):
                bw.write(line)
                continue
            col = line.split("\t")
            xr = zs = ""
            for c in col:
                if c.startswith("XR:Z:"):
                    xr = re.sub(r"[a-z]", "", c[5:].strip())
                if c.startswith("ZS:Z:"):
                    zs = c[5:7]
            if not xr or not zs:
                disp("The XR and ZS tag of input alignments are required. "
                     "Please make sure it is generated by BASAL with -R "
                     "option. Exit.")
                sys.exit(1)
            cigar = col[5]
            if "D" not in cigar:
                bw.write(line)
                continue
            base = convert_from
            if zs in ("+-", "-+"):
                base = reverse_complement(convert_from)
            col[5] = rightmost_d(cigar, xr, base)
            bw.write("\t".join(col))
    disp(f"shiftD Finished. Corrected alignments are saved in {out_bam}")
