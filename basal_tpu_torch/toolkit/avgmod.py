"""avgmod — per-site conversion/modification ratio pileup.

Re-implementation of BASALkit's ``avgmod`` subcommand
(basalkit.py:145-233, basalkit_functions.py:16-232,297-388): streams SAM/BAM
alignments, applies the CIGAR to the read, derives the mapping strand from
ZS (BASAL) / XR+XG (Bismark) / XB (gemBS) tags, filters
(unique/paired/dup/trim-fillin/min-converted-sites), and accumulates per-site
depth and modified counts; then writes ``_AvgMod.tsv`` (+ optional wiggle).

BAM input decodes through basal_tpu_torch.toolkit.bamio (no external samtools).

Copied from ``basal_tpu/toolkit/avgmod.py`` at b9f8fd4: the port imports
nothing of basal_tpu.  Changes: ``_member_lut`` keeps ``-``.  The original
leaves it out, so its batched pileup (``add_file``) drops every site where
the read has a deletion, which its per-read path (``_add_file_slow``, the
reference's semantics) counts: under ``-M T:-`` (BID-seq) the original
reports no modified site at all.  The port's ``add_file`` equals the
per-read path.
"""

from __future__ import annotations

import re
import sys
import time
from typing import Dict, Iterable, List, Optional, Set

import numpy as np

COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A", "-": "-", "N": "N"}


def disp(text):
    print(f"[BASALKIT @{time.asctime()}] \t{text}", file=sys.stderr)


def reverse_complement(seq: str) -> str:
    return "".join(COMPLEMENT[c] for c in reversed(seq.upper()))


def load_reference(path: str, chroms: Set[str]) -> Dict[str, str]:
    disp(f"Loading Reference Genome: {path}")
    ref = {}
    name, parts = None, []
    for line in open(path):
        if line.startswith(">"):
            if name is not None and (not chroms or name in chroms):
                ref[name] = "".join(parts).upper()
            name = line[1:].split()[0]
            parts = []
        else:
            parts.append(line.strip())
    if name is not None and (not chroms or name in chroms):
        ref[name] = "".join(parts).upper()
    return ref


def mark_reference(ref: Dict[str, str]) -> Dict[str, np.ndarray]:
    """CG/CHG/CHH context codes 1/2/3 for C (fwd) and G (rev) sites
    (Mark_Reference, basalkit_functions.py:29-47), numpy-vectorized."""
    disp("Marking Reference Genome")
    out = {}
    for cr, seq in ref.items():
        b = np.frombuffer(seq.encode("latin1"), dtype=np.uint8)
        n = len(b)
        mark = np.zeros(n, dtype=np.int8)
        is_c = b == ord("C")
        is_g = b == ord("G")
        # C at i (i < n-2): CG if s[i+1]=='G'; CHG if s[i+2]=='G'; else CHH
        ci = np.flatnonzero(is_c[: max(n - 2, 0)])
        nxt_g = is_g[ci + 1]
        nxt2_g = is_g[ci + 2]
        mark[ci] = np.where(nxt_g, 1, np.where(nxt2_g, 2, 3))
        # G at i (i >= 2): CG if s[i-1]=='C'; CHG if s[i-2]=='C'; else CHH
        gi = np.flatnonzero(is_g)
        gi = gi[gi >= 2]
        prv_c = is_c[gi - 1]
        prv2_c = is_c[gi - 2]
        mark[gi] = np.where(prv_c, 1, np.where(prv2_c, 2, 3))
        out[cr] = mark
    return out


_CIGAR_RE = re.compile(r"\d+[a-zA-Z]")


def apply_cigar(seq: str, cigar: str) -> str:
    """Project the read onto reference coordinates (parseCigar,
    basalkit_functions.py:49-72): I/S removed, D -> '-', N -> '+'."""
    out = []
    idx = 0
    for m in _CIGAR_RE.findall(cigar):
        n, op = int(m[:-1]), m[-1]
        if op in "M=X":
            out.append(seq[idx:idx + n])
            idx += n
        elif op in "IS":
            idx += n
        elif op == "D":
            out.append("-" * n)
        elif op == "N":
            out.append("+" * n)
        # H / P: ignored
    return "".join(out)


def _member_lut(chars) -> np.ndarray:
    lut = np.zeros(256, dtype=bool)
    for c in chars:
        lut[ord(c)] = True
    return lut


def strand_from_bismark(xr: str, xg: str) -> str:
    return {("CT", "CT"): "++", ("CT", "GA"): "-+",
            ("GA", "CT"): "+-", ("GA", "GA"): "--"}.get((xr, xg), "")


def strand_from_gembs(xb: str, flag: int) -> str:
    if flag & 32:
        return {"C": "++", "G": "--"}.get(xb, "")
    if flag & 16:
        return {"C": "+-", "G": "-+"}.get(xb, "")
    return ""


def iter_sam_lines(path: str, ref: Optional[Dict[str, str]] = None
                   ) -> Iterable[str]:
    up = path.upper()
    if up.endswith(".SAM"):
        yield from open(path)
    elif up.endswith(".CRAM"):
        # The reference accepts CRAM by shelling out to `samtools view`
        # (basalkit_functions.py:163-166).  We decode CRAM 3.0 natively
        # (toolkit/cram.py: gzip/bzip2/lzma/rANS4x8 codecs); sequence
        # reconstruction uses the loaded reference genome.  CRAM 3.1
        # codecs are refused inside the decoder with a clear message.
        from .cram import iter_cram_sam_lines
        for line in iter_cram_sam_lines(path, ref):
            if not line.startswith("@"):
                yield line
    elif up.endswith(".BAM"):
        from .bamio import iter_bam_sam_lines
        for line in iter_bam_sam_lines(path):
            if not line.startswith("@"):
                yield line
    else:
        yield from open(path)


class AvgMod:
    """Pileup accumulator; mirrors Load_Alignment + Out_base_ratio."""

    def __init__(self, ref: Dict[str, str], convert_from: str,
                 convert_to: List[str], conversion_mode: str = "U",
                 molecule_type: str = "DNA", aligner: str = "BASAL",
                 unique: bool = False, pair: bool = False,
                 rm_dup: bool = False, trim_fillin: int = 0,
                 seq_context: Optional[Set[int]] = None,
                 handle_snp: int = 0, converted_site: float = 0.0,
                 refmark: Optional[Dict[str, np.ndarray]] = None):
        self.ref = ref
        self.frm = convert_from
        self.to = convert_to
        self.mode = conversion_mode
        self.molecule = molecule_type
        self.aligner = aligner
        self.unique = unique
        self.pair = pair
        self.rm_dup = rm_dup
        self.trim_fillin = trim_fillin
        self.seq_context = seq_context or set()
        self.handle_snp = handle_snp
        self.converted_site = converted_site
        self.refmark = refmark or {}
        self.depth = {cr: np.zeros(len(s), np.uint32) for cr, s in ref.items()}
        self.meth = {cr: np.zeros(len(s), np.uint32) for cr, s in ref.items()}
        if handle_snp > 0:
            self.depth_ct = {cr: np.zeros(len(s), np.uint32) for cr, s in ref.items()}
            self.meth_ct = {cr: np.zeros(len(s), np.uint32) for cr, s in ref.items()}
        else:
            self.depth_ct = self.meth_ct = None
        self.coverage = ({cr: np.zeros(len(s), np.uint8) for cr, s in ref.items()}
                         if rm_dup else None)
        self.nmap = 0
        # conversion-rule tuples (basalkit_functions.py:171-174):
        # (raw, modified, unmodified, raw_rc, modified_rc, unmodified_rc)
        cp = COMPLEMENT[convert_from]
        to_cp = [COMPLEMENT[c] for c in convert_to]
        if conversion_mode == "U":
            self.rule = {"+": (convert_from, [convert_from], convert_to,
                               cp, [cp], to_cp),
                         "-": (cp, [cp], to_cp,
                               convert_from, [convert_from], convert_to)}
        else:  # "M" (TAPS)
            self.rule = {"+": (convert_from, convert_to, [convert_from],
                               cp, to_cp, [cp]),
                         "-": (cp, to_cp, [cp],
                               convert_from, convert_to, [convert_from])}

    # -- one SAM record -> (seq, strand, cr, pos) or None ----------------
    def _load_read(self, line: str):
        if not getattr(self, "sam_format", True):
            return self._load_read_bsp(line)
        if line.startswith("@"):
            return None
        col = line.rstrip("\n").split("\t")
        flag = int(col[1])
        if flag & 4:
            return None
        if self.unique and (flag & 256):
            return None
        if self.pair and not (flag & 2):
            return None
        cr, pos, cigar, seq = col[2], int(col[3]) - 1, col[5], col[9]
        if cr not in self.ref:
            return None
        seq = apply_cigar(seq, cigar)
        if not seq:
            return None
        if self.aligner == "BASAL":
            i = line.find("ZS:Z:")
            strand = line[i + 5:i + 7] if i >= 0 else ""
        elif self.aligner == "Bismark":
            i = line.find("XR:Z:")
            j = line.find("XG:Z:")
            strand = strand_from_bismark(line[i + 5:i + 7], line[j + 5:j + 7])
        elif self.aligner == "gemBS":
            i = line.find("XB:A:")
            strand = strand_from_gembs(line[i + 5:i + 6], flag)
        else:
            strand = ""
        if strand not in ("++", "-+", "+-", "--"):
            return None
        pos2 = pos + len(seq)
        if pos2 >= len(self.ref[cr]):
            return None
        if strand in ("+-", "-+"):
            frag_end, direction = pos2, 2
        else:
            frag_end, direction = pos, 1
        if self.rm_dup:
            if self.coverage[cr][frag_end] & direction:
                return None
            self.coverage[cr][frag_end] |= direction
        if self.trim_fillin > 0:
            if strand in ("+-", "-+"):
                seq = seq[:-self.trim_fillin]
            else:
                seq, pos = seq[self.trim_fillin:], pos + self.trim_fillin
        if self.molecule == "DNA":
            return seq, strand[0], cr, pos
        return seq, ("+" if not (flag & 16) else "-"), cr, pos

    # BSP text format (Load_One_Read else-branch,
    # basalkit_functions.py:125-137): legacy output of the BSP aligner
    def _load_read_bsp(self, line: str):
        col = line.rstrip("\n").split("\t")
        if len(col) < 10:
            return None
        flag = col[3][:2]
        if flag in ("NM", "QC"):
            return None
        if self.unique and flag != "UM":
            return None
        if self.pair and col[7] == "0":
            return None
        seq, strand, cr = col[1], col[6], col[4]
        pos, mm = int(col[5]) - 1, col[9]
        if cr not in self.ref:
            return None
        if ":" in mm:
            tmp = mm.split(":")
            gap_pos, gap_size = int(tmp[1]), int(tmp[2])
            if gap_size < 0:
                seq = seq[:gap_pos] + seq[gap_pos - gap_size:]
            else:
                seq = seq[:gap_pos] + "-" * gap_size + seq[gap_pos:]
        if strand not in ("++", "-+", "+-", "--"):
            return None
        pos2 = pos + len(seq)
        if pos2 >= len(self.ref[cr]):
            return None
        if strand in ("+-", "-+"):
            frag_end, direction = pos2, 2
        else:
            frag_end, direction = pos, 1
        if self.rm_dup:
            if self.coverage[cr][frag_end] & direction:
                return None
            self.coverage[cr][frag_end] |= direction
        if self.trim_fillin > 0:
            if strand in ("+-", "-+"):
                seq = seq[:-self.trim_fillin]
            else:
                seq, pos = seq[self.trim_fillin:], pos + self.trim_fillin
        return seq, strand[0], cr, pos

    def add_file(self, path: str):
        """Streaming pileup.  Record parsing/filters stay per line (exact
        reference semantics); the per-site accumulation is batched numpy
        (see _accumulate) — ~20x faster than the reference's per-read regex
        loop on large BAMs."""
        up = path.upper()
        self.sam_format = up.endswith(".SAM") or up.endswith(".BAM") \
            or up.endswith(".CRAM")
        disp(f"Load Alignment: {path}")
        nline = 0
        batch = []
        for line in iter_sam_lines(path, self.ref):
            nline += 1
            info = self._load_read(line)
            if info is None:
                continue
            batch.append(info)
            if len(batch) >= 20000:
                self._accumulate(batch)
                batch = []
        self._accumulate(batch)
        disp(f"Read {nline} lines")

    def _site_index(self, cr):
        """Per-chr sorted positions of each raw base, per strand key."""
        if not hasattr(self, "_sites"):
            self._sites = {}
        if cr not in self._sites:
            b = np.frombuffer(self.ref[cr].encode("latin1"), np.uint8)
            per = {}
            for strand in ("+", "-"):
                raw, modified, unmodified, raw_rc, mod_rc, unmod_rc = \
                    self.rule[strand]
                per[strand] = (
                    np.flatnonzero(b == ord(raw)),
                    np.flatnonzero(b == ord(raw_rc)),
                    _member_lut(modified), _member_lut(unmodified),
                    _member_lut(mod_rc), _member_lut(unmod_rc))
            self._sites[cr] = per
        return self._sites[cr]

    @staticmethod
    def _batch_sites(sites, pos, lens, allseq, seq0):
        """Vectorized covered-site extraction for a whole read group:
        returns (gpos, bases, rid, n_cov) flattened over all reads, where
        rid maps each site back to its read — the batched twin of the
        per-read `sites[a:b2]` slice."""
        a = np.searchsorted(sites, pos)
        b = np.searchsorted(sites, pos + lens)
        n = b - a
        total = int(n.sum())
        if total == 0:
            z = np.zeros(0, np.int64)
            return z, z.astype(np.uint8), z, n
        rid = np.repeat(np.arange(len(pos)), n)
        csum = np.cumsum(n) - n
        idx = np.repeat(a - csum, n) + np.arange(total)
        gpos = sites[idx]
        offs = gpos - pos[rid]
        bases = allseq[seq0[rid] + offs]
        return gpos, bases, rid, n

    def _accumulate(self, batch):
        """Batched pileup: one vectorized pass per (chr, strand) read group
        instead of ~6 small numpy calls per read (call overhead dominated
        the wall on large inputs).  Semantics identical to _add_file_slow
        per read: the converted_site filter (absolute or fractional) gates
        BOTH the forward accumulation and the SNP-plane counts, and the
        -x context mask applies to accumulation only, never to n_conv."""
        if not batch:
            return
        self.nmap += len(batch)
        mode_m = self.mode == "M"
        groups = {}
        for info in batch:
            groups.setdefault((info[2], info[1]), []).append(info)
        for (cr, strand), lst in groups.items():
            sites, sites_rc, lut_mod, lut_unmod, lut_mod_rc, lut_unmod_rc = \
                self._site_index(cr)[strand]
            markcr = self.refmark.get(cr)
            R = len(lst)
            pos = np.fromiter((i[3] for i in lst), np.int64, R)
            lens = np.fromiter((len(i[0]) for i in lst), np.int64, R)
            allseq = np.frombuffer(
                "".join(i[0] for i in lst).encode("latin1"), np.uint8)
            seq0 = np.cumsum(lens) - lens

            gpos, bases, rid, n_cov = self._batch_sites(
                sites, pos, lens, allseq, seq0)
            is_mod = lut_mod[bases]
            is_unmod = lut_unmod[bases]
            conv = is_mod if mode_m else is_unmod
            n_conv = np.bincount(rid, conv, minlength=R)
            if self.converted_site >= 1:
                read_ok = n_conv >= self.converted_site
            else:
                read_ok = ~(n_conv < self.converted_site
                            * n_cov.astype(np.float64))
            site_ok = read_ok[rid]
            if markcr is not None and self.seq_context:
                site_ok = site_ok & np.isin(markcr[gpos],
                                            list(self.seq_context))
            np.add.at(self.depth[cr], gpos[site_ok & (is_mod | is_unmod)], 1)
            np.add.at(self.meth[cr], gpos[site_ok & is_mod], 1)
            if self.handle_snp == 0:
                continue
            gpos, bases, rid, _ = self._batch_sites(
                sites_rc, pos, lens, allseq, seq0)
            is_mod = lut_mod_rc[bases]
            is_unmod = lut_unmod_rc[bases]
            site_ok = read_ok[rid]
            if markcr is not None and self.seq_context:
                site_ok = site_ok & np.isin(markcr[gpos],
                                            list(self.seq_context))
            np.add.at(self.depth_ct[cr], gpos[site_ok & (is_mod | is_unmod)], 1)
            np.add.at(self.meth_ct[cr], gpos[site_ok & is_mod], 1)

    def _add_file_slow(self, path: str):
        disp(f"Load Alignment: {path}")
        nline = 0
        for line in iter_sam_lines(path, self.ref):
            nline += 1
            info = self._load_read(line)
            if info is None:
                continue
            seq, strand, cr, pos = info
            self.nmap += 1
            raw, modified, unmodified, raw_rc, mod_rc, unmod_rc = self.rule[strand]
            refseq = self.ref[cr]
            markcr = self.refmark.get(cr)
            window = refseq[pos:pos + len(seq)]
            idxs = [m.start() for m in re.finditer(raw, window)]
            n_conv = 0
            for i in idxs:
                if self.mode == "U" and seq[i] in unmodified:
                    n_conv += 1
                elif self.mode == "M" and seq[i] in modified:
                    n_conv += 1
            if self.converted_site >= 1:
                if n_conv < self.converted_site:
                    continue
            elif n_conv < self.converted_site * len(idxs):
                continue
            if idxs:
                dep, met = self.depth[cr], self.meth[cr]
                for i in idxs:
                    if markcr is not None and self.seq_context and \
                            markcr[i + pos] not in self.seq_context:
                        continue
                    c = seq[i]
                    if c in unmodified:
                        dep[i + pos] += 1
                    elif c in modified:
                        dep[i + pos] += 1
                        met[i + pos] += 1
            if self.handle_snp == 0:
                continue
            ridx = [m.start() for m in re.finditer(raw_rc, window)]
            if ridx:
                dct, mct = self.depth_ct[cr], self.meth_ct[cr]
                for i in ridx:
                    if markcr is not None and self.seq_context and \
                            markcr[i + pos] not in self.seq_context:
                        continue
                    c = seq[i]
                    if c in unmod_rc:
                        dct[i + pos] += 1
                    elif c in mod_rc:
                        dct[i + pos] += 1
                        mct[i + pos] += 1
        disp(f"Read {nline} lines")

    def combine_cpg(self):
        """-g: combine Watson+Crick CpG counts (basalkit_functions.py:297-308)."""
        for arrs in (self.meth, self.depth,
                     *((self.meth_ct, self.depth_ct)
                       if self.handle_snp > 0 else ())):
            for cr, a in arrs.items():
                b = np.frombuffer(self.ref[cr].encode("latin1"), np.uint8)
                cg = np.flatnonzero((b[:-1] == ord("C")) & (b[1:] == ord("G")))
                a[cg] = a[cg] + a[cg + 1]
                a[cg + 1] = 0

    def write_output(self, tsv_prefix: str, min_depth: int = 4,
                     motif_length: int = 2, wig_prefix: Optional[str] = None,
                     wig_bin: int = 25):
        """Out_base_ratio (basalkit_functions.py:318-388)."""
        header = ["chr", "pos", "strand", "context", "ratio", "eff_coverage",
                  "N_mod", "N_total"]
        if self.handle_snp > 0:
            header += ["N_mod_rev", "N_total_rev"]
        fo = open(tsv_prefix + "_AvgMod.tsv", "w")
        fo.write("\t".join(header) + "\n")
        fw = None
        if wig_prefix is not None:
            fw = open(wig_prefix + "_AvgMod.wig", "w")
            fw.write(f"track type=wiggle_0 name={wig_prefix}_MethRatio\n")
        nc, nd = 0, 0
        for cr in sorted(self.depth):
            dep, met, refcr = self.depth[cr], self.meth[cr], self.ref[cr]
            markcr = self.refmark.get(cr)
            if fw:
                fw.write(f"variableStep chrom={cr} span={wig_bin}\n")
                wbin = 0
                wigd = wigm = 0.0
            for i in np.flatnonzero(dep >= min_depth):
                i = int(i)
                dd = int(dep[i])
                d = dd
                if self.handle_snp > 0:
                    m1, d1 = int(self.meth_ct[cr][i]), int(self.depth_ct[cr][i])
                    if m1 != d1:
                        if self.handle_snp == 2:
                            continue
                        d = float(dd) * m1 / d1
                if self.seq_context and markcr is not None and \
                        markcr[i] not in self.seq_context:
                    continue
                if refcr[i] == self.frm:
                    seq = refcr[i - motif_length:i + motif_length + 1]
                    strand = "+"
                else:
                    seq = reverse_complement(
                        refcr[i - motif_length:i + motif_length + 1])
                    strand = "-"
                m = int(met[i])
                if d == 0:
                    continue
                ratio = min(m, d) * 1.0 / d
                nc += 1
                nd += d
                if fw:
                    if i // wig_bin != wbin:
                        if wigd > 0:
                            fw.write(f"{wbin * wig_bin + 1:.0f}\t"
                                     f"{min(wigm / wigd, 1):.3f}\n")
                        wbin = i // wig_bin
                        wigd = wigm = 0.0
                    wigd += d
                    wigm += m
                if self.handle_snp > 0:
                    fo.write(f"{cr}\t{i + 1}\t{strand}\t{seq}\t{ratio:.3f}\t"
                             f"{d:.2f}\t{m}\t{dd}\t{m1}\t{d1}\n")
                else:
                    fo.write(f"{cr}\t{i + 1}\t{strand}\t{seq}\t{ratio:.3f}\t"
                             f"{d:.2f}\t{m}\t{dd}\n")
        fo.close()
        if fw:
            fw.close()
        fold = "NA" if nc == 0 else round(float(nd) / nc, 2)
        disp(f"Total {self.nmap} valid mappings, cover {nc} base {self.frm}, "
             f"average depth: {fold} fold.")
