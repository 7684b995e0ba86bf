"""basalkit-compatible CLI: avgmod / shiftD / mergeBAM / fdr / regmod.

Mirrors the reference toolkit's subcommands and options (basalkit.py) with
self-contained BAM I/O and statistics (no samtools/pysam/statsmodels).
Run: ``python -m basal_tpu_torch.toolkit.cli <Function> ...``

Copied from ``basal_tpu/toolkit/cli.py`` at b9f8fd4: the port imports
nothing of basal_tpu.  Changes: none.
"""

from __future__ import annotations

import argparse
import sys
from collections import OrderedDict

VERSION = "1.8.1"

CMDS = OrderedDict([
    ("avgmod", "Calculate average modification level(AvgMod) of tested "
               "nucleotide(e.g. 5mC/6mA)"),
    ("shiftD", "Shift the position of D in CIGAR in bam/sam (BID-seq)"),
    ("mergeBAM", "Lift transcriptome BAM to genome positions and merge with "
                 "the genome BAM"),
    ("fdr", "Significance test between treatment and control/background"),
    ("regmod", "Summarise the modification level of given regions"),
])


def print_help():
    print(f"BASAL Toolkit (TPU-native) v{VERSION}\n")
    print("Available Functions:\n")
    for k, v in CMDS.items():
        print(f"  {k}\t{v}\n")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in CMDS:
        print_help()
        return 1
    cmd = argv[0]
    p = argparse.ArgumentParser(prog=f"basalkit {cmd}", description=CMDS[cmd])

    if cmd == "avgmod":
        p.add_argument("Alignments")
        p.add_argument("Reference")
        p.add_argument("-M", "--converted_base", default="C:T")
        p.add_argument("-D", "--conversion_mode", default="U", choices=["U", "M"])
        p.add_argument("-T", "--molecule_type", default="DNA", choices=["DNA", "RNA"])
        p.add_argument("-a", "--aligner", default="BASAL",
                       choices=["BASAL", "Bismark", "gemBS"])
        p.add_argument("-o", "--tsv_prefix", default="output")
        p.add_argument("-w", "--wig_prefix", default=None)
        p.add_argument("-b", "--wig_bin", type=int, default=25)
        p.add_argument("-c", "--chroms", default=None)
        p.add_argument("-s", "--sam_path", default=None)  # accepted, unused
        p.add_argument("-u", "--unique", action="store_true")
        p.add_argument("-p", "--pair", action="store_true")
        p.add_argument("-r", "--rm_dup", action="store_true")
        p.add_argument("-t", "--trim_fillin", type=int, default=0)
        p.add_argument("-g", "--combine", action="store_true")
        p.add_argument("-m", "--min_depth", type=int, default=4)
        p.add_argument("-z", "--converted_site", type=float, default=0)
        p.add_argument("-i", "--handle_SNP", default="no-action",
                       choices=["no-action", "correct", "skip"])
        p.add_argument("-x", "--context", default=None)
        p.add_argument("-y", "--motif_length", type=int, default=5)
        a = p.parse_args(argv[1:])

        from .avgmod import AvgMod, disp, load_reference, mark_reference
        disp("avgmod Started")
        frm, to = a.converted_base.split(":")
        chroms = set(a.chroms.split(",")) if a.chroms else set()
        ref = load_reference(a.Reference, chroms)
        ctx_names = ["CG", "CHG", "CHH"] if a.converted_base == "C:T" else []
        seq_context = set()
        if a.context:
            seq_context = {ctx_names.index(c) + 1
                           for c in a.context.upper().split(",")}
        refmark = mark_reference(ref) if seq_context else {}
        if a.combine and a.converted_base != "C:T":
            p.error("-g is only valid for -M C:T")
        handle_snp = {"no-action": 0, "correct": 1, "skip": 2}[a.handle_SNP]
        am = AvgMod(ref, frm, list(to), conversion_mode=a.conversion_mode,
                    molecule_type=a.molecule_type, aligner=a.aligner,
                    unique=a.unique, pair=a.pair, rm_dup=a.rm_dup,
                    trim_fillin=a.trim_fillin, seq_context=seq_context,
                    handle_snp=handle_snp, converted_site=a.converted_site,
                    refmark=refmark)
        for path in sorted(set(a.Alignments.split(","))):
            am.add_file(path)
        if a.combine:
            disp("Combining cytosine methylation from both strands")
            am.combine_cpg()
        am.write_output(a.tsv_prefix, min_depth=a.min_depth,
                        motif_length=a.motif_length // 2,
                        wig_prefix=a.wig_prefix, wig_bin=a.wig_bin)
        disp("avgmod Finished")

    elif cmd == "shiftD":
        p.add_argument("Alignments")
        p.add_argument("-c", "--convert_from_base", default="T")
        p.add_argument("-s", "--sam_path", default=None)
        p.add_argument("-o", "--out", default="corrected")
        a = p.parse_args(argv[1:])
        from .shiftd import shift_d
        shift_d(a.Alignments, a.out, a.convert_from_base)

    elif cmd == "mergeBAM":
        p.add_argument("transcriptomeAlignmentBam")
        p.add_argument("genomeAlignmentBam")
        p.add_argument("gtf")
        p.add_argument("-o", "--output", default="sample1")
        p.add_argument("-u", "--unlift", action="store_true")
        a = p.parse_args(argv[1:])
        from .mergebam import merge_bam
        merge_bam(a.transcriptomeAlignmentBam, a.genomeAlignmentBam, a.gtf,
                  a.output, unlift=a.unlift)

    elif cmd == "fdr":
        p.add_argument("treat")
        p.add_argument("-c", "--ctrl", default=None)
        p.add_argument("-m", "--min_depth", type=int, default=4)
        p.add_argument("-d", "--method", default="binomial",
                       choices=["binomial", "poisson", "fisher"])
        p.add_argument("-r", "--fdr_method", default="fdr_bh",
                       choices=["bonferroni", "sidak", "holm-sidak", "holm",
                                "simes-hochberg", "hommel", "fdr_bh",
                                "fdr_by", "fdr_tsbh", "fdr_tsbky"])
        p.add_argument("-o", "--output_prefix", default="output")
        a = p.parse_args(argv[1:])
        from .fdr import calc_pval
        calc_pval(a.treat, a.ctrl, a.output_prefix, a.min_depth, a.method,
                  a.fdr_method)

    elif cmd == "regmod":
        p.add_argument("Bed")
        p.add_argument("AvgMod")
        p.add_argument("-s", "--usestrand", action="store_true")
        p.add_argument("-o", "--output", dest="OUT", default="region_ratio.tsv")
        a = p.parse_args(argv[1:])
        from .regmod import regmod
        regmod(a.Bed, a.AvgMod, a.OUT, use_strand=a.usestrand)
    return 0


if __name__ == "__main__":
    sys.exit(main())
