"""basal-compatible command line of the PyTorch port.

    python -m basal_tpu_torch.cli -a reads.fq -d ref.fa -M A:G -S 1 -o out.sam

    python -m basal_tpu_torch.cli -a r1.fq -b r2.fq -d ref.fa -M C:T -S 1 -o out.sam

Takes basal_tpu's flags and runs the single-end or, with ``-b``, the
paired-end aligner on the device named by ``BASAL_TPU_TORCH_DEVICE``
(default ``cuda``; ``cpu`` runs the kernels' plain versions).

``VERSION``, ``_usage`` and ``parse_args`` are copied from
``basal_tpu/cli.py`` (lines 15-81) at cb4d597, unchanged: the port imports
nothing of basal_tpu.
"""

from __future__ import annotations

import sys
import time

from .config import MAXGAPS, MAXHITS, AlignParams

VERSION = "1.8.1"  # reference-parity version (main.cpp:48)


def _usage():
    sys.stderr.write(
        "basal_tpu — TPU-native base-conversion sequencing aligner\n"
        "Usage: basal-tpu [options]\n"
        "  -a <str>   input reads FASTA/FASTQ/BAM [required]\n"
        "  -b <str>   mate reads (paired-end)\n"
        "  -d <str>   reference FASTA [required]\n"
        "  -o <str>   output SAM/BAM (default stdout SAM)\n"
        "  -M <str>   convert-from:convert-to rule, e.g. C:T, A:G, A:CGT, T:- [required]\n"
        "  -v <float> max mismatches (fraction of length if <1)\n"
        "  -g <int>   max gap size (<=%d)\n"
        "  -w <int>   max equal-best hits (<=%d)\n"
        "  -B/-E <int> first/last read to map\n"
        "  -I <int>   index interval (1-16)\n"
        "  -k <float> over-represented kmer cut-off ratio\n"
        "  -s <int>   seed size (10-16)\n"
        "  -S <int>   RNG seed (0: clock)\n"
        "  -p <int>   host worker threads\n"
        "  -m/-x <int> min/max insert size\n"
        "  -q/-z/-f/-A/-L  trimming options\n"
        "  -n [0,1,2] strand protocol (directional/non-directional/PBAT)\n"
        "  -r [0,1,2] repeat-hit reporting\n"
        "  -R/-u/-H/-V  reporting options\n" % (MAXGAPS, MAXHITS))
    sys.exit(1)


def parse_args(argv):
    """Hand-rolled parser mirroring mGetOptions' -x val / -x=val forms."""
    opts = {}
    flags = set()
    i = 0
    valopts = "abdosMmnxgrVIkvwqfzpABELDS"
    boolopts = "R3HuN"
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-") or len(a) < 2:
            sys.stderr.write(f"unknown option: {a}\n")
            sys.exit(1)
        c = a[1]
        if c == "h":
            _usage()
        if c in boolopts and len(a) == 2:
            flags.add(c)
        elif c in valopts:
            if len(a) == 2:
                i += 1
                if i >= len(argv):
                    sys.stderr.write(f"missing value for -{c}\n")
                    sys.exit(1)
                v = argv[i]
            elif a[2] == "=":
                v = a[3:]
            else:
                sys.stderr.write(f"unknown option: {a}\n")
                sys.exit(1)
            if c == "A":
                opts.setdefault("A", []).append(v)
            else:
                opts[c] = v
        else:
            sys.stderr.write(f"unknown option: {a}\n")
            sys.exit(1)
        i += 1
    return opts, flags


def params_from_args(argv, opts, flags) -> AlignParams:
    """AlignParams of parsed flags (the mapping of basal_tpu's cli.main)."""
    kw = dict(conversion=opts["M"])
    if "s" in opts:
        kw["seed_size"] = int(opts["s"])
    if "I" in opts:
        kw["index_interval"] = min(int(opts["I"]), 16)
    # SetSeedSize recomputes min_read_size with the index_interval value at
    # the time -s appears on the command line (argument-order dependence in
    # the reference's option parser); without -s the constructor-time value
    # 15 stands (see AlignParams.min_read_size_quirk)
    cur_i, cur_min = 4, 15
    for j, a in enumerate(argv):
        if a == "-I" and j + 1 < len(argv):
            cur_i = min(int(argv[j + 1]), 16)
        elif a.startswith("-I="):
            cur_i = min(int(a[3:]), 16)
        elif a == "-s" and j + 1 < len(argv):
            cur_min = int(argv[j + 1]) + cur_i - 1
        elif a.startswith("-s="):
            cur_min = int(a[3:]) + cur_i - 1
        elif a == "-D" or a.startswith("-D="):
            cur_i = 1
    kw["min_read_size_quirk"] = cur_min
    if "k" in opts:
        kw["max_kmer_ratio"] = float(opts["k"])
    if "v" in opts:
        kw["max_snp_num"] = AlignParams.parse_v(float(opts["v"]))
    if "g" in opts:
        kw["gap"] = min(int(opts["g"]), MAXGAPS)
    if "w" in opts:
        kw["max_num_hits"] = int(opts["w"])
    if "r" in opts:
        kw["report_repeat_hits"] = int(opts["r"])
    if "n" in opts:
        kw["chains"] = int(opts["n"])
    if "S" in opts:
        kw["randseed"] = int(opts["S"])
    if "m" in opts:
        kw["min_insert"] = int(opts["m"])
    if "x" in opts:
        kw["max_insert"] = int(opts["x"])
    if "q" in opts:
        kw["qual_threshold"] = int(opts["q"])
    if "z" in opts:
        kw["zero_qual"] = int(opts["z"])
    if "f" in opts:
        kw["max_ns"] = int(opts["f"])
    if "L" in opts:
        kw["max_readlen"] = int(opts["L"])
    if "B" in opts:
        kw["read_start"] = max(int(opts["B"]), 1)
    if "E" in opts:
        kw["read_end"] = int(opts["E"])
    if "p" in opts:
        kw["num_threads"] = int(opts["p"])
    if "V" in opts:
        kw["verbose_level"] = int(opts["V"])
    if "A" in opts:
        kw["adapters"] = tuple(opts["A"])
    if "D" in opts:
        kw["digestion_site"] = opts["D"]
    if "b" in opts:
        kw["pairend"] = True
    kw["out_ref"] = "R" in flags
    kw["nt3"] = "3" in flags
    kw["sam_header"] = "H" not in flags
    kw["out_unmap"] = "u" in flags
    kw["n_mis"] = "N" in flags
    return AlignParams(**kw)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        _usage()
    command_line = "basal-tpu " + " ".join(argv)
    opts, flags = parse_args(argv)
    if "M" not in opts:
        sys.stderr.write("\n-M option is required\n")
        sys.exit(1)
    if "a" not in opts or "d" not in opts:
        sys.stderr.write("-a and -d are required\n")
        sys.exit(1)
    params = params_from_args(argv, opts, flags)
    verbose = params.verbose_level

    def log(msg, level=1):
        if level <= verbose:
            sys.stderr.write(f"[BASAL @{time.ctime()}] {msg}\n")

    if params.pairend:
        from .pairs.pipeline import run_pair_end

        def runner(fh):
            return run_pair_end(params, opts["d"], opts["a"], opts["b"],
                                out_fh=fh, command_line=command_line, log=log)
    else:
        from .align.pipeline import run_single_end

        def runner(fh):
            return run_single_end(params, opts["d"], opts["a"], out_fh=fh,
                                  command_line=command_line, log=log)

    out_path = opts.get("o")
    if out_path is None:
        runner(getattr(sys.stdout, "buffer", sys.stdout))
        sys.stdout.flush()
    elif out_path.endswith(".bam"):
        from .toolkit.bamio import BamWriter
        with BamWriter(out_path) as bw:
            runner(bw)
    else:
        with open(out_path, "wb") as fh:
            runner(fh)


if __name__ == "__main__":
    main()
