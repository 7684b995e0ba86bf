"""fdr — per-site significance vs control or global background.

Re-implementation of BASALkit ``fdr`` (basalkit.py:324-327,
basalkit_functions.py:711-780): one-sided binomial / poisson / fisher test of
treatment modification counts against a control AvgMod table (joined on
chr/pos/strand) or the treatment's own overall conversion ratio; FDR via the
self-contained multipletests (statsmodels replacement).

Output: ``<prefix>_FDR.tsv.gz`` with the reference's exact columns/formats.

Copied from ``basal_tpu/toolkit/fdr.py`` at b9f8fd4: the port imports
nothing of basal_tpu.  Changes: none.
"""

from __future__ import annotations

import gzip
import math

import numpy as np
import pandas as pd
import scipy.stats

from .avgmod import disp
from .multitest import multipletests


def _binom_sf_ge(x: int, n: int, p: float) -> float:
    """One-sided binomial P(X >= x); scipy.stats.binom_test(...,
    alternative='greater') equivalent (binom_test was removed in scipy>=1.12)."""
    if n == 0:
        return 1.0
    return float(scipy.stats.binom.sf(x - 1, n, min(max(p, 0.0), 1.0)))


def _pvalue(method: str, n_mod: int, n_total: int, ctrl_cr: float,
            n_mod_ctrl: int, n_total_ctrl: int) -> float:
    if method == "binomial":
        return _binom_sf_ge(n_mod, n_total, ctrl_cr)
    if method == "poisson":
        return float(scipy.stats.poisson.sf(
            n_mod, int(math.ceil(ctrl_cr * n_total))))
    if method == "fisher":
        return float(scipy.stats.fisher_exact(
            [[n_mod, n_total - n_mod],
             [n_mod_ctrl, n_total_ctrl - n_mod_ctrl]],
            alternative="greater")[1])
    raise ValueError(method)


def calc_pval(treat: str, ctrl, output_prefix: str, min_depth: int = 4,
              method: str = "binomial", fdr_method: str = "fdr_bh"):
    tdf = pd.read_csv(treat, sep="\t", compression="infer")
    tdf = tdf[tdf.N_total >= min_depth]
    rows = []
    pvals = []
    if ctrl is None:
        header = ["chr", "pos", "strand", "context", "ratio", "eff_coverage",
                  "N_mod", "N_total", "ratio_ctrl", "pvalue"]
        n_mod_ctrl = int(tdf["N_mod"].sum())
        n_total_ctrl = int(tdf["N_total"].sum())
        ctrl_cr = n_mod_ctrl / n_total_ctrl
        for _, row in tdf.iterrows():
            n_mod, n_total = int(row["N_mod"]), int(row["N_total"])
            if n_mod > n_total:
                continue
            pv = _pvalue(method, n_mod, n_total, ctrl_cr,
                         n_mod_ctrl, n_total_ctrl)
            pvals.append(pv)
            rows.append("{}\t{}\t{}\t{}\t{:.3f}\t{:.2f}\t{}\t{}\t{:.3f}\t{:.3e}"
                        .format(row["chr"], row["pos"], row["strand"],
                                row["context"], row["ratio"],
                                row["eff_coverage"], row["N_mod"],
                                row["N_total"], ctrl_cr, pv))
    else:
        header = ["chr", "pos", "strand", "context", "ratio", "eff_coverage",
                  "N_mod", "N_total", "N_mod_ctrl", "N_total_ctrl",
                  "ratio_ctrl", "pvalue"]
        cdf = pd.read_csv(ctrl, sep="\t", compression="infer")
        cdf = cdf[cdf.N_total >= min_depth]
        keys = tdf.columns[:3].tolist()
        matched = pd.merge(tdf.iloc[:, :3], cdf.iloc[:, :3], how="inner")
        mt = pd.merge(matched, tdf, on=keys)
        mc = pd.merge(matched, cdf, on=keys)
        disp(f"{len(mt)} common sites found between treat and ctrl")
        for (_, rt), (_, rc) in zip(mt.iterrows(), mc.iterrows()):
            n_mod, n_total = int(rt["N_mod"]), int(rt["N_total"])
            n_mod_c, n_total_c = int(rc["N_mod"]), int(rc["N_total"])
            if n_mod > n_total or n_mod_c > n_total_c:
                continue
            ctrl_cr = n_mod_c / n_total_c
            pv = _pvalue(method, n_mod, n_total, ctrl_cr, n_mod_c, n_total_c)
            pvals.append(pv)
            rows.append(
                "{}\t{}\t{}\t{}\t{:.3f}\t{:.2f}\t{}\t{}\t{}\t{}\t{:.3f}\t{:.3e}"
                .format(rt["chr"], rt["pos"], rt["strand"], rt["context"],
                        rt["ratio"], rt["eff_coverage"], rt["N_mod"],
                        rt["N_total"], n_mod_c, n_total_c, ctrl_cr, pv))

    fdr_col = multipletests(pvals, method=fdr_method)[1]
    out = output_prefix + "_FDR.tsv.gz"
    with gzip.open(out, "wt") as f:
        f.write("\t".join(header) + "\tFDR\n")
        for r, q in zip(rows, fdr_col):
            f.write(f"{r}\t{q:.3e}\n")
    disp(f"FDR values are saved in {out}")
