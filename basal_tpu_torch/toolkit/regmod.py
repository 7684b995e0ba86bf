"""regmod — region-level weighted modification ratios over BED intervals.

Re-implementation of BASALkit ``regmod`` (basalkit.py:329-369,
basalkit_functions.py:782-826): per region, merge +/- strand sites (minus
shifted to the CpG's plus coordinate) and report the coverage-weighted
modification ratio.

Copied from ``basal_tpu/toolkit/regmod.py`` at b9f8fd4: the port imports
nothing of basal_tpu.  Changes: none.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from .avgmod import disp


def read_methy_file(path: str, cols=(0, 1, 2, 6, 7)) -> pd.DataFrame:
    names = ["chr", "pos", "strand", "modified", "total"]
    disp(f"Loading ratios in tsv file: {path}")
    df = pd.read_csv(path, sep="\t", header=0, usecols=list(cols),
                     names=names, compression="infer", low_memory=False)
    df.index = df["pos"]
    return df.drop(columns=["pos"])


def _merge_strand_chr(df: pd.DataFrame) -> pd.DataFrame:
    """merge_strand_each_chr (basalkit_functions.py:790-800): '-' sites shift
    one base left onto the CpG's '+' coordinate; counts sum."""
    dp = df[df["strand"] == "+"]
    dn = df[df["strand"] == "-"].copy()
    dn.index = dn.index.values - 1
    idx = np.sort(np.unique(np.append(dn.index.values, dp.index.values)))
    out = pd.DataFrame(np.zeros((len(idx), 2)), index=idx,
                       columns=["modified", "total"])
    out.loc[dp.index, :] += dp.loc[:, ["modified", "total"]].values
    out.loc[dn.index, :] += dn.loc[:, ["modified", "total"]].values
    return out.loc[0:, :]


def merge_strand(df: pd.DataFrame) -> pd.DataFrame:
    parts = []
    for ch in df["chr"].unique().tolist():
        sub = df[df["chr"] == ch]
        if sub.shape[0] > 0:
            m = _merge_strand_chr(sub)
            m["chr"] = ch
            parts.append(m)
    return pd.concat(parts) if parts else pd.DataFrame()


def region_weighted_ratio(ratio_sub: pd.DataFrame, start=0, end=0):
    sel = ratio_sub[(ratio_sub.index >= start) & (ratio_sub.index <= end)]
    count = sel.shape[0]
    if count > 0:
        merged = merge_strand(sel)
        mc = merged["modified"].sum()
        tc = merged["total"].sum()
        return [mc * 1.0 / tc, count, tc]
    return [np.nan, count, np.nan]


def regmod(bed_path: str, avgmod_path: str, out_path: str,
           use_strand: bool = False):
    df = read_methy_file(avgmod_path)
    with open(out_path, "w") as o1:
        if use_strand:
            bed = pd.read_csv(bed_path, sep="\t", usecols=[0, 1, 2, 5],
                              header=None)
            bed.columns = ["chr", "start", "end", "strand"]
            bed.sort_values(["chr", "strand", "start", "end"], inplace=True)
            disp(f"Generating AvgMod ratio for {bed.shape[0]} Regions ...")
            o1.write("\t".join(["chr", "start", "end", "strand", "AvgMod",
                                "site", "coverage"]) + "\n")
            ch0 = st0 = ""
            sub = df
            for _, row in bed.iterrows():
                ch, a, b, st = row["chr"], int(row["start"]), int(row["end"]), row["strand"]
                if ch != ch0 or st != st0:
                    sub = df[(df["chr"] == ch) & (df["strand"] == st)]
                vals = region_weighted_ratio(sub, a, b)
                o1.write("\t".join(map(str, [ch, a, b, st] + vals)) + "\n")
                ch0, st0 = ch, st
        else:
            bed = pd.read_csv(bed_path, sep="\t", usecols=[0, 1, 2],
                              header=None)
            bed.columns = ["chr", "start", "end"]
            bed.sort_values(["chr", "start", "end"], inplace=True)
            disp(f"Generating AvgMod ratio for {bed.shape[0]} regions ...")
            o1.write("\t".join(["chr", "start", "end", "AvgMod", "site",
                                "coverage"]) + "\n")
            ch0 = ""
            sub = df
            for _, row in bed.iterrows():
                ch, a, b = row["chr"], row["start"], row["end"]
                if ch != ch0:
                    sub = df[df["chr"] == ch]
                vals = region_weighted_ratio(sub, a, b)
                o1.write("\t".join(map(str, [ch, a, b] + vals)) + "\n")
                ch0 = ch
