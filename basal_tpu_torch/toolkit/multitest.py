"""Multiple-testing correction — self-contained replacement for
statsmodels.stats.multitest.multipletests (not available in this
environment), implementing the ten methods BASALkit's ``fdr`` exposes
(basalkit.py:117-119).  Returns (reject, pvals_corrected) like statsmodels.

Copied from ``basal_tpu/toolkit/multitest.py`` at b9f8fd4: the port imports
nothing of basal_tpu.  Changes: none.
"""

from __future__ import annotations

import numpy as np


def _ecf(sortedp):  # empirical cumulative fraction 1/n..1
    n = len(sortedp)
    return np.arange(1, n + 1) / n


def multipletests(pvals, alpha: float = 0.05, method: str = "fdr_bh"):
    p = np.asarray(pvals, dtype=float)
    n = len(p)
    if n == 0:
        return np.zeros(0, bool), p.copy()
    method = method.lower()

    if method == "bonferroni":
        q = np.minimum(p * n, 1.0)
        return q <= alpha, q
    if method == "sidak":
        q = 1.0 - np.power(1.0 - p, n)
        return q <= alpha, q

    order = np.argsort(p)
    po = p[order]
    inv = np.empty(n, int)
    inv[order] = np.arange(n)

    if method in ("holm", "holm-sidak"):
        k = np.arange(n)
        if method == "holm":
            adj = po * (n - k)
        else:
            adj = 1.0 - np.power(1.0 - po, n - k)
        adj = np.maximum.accumulate(adj)
        q = np.minimum(adj, 1.0)[inv]
        return q <= alpha, q
    if method == "simes-hochberg":
        k = np.arange(n)
        adj = po * (n - k)
        adj = np.minimum.accumulate(adj[::-1])[::-1]
        q = np.minimum(adj, 1.0)[inv]
        return q <= alpha, q
    if method == "hommel":
        # R p.adjust "hommel" on sorted p (Wright 1992), as statsmodels does
        q = po.copy()
        pa = po.copy()
        for m in range(n, 1, -1):
            i1 = np.arange(0, n - m + 1)
            i2 = np.arange(n - m + 1, n)
            q1 = np.min(m * po[i2] / np.arange(2, m + 1)) if len(i2) else np.inf
            q[i1] = np.minimum(m * po[i1], q1)
            if len(i2):
                q[i2] = q[n - m]
            pa = np.maximum(pa, q)
        q = np.minimum(np.maximum(pa, po), 1.0)[inv]
        return q <= alpha, q
    if method in ("fdr_bh", "fdr_by"):
        k = np.arange(1, n + 1)
        factor = 1.0 if method == "fdr_bh" else np.sum(1.0 / k)
        adj = po * n * factor / k
        adj = np.minimum.accumulate(adj[::-1])[::-1]
        q = np.minimum(adj, 1.0)[inv]
        return q <= alpha, q
    if method in ("fdr_tsbh", "fdr_tsbky"):
        if method == "fdr_tsbh":
            # statsmodels fdrcorrection_twostage(method='bh'): fact=1, so the
            # stage-1 alpha is unscaled (alpha/(1+alpha) is only for 'bky')
            rej1, _ = multipletests(p, alpha, "fdr_bh")
            m0 = n - rej1.sum()
            k = np.arange(1, n + 1)
            adj = po * m0 / k
            adj = np.minimum.accumulate(adj[::-1])[::-1]
            q = np.minimum(adj, 1.0)[inv]
            return q <= alpha, q
        # fdr_tsbky (two-stage Benjamini-Krieger-Yekutieli)
        alpha_prime = alpha / (1 + alpha)
        rej1, _ = multipletests(p, alpha_prime, "fdr_bh")
        m0 = n - rej1.sum()
        if m0 == 0:
            q = np.zeros(n)
            return np.ones(n, bool), q
        k = np.arange(1, n + 1)
        adj = po * m0 / k
        adj = np.minimum.accumulate(adj[::-1])[::-1]
        q = np.minimum(adj, 1.0)[inv]
        return q <= alpha_prime, q
    raise ValueError(f"unknown method {method}")
