"""The routing protocol of the shard-resident seed index.

Each process holds only its k-mer range of the seed table; per read batch,
the k-mers the batch can probe are fetched from their owners in batched
collective rounds, and the dense ``starts/counts/n1/locs`` tables that the
scheduler reads are filled for those k-mers only (see ``RoutedSeedIndex``).
A free-running service thread runs the rounds, so a peer's query is
answered while this process aligns.

Copied from ``basal_tpu/parallel/multihost.py`` (``_RoundResult`` and
``RoutedSeedIndex``, lines 84-463) at cb4d597: the port imports nothing of
basal_tpu.  Changes: imports; removed the JAX members
``RoutedSeedIndex.__init__`` and ``_round`` (the shard build and the
collectives), which ``parallel.multihost.TorchRoutedSeedIndex`` defines on
torch.distributed, and ``_allgather_ragged``.  ``_round_inner``'s ``mhu``
is any object with ``process_allgather``.  ``_fill`` holds the index's
own lock (``self._fill_lock``, made in ``TorchRoutedSeedIndex.__init__``,
so unrelated indices never wait on each other): the service thread
installs replies
while the caller's thread installs its own-range k-mers in
``ensure_batch``; unserialised, one fill could write its locs over the
other's and roll ``_locs_n`` back, or fail on a slice that no longer fits
its reply and stop the thread.  An empty reply (the service thread's in
a round that answers only a peer) returns before it, as it installs
nothing.
"""

from __future__ import annotations

import time

import numpy as np


class _RoundResult(object):
    __slots__ = ("finished", "any_queries")

    def __init__(self, finished: bool, any_queries: bool):
        self.finished = finished
        self.any_queries = any_queries


class RoutedSeedIndex:
    """SeedIndex-compatible facade whose entries are fetched on demand from
    k-mer-range shards resident on their owning hosts.

    Exposes dense ``starts/counts/n1/locs/max_kmer_num`` (the exact fields
    NativeBatch / SeedScheduler consume) but fills them cumulatively, one
    batched routing round per read batch (``ensure_batch``).  Entries are
    value-identical to the dense single-host index for every k-mer ever
    queried; unqueried k-mers are never read by the scan (every index access
    goes through the batch's own ``enc.seedval``).  Cumulative filling keeps
    the two-deep overlapped pipeline safe: batch k's ladder waves reuse
    entries batch k requested even after batch k+1's round ran.
    """

    @property
    def locs(self) -> np.ndarray:
        return self._locs

    # -- routing ---------------------------------------------------------

    def _answer_one(self, q: np.ndarray):
        """Owner side, one requester list: the slice of ``q`` in our k-mer
        range, reduced to k-mers that actually occur.  Returns
        (idx positions of occurring k-mers within the in-range sublist,
        counts, n1, concatenated locs) — absent k-mers are implied by
        omission, which keeps the reply proportional to real index content
        instead of the query volume."""
        sh = self.shard
        lo, hi = sh.kmer_lo, sh.kmer_hi
        sub = q[(q >= lo) & (q < hi)] - lo
        idx = np.flatnonzero(sh.counts[sub] > 0).astype(np.int32)
        kk = sub[idx]
        c = sh.counts[kk]
        tot = int(c.sum())
        if tot:
            st = sh.starts[kk]
            # vectorized multi-slice CSR gather
            off = np.concatenate([[0], np.cumsum(c[:-1])])
            pos = np.arange(tot, dtype=np.int64)
            seg = np.searchsorted(np.cumsum(c), pos, side="right")
            locs = sh.locs[st[seg] + (pos - off[seg])]
        else:
            locs = np.zeros(0, np.uint32)
        return idx, c, sh.n1[kk], locs

    def _fill(self, sub_all: np.ndarray, idx: np.ndarray, cnts: np.ndarray,
              n1s: np.ndarray, locs: np.ndarray) -> None:
        """Install a reply: ``sub_all`` is the full queried sublist (marked
        present), ``idx`` selects its occurring k-mers.  Only occurring
        entries are scatter-written — the calloc zero pages stand in for
        the absent majority.  One fill at a time (see the module note);
        an empty reply installs nothing and takes no turn."""
        if not len(sub_all):
            return
        import time
        tp = self.t_phase
        with self._fill_lock:
            t = time.time()
            tot = int(cnts.sum())
            need = self._locs_n + tot
            if need > len(self._locs):
                cap = max(need, 2 * len(self._locs))
                nl = np.empty(cap, dtype=np.uint32)
                nl[:self._locs_n] = self._locs[:self._locs_n]
                self._locs = nl
            if tot:
                self._locs[self._locs_n:need] = locs
            tp["f_locs"] += time.time() - t
            t = time.time()
            if len(idx):
                kk = sub_all[idx]
                self.starts[kk] = self._locs_n + np.concatenate(
                    [[0], np.cumsum(cnts[:-1], dtype=np.int64)])
                self.counts[kk] = cnts
                self.n1[kk] = n1s
            tp["f_scatter"] += time.time() - t
            t = time.time()
            self._have[sub_all] = True
            tp["f_have"] += time.time() - t
            self._locs_n = need

    def _round_inner(self, q, done, mhu):
        """4 collectives per round (was 8): the fixed-latency cost of the
        cross-process backend is per-collective, so status+query-size merge
        into one small header all-gather, and each owner's reply meta+locs
        merge into one u32 payload sized by a combined reply header.
        Rounds where NO process has queries skip the payload collectives
        entirely (drain heartbeats are a single [2]-word all-gather)."""
        import time
        tp = self.t_phase
        t = time.time()
        hdr = np.asarray(mhu.process_allgather(
            np.array([1 if done else 0, len(q)], np.int64))).reshape(
                self.nproc, 2)
        tp["status"] += time.time() - t
        if int(hdr[:, 0].sum()) == self.nproc:
            return _RoundResult(True, False)
        qsizes = hdr[:, 1]
        if int(qsizes.sum()) == 0:
            return _RoundResult(False, False)
        t = time.time()
        # pow2 bucket padding: the allgather XLA program compiles once per
        # bucket, not once per round
        m = 1 << (max(int(qsizes.max()), 1) - 1).bit_length()
        pad = np.zeros(m, np.uint32)
        pad[:len(q)] = q
        qfull = np.asarray(mhu.process_allgather(pad)).reshape(self.nproc, m)
        queries = [qfull[p, :int(qsizes[p])] for p in range(self.nproc)]
        tp["qgather"] += time.time() - t
        self.exchanged_queries += int(qsizes.sum()) - int(qsizes[self.pid])
        # answer every requester's in-range queries (our own list never
        # overlaps our range: ensure_batch serves those locally)
        t = time.time()
        hdr_mine = np.zeros(self.nproc + 1, np.int64)
        meta_parts, locs_parts = [], []
        for r, qq in enumerate(queries):
            idx, c, n1s, locs = self._answer_one(qq)
            hdr_mine[r] = len(idx)
            meta_parts.append(np.concatenate([idx, c, n1s]).astype(np.int32))
            locs_parts.append(locs)
        meta_cat = (np.concatenate(meta_parts) if meta_parts
                    else np.zeros(0, np.int32))
        locs_cat = (np.concatenate(locs_parts) if locs_parts
                    else np.zeros(0, np.uint32))
        payload = np.concatenate([meta_cat.view(np.uint32), locs_cat])
        hdr_mine[self.nproc] = len(payload)
        tp["answer"] += time.time() - t
        t = time.time()
        hdrs = np.asarray(mhu.process_allgather(hdr_mine)).reshape(
            self.nproc, self.nproc + 1)
        m2 = 1 << (max(int(hdrs[:, self.nproc].max()), 1) - 1).bit_length()
        pp = np.zeros(m2, np.uint32)
        pp[:len(payload)] = payload
        pfull = np.asarray(mhu.process_allgather(pp)).reshape(self.nproc, m2)
        tp["rgather"] += time.time() - t
        # parse the owners' reply segments addressed to us; segment offsets
        # come from the combined header + the counts inside earlier segments
        t = time.time()
        myq = queries[self.pid]
        for o in range(self.nproc):
            if o == self.pid:
                continue
            lo, hi = self.bounds[o], self.bounds[o + 1]
            meta_len = 3 * int(hdrs[o, :self.nproc].sum())
            total_o = int(hdrs[o, self.nproc])
            meta_o = pfull[o, :meta_len].view(np.int32)
            locs_o = pfull[o, meta_len:total_o]
            self.exchanged_locs += total_o - meta_len
            moff = 0
            loff = 0
            for r in range(self.nproc):
                nz = int(hdrs[o, r])
                idx = meta_o[moff:moff + nz]
                cnts = meta_o[moff + nz:moff + 2 * nz]
                n1s = meta_o[moff + 2 * nz:moff + 3 * nz]
                tot = int(cnts.sum())
                if r == self.pid:
                    sub_all = myq[(myq >= lo) & (myq < hi)]
                    self._fill(sub_all, idx, cnts, n1s,
                               locs_o[loff:loff + tot])
                moff += 3 * nz
                loff += tot
        tp["parse"] += time.time() - t
        return _RoundResult(False, True)

    # -- free-running routing service -----------------------------------
    # A dedicated thread runs collective rounds continuously, so a peer's
    # query round is answered within ~one round-trip even while THIS
    # process is deep in its align phase.  Without it, a process that
    # needs one more routing round than its peer blocks until the peer's
    # entire align loop finishes (the drain call) — seconds of skew-wait
    # measured on the 2-host bench.  Every process runs the same loop, so
    # the per-round collective sequences stay paired; rounds with no
    # queries anywhere are a single [2]-word heartbeat (see _round_inner).

    def _service_loop(self):
        empty = np.zeros(0, np.uint32)
        # Idle heartbeats are throttled with exponential backoff: an
        # unthrottled loop spins collective dispatch + poll on one full
        # core for the whole align phase (measured: t_phase['status'] 4.5s
        # of a 5.4s align on 2-core workers — half the process's CPU).
        # All processes run the same backoff, so arrival skew at each
        # heartbeat stays ~ms and blocked-poll spin is bounded.  A posted
        # query resets the backoff; worst-case routing latency is one
        # peer backoff interval (~20 ms) per round, against 1-3 rounds
        # per 50k-read batch.
        idle_sleep = 0.0
        while True:
            with self._cv:
                q = self._pending_q
                want_done = self._drain_flag and q is None
            res = self._round(q if q is not None else empty, want_done)
            if q is not None:
                with self._cv:
                    self._pending_q = None
                    self._cv.notify_all()
            if res.finished:
                return
            if res.any_queries or q is not None:
                idle_sleep = 0.0
            else:
                idle_sleep = min(0.05, max(0.001, idle_sleep * 2))
                with self._cv:
                    if self._pending_q is None and not self._drain_flag:
                        self._cv.wait(timeout=idle_sleep)

    def _start_service(self):
        import threading
        if getattr(self, "_svc", None) is None:
            self._cv = threading.Condition()
            self._pending_q = None
            self._drain_flag = False
            self._svc = threading.Thread(target=self._service_loop,
                                         daemon=True)
            self._svc.start()

    def ensure_batch(self, enc, wait: bool = True, extra=None) -> None:
        """One batched routing round: fetch every not-yet-present k-mer this
        batch's seed probes can touch (enc.seedval holds the value at every
        start offset, so the query set is complete before any index read).
        Own-range k-mers are served from the local shard without touching
        the network; only foreign-range queries enter the service thread's
        next collective round.

        ``extra`` (optional u32 array) joins the query set — the caller
        passes the scheduler's stale seed buffers, whose values come from a
        PREVIOUS batch's reads and may not appear in this batch's seedval
        (the stale-seed-array quirk; see align.candidates.SeedScheduler).

        ``wait=False`` posts the query and returns immediately — the reply
        lands while the caller does other work (e.g. the previous batch's
        finish phase); call ``wait_batch()`` before ANY index read.  Only
        one posted query may be outstanding."""
        nk = self.params.total_kmers
        q = enc.seedval.reshape(-1)
        if extra is not None and len(extra):
            q = np.concatenate([q, np.asarray(extra, q.dtype).reshape(-1)])
        q = np.unique(q[q < nk]).astype(np.uint32)
        q = q[~self._have[q]]
        self.rounds += 1
        lo, hi = self.bounds[self.pid], self.bounds[self.pid + 1]
        own = (q >= lo) & (q < hi)
        local = q[own]
        if len(local):
            idx, c, n1s, locs = self._answer_one(local)
            self._fill(local, idx, c, n1s, locs)
        if self.nproc == 1:
            return
        self._start_service()
        t0 = time.time()
        with self._cv:
            while self._pending_q is not None:  # drain a prior async post
                self._cv.wait()
            self._pending_q = q[~own]
            self._cv.notify_all()
            if wait:
                while self._pending_q is not None:
                    self._cv.wait()
        self.t_wait += time.time() - t0

    def wait_batch(self) -> None:
        """Block until an ensure_batch(wait=False) post has been answered
        (no-op when none is outstanding or single-process)."""
        if self.nproc == 1 or getattr(self, "_svc", None) is None:
            return
        t0 = time.time()
        with self._cv:
            while self._pending_q is not None:
                self._cv.wait()
        self.t_wait += time.time() - t0

    def drain(self) -> None:
        """Signal the service thread that this process's read window is
        exhausted; it keeps answering peers' rounds until every process is
        done, then exits.  Call after the local align loop finishes."""
        if self.nproc == 1:
            return
        self._start_service()  # a window with zero batches still serves
        with self._cv:
            self._drain_flag = True
            self._cv.notify_all()
        self._svc.join()
