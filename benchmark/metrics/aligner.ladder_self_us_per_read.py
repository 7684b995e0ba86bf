"""aligner.ladder_self_us_per_read (host aligner): self time of the
program's ``aligner.ladder`` spans (the strata ladder's masks and growth,
its replays and launches left out) per read in the window
(``benchkit.program``)."""

from benchkit import program


def read(run):
    return program.metric(run, "aligner.ladder_self_us_per_read")
