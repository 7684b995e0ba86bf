"""sam.python_reads_pct (SAM output): the share of the window's reads that
the Python emitter (``sam.python`` spans) wrote rather than the native
formatter (``sam.native``), from the program's own spans
(``benchkit.program``)."""

from benchkit import program


def read(run):
    return program.metric(run, "sam.python_reads_pct")
