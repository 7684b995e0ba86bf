"""devctx.blob_us_per_read (device context): self time of the program's
``devctx.blob`` spans (chunking, ``split_waves``, ``np.unique``,
``build_blob``) per read in the window (``benchkit.program``)."""

from benchkit import program


def read(run):
    return program.metric(run, "devctx.blob_us_per_read")
