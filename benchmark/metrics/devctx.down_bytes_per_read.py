"""devctx.down_bytes_per_read (device context): result bytes the device
contexts copied back (``down_bytes``) per read in the window."""


def read(run):
    return run.delta("down_bytes") / run.win.reads
