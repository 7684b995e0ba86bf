"""aligner.cand_per_read (host aligner): candidates evaluated on the
device (``stage['cand_device']``) per read in the window."""


def read(run):
    return run.delta("cand_device") / run.win.reads
