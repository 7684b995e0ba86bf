"""reads_per_s (end to end): SAM records written after the window opened,
up to the last write at or before its end, over that time.  Each mate
of a pair would count as one read."""


def read(run):
    return run.win.reads_per_s
