"""aligner.finish_us_per_read (host aligner): thread time in
``SingleEndAligner.finish_batch`` (fetch, replay, the strata ladder's
later waves, SAM emission) per read in the window."""


def read(run):
    return run.us_per_read("aligner.finish_batch")
