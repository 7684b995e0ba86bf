"""aligner.submit_us_per_read (host aligner): thread time in
``SingleEndAligner.submit_batch`` (encode, seeds and groups, fill_groups,
blob, dispatch) per read in the window."""


def read(run):
    return run.us_per_read("aligner.submit_batch")
