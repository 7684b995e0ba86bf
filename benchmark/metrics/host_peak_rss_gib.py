"""host_peak_rss_gib (end to end): peak resident memory of the run's
process (``ru_maxrss``); the inputs are made in a child process."""


def read(run):
    return run.rss_gib
