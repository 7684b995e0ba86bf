"""index.build_s (index): the seed-index build, ``timings['t_index']``."""


def read(run):
    return run.timings.get("t_index")
