"""reference.load_s (index): the reference load and packing,
``timings['t_ref']``."""


def read(run):
    return run.timings.get("t_ref")
