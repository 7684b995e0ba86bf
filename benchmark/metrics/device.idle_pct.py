"""device.idle_pct (device): 100 x (1 - the union of the card's kernel,
copy and set intervals over the window / the window)."""


def read(run):
    if not run.busy_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
