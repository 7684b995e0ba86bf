"""devctx.fetch_us_per_read (device context): thread time in
``TorchDeviceContext.fetch`` (wait, copy-back, int16 -> int32 widening,
watchdog) per read in the window."""


def read(run):
    return run.us_per_read("devctx.fetch")
