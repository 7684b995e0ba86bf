"""devctx.dispatch_us_per_read (device context): thread time in
``TorchDeviceContext.extend_async`` (wave split, blob build, pinned
upload, launch, copy-back start) per read in the window."""


def read(run):
    return run.us_per_read("devctx.extend_async")
