"""sam.emit_us_per_read (SAM output): thread time in
``SingleEndAligner._emit_native`` (the native formatter, or the Python
emitter on ladder batches) per read in the window."""


def read(run):
    return run.us_per_read("sam.emit")
