"""setup_s (end to end): from the first import of the program to the
window's opening: imports, reference load, seed-index build, kernel
libraries (built on a checkout's first run), card context, warm-up."""


def read(run):
    return run.setup_s
