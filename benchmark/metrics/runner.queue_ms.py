"""runner.queue_ms (runner): the mean time a batch waits in
``TorchThreadedRunner`` for its ``-p`` slot (the program's
``runner.queue`` spans in the window), ms per batch
(``benchkit.program``)."""

from benchkit import program


def read(run):
    return program.metric(run, "runner.queue_ms")
