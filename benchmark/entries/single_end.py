"""The single-end entry: ``basal_tpu_torch.align.pipeline.run_single_end``
with the SAM going to the benchmark's sink.  Its classes by role, for the
benchmark's wrappers: the FASTQ reader (``reads/io.py``), the host aligner
(``align/aligner.py``) and the device context (``align/pipeline.py``)."""


def classes() -> dict:
    from basal_tpu_torch.align import aligner, pipeline
    from basal_tpu_torch.reads import io
    return dict(reader=io.RawFastqReader, aligner=aligner.SingleEndAligner,
                devctx=pipeline.TorchDeviceContext)


def run(params, fasta: str, reads: str, sink, timings: dict,
        device: str) -> None:
    from basal_tpu_torch.align import pipeline
    pipeline.run_single_end(params, fasta, reads, out_fh=sink,
                            timings=timings, device=device)
