"""basal_tpu_torch — the base-conversion aligner on PyTorch and CUDA.

A port of ``basal_tpu`` to PyTorch with hand-written CUDA kernels for
NVIDIA Hopper.  It owns what touches the device (``ops``, ``align.pipeline``,
``cli``) and imports basal_tpu's framework-free host layers (config, index,
reads, candidates, replay, SAM, the C++ engine, the BAM writer) as they are.
It never imports jax.
"""
