"""App layer of the PyTorch/CUDA port (mirrors the JAX build's scripts/):
the ``render``, ``optimize``, ``interactive`` and ``gallery`` command
lines, run as ``python -m pnraytracing_tpu_torch.scripts.<name>``."""
