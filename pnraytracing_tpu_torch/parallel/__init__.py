"""parallel layer of the PyTorch/CUDA port (mirrors
pnraytracing_tpu/parallel)."""
