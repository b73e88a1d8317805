"""pnraytracing_tpu_torch — the PyTorch/CUDA port of pnraytracing_tpu.

A second package beside the JAX reference, for an NVIDIA H100: the same
scene model, sampler stack, Disney BRDF and wavefront integrator written
with PyTorch tensors, and every Pallas TPU kernel of the ported path
rewritten by hand in CUDA C++ for Hopper (``csrc/``, built with ``nvcc``
at first use by ``cuda_build.py``).  Each kernel has a plain PyTorch
version beside it, which runs when the tensors lie on the CPU.

This slice covers the flagship forward frame: ``scene.scenes.
config3_teapot_night`` -> ``render.renderer.render_frame`` ->
``render.integrator.render_rays``.  ROADMAP.md lists what is still to
port.  Entry points take ``device=None``, which means the card.
"""

__version__ = "0.1.0"
