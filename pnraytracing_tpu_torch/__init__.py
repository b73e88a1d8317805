"""pnraytracing_tpu_torch — the PyTorch/CUDA port of pnraytracing_tpu.

A second package beside the JAX reference, for an NVIDIA H100: the same
scene model, sampler stack, Disney BRDF and wavefront integrator written
with PyTorch tensors, and every Pallas TPU kernel rewritten by hand in
CUDA C++ for Hopper (``csrc/``, built with ``nvcc`` at first use by
``cuda_build.py``).  Each kernel has a plain PyTorch version beside it,
which runs when the tensors lie on the CPU.

Ported so far: the forward frame (``render.renderer.render_frame`` ->
``render.integrator.render_rays``) on the resident and the
brick-streaming traversal routes, with every ray-ordering and sampling
option and the reference-quirk mode ``RenderConfig(compat_pnrt=True)``
(a compat instantiation of every walk kernel, the compat shading and the
CDF-bisection environment sampler); the frame captured once as a CUDA
graph and replayed (``render.program``), ``render_average``, the
progressive state (``AccumState``, ``accum_add``) and the interactive
``RenderSession``; textures (``ops.texture``); ``probe_pixel``
(``render.debug``); the scene catalog but the asset-loading branches;
gradients: the trace/replay split (``trace_paths``,
``render_rays_replay``), ``diff.grad`` (``loss_and_grad``,
``loss_and_grad_replay``, ``adam_optimize``, ``refit_scene``) on
``torch.autograd``, each step captured once as a CUDA graph and replayed
on the card (``diff.program``), and the optimizer checkpoints; ``parallel/`` on
``torch.distributed`` (tile-sharded frames, data-parallel gradients,
primitive-sharded walks); ``utils/`` (image output, profiling, the
kernels' build directory, the resilient render loop of
``utils.resilience``); the command lines of ``scripts/``.
ROADMAP.md lists what is still to port.  Entry points take
``device=None``, which means the card.
"""

__version__ = "0.1.0"

from pnraytracing_tpu_torch.core.camera import CameraState, camera_rays, make_camera
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.core.types import (
    Camera,
    EnvMap,
    Lights,
    Materials,
    Scene,
    TextureAtlas,
    TriangleMesh,
)
from pnraytracing_tpu_torch.diff.grad import (
    adam_optimize,
    apply_params,
    extract_params,
    loss_and_grad,
    loss_and_grad_replay,
    refit_scene,
    render_image_from_params,
)
from pnraytracing_tpu_torch.render.debug import probe_pixel
from pnraytracing_tpu_torch.render.integrator import (
    TraceRecords,
    render_rays,
    render_rays_replay,
    trace_paths,
)
from pnraytracing_tpu_torch.render.renderer import (
    AccumState,
    accum_add,
    render,
    render_average,
    render_frame,
)
from pnraytracing_tpu_torch.render.session import (
    RenderSession,
    load_optimizer_checkpoint,
    save_optimizer_checkpoint,
)
from pnraytracing_tpu_torch.scene.build import SceneBuilder

__all__ = [
    "RenderConfig",
    "Camera",
    "CameraState",
    "EnvMap",
    "Lights",
    "Materials",
    "Scene",
    "TextureAtlas",
    "TriangleMesh",
    "SceneBuilder",
    "RenderSession",
    "AccumState",
    "accum_add",
    "make_camera",
    "camera_rays",
    "render",
    "render_frame",
    "render_average",
    "probe_pixel",
    "render_rays",
    "TraceRecords",
    "trace_paths",
    "render_rays_replay",
    "extract_params",
    "apply_params",
    "refit_scene",
    "render_image_from_params",
    "loss_and_grad",
    "loss_and_grad_replay",
    "adam_optimize",
    "save_optimizer_checkpoint",
    "load_optimizer_checkpoint",
]
