"""Failure detection and recovery for the device path.

PyTorch counterpart of ``pnraytracing_tpu/utils/resilience.py``: the
five names ``is_device_loss``, ``probe_device``, ``wait_for_device``,
``run_resilient`` and ``ResilientRenderLoop``, with a design of its own
for CUDA.

The JAX module retries a failed step in the same process after
re-uploading its state: a TPU worker that crashed comes back, and the
client process can use it again.  On CUDA the errors that mean a lost or
faulted device are *sticky*: after an "unspecified launch failure", an
uncorrectable ECC error or a launch timeout (and likewise after an
illegal memory access or a device-side assert) every later CUDA call of
that process fails, because its CUDA context is gone.  A retry in that
process can never succeed, so recovery replaces the process that owns
the context:

* :func:`run_resilient` keeps the JAX contract in process (wait,
  re-upload, retry) for the losses that leave the context usable, and
  re-raises a sticky loss at once;
* :class:`ResilientRenderLoop` renders each sample in a
  :class:`RenderWorker`, a child process that owns the CUDA context and
  can be killed and replaced; the accumulation lives on the host in the
  parent, so a lost card costs the sample in flight, never the
  accumulation.

Which errors count as a lost device (:func:`is_device_loss`): the text
``cudaGetErrorString`` gives for the error code (PyTorch raises it as
``torch.AcceleratorError`` or a ``RuntimeError`` "CUDA error: <text>"),
or that ``ncclGetErrorString`` gives (a ``RuntimeError`` naming NCCL):

=======================================================  =================
text                                                     error code
=======================================================  =================
unspecified launch failure                               cudaErrorLaunchFailure (719)
uncorrectable ECC error encountered                      cudaErrorECCUncorrectable (214)
the launch timed out and was terminated                  cudaErrorLaunchTimeout (702)
CUDA-capable device(s) is/are busy or unavailable        cudaErrorDevicesUnavailable (46)
no CUDA-capable device is detected                       cudaErrorNoDevice (100)
unhandled system error                                   ncclSystemError (2)
remote process exited or there was a network error       ncclRemoteError (6)
=======================================================  =================

and the port's own :class:`WorkerLost` ("render worker lost: ...").
Not a loss: "out of memory" (cudaErrorMemoryAllocation, 2),
"device-side assert triggered" (cudaErrorAssert, 710), "an illegal
memory access was encountered" (cudaErrorIllegalAddress, 700), "invalid
argument" (cudaErrorInvalidValue, 1), "invalid configuration argument"
(cudaErrorInvalidConfiguration, 9), and every exception that is not a
CUDA or NCCL error.  The port's own kernels are the likeliest cause of
an illegal access or an assert; retrying one would hide a kernel fault.
"""

from __future__ import annotations

import dataclasses
import io
import signal
import time
import traceback
from multiprocessing.connection import wait as _wait_ready
from typing import Callable

import numpy as np
import torch

from pnraytracing_tpu_torch.core.camera import resolve_device
from pnraytracing_tpu_torch.core.types import _Movable, tensors

_LOSS_SIGNATURES = (
    "unspecified launch failure",
    "uncorrectable ECC error",
    "the launch timed out and was terminated",
    "CUDA-capable device(s) is/are busy or unavailable",
    "no CUDA-capable device is detected",
    "unhandled system error",
    "remote process exited",
    "render worker lost",  # WorkerLost's own text
)
# programming errors, never retried
_FAULT_SIGNATURES = (
    "out of memory",
    "device-side assert triggered",
    "an illegal memory access was encountered",
    "invalid argument",
    "invalid configuration",
)
# losses after which this process's CUDA context is gone for good
_STICKY_SIGNATURES = _LOSS_SIGNATURES[:3]
# how a RuntimeError names a CUDA runtime / driver or an NCCL error
_CUDA_OR_NCCL = ("CUDA error", "CUDA driver error", "NCCL")

MAX_RETRIES = 3


class WorkerLost(RuntimeError):
    """The render worker exited (by a signal, or without a reply), or
    reported a lost device: a device loss, recovered by a new worker."""


class WorkerError(RuntimeError):
    """An exception of the render worker that is not a device loss,
    raised in the parent with the worker's traceback."""


def is_device_loss(exc: BaseException) -> bool:
    """True for failures where recovery and a retry are meaningful: a
    ``torch.AcceleratorError``, a CUDA or NCCL ``RuntimeError`` or a
    :class:`WorkerLost` whose message carries a lost device's signature
    (the module docstring lists them)."""
    msg = str(exc)
    accelerator = getattr(torch, "AcceleratorError", ())
    if not (isinstance(exc, (WorkerLost, accelerator))
            or (isinstance(exc, RuntimeError)
                and any(s in msg for s in _CUDA_OR_NCCL))):
        return False
    return (any(s in msg for s in _LOSS_SIGNATURES)
            and not any(s in msg for s in _FAULT_SIGNATURES))


def _sticky(exc: BaseException) -> bool:
    return not isinstance(exc, WorkerLost) and any(
        s in str(exc) for s in _STICKY_SIGNATURES)


def probe_device(timeout_s: float = 90.0) -> bool:
    """One tiny computation on the card in a SUBPROCESS with a hard
    timeout: True when it prints the right sum.  A fresh process, because
    a sticky error poisons the process that saw it and a wedged card can
    hang a call.  Without a card the subprocess fails and the result is
    False: the probe never falls back to the CPU."""
    import subprocess
    import sys as _sys

    code = (
        "import torch;"
        "x = torch.ones((8, 8), device='cuda');"
        "print(float((x @ x).sum()))"
    )
    try:
        out = subprocess.run(
            [_sys.executable, "-c", code], capture_output=True,
            timeout=timeout_s,
        )
        return out.returncode == 0 and b"512.0" in out.stdout
    except (subprocess.TimeoutExpired, OSError):
        return False


def wait_for_device(
    timeout_s: float = 1800.0,
    poll_s: float = 30.0,
    log: Callable[[str], None] | None = None,
) -> bool:
    """Poll until the card accepts work again.  Returns False on
    timeout."""
    deadline = time.monotonic() + timeout_s
    attempt = 0
    while time.monotonic() < deadline:
        attempt += 1
        if probe_device():
            if log:
                log(f"device recovered after {attempt} probe(s)")
            return True
        if log:
            log(f"device still down (probe {attempt}); sleeping {poll_s:.0f}s")
        time.sleep(poll_s)
    return False


@dataclasses.dataclass
class _Held:
    """A host copy of a tensor or a tensor dataclass, and its device."""

    value: object
    device: torch.device


def _host_copy(tree):
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return _Held(tree.cpu(), tree.device)
    if isinstance(tree, _Movable):
        first = next(tensors(tree), None)
        return _Held(tree.to("cpu"), first.device if first is not None
                     else None)
    return tree


def _reupload(tree):
    if isinstance(tree, dict):
        return {k: _reupload(v) for k, v in tree.items()}
    if isinstance(tree, _Held):
        return tree.value if tree.device is None else tree.value.to(
            tree.device)
    return tree


def run_resilient(
    step: Callable[..., object],
    *args,
    reupload: dict | None = None,
    max_retries: int = MAX_RETRIES,
    log: Callable[[str], None] | None = None,
    **kwargs,
):
    """Run ``step(*args, **kwargs)``; on a device loss, wait for the card,
    move host copies of the trees in ``reupload`` (name -> a tensor, a
    tensor dataclass such as a ``Scene``, or a dict of them, passed to
    ``step`` as keyword arguments) back to their devices, and retry.

    The host copies are taken at entry, since nothing can be read off a
    lost card.  A sticky loss (module docstring) is re-raised at once:
    this process's CUDA context is gone, and only a new process
    (:class:`ResilientRenderLoop`'s worker, or a restart) can use the
    card again.  Exceptions that are not device losses propagate at
    once: a shape error must not be retried into a 30-minute poll loop.
    """
    kwargs = dict(kwargs)
    held = {}
    if reupload:
        for name, tree in reupload.items():
            kwargs[name] = tree
            held[name] = _host_copy(tree)
    for attempt in range(max_retries + 1):
        try:
            return step(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — filtered below
            if not is_device_loss(e) or attempt == max_retries:
                raise
            if _sticky(e):
                if log:
                    log(f"device loss ({type(e).__name__}) is sticky: this "
                        f"process's CUDA context is gone and no retry in it "
                        f"can succeed; recover through ResilientRenderLoop's "
                        f"worker or a restart")
                raise
            if log:
                log(f"device loss ({type(e).__name__}); recovering "
                    f"(attempt {attempt + 1}/{max_retries})")
            if not wait_for_device(log=log):
                raise
            for name, tree in held.items():
                kwargs[name] = _reupload(tree)
    raise AssertionError("unreachable")


def _worker_main(conn, device: str) -> None:
    """Entry point of a :class:`RenderWorker`'s child: read the scene,
    camera and cfg once, then answer each frame index with its sample
    image (numpy) until told to stop.  An exception is answered with its
    type name, message, traceback and whether it is a device loss, and
    ends the child."""
    first = True
    try:
        from pnraytracing_tpu_torch.render import program
        from pnraytracing_tpu_torch.render.renderer import render_frame

        t0 = time.perf_counter()
        dev = torch.device(device)
        payload = torch.load(io.BytesIO(conn.recv_bytes()),
                             weights_only=False)
        scene = payload["scene"].to(dev)
        camera = payload["camera"].to(dev)
        cfg = payload["cfg"]
        upload_s = time.perf_counter() - t0
        while True:
            frame = conn.recv()
            if frame is None:
                return
            t0 = time.perf_counter()
            img = render_frame(scene, camera, cfg, frame,
                               device=dev).cpu().numpy()
            info = None
            if first:
                info = {"launches": program.launch_counts(),
                        "frame_launches": (
                            program.frame_program(scene, cfg, dev).launches
                            if dev.type == "cuda" else None),
                        "upload_s": upload_s,
                        "first_frame_s": time.perf_counter() - t0}
                first = False
            conn.send(("image", img, info))
    except (EOFError, KeyboardInterrupt):
        return
    except Exception as e:  # noqa: BLE001 — reported to the parent
        try:
            conn.send(("error", type(e).__name__, str(e),
                       traceback.format_exc(), is_device_loss(e)))
        except OSError:
            pass


class RenderWorker:
    """A child process (``torch.multiprocessing``'s ``spawn`` context)
    that owns the CUDA context and renders samples of one scene.

    The scene (moved to the host), the camera and the cfg go to the
    child once, serialized by ``torch.save`` (no shared memory), and
    :meth:`restart` sends the same bytes to a fresh child.  Each sample
    is a frame index out and an image [H, W, 3] float32 numpy back.  A
    child that dies (a signal, an exit without a reply) or reports a
    device loss raises :class:`WorkerLost`; any other exception of the
    child raises :class:`WorkerError` with its traceback.  After the
    first reply, ``launches`` holds the child's kernel launch counts
    (its warm-up and captured frames on a CUDA device, zero on the CPU),
    ``frame_launches`` the captured frame's (None on the CPU),
    ``start_seconds`` the time from the start to that reply and
    ``timings`` the child's own seconds (``upload_s``: read the scene
    and move it to the device, the CUDA context's creation included;
    ``first_frame_s``: the first sample, warm-up frame and capture
    included)."""

    def __init__(self, scene, camera, cfg, device=None):
        self.device = resolve_device(device)
        buf = io.BytesIO()
        torch.save({"scene": scene.to("cpu"), "camera": camera.to("cpu"),
                    "cfg": cfg}, buf)
        self._payload = buf.getvalue()
        self.process = None
        self._conn = None
        self.start()

    def start(self) -> None:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self.process = ctx.Process(target=_worker_main,
                                   args=(child, str(self.device)),
                                   daemon=True)
        self._t_start = time.perf_counter()
        self.process.start()
        child.close()
        self.launches = self.frame_launches = None
        self.start_seconds = self.timings = None
        try:
            self._conn.send_bytes(self._payload)
        except OSError:
            pass  # the child is gone: reply() says why

    def request(self, frame: int) -> None:
        """Send one frame index; :meth:`reply` waits for its image."""
        try:
            self._conn.send(int(frame))
        except OSError:
            pass  # the child is gone: reply() reads its last words

    def reply(self) -> np.ndarray:
        """The image of the last request.  Waits for a reply or the
        child's exit, without a timeout: a hung kernel, with the child
        alive and silent, hangs here."""
        _wait_ready([self._conn, self.process.sentinel])
        try:
            msg = self._conn.recv() if self._conn.poll() else None
        except (EOFError, OSError):
            msg = None
        if msg is None:
            self.process.join(timeout=10)
            code = self.process.exitcode
            how = (f"signal {-code} ({signal.Signals(-code).name})"
                   if code is not None and code < 0 else f"exit code {code}")
            raise WorkerLost(f"render worker lost: pid {self.process.pid} "
                             f"exited without a reply ({how})")
        if msg[0] == "error":
            _, name, text, tb, loss = msg
            self.kill()
            if loss:
                raise WorkerLost(f"render worker lost: {name}: {text}")
            raise WorkerError(f"{name} in the render worker: {text}\n\n"
                              f"the worker's traceback:\n{tb}")
        _, img, info = msg
        if info is not None:
            self.start_seconds = time.perf_counter() - self._t_start
            self.launches = info.pop("launches")
            self.frame_launches = info.pop("frame_launches")
            self.timings = info
        return img

    def render(self, frame: int) -> np.ndarray:
        self.request(frame)
        return self.reply()

    def kill(self) -> None:
        """SIGKILL the child if it is alive and reap it."""
        if self.process.is_alive():
            self.process.kill()
        self.process.join()
        self._conn.close()

    def restart(self) -> None:
        """Kill this child and start a fresh one with the same scene."""
        self.kill()
        self.start()

    def close(self) -> None:
        """Stop the child (killed after 10 s if it does not exit)."""
        if self.process.is_alive():
            try:
                self._conn.send(None)
            except OSError:
                pass
            self.process.join(timeout=10)
        self.kill()


class ResilientRenderLoop:
    """Progressive rendering that survives a lost card.

    The accumulation (``accum``, the host float32 [H, W, 3] sum, and
    ``count``) lives in this process; each sample is rendered by
    :meth:`_render_one`.  On the CPU (``device="cpu"``) that calls
    ``render_frame`` in process.  On the card it asks a
    :class:`RenderWorker`, so this process never needs a CUDA context of
    its own: the worker gets the scene as host tensors once (made here
    once, ``scene.to("cpu")``: the "re-upload") and a frame index a
    sample.  On a device loss (the worker killed, or a lost card
    reported) the loop kills the worker, waits for the card
    (:func:`wait_for_device`), starts a fresh worker and retries the
    same frame index, at most :data:`MAX_RETRIES` times a sample
    (``losses_recovered`` counts the recoveries).  Any other exception
    shuts the worker down and is raised here with the worker's
    traceback.  A worker that cannot start on the card raises; nothing
    renders on the CPU in its place.  Use it as a context manager, or
    call :meth:`close`, so that no worker outlives its loop.

    Out of scope, as in the JAX loop: a hung kernel (a worker alive and
    silent) is waited for without a timeout.
    """

    def __init__(self, scene, camera, cfg,
                 log: Callable[[str], None] | None = None, device=None):
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.log = log
        self.device = resolve_device(device)
        self.accum = np.zeros((cfg.height, cfg.width, 3), np.float32)
        self.count = 0
        self.losses_recovered = 0
        self.worker: RenderWorker | None = None
        self._host_scene = scene.to("cpu")

    def _render_one(self, frame: int, scene) -> np.ndarray:
        if self.device.type != "cuda":
            from pnraytracing_tpu_torch.render.renderer import render_frame

            return render_frame(scene, self.camera, self.cfg, frame,
                                device=self.device).numpy()
        if self.worker is None:
            self.worker = RenderWorker(scene, self.camera, self.cfg,
                                       self.device)
        return self.worker.render(frame)

    def _sample(self, frame: int) -> np.ndarray:
        for attempt in range(MAX_RETRIES + 1):
            try:
                return self._render_one(frame, self._host_scene)
            except Exception as e:  # noqa: BLE001 — filtered below
                if not is_device_loss(e) or attempt == MAX_RETRIES:
                    self.close()
                    raise
                if self.log:
                    self.log(f"device loss ({type(e).__name__}: {e}); "
                             f"recovering (attempt {attempt + 1}/"
                             f"{MAX_RETRIES})")
                if self.worker is not None:
                    self.worker.kill()
                if not wait_for_device(log=self.log):
                    self.close()
                    raise
                if self.worker is not None:
                    self.worker.start()
                self.losses_recovered += 1
        raise AssertionError("unreachable")

    def render(self, spp: int) -> np.ndarray:
        for _ in range(spp):
            self.accum += self._sample(self.count)
            self.count += 1
        return self.resolve()

    def resolve(self) -> np.ndarray:
        return self.accum / max(self.count, 1)

    def close(self) -> None:
        """Stop the worker, if one runs."""
        if self.worker is not None:
            self.worker.close()
            self.worker = None

    def __enter__(self) -> "ResilientRenderLoop":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
