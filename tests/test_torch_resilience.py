"""The port's ``utils/resilience.py`` on the CPU: the four tests of the JAX
package's ``tests/test_resilience.py`` ported (device loss simulated by
raising ``torch.AcceleratorError`` with the text of a lost card), the
sticky-loss rule of ``run_resilient``, a ``RenderWorker`` child process
killed and restarted, the loop's recovery through such a worker, and the
recovered loop against the JAX package's ``ResilientRenderLoop`` on the
same scene.
"""

import dataclasses
import functools
import os
import signal

import numpy as np
import pytest
import torch

from pnraytracing_tpu.core.config import RenderConfig as JaxRenderConfig
from pnraytracing_tpu.utils.resilience import (
    ResilientRenderLoop as JaxResilientRenderLoop,
)
from pnraytracing_tpu_torch.core.config import RenderConfig
from pnraytracing_tpu_torch.render.renderer import render_frame
from pnraytracing_tpu_torch.utils import resilience
from pnraytracing_tpu_torch.utils.resilience import (
    RenderWorker,
    ResilientRenderLoop,
    WorkerError,
    WorkerLost,
    is_device_loss,
    run_resilient,
)
from tests.test_render import small_scene as jax_small_scene
from tests.test_torch_scene import (  # noqa: F401
    _torch_threads,
    port_camera,
    port_scene,
)

CFG = RenderConfig(width=16, height=16, max_depth=1, sampler="hash")
WORKER_CFG = RenderConfig(width=8, height=8, max_depth=1, sampler="hash")


def loss(text="unspecified launch failure"):
    return torch.AcceleratorError(f"CUDA error: {text}")


@functools.lru_cache(maxsize=1)
def scenes():
    """(JAX scene, JAX camera) of tests/test_render.py's small scene and
    the same scene and camera carried over to the port."""
    js, jcam = jax_small_scene()
    return js, jcam, port_scene(js), port_camera(jcam)


@pytest.mark.parametrize("exc,want", [
    (loss("unspecified launch failure"), True),
    (loss("uncorrectable ECC error encountered"), True),
    (loss("the launch timed out and was terminated"), True),
    (loss("CUDA-capable device(s) is/are busy or unavailable"), True),
    (loss("no CUDA-capable device is detected"), True),
    (RuntimeError("NCCL error in: ProcessGroupNCCL.cpp:1, unhandled system "
                  "error (run with NCCL_DEBUG=INFO for details)"), True),
    (RuntimeError("NCCL error in: ProcessGroupNCCL.cpp:1, remote process "
                  "exited or there was a network error"), True),
    (RuntimeError("CUDA error: unspecified launch failure"), True),
    (WorkerLost("render worker lost: pid 1 exited without a reply "
                "(signal 9 (SIGKILL))"), True),
    (loss("out of memory"), False),
    (loss("device-side assert triggered"), False),
    (loss("an illegal memory access was encountered"), False),
    (loss("invalid argument"), False),
    (loss("invalid configuration argument"), False),
    (ValueError("unspecified launch failure"), False),  # wrong type
    (RuntimeError("unspecified launch failure"), False),  # not CUDA's
    (WorkerError("ValueError in the render worker: bad shapes"), False),
], ids=lambda v: type(v).__name__ if isinstance(v, BaseException) else None)
def test_classification(exc, want):
    assert is_device_loss(exc) is want


def test_run_resilient_retries_and_reuploads(monkeypatch):
    """A loss that leaves the CUDA context usable (a busy card) is
    retried in process with host copies of the declared trees, taken at
    entry, moved back to their devices: a tensor and a tensor
    dataclass."""
    monkeypatch.setattr(resilience, "wait_for_device", lambda **kw: True)
    calls = {"n": 0, "trees": []}

    def step(tree=None):
        calls["n"] += 1
        calls["trees"].append(tree)
        if calls["n"] == 1:
            raise loss("CUDA-capable device(s) is/are busy or unavailable")
        return 42

    camera = scenes()[3]
    tree = {"a": torch.arange(3, dtype=torch.float32), "camera": camera}
    want = tree["a"].clone()
    out = run_resilient(step, reupload={"tree": tree})
    assert out == 42
    assert calls["n"] == 2
    got = calls["trees"][1]
    assert got is not tree
    torch.testing.assert_close(got["a"], want, rtol=0, atol=0)
    torch.testing.assert_close(got["camera"].eye, camera.eye, rtol=0, atol=0)


def no_wait(**kw):
    pytest.fail("wait_for_device was called")


def test_run_resilient_propagates_programming_errors(monkeypatch):
    monkeypatch.setattr(resilience, "wait_for_device", no_wait)
    for exc in (ValueError("bad shapes"), loss("device-side assert "
                                               "triggered")):
        def step():
            raise exc

        with pytest.raises(type(exc)):
            run_resilient(step)


def test_run_resilient_reraises_sticky_loss(monkeypatch):
    """After an unspecified launch failure this process's CUDA context
    is gone: re-raised at once, without polling the card."""
    monkeypatch.setattr(resilience, "wait_for_device", no_wait)
    calls, logs = [], []

    def step():
        calls.append(1)
        raise loss("unspecified launch failure")

    with pytest.raises(torch.AcceleratorError):
        run_resilient(step, log=logs.append)
    assert len(calls) == 1
    assert "sticky" in logs[0] and "ResilientRenderLoop" in logs[0]


def flaky_loop(loop, fail_frame=2):
    """``loop._render_one`` raising a device loss once, on the first
    attempt of sample ``fail_frame``."""
    real = loop._render_one
    state = {"armed": True}

    def flaky(frame, scn):
        if frame == fail_frame and state["armed"]:
            state["armed"] = False
            raise loss("unspecified launch failure")
        return real(frame, scn)

    loop._render_one = flaky


def test_render_loop_survives_mid_run_loss(monkeypatch):
    monkeypatch.setattr(resilience, "wait_for_device", lambda **kw: True)
    _, _, scene, cam = scenes()
    loop = ResilientRenderLoop(scene, cam, CFG, device="cpu")
    flaky_loop(loop)
    img = loop.render(4)
    assert loop.count == 4 and loop.losses_recovered == 1
    assert np.isfinite(img).all()
    # reference: uninterrupted loop, same frames -> identical average
    ref = ResilientRenderLoop(scene, cam, CFG, device="cpu").render(4)
    np.testing.assert_array_equal(img, ref)


def test_recovered_loop_matches_jax(monkeypatch):
    """The port's loop, recovered from a loss at sample 2, against the
    JAX package's uninterrupted loop on the same scene: every pixel
    within the image budget atol 3e-5 (no rim pixel differs here)."""
    monkeypatch.setattr(resilience, "wait_for_device", lambda **kw: True)
    js, jcam, scene, cam = scenes()
    loop = ResilientRenderLoop(scene, cam, CFG, device="cpu")
    flaky_loop(loop)
    got = loop.render(4)
    want = JaxResilientRenderLoop(js, jcam, JaxRenderConfig(
        width=16, height=16, max_depth=1, sampler="hash")).render(4)
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)
    assert want.mean() > 0.05  # the frame is lit


def test_render_worker_killed_and_restarted():
    """A worker child (spawn) on the CPU: its frame equals the
    in-process frame bit for bit; after SIGKILL the next request raises
    a device loss; after a restart the frame is equal again."""
    _, _, scene, cam = scenes()
    want = render_frame(scene, cam, WORKER_CFG, 5, device="cpu").numpy()
    w = RenderWorker(scene, cam, WORKER_CFG, device="cpu")
    try:
        np.testing.assert_array_equal(w.render(5), want)
        assert w.frame_launches is None  # no capture on the CPU
        assert not any(w.launches.values())  # plain versions only
        assert w.timings["first_frame_s"] > 0 and w.start_seconds > 0
        os.kill(w.process.pid, signal.SIGKILL)
        with pytest.raises(WorkerLost, match="SIGKILL") as lost:
            w.render(5)
        assert is_device_loss(lost.value)
        w.restart()
        np.testing.assert_array_equal(w.render(5), want)
    finally:
        w.close()
    assert not w.process.is_alive() and w.process.exitcode == 0


def test_render_worker_error_carries_traceback():
    """An exception of the child that is not a device loss ends it and
    is raised in the parent with the child's traceback."""
    _, _, scene, cam = scenes()
    bad = dataclasses.replace(cam, eye=cam.eye[:2])  # fails in the child
    w = RenderWorker(scene, bad, WORKER_CFG, device="cpu")
    try:
        with pytest.raises(WorkerError, match="the worker's traceback") as e:
            w.render(0)
        assert not is_device_loss(e.value)
        assert not w.process.is_alive()
    finally:
        w.close()


def test_loop_replaces_a_killed_worker(monkeypatch):
    """The loop's recovery through a real worker on the CPU: the worker
    SIGKILLed with sample 2 in flight is replaced, sample 2 rendered
    again, and the image equals an uninterrupted loop's bit for bit."""
    monkeypatch.setattr(resilience, "wait_for_device", lambda **kw: True)
    _, _, scene, cam = scenes()
    logs = []
    loop = ResilientRenderLoop(scene, cam, WORKER_CFG, device="cpu",
                               log=logs.append)
    with loop:
        loop.worker = RenderWorker(scene, cam, WORKER_CFG, device="cpu")
        pids = []

        def via_worker(frame, scn):
            if frame == 2 and not pids:
                pids.append(loop.worker.process.pid)
                loop.worker.request(frame)
                os.kill(pids[0], signal.SIGKILL)
                return loop.worker.reply()
            return loop.worker.render(frame)

        loop._render_one = via_worker
        img = loop.render(4)
        assert loop.worker.process.pid != pids[0]
    assert loop.worker is None  # closed with the loop
    assert loop.count == 4 and loop.losses_recovered == 1
    assert "WorkerLost" in logs[0]
    ref = ResilientRenderLoop(scene, cam, WORKER_CFG, device="cpu").render(4)
    np.testing.assert_array_equal(img, ref)


def test_probe_device_needs_a_card():
    """The probe runs on the card or fails: False here, where there is
    none (no fallback to the CPU)."""
    assert resilience.probe_device(timeout_s=60) is torch.cuda.is_available()
