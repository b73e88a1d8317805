"""Loop construction for the plain versions of the XLA walks.

PyTorch counterpart of ``pnraytracing_tpu/accel/loops.py``.  The JAX
package evaluates a traversal while-loop's condition only every
``chunk`` body iterations (``RenderConfig.trav_chunk``), because on its
TPU a loop condition cost as much as a body.  The plain versions of the
port's walks run the same construction in Python, so ``chunk`` can be
shown not to change their answers; the CUDA kernels walk one ray a
thread and have no loop condition to chunk.  Bodies must be no-ops once
the condition fails (the walks' are: they pop only rays whose stack is
not empty), so overshooting within a chunk changes nothing.
"""

from __future__ import annotations


def chunked_while(cond, body, state, chunk: int):
    """``while cond(state): state = body(state)`` with the condition
    evaluated every ``chunk`` iterations; ``chunk <= 1`` is a plain
    while loop."""
    n = max(chunk, 1)
    while cond(state):
        for _ in range(n):
            state = body(state)
    return state
