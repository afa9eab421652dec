"""The data-dependent loops of the step: the port's ``lax.while_loop``.

The BL99 solver, the mushy Picard solver and ridging iterate until every
cell has converged (the JAX package's ``lax.while_loop`` at
``cice5_tpu/models/thermo/bl99.py:534``, ``mushy.py:535`` and
``models/dynamics/ridge.py:469``). Each is written here as a pending test
and a body:

- ``pending(carry)``: a 0-d bool tensor, True while a pass is still due
  (some cell has not converged and the pass count is under its cap);
- ``body(carry, go)``: one pass, where ``go`` is ``pending(carry)``. Only
  the cells still iterating change, and only when ``go`` is True; the pass
  count ``carry["niter"]`` (a 0-d int64 tensor) grows by ``go``.

``carry`` is a dict of tensors with the key ``"niter"``. So a body run
for more passes than its loop needs changes nothing: the extra passes
find ``go`` False, and the result and the pass count stay bit for bit
what they were (over-run invariance, which ``tests/test_torch_graph.py``
holds each loop to). A driver may therefore run passes in blocks, or on
the device past the loop's end, with the eager loop's result. The
captured step (``driver/graph.py``) replays one pass at a time after a
host read of the flag, as the eager loop below does.
"""
from __future__ import annotations

import contextlib
import contextvars

# the loop driver of a step being captured or rehearsed (driver/graph.py);
# None runs the eager loop
_DRIVER = contextvars.ContextVar("reference.cice_loop_driver",
                                 default=None)


def while_loop(body, pending, carry: dict) -> dict:
    """Run ``body`` while ``pending`` holds and return the last carry.
    Eagerly, each pass costs one host read of the pending flag; inside
    ``driven_by(driver)`` the driver runs the loop instead."""
    driver = _DRIVER.get()
    if driver is not None:
        return driver(body, pending, carry)
    go = pending(carry)
    while bool(go):
        carry = body(carry, go)
        go = pending(carry)
    return carry


@contextlib.contextmanager
def driven_by(driver):
    """Within the block, every ``while_loop`` calls ``driver(body,
    pending, carry)`` in place of its eager loop."""
    token = _DRIVER.set(driver)
    try:
        yield
    finally:
        _DRIVER.reset(token)
