"""Phase marks for timing a training step or a serving dispatch on the
card.

The simulation engine and :func:`repro_torch.optim.decentralized.mix`
call :func:`mark` at the phase boundaries of a step:

    "step"    a step begins (gradients come next)
    "update"  the gradients are done; the method's update begins
    "mix"     a gossip mix begins
    "end"     the step is done

A failure-model step (``simulate_decentralized(failure=)``) marks the
same, and its mixer closure marks each tensor's ``"stale"`` read (the
history ring), ``"corrupt"`` read (the Byzantine values) and ``"mix"``;
``"state"`` opens the node freeze, the clocks and the history write
after the method's update.

The distributed train step (``repro_torch.dist.steps``) marks
``"step"``, ``"update"`` and ``"end"`` the same way; in place of
``"mix"``, its gossip mixer marks each tensor's exchange and each
bucket's combine (compressed: each bucket's ``"quantize"``, then its
reference leaves' ``"exchange"`` (the point-to-point messages), then its
``"combine"``).

The continuous serving engine marks each dispatch with its name
(``"prefill_<bucket>"``, ``"prefill_<bucket>x<n>"``, ``"decode"``) and
then ``"end"``.  The fixed-batch engine marks each speculative round's
phases: ``"round"`` (the window snapshot), ``"draft"``, ``"verify"``,
``"accept"`` (the accept rule and the restore), then ``"end"``.

Outside :func:`cuda_marks` a mark is one global lookup and does
nothing.  Inside it, each mark records a CUDA event on the current
stream, so the spans between marks are device time with no extra
synchronisation; read them after the block, once the work has finished.
"""
from __future__ import annotations

import contextlib

import torch

_marks: list | None = None


def mark(name: str) -> None:
    if _marks is not None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        _marks.append((name, event))


@contextlib.contextmanager
def cuda_marks():
    """Record a CUDA event at every :func:`mark` inside the block; yields
    the list of ``(name, event)`` pairs, in order."""
    global _marks
    if _marks is not None:
        raise RuntimeError("cuda_marks blocks do not nest")
    _marks = []
    try:
        yield _marks
    finally:
        _marks = None
