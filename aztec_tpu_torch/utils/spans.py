"""Named host spans on the profiler's clock.

``span(name)`` marks a stretch of the prover's host work.  While spans are
off (the default) it returns one shared no-op context manager: a flag read,
nothing allocated, nothing recorded.  While they are on it enters
``torch.profiler.record_function("aztec_tpu_torch." + name)``, so the range
lands in whatever profiler session is running, on that session's clock and
beside the device operations launched inside it.  A span never
synchronises the device; it times the host only.  Spans nest on the host
thread: ``prove`` is the root of a proof, and the request a span belongs to
is the ``prove`` range that contains it.

An operator turns spans on for a block and reads them in the Chrome trace::

    from torch.profiler import ProfilerActivity, profile
    from aztec_tpu_torch.utils import spans

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with spans.enabled():
            proof = prover.construct_proof()
    prof.export_chrome_trace("proof.json")

The ranges are the trace's ``user_annotation`` events whose names start
with ``aztec_tpu_torch.``; an idle stretch of the card is put down to the
innermost range open on the host at the time.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "aztec_tpu_torch."
_OFF = contextlib.nullcontext()
_on = False


def span(name: str):
    """A context manager over one named stretch of host work."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def enabled():
    """Spans on inside the block; the previous state after it."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was
