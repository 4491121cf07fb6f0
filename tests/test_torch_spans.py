"""The port's spans (aztec_tpu_torch/utils/spans.py) under a CPU profiler
session: off, a span is one shared no-op and the trace holds none of the
port's ranges; on, the ranges land in the session, nested as opened.
tests/test_torch_plonk.py reads the spans of a whole proof."""

import torch
from torch.profiler import ProfilerActivity, profile

from aztec_tpu_torch.utils import spans


def _block():
    with spans.span("outer"):
        with spans.span("inner"):
            torch.ones(4).add_(1)


def _ranges(prof):
    return [e for e in prof.events() if e.name.startswith(spans.PREFIX)]


def test_off_span_is_the_shared_no_op_and_records_nothing():
    assert spans.span("a") is spans.span("b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _block()
    assert _ranges(prof) == []


def test_on_spans_nest_in_the_session():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.enabled():
            _block()
        _block()
    outer, inner = _ranges(prof)      # one of each: off again after the block
    assert (outer.name, inner.name) == ("aztec_tpu_torch.outer", "aztec_tpu_torch.inner")
    assert inner.cpu_parent is outer
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert spans.span("a") is spans.span("b")
