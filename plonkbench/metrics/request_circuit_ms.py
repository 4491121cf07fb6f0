"""Milliseconds of a request's own circuit (``build_request``: the stdlib's
gates from the request's input on a new composer), the median over the
traced requests of the benchmark's span, the device synchronised at both
ends.  Only cells whose requests each carry an input have the span."""

import statistics


def read(run):
    spans = [r["circuit"] for r in run["traced"] if r.get("circuit") is not None]
    return statistics.median(spans) * 1e3 if spans else None
