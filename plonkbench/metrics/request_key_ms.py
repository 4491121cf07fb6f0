"""Milliseconds of a request's own proving key (``compute_proving_key()``
on the request's composer: SRS, selectors, sigmas), the median over the
traced requests of the benchmark's span, the device synchronised at both
ends.  Only cells whose requests each carry an input have the span."""

import statistics


def read(run):
    spans = [r["key"] for r in run["traced"] if r.get("key") is not None]
    return statistics.median(spans) * 1e3 if spans else None
