"""Milliseconds of create_prover() (the witness planes) a request: the
median over the traced requests of the benchmark's span, the device
synchronised at both ends."""

import statistics


def read(run):
    spans = [r["witness"] for r in run["traced"] if "witness" in r]
    return statistics.median(spans) * 1e3 if spans else None
