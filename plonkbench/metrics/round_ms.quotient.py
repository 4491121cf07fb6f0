"""Milliseconds of the prover's fourth round and its queue drain (the
quotient and its commitments) a request: the median over the traced requests
of the span from the round's start to the next round's, the device
synchronised at both ends."""

import statistics


def read(run):
    spans = [r["rounds"]["fourth"] for r in run["traced"]
             if "fourth" in r.get("rounds", {})]
    return statistics.median(spans) * 1e3 if spans else None
