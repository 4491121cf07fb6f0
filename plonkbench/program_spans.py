"""The port's own spans in a traced run, and what the card did under them.

With ``aztec_tpu_torch.utils.spans`` on, the prover opens
``torch.profiler.record_function`` ranges named ``aztec_tpu_torch.<span>``
(``prove``, ``msm``, ``msm.chunk``, ``msm.finish``, ``witness.host``) on the
profiler's clock.  ``ProgramSpans`` reads them from the traced run's Chrome
trace, with the host's CUDA runtime calls, and works out beside the window
that ``plonkbench.trace.Trace`` reads:

- ``msm_idle_ms``, ``msm_idle_ms.chunks``, ``msm_idle_ms.finish``: device-idle
  ms a proof while the host was inside ``msm``, ``msm.chunk``, ``msm.finish``
  (each idle gap cut at the ranges' edges; a child lies inside its parent,
  so the parent counts its time once);
- ``host_syncs_per_proof`` and ``host_wait_ms``: the runtime calls a proof,
  made inside ``prove``, that block the host on the device, and the host ms
  inside them (``cudaDeviceSynchronize`` is left out: on the proof path only
  the benchmark's own span edges call it);
- ``witness_host_ms``: the median ``witness.host`` range, in ms.

The program's ranges and the benchmark's need not nest (the benchmark's
``round.sixth`` closes after the program's ``prove``): each is read by its
own containment.

The benchmark's traced run does not turn the program's spans on, and its
``Trace`` keeps neither them nor the runtime calls: that takes an edit of
``run.py`` (enter ``spans.enabled()`` with the window) and of ``trace.py``
(keep what ``ProgramSpans.from_events`` keeps).  Until then::

    python -m plonkbench.program_spans --workload <cell> --seed <n> --seconds <s>

runs the cell's traced run (``run.run_cell``) with the program's spans on
for the traced window, and prints one JSON line: these readings, their
checks against the run's own ``breakdown``, and the run's per-layer
metrics.  On a port without spans the readings are null.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys

PREFIX = "aztec_tpu_torch."
BENCH_PREFIX = "plonkbench."
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
# runtime calls that return only once the device has caught up
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy",
                        "cuStreamSynchronize", "cuEventSynchronize"})
READINGS = ("msm_idle_ms", "msm_idle_ms.chunks", "msm_idle_ms.finish",
            "host_syncs_per_proof", "host_wait_ms", "witness_host_ms")


def _cut(gaps: list, ranges: list) -> list:
    """The parts of ``gaps`` that lie inside the union of ``ranges``."""
    merged = []
    for s, e in sorted(ranges):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    out = []
    for gs, ge in gaps:
        for s, e in merged:
            lo, hi = max(gs, s), min(ge, e)
            if hi > lo:
                out.append((lo, hi))
    return out


class ProgramSpans:
    def __init__(self, ranges: list, bench: list, runtime: list):
        self.ranges = ranges     # (name, start_us, end_us, tid), the prefix removed
        self.bench = bench       # the benchmark's ranges, the same way
        self.runtime = runtime   # (name, start_us, dur_us, tid)

    @classmethod
    def from_events(cls, events: list) -> "ProgramSpans":
        ranges, bench, runtime = [], [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            start, dur = float(e["ts"]), float(e.get("dur", 0))
            if cat == "user_annotation":
                for prefix, out in ((PREFIX, ranges), (BENCH_PREFIX, bench)):
                    if name.startswith(prefix):
                        out.append((name[len(prefix):], start, start + dur, e.get("tid")))
            elif cat in RUNTIME_CATEGORIES:
                runtime.append((name, start, dur, e.get("tid")))
        return cls(sorted(ranges, key=lambda r: r[1]), sorted(bench, key=lambda r: r[1]),
                   sorted(runtime, key=lambda r: r[1]))

    @classmethod
    def from_chrome(cls, path: str) -> "ProgramSpans":
        with open(path) as f:
            events = json.load(f)
        return cls.from_events(events.get("traceEvents", events)
                               if isinstance(events, dict) else events)

    def named(self, name: str, trace=None) -> list:
        """The program's ``name`` ranges (inside ``trace``'s window, if given)."""
        w0, w1 = trace.window() if trace is not None else (float("-inf"), float("inf"))
        return [r for r in self.ranges if r[0] == name and w0 <= r[1] and r[2] <= w1]

    def idle_under(self, trace, name: str) -> list:
        """The window's idle gaps while the host was inside a ``name`` range
        (its children included), each gap cut at the ranges' edges."""
        return _cut(trace.idle_gaps(), [(s, e) for _, s, e, _ in self.named(name, trace)])

    def syncs(self, trace) -> list:
        """The blocking runtime calls made inside ``prove`` on its thread."""
        proves = self.named("prove", trace)
        return [c for c in self.runtime if c[0] in SYNC_CALLS and any(
            s <= c[1] < e and tid == c[3] for _, s, e, tid in proves)]

    def readings(self, trace) -> dict:
        """The six readings a proof; all None where the window holds no
        ``prove`` range (a port without spans, or spans off)."""
        proofs = len(self.named("prove", trace))
        if not proofs:
            return dict.fromkeys(READINGS)

        def idle_ms(name):
            return sum(e - s for s, e in self.idle_under(trace, name)) / 1e3 / proofs
        syncs = self.syncs(trace)
        witness = [e - s for _, s, e, _ in self.named("witness.host", trace)]
        return {"msm_idle_ms": idle_ms("msm"),
                "msm_idle_ms.chunks": idle_ms("msm.chunk"),
                "msm_idle_ms.finish": idle_ms("msm.finish"),
                "host_syncs_per_proof": len(syncs) / proofs,
                "host_wait_ms": sum(d for _, _, d, _ in syncs) / 1e3 / proofs,
                "witness_host_ms": statistics.median(witness) / 1e3 if witness else None}

    def stages(self, trace) -> dict:
        """Idle ms, kernels launched, blocking calls and the host ms inside
        them, a proof, by stage: ``chunks``, ``finish``, the rest of ``msm``
        (the tail, the batch's set-up, the conversion to host ints) and the
        rest of ``prove``."""
        proofs = len(self.named("prove", trace))
        w0, w1 = trace.window()
        launches = [o[4] for o in trace.kernels() if o[4] is not None and w0 <= o[2] < w1]
        syncs = self.syncs(trace)
        out = {}
        for key, name in (("prove", "prove"), ("msm", "msm"), ("chunks", "msm.chunk"),
                          ("finish", "msm.finish")):
            ranges = [(s, e) for _, s, e, _ in self.named(name, trace)]

            def within(t):
                return any(s <= t <= e for s, e in ranges)
            out[key] = {"idle_ms": sum(e - s for s, e in self.idle_under(trace, name)) / 1e3,
                        "kernels": sum(map(within, launches)),
                        "syncs": sum(within(c[1]) for c in syncs),
                        "wait_ms": sum(c[2] for c in syncs if within(c[1])) / 1e3}
            out[key] = {k: v / proofs for k, v in out[key].items()}
        for rest, whole, parts in (("msm.rest", "msm", ("chunks", "finish")),
                                   ("prove.rest", "prove", ("msm",))):
            out[rest] = {k: v - sum(out[p][k] for p in parts) for k, v in out[whole].items()}
        return out

    def checks(self, trace, breakdown: dict) -> dict:
        """What must hold of the readings if the two sets of ranges share one
        clock: each program ``msm`` inside a benchmark ``msm`` on its thread;
        the idle time under ``msm``, cut at its edges and put whole under the
        range open at each gap's start as the breakdown puts it, against the
        breakdown's; the stages within the whole; the wait within ``prove``."""
        proofs = len(self.named("prove", trace))
        if not proofs:
            return {}
        read = self.readings(trace)
        outer = [r for r in self.bench if r[0] == "msm"]
        stray = sum(not any(s <= r[1] and r[2] <= e and tid == r[3] for _, s, e, tid in outer)
                    for r in self.named("msm", trace))
        prove_ms = sum(e - s for _, s, e, _ in self.named("prove", trace)) / 1e3 / proofs
        msms = self.named("msm", trace)
        by_start = sum(e - s for s, e in trace.idle_gaps()
                       if any(a <= s < b for _, a, b, _ in msms)) / 1e6
        return {"msm_outside_benchmark_msm": stray,
                "msm_idle_s_traced": read["msm_idle_ms"] * proofs / 1e3,
                "msm_idle_s_by_gap_start": by_start,
                "breakdown_msm_idle_s": dict(breakdown["idle_gaps"]).get("msm"),
                "stages_ms": read["msm_idle_ms.chunks"] + read["msm_idle_ms.finish"],
                "prove_host_ms": prove_ms,
                "stages": self.stages(trace),
                "spans_per_proof": {n: len(self.named(n, trace)) / proofs for n in sorted(
                    {r[0] for r in self.ranges})},
                "runtime_calls_per_proof": {n: sum(c[0] == n for c in self.runtime) / proofs
                                            for n in sorted({c[0] for c in self.runtime})}}


def traced_run(name: str, seed: int, seconds: float, **kw):
    """``run.run_cell`` traced, with the program's spans on while the window
    is open; returns the run's result, its ``Trace`` and its ``ProgramSpans``."""
    from plonkbench import run
    from plonkbench.trace import Trace

    try:
        from aztec_tpu_torch.utils import spans
        switch = spans.enabled
    except ImportError:          # a port that opens no spans
        switch = contextlib.nullcontext
    kept = {}
    bench_msm_span, bench_from_chrome = run.msm_span, Trace.from_chrome

    @contextlib.contextmanager
    def msm_span():              # entered and left with the traced window
        with bench_msm_span(), switch():
            yield

    def from_chrome(cls, path):
        kept["program"] = ProgramSpans.from_chrome(path)
        kept["trace"] = bench_from_chrome(path)
        return kept["trace"]
    run.msm_span, Trace.from_chrome = msm_span, classmethod(from_chrome)
    try:
        res = run.run_cell(name, seed, seconds, True, **kw)
    finally:
        run.msm_span, Trace.from_chrome = bench_msm_span, classmethod(bench_from_chrome.__func__)
    return res, kept["trace"], kept["program"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch
    from plonkbench import run

    if not torch.cuda.is_available():
        run.log("the traced run needs a CUDA device")
        return 2
    res, trace, program = traced_run(args.workload, args.seed, args.seconds)
    bad = run.forbidden_modules()
    if bad:
        run.log(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}")
        return 3
    w0, w1 = trace.window()
    line = {"workload": args.workload, "seed": args.seed, "card": run.card(),
            "correct": res["correct"], "attempted": res["attempted"],
            "traced_window_s": (w1 - w0) / 1e6, "busy_s": res["busy_s"],
            "readings": program.readings(trace),
            "checks": program.checks(trace, res["breakdown"]),
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "breakdown": res["breakdown"]}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
