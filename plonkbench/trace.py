"""The traced window, read from one torch.profiler session's Chrome trace.

What the per-layer readers see: every device operation (kernels, copies,
sets) with its device interval and the host time of its launch, and the
benchmark's own host spans (``torch.profiler.record_function`` ranges named
``plonkbench.<span>``), all on the profiler's one clock, in microseconds.
"""

from __future__ import annotations

import json
import re

SPAN_PREFIX = "plonkbench."
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# The port's hand-written kernels (aztec_tpu_torch/csrc/*.cu) by layer:
# K1 the field ops and the FFT's stage kernel; K2-K5 the curve formulas, the
# rakes and the bucket phase, which only the MSM launches.
K1_KERNELS = frozenset({
    "mont_mul_kernel", "add_mod_kernel", "sub_mod_kernel", "mul_add_kernel",
    "mont_pow_kernel", "fft_stages_kernel", "butterfly_kernel"})
MSM_KERNELS = frozenset({
    "mixed_add_kernel", "add_unsafe_kernel", "proj_add_kernel",
    "proj_dbl_kernel", "proj_dbl_n_kernel", "j2c_kernel", "c2j_kernel",
    "rake_packed_kernel", "rake_packed_exact_kernel", "rake_lazy_kernel",
    "rake_exact_kernel", "rake_kernel", "bucket_lanes_kernel",
    "bucket_final_kernel", "bucket_combine_kernel"})
OTHER_CSRC = frozenset({"empty_kernel", "vpu_kernel", "dissect_kernel"})
CSRC_KERNELS = K1_KERNELS | MSM_KERNELS | OTHER_CSRC
_SYMBOL = re.compile(r"(\w+_kernel)\b")


def symbol(name: str) -> str | None:
    """The csrc kernel a device operation's name is, or None (torch's own
    kernels, copies and sets: the glue)."""
    for m in _SYMBOL.finditer(name):
        if m.group(1) in CSRC_KERNELS:
            return m.group(1)
    return None


class Trace:
    def __init__(self, ops: list, spans: list):
        self.ops = ops        # (name, category, start_us, dur_us, launch_us | None)
        self.spans = spans    # (name, start_us, end_us), the prefix removed

    @classmethod
    def from_chrome(cls, path: str) -> "Trace":
        with open(path) as f:
            events = json.load(f)
        events = events.get("traceEvents", events) if isinstance(events, dict) else events
        launches, ops, spans = {}, [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat == "cuda_runtime" and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = float(e["ts"])
            elif cat == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX):
                start = float(e["ts"])
                spans.append((e["name"][len(SPAN_PREFIX):], start,
                              start + float(e.get("dur", 0))))
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
                corr = e.get("args", {}).get("correlation")
                ops.append((e.get("name", ""), e["cat"], float(e["ts"]),
                            float(e.get("dur", 0)), launches.get(corr)))
        ops.sort(key=lambda o: o[2])
        spans.sort(key=lambda s: s[1])
        return cls(ops, spans)

    def spans_named(self, name: str) -> list:
        return [(s, e) for n, s, e in self.spans if n == name]

    def window(self) -> tuple:
        """The traced window: the benchmark's ``window`` span."""
        (start, end), = self.spans_named("window")
        return start, end

    def kernels(self) -> list:
        return [o for o in self.ops if o[1] == "kernel"]

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals inside the window,
        merged: [(start_us, end_us)]."""
        w0, w1 = self.window()
        merged = []
        for _, _, s, d, _ in self.ops:
            s, e = max(s, w0), min(s + d, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(x) for x in merged]

    def idle_gaps(self) -> list:
        """[(start_us, end_us)] of the window's time with no device op."""
        w0, w1 = self.window()
        gaps, t = [], w0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1))
        return gaps

    def open_span(self, t_us: float) -> str:
        """The innermost benchmark span open on the host at ``t_us``."""
        best = None
        for name, s, e in self.spans:
            if s <= t_us < e and name != "window":
                if best is None or s >= best[1]:
                    best = (name, s)
        return best[0] if best else "between requests"

    def launched_within(self, span: str) -> list:
        """The device ops launched while the host was inside a ``span``."""
        ranges = self.spans_named(span)
        out = []
        for op in self.ops:
            launch = op[4]
            if launch is not None and any(s <= launch <= e for s, e in ranges):
                out.append(op)
        return out
