"""Kernel times on the card's own clock, and the card's identity and peaks.

``device_ms(fn)`` is the mean device time of the kernels that ``fn``
launches: its calls are captured into a CUDA graph and the graph is
replayed between CUDA events, so no host time (argument checks,
allocation, the ctypes call) sits between the kernels.  ``call_ms(fn)``,
CUDA events around a run of wrapper calls, measures that host time too
wherever the kernel is shorter than its launch; ``chip_smoke.py`` keeps
both.  (torch.profiler's kernel events were tried first: after a profiled
proof of 13,000 kernels, later sessions in the same process reported
about a third of the kernels' time, below the bytes bound.)
"""

from __future__ import annotations

import subprocess

import torch

ITERS = 20     # calls in one captured graph
REPLAYS = 3
# H100 SXM memory rate (NVIDIA data sheet): 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12
# Thread-instructions an SM issues per clock, of any kind: four schedulers,
# one warp instruction (32 threads) each (NVIDIA H100 architecture
# whitepaper).  No pipe mix issues faster.
ISSUE_PER_CLOCK_PER_SM = 128


def nvidia_smi(query: str) -> str:
    """The first GPU's line of ``nvidia-smi --query-gpu=<query>``."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return nvidia_smi("name,power.limit")


def peak_per_s(per_clock_per_sm: float) -> float:
    """A rate given per clock per SM, times the SM count and the highest SM
    clock of the card."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return per_clock_per_sm * sms * mhz * 1e6


def bound(nbytes: float, t_ops: float):
    """(least milliseconds, what bounds it): ``nbytes`` at the memory rate
    or the operations' own time ``t_ops`` (ms), whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def issue_ms(instructions: float) -> float:
    """Milliseconds the card takes to issue ``instructions`` thread-
    instructions at ISSUE_PER_CLOCK_PER_SM."""
    return instructions / peak_per_s(ISSUE_PER_CLOCK_PER_SM) * 1e3


def call_ms(fn, iters: int = 5):
    """Mean milliseconds per call of fn() between CUDA events around
    ``iters`` calls, after one warm-up: the device time plus whatever host
    time the calls leave between launches.  Returns (ms, last result)."""
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


def device_ms(fn) -> float:
    """Mean device milliseconds per call of the kernels ``fn()`` launches:
    ITERS calls captured into one CUDA graph after a warm-up call, then
    REPLAYS replays between CUDA events.  The host issues one graph launch
    per replay, so none of its time sits between the kernels.  A wrapper
    called during the capture counts its launch once; the replays launch
    again without counting."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(ITERS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (REPLAYS * ITERS)
