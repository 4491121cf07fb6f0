"""The parallel layer's cost on the card: sharded MSM and coset FFT at D
shards against the single-device call, same work.

Port of tools/scaling_probe.py.  For D in (1, 2, 4) shards of ONE card
(``Mesh.local(D)``), it times the sharded MSM of 2^log2n points of the
committed table (``parallel.sharded_msm``: the chunked route) against
``msm.chunked.msm_chunked``, and the sharded coset FFT at 4n
(``parallel.sharded_fft``, D^2 | 4n) against ``poly.fft.coset_fft``; each
result is held to the single-device one.  On one card the shards run one
after another, so the ratio T_mesh / T_solo - 1 is the sharding's overhead
(partials, the all-to-all's block moves, the twiddle combine), not a
speed-up: with compute scaling linearly across cards, the overhead bounds
the efficiency of D cards at 1 / (1 + overhead).

Run on a card (the times are host clock around synchronised calls, the
median of ``--reps`` warm calls):

    python -m aztec_tpu_torch.tools.scaling_probe [--log2n 17] [--out FILE]

It prints one JSON object and writes it to ``--out`` if given.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

SHARDS = (1, 2, 4)


def timed(fn, reps: int, sync):
    """(median seconds of ``reps`` synchronised calls after one warm-up,
    the last result)."""
    out = fn()
    sync()
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs), out


def probe(log2n: int = 17, reps: int = 3, shards=SHARDS,
          device: str = "cuda") -> dict:
    """The report; on the card unless ``device="cpu"`` (a rehearsal of the
    control flow: its seconds are the CPU's, not a device metric)."""
    import numpy as np
    import torch

    from ..curves.io import jacobian_to_host
    from ..curves.spec import BN254_G1
    from ..ff import FR, limb
    from ..ff.bn254 import FR_MOD
    from ..msm.chunked import msm_chunked
    from ..numeric.bigint import ints_to_limbs
    from ..parallel import Mesh, sharded_msm
    from ..parallel.sharded_fft import sharded_coset_fft
    from ..poly import fft_ops as pfft
    from ..poly.domain import EvaluationDomain
    from ..srs.reference_string import load_point_table
    from .timing import card_line

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("scaling_probe measures the card: no CUDA "
                               "device")
        dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    n = 1 << log2n
    rng = np.random.default_rng(11)
    X, Y = (torch.as_tensor(p.astype(np.int32), device=dev)
            for p in load_point_table(n))
    S = torch.as_tensor(ints_to_limbs(
        [int.from_bytes(rng.bytes(32), "little") % BN254_G1.order
         for _ in range(n)]).astype(np.int32), device=dev)
    report = {"card": card_line() if dev.type == "cuda" else "cpu",
              "log2n": log2n, "reps": reps, "msm": {}, "coset_fft": {}}

    t_solo, r_solo = timed(lambda: msm_chunked((X, Y), S, BN254_G1), reps,
                           sync)
    solo = jacobian_to_host(r_solo, BN254_G1)
    report["msm"]["solo_s"] = t_solo
    for D in shards:
        mesh = Mesh.local(D, dev)
        t, r = timed(lambda: sharded_msm(mesh, (X, Y), S, BN254_G1), reps,
                     sync)
        if jacobian_to_host(r, BN254_G1) != solo:
            raise AssertionError(f"sharded MSM over {D} shards differs")
        report["msm"][f"d{D}_s"] = t
        report["msm"][f"d{D}_overhead"] = t / t_solo - 1

    m = 4 * n
    dom = EvaluationDomain(m, dev)
    coeffs = limb.to_mont(torch.as_tensor(ints_to_limbs(
        [int.from_bytes(rng.bytes(32), "little") % FR_MOD
         for _ in range(m)]).astype(np.int32), device=dev), FR)
    t_solo, f_solo = timed(lambda: pfft.coset_fft(coeffs, dom), reps, sync)
    canon = limb.from_mont(f_solo, FR)
    report["coset_fft"]["solo_s"] = t_solo
    for D in shards:
        mesh = Mesh.local(D, dev)
        t, f = timed(lambda: sharded_coset_fft(mesh, coeffs, dom), reps,
                     sync)
        if not torch.equal(limb.from_mont(f, FR), canon):
            raise AssertionError(f"sharded coset FFT over {D} shards differs")
        report["coset_fft"][f"d{D}_s"] = t
        report["coset_fft"][f"d{D}_overhead"] = t / t_solo - 1
    return report


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2n", type=int, default=17)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    report = probe(a.log2n, a.reps, device=a.device)
    line = json.dumps(report)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
