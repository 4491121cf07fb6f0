"""The MSMs' share of their roofline, in %: the least time of the proof's
MSMs (plonkbench/work.py: 2w + 3 MSMs of n points, from the shapes alone)
over the device time of every operation launched while the host was inside
the MSM (the benchmark's ``msm`` span around proving_key.commit_scalars)."""

from plonkbench import work


def read(run):
    trace, proofs = run["trace"], len(run["traced"])
    if trace is None or not proofs:
        return None
    us = sum(d for _, _, _, d, _ in trace.launched_within("msm"))
    if not us:
        return None
    least = proofs * work.proof_msms(run["width"]) * work.msm_seconds(run["subgroup"])
    return 100 * least / (us / 1e6)
