"""The whole proof's share of the card's peak, in %: the least time of the
traced proofs' MSMs and FFTs (plonkbench/work.py, from the shapes alone)
over the traced window's wall time."""

from plonkbench import work


def read(run):
    trace, proofs = run["trace"], len(run["traced"])
    if trace is None or not proofs:
        return None
    w0, w1 = trace.window()
    least = proofs * work.proof_seconds(run["width"], run["subgroup"])
    return 100 * least / ((w1 - w0) / 1e6)
