"""Device kernels a proof launches, all of them, over the traced window."""


def read(run):
    trace, proofs = run["trace"], len(run["traced"])
    if trace is None or not proofs:
        return None
    w0, w1 = trace.window()
    count = sum(1 for _, _, s, _, _ in trace.kernels() if w0 <= s < w1)
    return count / proofs if count else None
