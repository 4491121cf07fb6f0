"""Device milliseconds a proof of the operations that are not the port's
hand-written kernels (torch's elementwise kernels, cat, copies, gathers,
scatters, index_add_, memcpy and memset), over the traced window."""

from plonkbench.trace import symbol


def read(run):
    trace, proofs = run["trace"], len(run["traced"])
    if trace is None or not proofs:
        return None
    w0, w1 = trace.window()
    us = sum(d for name, _, s, d, _ in trace.ops
             if w0 <= s < w1 and symbol(name) is None)
    return us / 1e3 / proofs
