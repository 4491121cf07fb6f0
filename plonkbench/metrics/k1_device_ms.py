"""Device milliseconds a proof of K1, the field-op and FFT kernels
(csrc/field_ops.cu), over the traced window."""

from plonkbench.trace import K1_KERNELS, symbol


def read(run):
    trace, proofs = run["trace"], len(run["traced"])
    if trace is None or not proofs:
        return None
    w0, w1 = trace.window()
    us = sum(d for name, _, s, d, _ in trace.kernels()
             if w0 <= s < w1 and symbol(name) in K1_KERNELS)
    return us / 1e3 / proofs if us else None
