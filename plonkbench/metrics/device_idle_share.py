"""The share of the traced window in which no operation ran on the device:
one minus the union of the device operations' intervals over the window."""


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    w0, w1 = trace.window()
    busy = sum(e - s for s, e in trace.busy_intervals())
    return 1 - busy / (w1 - w0) if busy > 0 else None
