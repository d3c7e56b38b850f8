"""1 minus the union of the card's intervals over the traced window, %."""


def read(run):
    busy, _ = run.busy()
    a, b = run.trace_window
    return 100.0 * (1.0 - busy / (b - a))
