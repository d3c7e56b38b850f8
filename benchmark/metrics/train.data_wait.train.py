"""Share of the window the training loop spent waiting on the port's batch
producer (``next`` on ``prefetch`` over ``BatchIterator``), from the
benchmark's spans, %."""


def read(run):
    wait = sum(t1 - t0 for t0, t1, _ in run.window_spans("fetch"))
    if not run.work:
        return None
    return 100.0 * wait / run.counters["window_s"]
