"""Share of the training loop's batch fetches that found the producer's
queue empty: the program's counters ``data.gets_empty`` over
``data.gets`` (``diffsvc_tpu_torch.data.dataset.prefetch``), counted
inside the window, %."""


def read(run):
    try:
        from diffsvc_tpu_torch.utils import trace
    except ImportError:          # a program that records no counters
        return None
    counts = trace.counters(run.t0, run.t1)
    gets = counts.get("data.gets", 0)
    if not gets:
        if run.device == "cuda" and run.work:
            raise RuntimeError("the window ran training steps but the "
                               "program's trace counted no data.gets")
        return None
    return 100.0 * counts.get("data.gets_empty", 0) / gets
