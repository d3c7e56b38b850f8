"""Share of the window the batch producer's thread spent making batches:
the program's ``data.collate`` spans (``diffsvc_tpu_torch.data.dataset.
prefetch``: each batch's items, collate and batch-dimension pad), cut to
the window, over the window, %."""


def read(run):
    try:
        from diffsvc_tpu_torch.utils import trace
    except ImportError:          # a program that records no spans
        return None
    busy = sum(min(s.t1, run.t1) - max(s.t0, run.t0) for s in trace.spans()
               if s.name == "data.collate" and s.t1 > run.t0
               and s.t0 < run.t1)
    if not busy:
        if run.device == "cuda" and run.work:
            raise RuntimeError("the window ran training steps but the "
                               "program's trace holds no data.collate span")
        return None
    return 100.0 * busy / (run.t1 - run.t0)
