"""Card-idle time the conversion's host work holds: each idle moment of the
traced window given to the innermost of the program's spans open then
(``diffsvc_tpu_torch.utils.trace``), summed over ``svc.batched`` and its
descendants (the per-chunk front end, the collate, the uploads, sampling,
pe, the vocoder and the downloads), over the window, %.

The program's spans are on the host's clock; they go onto the trace's by
one offset, the window's profiler range's start less its host start.
"""


def read(run):
    try:
        from diffsvc_tpu_torch.utils import trace
    except ImportError:          # a program that records no spans
        return None
    if run.device != "cuda":
        return None
    w0 = next(t0 for lab, t0, _, _ in run.spans if lab == "window")
    share = trace.idle_share(
        [s for s in trace.spans() if s.t1 >= run.t0 and s.t0 <= run.t1],
        run.busy()[1], run.trace_window[0] - w0, run.trace_window,
        "svc.batched", "svc.")
    if share is None and run.work:
        raise RuntimeError("the window ran infer_batched, but the "
                           "program's trace holds no svc.batched span")
    return share
