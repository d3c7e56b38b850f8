"""Card-idle time the training step's host work holds: each idle moment of
the traced window given to the innermost of the program's spans open then
(``diffsvc_tpu_torch.utils.trace``), summed over ``train.step`` and its
descendants (upload, draws, forward and backward issue, the reduction, the
optimizer), over the window, %.

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
        "train.step", "train.")
    if share is None and run.work:
        raise RuntimeError("the window ran training steps, but the "
                           "program's trace holds no train.step span")
    return share
