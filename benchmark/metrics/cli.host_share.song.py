"""Share of each song's wall spent outside the conversion calls
(``Svc.infer_fused`` / ``infer_batched``) that ``run_clip`` makes: the CLI
and slicing layer (``infer_cli``, ``infer/slicer``: wav reads, slicing,
chunk cache, assembly, the output write), from the benchmark's spans."""


def read(run):
    songs = sum(t1 - t0 for t0, t1, _ in run.window_spans("song"))
    calls = sum(t1 - t0 for lab in ("infer_fused", "infer_batched")
                for t0, t1, _ in run.window_spans(lab))
    if songs <= 0 or calls <= 0:
        return None
    return 100.0 * (1.0 - calls / songs)
