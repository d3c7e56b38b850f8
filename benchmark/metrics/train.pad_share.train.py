"""Padded frames over all frames of the window's batches (rows x padded
length), counted from the collated shapes: the batching layer's waste, %."""


def read(run):
    total = sum(w["rows"] * w["frames"] for w in run.work)
    real = sum(sum(w["lengths"]) for w in run.work)
    if not total:
        return None
    return 100.0 * (total - real) / total
