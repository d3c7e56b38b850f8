"""Matplotlib figures for TensorBoard (reference utils/plot.py).

Figures are built with ``matplotlib.figure.Figure`` directly — NOT pyplot —
so they are thread-safe (test_runner saves plots from a thread pool) and
carry no global figure-manager state to leak or close.

A copy of ``diffsvc_tpu/utils/plot.py``, so that the port loads no module of
the JAX package.
"""

from __future__ import annotations

import numpy as np


def _new_figure(figsize):
    from matplotlib.figure import Figure

    return Figure(figsize=figsize)


def spec_to_figure(spec_pred, spec_gt=None, vmin=-6.0, vmax=1.5):
    n = 2 if spec_gt is not None else 1
    fig = _new_figure((12, 3 * n))
    axes = np.atleast_1d(fig.subplots(n, 1))
    axes[0].pcolor(np.asarray(spec_pred).T, vmin=vmin, vmax=vmax)
    axes[0].set_title("pred")
    if spec_gt is not None:
        axes[1].pcolor(np.asarray(spec_gt).T, vmin=vmin, vmax=vmax)
        axes[1].set_title("gt")
    fig.tight_layout()
    return fig

