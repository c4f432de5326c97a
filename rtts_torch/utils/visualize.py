"""Spectrogram / attention images for eval artifacts: a copy of
``rtts/data/visualize.py``.  matplotlib is imported inside each function,
so importing this module needs none (the eval reports a missing one and
trains on)."""

from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np


def plot_spectrogram(mel: np.ndarray, path: str,
                     title: str = "mel spectrogram",
                     target: Optional[np.ndarray] = None) -> str:
    """Save a log-mel (T, n_mels) image; optionally side-by-side with a
    target for eval comparisons.  Returns the written path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = 2 if target is not None else 1
    fig, axes = plt.subplots(n, 1, figsize=(10, 3 * n), squeeze=False)
    axes[0][0].imshow(np.asarray(mel).T, origin="lower", aspect="auto",
                      interpolation="nearest")
    axes[0][0].set_title(title)
    axes[0][0].set_xlabel("frames")
    axes[0][0].set_ylabel("mel bin")
    if target is not None:
        axes[1][0].imshow(np.asarray(target).T, origin="lower", aspect="auto",
                          interpolation="nearest")
        axes[1][0].set_title("target")
    fig.tight_layout()
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(p, dpi=80)
    plt.close(fig)
    return str(p)


def plot_attention(attn: np.ndarray, path: str, title: str = "attention") -> str:
    """Save an attention matrix (Lq, Lk) heatmap."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(np.asarray(attn), origin="lower", aspect="auto",
              interpolation="nearest")
    ax.set_title(title)
    ax.set_xlabel("key position")
    ax.set_ylabel("query position")
    fig.tight_layout()
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(p, dpi=80)
    plt.close(fig)
    return str(p)
