"""Polyphase audio resampling: a copy of ``rtts/audio/resample.py``.

Windowed-sinc (Kaiser) polyphase filtering in NumPy, host-side (resampling
is offline preprocessing, on no device path).  The port keeps its own copy
because it imports nothing of the JAX package
(``tests/test_torch_copies.py`` holds the two equal).
"""

from __future__ import annotations

import math

import numpy as np


def _kaiser_sinc_filter(num_taps: int, cutoff: float, beta: float = 8.6) -> np.ndarray:
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(2.0 * cutoff * n) * 2.0 * cutoff
    return (h * np.kaiser(num_taps, beta)).astype(np.float64)


def resample_poly(x: np.ndarray, orig_sr: int, target_sr: int, taps_per_phase: int = 32) -> np.ndarray:
    """Resample 1-D float audio from orig_sr to target_sr (polyphase)."""
    if orig_sr == target_sr:
        return np.asarray(x, dtype=np.float32)
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    cutoff = 0.5 / max(up, down)
    num_taps = taps_per_phase * max(up, down)
    if num_taps % 2 == 0:
        num_taps += 1
    h = _kaiser_sinc_filter(num_taps, cutoff) * up
    x = np.asarray(x, dtype=np.float64)
    # upsample by zero-stuffing, filter, downsample
    up_x = np.zeros(len(x) * up, dtype=np.float64)
    up_x[::up] = x
    y = np.convolve(up_x, h, mode="same")
    return y[::down].astype(np.float32)
