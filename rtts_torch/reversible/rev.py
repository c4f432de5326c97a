"""Two-stream residual sequence, forward only.

Port of the forward of ``rtts/reversible/rev.py::reversible_sequence``:

    h1 = h2 = x;  per layer:  h1 += f(h2);  h2 += g(h1);   y = (h1 + h2) / 2

The reversible and plain residual schemes of the reference run this same
forward; they differ only in what the backward stores, so inference needs
neither the custom backward nor the choice between them.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def reversible_sequence(layer_fns: Sequence[Tuple[Callable, Callable]],
                        params_list, x: torch.Tensor, memory, aux_list
                        ) -> torch.Tensor:
    """Run a stack of (f, g) residual pairs over x: (B, L, D).

    f(params, x, memory, aux) -> out;  g(params, y, memory, aux) -> out."""
    h1 = h2 = x
    for (f, g), p, aux in zip(layer_fns, params_list, aux_list):
        h1 = h1 + f(p.f, h2, memory, aux)
        h2 = h2 + g(p.g, h1, memory, aux)
    return (h1 + h2) * 0.5
