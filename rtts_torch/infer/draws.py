"""The random draws of a greedy decode, in the order it makes them.

``rtts_torch.infer.decode.decode_greedy`` and the runner of an exported
artifact (``rtts_torch.infer.export.ExportedSynthesizer``) both draw from
here, so one seed gives one mel whether the decode step runs live or from
an artifact.  This module imports no model code: the runner loads without
it.

- ``prenet_uniforms``: each step, the decoder prenet's always-on dropout,
  one (B, width) uniform draw per prenet layer, in layer order, from the
  decode's generator (``torch.Generator(device).manual_seed(seed)``):
  exactly what ``rtts_torch.nn.layers.dropout`` draws from it.
- ``decode_rotations``: once per decode, the LSH modes' hash rotations of
  every decoder self-attention layer, from a generator seeded with the
  config's ``hash_seed`` or, without one, ``rotation_seed(seed)`` (apart
  from the prenet's stream, which it leaves untouched).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

# the rotation draw's seed namespace, apart from the prenet dropout's
# generator (the reference's fold-in constant)
ROT_KEY = 0x7FFFFFFF


def rotation_seed(seed: int) -> int:
    """The decode rotations' seed for a decode seeded ``seed``."""
    return int(np.random.SeedSequence([seed, ROT_KEY]).generate_state(
        1, np.uint64)[0])


def prenet_uniforms(generator: Optional[torch.Generator], batch: int,
                    widths: Sequence[int], rate: float, device
                    ) -> List[torch.Tensor]:
    """One step's prenet dropout uniforms: (batch, w) f32 for each width
    in ``widths``, drawn in order; none when ``rate`` is 0."""
    if rate == 0.0:
        return []
    return [torch.rand((batch, w), generator=generator, device=device)
            for w in widths]


def draw_rotations(h: int, d: int, n_hashes: int, half: int,
                   generator: Optional[torch.Generator], device
                   ) -> torch.Tensor:
    """(h, d, n_hashes, half) f32 standard normal rotations: every LSH
    hash's draw, the encoder's (``rtts_torch.attention.lsh.
    draw_rotations``, outside a rotation tape) and the decode's."""
    return torch.randn((h, d, n_hashes, half), generator=generator,
                       device=device, dtype=torch.float32)


def decode_rotations(seed: int, layers: int, heads: int, head_dim: int,
                     n_hashes: int, n_buckets: int, device
                     ) -> List[torch.Tensor]:
    """Per-layer rotations (heads, head_dim, n_hashes, n_buckets / 2) from
    one generator seeded ``seed``, layer by layer."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [draw_rotations(heads, head_dim, n_hashes, n_buckets // 2, gen,
                           device)
            for _ in range(layers)]
