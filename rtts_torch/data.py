"""The training data pipeline of the port.

``rtts.data.dataset`` is plain Python and numpy (manifest, train/val split,
length-bucketed ``TextMelDataset``, the deterministic step -> batch
``EpochBatcher``), so the port shares it instead of copying it; this module
is the one place where the port reaches it.  ``to_device`` turns one of its
numpy batches into tensors on the training device.
"""

from typing import Dict

import numpy as np
import torch

from rtts.data.dataset import (EpochBatcher, Manifest, TextMelDataset,
                               split_manifest)

__all__ = ["EpochBatcher", "Manifest", "TextMelDataset", "split_manifest",
           "to_device"]


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """tokens -> int64, token_mask / mel_mask -> bool, mel -> float32."""
    return {
        "tokens": torch.as_tensor(np.asarray(batch["tokens"]),
                                  device=device).long(),
        "token_mask": torch.as_tensor(np.asarray(batch["token_mask"]),
                                      device=device).bool(),
        "mel": torch.as_tensor(np.asarray(batch["mel"], np.float32),
                               device=device),
        "mel_mask": torch.as_tensor(np.asarray(batch["mel_mask"]),
                                    device=device).bool(),
    }
