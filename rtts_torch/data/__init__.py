"""The data pipeline of the port, counterpart of ``rtts/data/``: the
training datasets (``dataset``), the synthetic corpus (``corpus``),
preprocessing wavs and transcripts into clips (``preprocess``), the
transcript scraper (``download``) and artifact versioning
(``versioning``)."""

from rtts_torch.data.dataset import (ClipStore, EpochBatcher, Manifest,
                                     MelAudioDataset, TextMelDataset,
                                     read_clip, split_manifest, to_device,
                                     write_clip)

__all__ = ["ClipStore", "EpochBatcher", "Manifest", "MelAudioDataset",
           "TextMelDataset", "read_clip", "split_manifest", "to_device",
           "write_clip"]
