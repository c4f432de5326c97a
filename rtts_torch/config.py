"""Configuration of the port: the dataclasses of ``rtts/config.py``.

``rtts.config`` is plain Python (dataclasses and a YAML subset, no JAX), so
the port shares it instead of copying it; every module of ``rtts_torch``
and ``chip_smoke.py`` reaches it through here.  Only the names below are
shared: ``resolve_reversible`` and ``resolve_ffn_chunk`` are left out,
because they import the JAX flash kernel, and serving's forward pass runs
the two-stream plain stack with an unchunked FFN either way.
"""

from rtts.config import (AUTO_FFN_CHUNK, AttentionConfig, Config,
                         ReformerStackConfig, ReformerTTSConfig,
                         SqueezeWaveConfig, from_dict, resolve_attention_kind,
                         to_dict)

__all__ = ["AUTO_FFN_CHUNK", "AttentionConfig", "Config",
           "ReformerStackConfig", "ReformerTTSConfig", "SqueezeWaveConfig",
           "from_dict", "resolve_attention_kind", "to_dict"]
