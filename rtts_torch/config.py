"""Configuration of the port: the dataclasses of ``rtts/config.py``.

``rtts.config`` is plain Python (dataclasses and a YAML subset, no JAX), so
the port shares it instead of copying it; every module of ``rtts_torch``
and ``chip_smoke.py`` reaches it through here.  ``resolve_reversible`` and
``resolve_ffn_chunk`` are the port's own: the shared module's versions ask
the JAX flash kernel whether it engages.  Here the port's
``resolve_flash_impl`` answers, in the same memory estimate.
"""

from typing import Optional

from rtts.config import (AUTO_FFN_CHUNK, AttentionConfig, Config,
                         OptimConfig, ReformerStackConfig, ReformerTTSConfig,
                         SqueezeWaveConfig, from_dict, resolve_attention_kind,
                         save_config, to_dict)
from rtts_torch.ops.flash_attention import resolve_flash_impl

__all__ = ["AUTO_FFN_CHUNK", "AttentionConfig", "Config", "OptimConfig",
           "ReformerStackConfig", "ReformerTTSConfig", "SqueezeWaveConfig",
           "from_dict", "resolve_attention_kind", "resolve_ffn_chunk",
           "resolve_reversible", "save_config", "to_dict"]


def _plain_transient_mb(cfg: ReformerStackConfig, batch: int, seq_len: int,
                        mem_len: Optional[int] = None) -> float:
    """Rough transient memory (MB) of the plain-residual train step of one
    stack: ``rtts/config.py::_plain_transient_mb`` term for term.  Flash
    attention stores O(L d) per layer, naive full attention its (B, H, L,
    L) f32 probabilities; each FFN its (B, L, d_ff) hidden."""
    a = cfg.attention
    f32 = 4.0
    flash = resolve_flash_impl(a.flash) == "flash"
    kinds = (list(cfg.attn_layers) if cfg.attn_layers is not None
             else [a.kind] * cfg.num_layers)
    total = 0.0
    for kind in kinds:
        if kind == "auto":
            kind = resolve_attention_kind(a, seq_len)
        if kind == "full":
            if flash:
                total += (batch * a.num_heads * seq_len
                          * (4 * a.head_dim + 128) * f32)
            else:
                total += batch * a.num_heads * seq_len * seq_len * f32
        elif kind == "lsh":
            total += (batch * a.num_heads * a.num_hashes * seq_len
                      * a.head_dim * f32 * 8)
        else:  # local: windowed scores per chunk
            window = (1 + a.num_chunks_before + a.num_chunks_after)
            total += (batch * a.num_heads * seq_len * a.chunk_length
                      * window * f32 * 2)
        total += batch * seq_len * cfg.d_ff * f32          # FFN hidden
        if mem_len is not None:                            # cross-attn pair
            if flash:
                total += (batch * a.num_heads * (seq_len + mem_len)
                          * (2 * a.head_dim + 64) * f32)
            else:
                total += batch * a.num_heads * seq_len * mem_len * f32
            total += batch * seq_len * cfg.d_ff * f32
    return total / 1e6


def resolve_reversible(cfg: ReformerStackConfig, batch: int, seq_len: int,
                       mem_len: Optional[int] = None) -> bool:
    """Resolve reversible="auto" for the given apply shapes, with the rule
    of ``rtts/config.py::resolve_reversible``: plain residuals while the
    estimated plain transient stays under ``auto_plain_budget_mb``."""
    if isinstance(cfg.reversible, bool):
        return cfg.reversible
    if cfg.reversible != "auto":
        raise ValueError(
            f"reversible must be true, false or 'auto', got {cfg.reversible!r}")
    return (_plain_transient_mb(cfg, batch, seq_len, mem_len)
            > cfg.auto_plain_budget_mb)


def resolve_ffn_chunk(cfg: ReformerStackConfig, batch: int, seq_len: int,
                      mem_len: Optional[int] = None) -> int:
    """Resolve ffn_chunk_size for the given apply shapes: "auto" chunks
    (AUTO_FFN_CHUNK) exactly when the residuals resolve reversible."""
    c = cfg.ffn_chunk_size
    if isinstance(c, str):
        if c != "auto":
            raise ValueError(
                f"ffn_chunk_size must be an int or 'auto', got {c!r}")
        return (AUTO_FFN_CHUNK
                if resolve_reversible(cfg, batch, seq_len, mem_len) else 0)
    if c < 0:
        raise ValueError(f"ffn_chunk_size must be >= 0, got {c}")
    return c
