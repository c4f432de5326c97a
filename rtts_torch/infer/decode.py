"""Autoregressive mel decoding with a full-attention KV cache (``kv_full``).

Port of the ``kv_full`` path of ``rtts/infer/decode.py``.  Each decoder
self-attention layer caches its keys (length-normalized and pre-scaled by
1/sqrt(d) at insertion) and values in (B, T_max, H, d) buffers allocated
once for ``max_frames``; each step projects one frame, writes it into the
caches in place and attends over the cached prefix.  Cross-attention K/V
are projected once from the raw encoder memory.  The loop is a host loop
that stops as soon as every row has fired its stop token; its set-up and
body are the reference's ``_init_state`` and ``_make_step_fn``.

Numerics follow the reference's single fixed-size loop: the step recurrence
replicates the two-stream residual stack (h1 += f(h2); h2 += g(h1); output
= mean) with float32 streams and compute-dtype sublayers.  The self-attention
of step t reads the first t+1 cache rows; the rows after t, which the
reference masks to -1e9, contribute exactly zero probability there.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from rtts_torch.attention.full import _len_norm
from rtts_torch.config import ReformerTTSConfig, resolve_attention_kind
from rtts_torch.models.reformer_tts import _dtype, postnet_apply
from rtts_torch.models.stack import _layer_kinds
from rtts_torch.ops.flash_attention import MASK_VALUE, SELF_MASK_VALUE
from rtts_torch.reversible.ffn import _ffn_body


@torch.no_grad()
def _precast_weights(model: torch.nn.Module, cdt) -> torch.nn.Module:
    """Cast every float32 parameter or buffer of rank >= 2 (matmul and conv
    weights, the embedding and positional tables) to the compute dtype,
    once and in place, before serving.  The per-use casts of ``Dense``,
    ``conv1d`` and the tables then do nothing, so no result changes.
    LayerNorm parameters, biases and ``alpha`` stay float32."""
    if cdt == torch.float32:
        return model
    for t in list(model.parameters()) + list(model.buffers()):
        if t.ndim >= 2 and t.dtype == torch.float32:
            t.data = t.data.to(cdt)
    return model


class DecodeResult(NamedTuple):
    """Uniform return of the greedy decode."""

    mel_post: torch.Tensor      # (B, T_max, n_mels) float32, length-masked
    lengths: torch.Tensor       # (B,) int32 — first-stop frame counts
    stop_logits: torch.Tensor   # (B, T_max) float32


def _proj_heads(dense, x, num_heads, cdt):
    """(B, D) -> (B, H, d)"""
    y = dense(x, cdt)
    return y.reshape(y.shape[0], num_heads, -1)


def _self_attn_step(p, h_t, k_cache, v_cache, t, num_heads, cdt):
    """One-frame shared-QK causal self-attention over the cached prefix;
    writes position t of the caches in place.  h_t: (B, D) LN'd frame."""
    qk_t = _proj_heads(p.w_qk, h_t, num_heads, cdt)        # (B, H, d)
    v_t = _proj_heads(p.w_v, h_t, num_heads, cdt)
    k_cache[:, t] = _len_norm(qk_t) * (qk_t.shape[-1] ** -0.5)
    v_cache[:, t] = v_t
    keys, vals = k_cache[:, :t + 1], v_cache[:, :t + 1]
    scores = torch.einsum("bhd,bthd->bht", qk_t, keys).float()
    scores[..., t] = SELF_MASK_VALUE          # no self-attend
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bht,bthd->bhd", probs.to(cdt), vals)
    return p.w_o(out.reshape(out.shape[0], -1), cdt)


def _cross_attn_step(p, h_t, mem_k, mem_v, memory_mask, num_heads, cdt):
    """One-frame cross-attention.  mem_k/mem_v: (B, L, H, d) precomputed."""
    q = _proj_heads(p.w_q, h_t, num_heads, cdt)
    scores = torch.einsum("bhd,blhd->bhl", q, mem_k).float() * (
        q.shape[-1] ** -0.5)
    if memory_mask is not None:
        scores = scores.masked_fill(~memory_mask[:, None, :], MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhl,blhd->bhd", probs.to(cdt), mem_v)
    return p.w_o(out.reshape(out.shape[0], -1), cdt)


def _init_mem_kv(model, cfg: ReformerTTSConfig, memory, cdt):
    """Cross-attention K/V per decoder cross layer, projected from the RAW
    encoder memory (the cross layer's LN normalizes the decoder stream, the
    query side, not the memory)."""
    num_heads = cfg.decoder.attention.num_heads
    b, l, _ = memory.shape
    mem_k, mem_v = [], []
    layers = model.decoder.layers
    for i in range(1, len(layers), 2):       # [self, cross] * num_layers
        a = layers[i].f.attn
        mem_k.append(a.w_k(memory, cdt).reshape(b, l, num_heads, -1))
        mem_v.append(a.w_v(memory, cdt).reshape(b, l, num_heads, -1))
    return mem_k, mem_v


def _decoder_step(model, cfg: ReformerTTSConfig, x_t, t, k_caches, v_caches,
                  mem_k, mem_v, memory_mask, cdt):
    """Run one frame (B, D) through the decoder stack at step t: the
    two-stream recurrence of ``_stack_substep`` over [self, cross] layer
    pairs, each followed by the FFN (the reference's ``_ffn_step`` is
    ``_ffn_body``)."""
    num_heads = cfg.decoder.attention.num_heads
    h1 = h2 = x_t.float()
    for li, lp in enumerate(model.decoder.layers):
        hh = lp.f.ln(h2)
        i = li // 2
        if li % 2:
            out = _cross_attn_step(lp.f.attn, hh, mem_k[i], mem_v[i],
                                   memory_mask, num_heads, cdt)
        else:
            out = _self_attn_step(lp.f.attn, hh, k_caches[i], v_caches[i], t,
                                  num_heads, cdt)
        h1 = h1 + out
        h2 = h2 + _ffn_body(lp.g, h1, cfg.decoder.ffn_activation, cdt)
    return model.decoder.final_ln((h1 + h2) * 0.5)


def check_kv_cache_dtype(cfg: ReformerTTSConfig) -> None:
    """Raise on a ``kv_cache_dtype`` the port does not honour yet: only the
    compute dtype ("compute", or unset) is ported, not the reference's e4m3
    caches with their +-448 clip."""
    name = cfg.kv_cache_dtype
    if name not in ("compute", None, ""):
        raise NotImplementedError(
            f"rtts_torch: kv_cache_dtype {name!r} is not ported yet (only "
            "'compute')")


def _init_caches(cfg: ReformerTTSConfig, batch: int, n_groups: int, cdt,
                 device) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    a = cfg.decoder.attention
    shape = (batch, n_groups, a.num_heads, a.head_dim)
    n = cfg.decoder.num_layers
    return ([torch.zeros(shape, dtype=cdt, device=device) for _ in range(n)],
            [torch.zeros(shape, dtype=cdt, device=device) for _ in range(n)])


def _auto_mode(cfg: ReformerTTSConfig, max_frames: int) -> str:
    """The reference's serving-cache rule (``rtts/infer/decode.py``): kv_local
    for local decoders, kv_lsh_chunk for pure-LSH decoders whose prefix
    dwarfs the ring working set, else kv_full."""
    a = cfg.decoder.attention
    n_groups = max_frames // cfg.reduction_factor
    kinds = set(resolve_attention_kind(a, n_groups) if k == "auto" else k
                for k in _layer_kinds(cfg.decoder))
    if "local" in kinds:
        return "kv_local"
    if kinds != {"lsh"}:
        return "kv_full"
    ring_cap = min(
        a.chunk_length * (1 + a.num_chunks_before + a.num_chunks_after),
        n_groups)
    return ("kv_lsh_chunk" if n_groups > 10 * a.num_hashes * ring_cap
            else "kv_full")


@torch.no_grad()
def decode_greedy(model, cfg: ReformerTTSConfig, memory: torch.Tensor,
                  memory_mask: torch.Tensor, max_frames: int,
                  generator: Optional[torch.Generator] = None,
                  stop_threshold: Optional[float] = None,
                  mode: str = "kv_full") -> DecodeResult:
    """Greedy AR decode -> DecodeResult(mel_post (B, T_max, n_mels), lengths
    (B,), stop_logits (B, T_max)).

    ``generator`` (on memory's device) draws the decoder prenet's always-on
    dropout.  ``mode`` "auto" resolves as the reference does; only kv_full
    is ported (the other caches raise NotImplementedError), and only the
    compute-dtype cache (``check_kv_cache_dtype``).  The caches are written
    in place."""
    check_kv_cache_dtype(cfg)
    cdt = _dtype(cfg.compute_dtype)
    if stop_threshold is None:
        stop_threshold = cfg.stop_threshold
    if mode == "auto":
        mode = _auto_mode(cfg, max_frames)
    if mode != "kv_full":
        raise NotImplementedError(
            f"rtts_torch: decode mode {mode!r} is not ported yet (kv_full)")
    r = cfg.reduction_factor
    if max_frames % r != 0:
        raise ValueError(f"max_frames {max_frames} not a multiple of "
                         f"reduction_factor {r}")
    n_groups = max_frames // r
    if n_groups > cfg.max_pos:
        raise ValueError(f"max_frames {max_frames} needs {n_groups} decoder "
                         f"positions; the table has {cfg.max_pos}")
    dev = memory.device
    batch = memory.shape[0]
    n_mels = cfg.n_mels
    memory_mask = memory_mask.bool()
    mem_k, mem_v = _init_mem_kv(model, cfg, memory.to(cdt), cdt)
    k_caches, v_caches = _init_caches(cfg, batch, n_groups, cdt, dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    lengths = torch.full((batch,), max_frames, dtype=torch.int32, device=dev)
    prev = torch.zeros(batch, n_mels * r, device=dev)
    mel = torch.zeros(batch, max_frames, n_mels, device=dev)
    stop_logits = torch.zeros(batch, max_frames, device=dev)
    pos_table, pos_alpha = model.dec_pos.table, model.dec_pos.alpha

    for t in range(n_groups):
        h = model.dec_prenet(prev.to(cdt), cfg.dec_prenet_dropout, generator,
                             compute_dtype=cdt)
        h = h + pos_alpha.to(h.dtype) * pos_table[t].to(h.dtype)
        y = _decoder_step(model, cfg, h, t, k_caches, v_caches, mem_k, mem_v,
                          memory_mask, cdt)
        group = model.mel_head(y, cdt).float()
        stop_logit = model.stop_head(y, cdt)[..., 0].float()
        mel[:, t * r:(t + 1) * r] = group.reshape(batch, r, n_mels)
        stop_logits[:, t * r:(t + 1) * r] = stop_logit[:, None]
        lengths = torch.where(done, lengths, (t + 1) * r)
        done = done | (torch.sigmoid(stop_logit) > stop_threshold)
        prev = group
        if bool(done.all()):
            break
    residual = postnet_apply(model.postnet, mel.to(cdt), cdt).float()
    frame_mask = torch.arange(max_frames, device=dev)[None, :] < lengths[:, None]
    mel_post = (mel + residual) * frame_mask[..., None]
    return DecodeResult(mel_post, lengths, stop_logits)
