"""Decoder cross-attention probabilities, for alignment diagnostics.

Port of ``rtts/infer/diagnostics.py``.  The training forward never writes
the attention probabilities out (flash and the LSH kernels keep scores on
chip), so this module replays the teacher-forced decoder with the same
parameters and the same two-stream residual arithmetic, capturing the
cross-attention softmax of every cross layer.  The replay mirrors
``decode_train``'s input preparation (shift, reduction grouping, autopad,
deterministic prenet) and the deterministic stack (LSH rotations from a
generator seeded 0, consumed layer by layer), and the reversible and plain
stacks compute the same forward.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from rtts_torch.attention.full import _merge_heads, _split_heads, local_heads
from rtts_torch.config import ReformerTTSConfig
from rtts_torch.models import reformer_tts as M
from rtts_torch.models.stack import _check_supported, make_stack_layer_fns
from rtts_torch.ops.flash_attention import MASK_VALUE
from rtts_torch.parallel.collectives import reduce_from_model


def _cross_probs(p, x, memory, memory_mask, num_heads, cdt
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention sublayer ``p`` (ln + attn) with its softmax
    exposed -> (out (B, T, D), probs (B, H, T, L) f32)."""
    h = p.ln(x)
    heads = local_heads(p.attn)
    q = _split_heads(p.attn.w_q(h, cdt), heads)
    k = _split_heads(p.attn.w_k(memory, cdt), heads)
    v = _split_heads(p.attn.w_v(memory, cdt), heads)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * (
        q.shape[-1] ** -0.5)
    if memory_mask is not None:
        logits = logits.masked_fill(~memory_mask[:, None, None, :],
                                    MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
    return p.attn.w_o(_merge_heads(out), cdt), probs


@torch.no_grad()
def decoder_cross_attention(model, cfg: ReformerTTSConfig, tokens,
                            token_mask, mel_target, mel_mask
                            ) -> List[torch.Tensor]:
    """Teacher-forced replay -> per-cross-layer attention probabilities,
    each (B, H, T_groups, L_tokens) float32."""
    return _replay(model, cfg, tokens, token_mask, mel_target, mel_mask)[0]


def _replay(model, cfg: ReformerTTSConfig, tokens, token_mask, mel_target,
            mel_mask):
    cdt = M._dtype(cfg.compute_dtype)
    token_mask = token_mask.bool()
    memory = M.encode(model, cfg, tokens, token_mask)
    mel_input = M.shift_mel(mel_target, cfg.reduction_factor)
    mel_mask = mel_mask.bool()

    # input preparation as decode_train's
    r = cfg.reduction_factor
    if r > 1:
        pad = (-mel_input.shape[1]) % r
        if pad:
            mel_input = F.pad(mel_input, (0, 0, 0, pad))
            mel_mask = F.pad(mel_mask, (0, pad))
        b, tp, n = mel_input.shape
        mel_input = mel_input.reshape(b, tp // r, r * n)
        mel_mask = mel_mask.reshape(b, tp // r, r).any(-1)
    mel_input, mel_mask, orig_g = M._autopad(mel_input, mel_mask,
                                             M._pad_multiple(cfg.decoder))
    dev = mel_input.device
    prenet_gen = (torch.Generator(device=dev).manual_seed(1)
                  if cfg.dec_prenet_dropout > 0.0 else None)
    h = model.dec_prenet(mel_input.to(cdt), cfg.dec_prenet_dropout,
                         prenet_gen, compute_dtype=cdt)
    h = model.dec_pos(h)
    h = h * mel_mask[..., None].to(h.dtype)

    # two-stream replay of the decoder stack, cross probs captured
    dcfg = cfg.decoder
    kinds = _check_supported(dcfg, h.shape[1], capture=True)
    layer_fns = make_stack_layer_fns(dcfg, True, cdt)
    hash_gen = (torch.Generator(device=dev).manual_seed(0)
                if "lsh" in kinds else None)
    h1 = h2 = h.float()
    probs_out: List[torch.Tensor] = []
    for i, ((f, g), p) in enumerate(zip(layer_fns, model.decoder.layers)):
        aux = {"mask": mel_mask, "memory_mask": token_mask,
               "generator": None, "hash_generator": hash_gen, "seed": None,
               "gen_states": [None] * 3}
        if i % 2 == 1:  # cross pair: capture probabilities
            out, probs = _cross_probs(p.f, h2, memory, token_mask,
                                      dcfg.attention.num_heads, cdt)
            probs_out.append(probs[:, :, :orig_g])
            h1 = h1 + out
        else:
            h1 = h1 + f(p.f, h2, memory, aux, None)[0]
        h2 = h2 + g(p.g, h1, memory, aux)
    y = model.decoder.final_ln((h1 + h2) * 0.5)
    return probs_out, y[:, :orig_g]


def alignment_map(model, cfg: ReformerTTSConfig, tokens, token_mask,
                  mel_target, mel_mask, layer: int = -1) -> torch.Tensor:
    """Head-averaged cross-attention of one layer -> (B, T_groups, L).  A
    tensor-parallel shard averages over every head of the block (its
    heads' sum, summed over the model group)."""
    probs = decoder_cross_attention(model, cfg, tokens, token_mask,
                                    mel_target, mel_mask)
    attn = model.decoder.layers[1].f.attn
    tp = attn.w_o.tp
    if tp is None:
        return probs[layer].mean(dim=1)
    return reduce_from_model(probs[layer].sum(dim=1), tp[1]) / attn.num_heads
