"""Independent torch reimplementation of the rtts model math — the
cross-framework oracle for the FULL model (VERDICT r2 item 2; SURVEY.md
§5.3 item 4).

These modules re-derive every formula (Transformer-TTS heads per SURVEY.md
§3.1 #8, WaveGlow-lineage WN per §3.1 #11, shared-QK attention per §3.2)
directly in torch.nn.functional, consuming the SAME parameter pytrees rtts
produces (jnp arrays -> numpy -> torch).  Any jax-vs-torch discrepancy in
conv/LN/softmax/masking semantics shows up as a parity failure.

Everything runs float32 CPU, deterministic (all dropout rates must be 0 in
the configs used with this twin).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

MASK_VALUE = -1e9
SELF_MASK_VALUE = -1e5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for a test module that imports this fixture: the
    suite runs several workers on a few cores, and torch's default of one
    thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _ti(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.int64))


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def dense(p, x):
    y = x @ _t(p["w"])
    if "b" in p:
        y = y + _t(p["b"])
    return y


def layer_norm(p, x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), _t(p["scale"]), _t(p["bias"]), eps)


def conv1d(p, x, groups=1, weight=None):
    """x (B, T, Cin) -> (B, T, Cout); rtts weight layout (K, Cin/g, Cout),
    SAME padding (odd kernels only)."""
    w = _t(p["w"]) if weight is None else weight
    k = w.shape[0]
    assert k % 2 == 1, "twin supports odd kernels (SAME padding)"
    w_t = w.permute(2, 1, 0)                       # (Cout, Cin/g, K)
    y = F.conv1d(x.transpose(1, 2), w_t, padding=k // 2, groups=groups)
    y = y.transpose(1, 2)
    if "b" in p:
        y = y + _t(p["b"])
    return y


def gelu(x):
    # rtts uses jax.nn.gelu's default tanh approximation
    return F.gelu(x, approximate="tanh")


def len_norm(x, eps=1e-6):
    var = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps)


def split_heads(x, h):
    b, l, d = x.shape
    return x.reshape(b, l, h, d // h).permute(0, 2, 1, 3)


def merge_heads(x):
    b, h, l, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, l, h * d)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def shared_qk_self_attention(p, x, mask, causal, num_heads):
    qk = split_heads(dense(p["w_qk"], x), num_heads)
    v = split_heads(dense(p["w_v"], x), num_heads)
    d = qk.shape[-1]
    q = qk
    k = len_norm(qk) * (d ** -0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k)
    L = x.shape[1]
    pos = torch.arange(L)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :], scores,
                             torch.tensor(MASK_VALUE))
    if causal:
        scores = torch.where(pos[:, None] >= pos[None, :], scores,
                             torch.tensor(MASK_VALUE))
    scores = torch.where(pos[:, None] == pos[None, :],
                         torch.tensor(SELF_MASK_VALUE), scores)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return dense(p["w_o"], merge_heads(out))


def cross_attention(p, x, memory, memory_mask, num_heads):
    q = split_heads(dense(p["w_q"], x), num_heads)
    k = split_heads(dense(p["w_k"], memory), num_heads)
    v = split_heads(dense(p["w_v"], memory), num_heads)
    d = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * (d ** -0.5)
    if memory_mask is not None:
        logits = torch.where(memory_mask[:, None, None, :], logits,
                             torch.tensor(MASK_VALUE))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return dense(p["w_o"], merge_heads(out))


def ffn(p, x, act="gelu"):
    h = layer_norm(p["ln"], x)
    h = gelu(dense(p["w_in"], h))
    return dense(p["w_out"], h)


# ---------------------------------------------------------------------------
# stacks (plain-residual twin of the reversible two-stream scheme:
# identical math when deterministic — rtts tests pin rev == plain)
# ---------------------------------------------------------------------------


def stack_apply(p, cfg_stack, x, mask, memory=None, memory_mask=None):
    cross_attend = memory is not None
    num_heads = cfg_stack.attention.num_heads
    h1 = h2 = x.to(torch.float32)
    li = 0
    for _ in range(cfg_stack.num_layers):
        lp = p["layers"][li]
        h = layer_norm(lp["f"]["ln"], h2)
        h1 = h1 + shared_qk_self_attention(lp["f"]["attn"], h, mask,
                                           cfg_stack.causal, num_heads)
        h2 = h2 + ffn(lp["g"], h1, cfg_stack.ffn_activation)
        li += 1
        if cross_attend:
            lp = p["layers"][li]
            h = layer_norm(lp["f"]["ln"], h2)
            h1 = h1 + cross_attention(lp["f"]["attn"], h, memory,
                                      memory_mask, num_heads)
            h2 = h2 + ffn(lp["g"], h1, cfg_stack.ffn_activation)
            li += 1
    y = (h1 + h2) * 0.5
    return layer_norm(p["final_ln"], y)


# ---------------------------------------------------------------------------
# full TTS model (teacher-forced)
# ---------------------------------------------------------------------------


def scaled_posenc(p, x):
    L = x.shape[-2]
    return x + _t(p["alpha"]) * _t(p["table"])[:L]


def encoder_prenet(p, x, mask=None):
    # mask contract mirrors rtts encoder_prenet: zero pads before the first
    # conv and at the end of every layer, so convs never see pad content
    m = None if mask is None else mask[..., None].to(x.dtype)
    if m is not None:
        x = x * m
    for layer in p:
        x = conv1d(layer["conv"], x)
        x = layer_norm(layer["ln"], x)
        x = torch.relu(x)
        if m is not None:
            x = x * m
    return x


def postnet(p, mel, mask=None):
    # mirrors rtts postnet_apply's frame_mask
    h = mel
    m = None if mask is None else mask[..., None].to(mel.dtype)
    if m is not None:
        h = h * m
    n = len(p)
    for i, layer in enumerate(p):
        h = conv1d(layer["conv"], h)
        if i < n - 1:
            h = layer_norm(layer["ln"], h)
            h = torch.tanh(h)
        if m is not None:
            h = h * m
    return h


def prenet_mlp(p, x):
    h = torch.relu(dense(p["fc1"], x))
    return torch.relu(dense(p["fc2"], h))


def tts_forward(params, cfg, tokens, token_mask, mel_target, mel_mask):
    """Teacher-forced forward matching rtts.models.reformer_tts.forward
    (deterministic, reduction_factor 1, scaled_sinusoidal, kind=full with
    L <= chunk so the shared-QK fallback engages).

    params: the rtts pytree (converted leaf-wise); tokens/masks/mel: numpy.
    Returns (mel_pre, mel_post, stop_logits) torch tensors.
    """
    assert cfg.reduction_factor == 1
    tokens = _ti(tokens)
    token_mask = torch.from_numpy(np.asarray(token_mask, bool))
    mel_mask_t = torch.from_numpy(np.asarray(mel_mask, bool))

    # encoder
    h = _t(params["embed"]["table"])[tokens]
    h = encoder_prenet(params["enc_prenet"], h, token_mask)
    h = scaled_posenc(params["enc_pos"], h)
    h = h * token_mask[..., None].to(h.dtype)
    memory = stack_apply(params["encoder"], cfg.encoder, h, token_mask)

    # teacher-forced decoder (shift_mel)
    mel_t = _t(mel_target)
    go = torch.zeros_like(mel_t[:, :1])
    mel_in = torch.cat([go, mel_t[:, :-1]], dim=1)
    h = prenet_mlp(params["dec_prenet"], mel_in)
    h = scaled_posenc(params["dec_pos"], h)
    h = h * mel_mask_t[..., None].to(h.dtype)
    h = stack_apply(params["decoder"], cfg.decoder, h, mel_mask_t,
                    memory=memory, memory_mask=token_mask)
    mel_pre = dense(params["mel_head"], h)
    stop_logits = dense(params["stop_head"], h)[..., 0]
    mel_post = mel_pre + postnet(params["postnet"], mel_pre, mel_mask_t)
    return mel_pre, mel_post, stop_logits


# ---------------------------------------------------------------------------
# SqueezeWave twin
# ---------------------------------------------------------------------------


def _wn_weight(p):
    v = _t(p["v"])
    norm = torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True) + 1e-12)
    return _t(p["g"])[None, None, :] * v / norm


def wn_conv(p, x, groups=1):
    return conv1d({"b": p["b"]}, x, groups=groups, weight=_wn_weight(p))


def wn_apply(wn, audio_half, mel_up, n_layers, wn_channels):
    h = wn_conv(wn["in"], audio_half)
    cond_all = wn_conv(wn["cond"], mel_up)
    skip_total = None
    for i in range(n_layers):
        d = wn_conv(wn["depth"][i], h, groups=wn_channels)
        a = wn_conv(wn["point"][i], d)
        cond = cond_all[..., i * 2 * wn_channels:(i + 1) * 2 * wn_channels]
        a = a + cond
        acts = torch.tanh(a[..., :wn_channels]) * torch.sigmoid(a[..., wn_channels:])
        rs = wn_conv(wn["res_skip"][i], acts)
        if i < n_layers - 1:
            h = h + rs
        skip_total = rs if skip_total is None else skip_total + rs
    return conv1d(wn["end"], skip_total)


def _channel_schedule(cfg):
    n_rem = cfg.n_group
    sched = []
    for k in range(cfg.n_flows):
        early = k % cfg.n_early_every == 0 and k > 0
        if early:
            n_rem -= cfg.n_early_size
        sched.append((n_rem, early))
    return sched


def squeezewave_forward(params, cfg, mel, audio):
    """(mel (B,M,n_mels), audio (B,T)) -> (z, log_s_list, log_det_list)."""
    mel = _t(mel)
    audio = _t(audio)
    b, t = audio.shape
    x = audio.reshape(b, t // cfg.n_group, cfg.n_group)
    l = x.shape[1]
    r = l // mel.shape[1]
    mel_up = mel.repeat_interleave(r, dim=1)

    z_out, log_s_list, log_det_list = [], [], []
    for k, (n_rem, early) in enumerate(_channel_schedule(cfg)):
        if early:
            z_out.append(x[..., : cfg.n_early_size])
            x = x[..., cfg.n_early_size:]
        fp = params["flows"][k]
        w = _t(fp["inv1x1"]["w_1x1"])
        x = x @ w
        log_det_list.append(l * torch.slogdet(w)[1])
        n_half = n_rem // 2
        a0, a1 = x[..., :n_half], x[..., n_half:]
        st = wn_apply(fp["wn"], a0, mel_up, cfg.wn_layers, cfg.wn_channels)
        log_s, tt = st[..., :n_half], st[..., n_half:]
        a1 = a1 * torch.exp(log_s) + tt
        log_s_list.append(log_s)
        x = torch.cat([a0, a1], dim=-1)
    z_out.append(x)
    return torch.cat(z_out, dim=-1), log_s_list, log_det_list


def squeezewave_infer(params, cfg, mel, z):
    """Inverse pass with an externally supplied z (matches rtts
    _infer_chunk fed the same noise)."""
    mel = _t(mel)
    z = _t(z)
    b, mc, _ = mel.shape
    l = mc * (cfg.hop_length // cfg.n_group)
    r = l // mc
    mel_up = mel.repeat_interleave(r, dim=1)
    sched = _channel_schedule(cfg)
    n_final = sched[-1][0]
    n_early_total = cfg.n_group - n_final
    x = z[..., n_early_total:]
    early_chunks = [
        z[..., i * cfg.n_early_size:(i + 1) * cfg.n_early_size]
        for i in range(n_early_total // cfg.n_early_size)
    ]
    for k in range(cfg.n_flows - 1, -1, -1):
        n_rem, early = sched[k]
        fp = params["flows"][k]
        n_half = n_rem // 2
        a0, a1 = x[..., :n_half], x[..., n_half:]
        st = wn_apply(fp["wn"], a0, mel_up, cfg.wn_layers, cfg.wn_channels)
        log_s, tt = st[..., :n_half], st[..., n_half:]
        a1 = (a1 - tt) * torch.exp(-log_s)
        x = torch.cat([a0, a1], dim=-1)
        w_inv = torch.inverse(_t(fp["inv1x1"]["w_1x1"]))
        x = x @ w_inv
        if early:
            x = torch.cat([early_chunks.pop(), x], dim=-1)
    return x.reshape(b, -1)
