"""SqueezeWave flow vocoder: training (audio -> z) and inference
(mel -> waveform).

Port of ``rtts/models/squeezewave.py``.  Audio is squeezed into
``n_group`` channels (L = samples / n_group); each flow's WN runs a
pointwise in-conv, ``wn_layers`` x [depthwise conv (kernel K2) -> pointwise
conv -> gated tanh/sigmoid unit conditioned on the upsampled mel ->
residual/skip], and an end conv giving (log_s, t).  ``forward`` runs the
flows on audio for the NLL (the 1x1's log-determinant by
``torch.linalg.slogdet`` on the weight's device); inference inverts the
affine couplings and the invertible 1x1 convs on Gaussian noise z.

On the card the depthwise stage always runs K2: the reference's
``SqueezeWaveConfig.use_pallas`` is never read, and on a TPU ``wn_conv``
always sent that stage to its Pallas kernel.  Layout is NTC throughout and
conv weights keep the JAX layout (K, C_in/groups, C_out).

Weight-normalized convs hold {v, g, b} (w = g * v / ||v||) until
``fold_weightnorm`` bakes them into {w, b} and precomputes the 1x1 inverses.
"""

from __future__ import annotations

import copy
import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from rtts_torch.config import SqueezeWaveConfig
from rtts_torch.models.reformer_tts import _dtype, cast_params
from rtts_torch.nn.conv import conv1d
from rtts_torch.nn.layers import normal, sigmoid
from rtts_torch.ops.depthwise_conv import depthwise_conv1d


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True) + 1e-12)


class WNConv(nn.Module):
    """A conv in weight-norm form {v, g, b} or folded form {w, b}."""

    def __init__(self, d_in: int, d_out: int, kernel: int, groups: int = 1, *,
                 generator=None, device=None, zero: bool = False):
        super().__init__()
        self.groups = groups
        shape = (kernel, d_in // groups, d_out)
        self.b = nn.Parameter(torch.zeros(d_out, device=device))
        if zero:    # a plain conv that starts at zero ("end")
            self.w = nn.Parameter(torch.zeros(shape, device=device))
            return
        v = normal(shape, generator, device,
                   1.0 / math.sqrt((d_in // groups) * kernel))
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(_norm(v)[0, 0])

    @property
    def folded(self) -> bool:
        return "w" in self._parameters

    def weight(self) -> torch.Tensor:
        if self.folded:
            return self.w
        return self.g[None, None, :] * self.v / _norm(self.v)

    @torch.no_grad()
    def fold(self) -> None:
        if not self.folded:
            w = self.weight()
            del self.v, self.g
            self.w = nn.Parameter(w)


class Inv1x1(nn.Module):
    """Invertible 1x1 conv {w_1x1}; folding adds its inverse {w_1x1_inv}."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w_1x1 = nn.Parameter(w)

    @torch.no_grad()
    def fold(self) -> None:
        if "w_1x1_inv" not in self._parameters:
            inv = torch.linalg.inv(self.w_1x1.float()).to(self.w_1x1.dtype)
            self.w_1x1_inv = nn.Parameter(inv)


class WN(nn.Module):
    def __init__(self, cfg: SqueezeWaveConfig, n_half: int, *, generator=None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        c, n = cfg.wn_channels, cfg.wn_layers
        # "in" is a Python keyword: registered by name, read via getattr
        self.add_module("in", WNConv(n_half, c, 1, **kw))
        self.cond = WNConv(cfg.n_mels, 2 * c * n, 1, **kw)
        self.depth = nn.ModuleList(
            WNConv(c, c, cfg.wn_kernel_size, groups=c, **kw) for _ in range(n))
        self.point = nn.ModuleList(WNConv(c, 2 * c, 1, **kw) for _ in range(n))
        self.res_skip = nn.ModuleList(WNConv(c, c, 1, **kw) for _ in range(n))
        # zero-initialized end conv: flows start as the identity
        self.end = WNConv(c, 2 * n_half, 1, device=device, zero=True)


class Flow(nn.Module):
    def __init__(self, cfg: SqueezeWaveConfig, n_rem: int, *, generator=None,
                 device=None):
        super().__init__()
        # random orthogonal 1x1 with det +1 (flip one column if needed)
        q, _ = torch.linalg.qr(torch.randn(n_rem, n_rem, generator=generator,
                                           dtype=torch.float64))
        if torch.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        self.inv1x1 = Inv1x1(q.float().to(device))
        self.wn = WN(cfg, n_rem // 2, generator=generator, device=device)


class SqueezeWave(nn.Module):
    def __init__(self, cfg: SqueezeWaveConfig, *, generator=None, device=None):
        super().__init__()
        self.flows = nn.ModuleList(
            Flow(cfg, n_rem, generator=generator, device=device)
            for n_rem, _ in _channel_schedule(cfg))


def init(cfg: SqueezeWaveConfig, generator: Optional[torch.Generator] = None,
         device="cuda") -> SqueezeWave:
    """Random vocoder parameters (weight-norm form) drawn from ``generator``,
    on ``device``: the card unless the caller asks for another (without a
    card the default raises), in ``cfg.param_dtype``."""
    return cast_params(SqueezeWave(cfg, generator=generator, device=device),
                       cfg.param_dtype)


def fold_weightnorm(model: SqueezeWave) -> SqueezeWave:
    """A copy with w = g*v/||v|| baked into plain weights and the 1x1
    inverses precomputed: the inference-time checkpoint transform."""
    model = copy.deepcopy(model)
    for m in model.modules():
        if isinstance(m, (WNConv, Inv1x1)):
            m.fold()
    return model


def is_folded(model: SqueezeWave) -> bool:
    return all(m.folded if isinstance(m, WNConv)
               else "w_1x1_inv" in m._parameters
               for m in model.modules() if isinstance(m, (WNConv, Inv1x1)))


def ensure_folded(model: SqueezeWave) -> SqueezeWave:
    """Fold at load; identity for an already folded model."""
    return model if is_folded(model) else fold_weightnorm(model)


def _channel_schedule(cfg: SqueezeWaveConfig) -> List[Tuple[int, bool]]:
    """Per-flow (n_remaining_channels, emit_early_before_this_flow)."""
    n_rem = cfg.n_group
    sched = []
    for k in range(cfg.n_flows):
        early = k % cfg.n_early_every == 0 and k > 0
        if early:
            n_rem -= cfg.n_early_size
        sched.append((n_rem, early))
    return sched


def squeeze_audio(audio: torch.Tensor, n_group: int) -> torch.Tensor:
    """(B, T) -> (B, L, n_group)"""
    b, t = audio.shape
    if t % n_group != 0:
        raise ValueError(f"audio length {t} not divisible by n_group "
                         f"{n_group}")
    return audio.reshape(b, t // n_group, n_group)


def unsqueeze_audio(x: torch.Tensor) -> torch.Tensor:
    """(B, L, n_group) -> (B, L * n_group)"""
    return x.reshape(x.shape[0], -1)


def upsample_mel(mel: torch.Tensor, target_len: int) -> torch.Tensor:
    """(B, M, n_mels) -> (B, target_len, n_mels) by frame repetition."""
    m = mel.shape[1]
    if target_len % m != 0:
        raise ValueError(f"squeezed length {target_len} not a multiple of "
                         f"mel frames {m}")
    return torch.repeat_interleave(mel, target_len // m, dim=1)


def _bound_log_s(log_s: torch.Tensor, clamp: float) -> torch.Tensor:
    """clamp * tanh(log_s / clamp); clamp <= 0 disables."""
    if clamp <= 0:
        return log_s
    return clamp * torch.tanh(log_s / clamp)


def wn_conv(p: WNConv, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    w = p.weight()
    if p.groups > 1 and p.groups == x.shape[-1] and w.shape[0] > 1:
        # the depthwise stage: K2 on the card, its plain version on the CPU;
        # both round the f32 w and b to x's dtype themselves, so no cast
        # runs here
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        return depthwise_conv1d(x, w, p.b)
    return conv1d(x, w, p.b, p.groups, compute_dtype)


def wn_apply(wn: WN, audio_half: torch.Tensor, mel_up: torch.Tensor,
             n_layers: int, wn_channels: int, compute_dtype=None) -> torch.Tensor:
    """(B, L, n_half), (B, L, n_mels) -> (B, L, 2*n_half) = [log_s | t]."""
    c = wn_channels
    h = wn_conv(getattr(wn, "in"), audio_half, compute_dtype)
    cond_all = wn_conv(wn.cond, mel_up, compute_dtype)
    skip_total = None
    for i in range(n_layers):
        d = wn_conv(wn.depth[i], h, compute_dtype)
        a = wn_conv(wn.point[i], d, compute_dtype)
        a = a + cond_all[..., i * 2 * c:(i + 1) * 2 * c]
        acts = torch.tanh(a[..., :c]) * sigmoid(a[..., c:])
        rs = wn_conv(wn.res_skip[i], acts, compute_dtype)
        if i < n_layers - 1:
            h = h + rs
        skip_total = rs if skip_total is None else skip_total + rs
    return wn_conv(wn.end, skip_total, compute_dtype)


def forward(model: SqueezeWave, cfg: SqueezeWaveConfig, mel: torch.Tensor,
            audio: torch.Tensor, compute_dtype=None
            ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """mel (B, M, n_mels), audio (B, T) -> (z (B, L, n_group), the per-flow
    bounded log_s, the per-flow L * log|det W|).  T must equal M *
    hop_length.  The 1x1 convs, the coupling and z stay f32; the WN runs in
    the compute dtype."""
    cdt = compute_dtype or _dtype(cfg.compute_dtype)
    x = squeeze_audio(audio, cfg.n_group).float()
    l = x.shape[1]
    mel_up = upsample_mel(mel, l).to(cdt)
    z_out: List[torch.Tensor] = []
    log_s_list: List[torch.Tensor] = []
    log_det_list: List[torch.Tensor] = []
    for k, (n_rem, early) in enumerate(_channel_schedule(cfg)):
        if early:
            z_out.append(x[..., :cfg.n_early_size])
            x = x[..., cfg.n_early_size:]
        fp = model.flows[k]
        w = fp.inv1x1.w_1x1.float()
        x = x @ w
        log_det_list.append(l * torch.linalg.slogdet(w).logabsdet)
        n_half = n_rem // 2
        a0, a1 = x[..., :n_half], x[..., n_half:]
        st = wn_apply(fp.wn, a0.to(cdt), mel_up, cfg.wn_layers,
                      cfg.wn_channels, cdt).float()
        log_s = _bound_log_s(st[..., :n_half], cfg.log_s_clamp)
        a1 = a1 * torch.exp(log_s) + st[..., n_half:]
        log_s_list.append(log_s)
        x = torch.cat([a0, a1], dim=-1)
    z_out.append(x)
    return torch.cat(z_out, dim=-1), log_s_list, log_det_list


@torch.no_grad()
def _infer_chunk(model: SqueezeWave, mel_c: torch.Tensor, z_c: torch.Tensor, *,
                 cfg: SqueezeWaveConfig) -> torch.Tensor:
    """Inverse flow pass with an externally supplied z (B, L, n_group)."""
    cdt = _dtype(cfg.compute_dtype)
    l = mel_c.shape[1] * (cfg.hop_length // cfg.n_group)
    mel_up = upsample_mel(mel_c, l).to(cdt)
    sched = _channel_schedule(cfg)
    n_early_total = cfg.n_group - sched[-1][0]
    x = z_c[..., n_early_total:]
    early_chunks = [
        z_c[..., i * cfg.n_early_size:(i + 1) * cfg.n_early_size]
        for i in range(n_early_total // cfg.n_early_size)
    ]
    for k in range(cfg.n_flows - 1, -1, -1):
        n_rem, early = sched[k]
        fp = model.flows[k]
        n_half = n_rem // 2
        a0, a1 = x[..., :n_half], x[..., n_half:]
        st = wn_apply(fp.wn, a0.to(cdt), mel_up, cfg.wn_layers,
                      cfg.wn_channels, cdt).float()
        log_s = _bound_log_s(st[..., :n_half], cfg.log_s_clamp)
        a1 = (a1 - st[..., n_half:]) * torch.exp(-log_s)
        x = torch.cat([a0, a1], dim=-1)
        inv = fp.inv1x1
        w_inv = (inv.w_1x1_inv if "w_1x1_inv" in inv._parameters
                 else torch.linalg.inv(inv.w_1x1.float()))
        x = x @ w_inv.float()
        if early:
            x = torch.cat([early_chunks.pop(), x], dim=-1)
    return unsqueeze_audio(x)


def infer(model: SqueezeWave, cfg: SqueezeWaveConfig, mel: torch.Tensor,
          sigma: Optional[float] = None,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """mel (B, M, n_mels) -> audio (B, M * hop_length): the flows run in
    reverse on z ~ N(0, sigma^2), drawn from ``generator`` on mel's device."""
    if sigma is None:
        sigma = cfg.sigma
    b, m, _ = mel.shape
    l = m * cfg.hop_length // cfg.n_group
    z = torch.randn((b, l, cfg.n_group), generator=generator,
                    device=mel.device) * sigma
    return _infer_chunk(model, mel, z, cfg=cfg)


# -- streaming inference (chunked, fused behind the AR decoder) ----------------


def receptive_field_squeezed(cfg: SqueezeWaveConfig) -> int:
    """One-sided receptive field of the flow stack in squeezed samples: only
    the depthwise convs mix time (the 1x1s and the coupling are pointwise),
    ``wn_layers`` of them per flow, ``n_flows`` flows in sequence.  Each
    reaches k // 2 (SAME padding reaches (k-1)//2 left and k//2 right, in
    K2 and its plain version alike, so k // 2 covers both sides)."""
    return cfg.n_flows * cfg.wn_layers * (cfg.wn_kernel_size // 2)


def infer_streaming(model: SqueezeWave, cfg: SqueezeWaveConfig,
                    mel: torch.Tensor, sigma: Optional[float] = None,
                    generator: Optional[torch.Generator] = None,
                    chunk_frames: int = 64) -> torch.Tensor:
    """Chunked mel -> audio, ``chunk_frames`` mel frames at a time, each
    window widened by the receptive field so that the kept samples are the
    single pass's.  z is drawn once for the whole utterance, by the same
    single ``torch.randn`` call as ``infer``, so both see the same noise
    from one generator state; each window goes through ``_infer_chunk``
    (K2 on the card)."""
    if sigma is None:
        sigma = cfg.sigma
    b, m, _ = mel.shape
    per_frame = cfg.hop_length // cfg.n_group     # squeezed samples a frame
    if per_frame < 1 or cfg.hop_length % cfg.n_group:
        raise ValueError("hop_length must be a positive multiple of n_group")
    if chunk_frames < 1:
        raise ValueError(f"chunk_frames must be positive, got {chunk_frames}")
    ctx = -(-receptive_field_squeezed(cfg) // per_frame)   # frames
    z = torch.randn((b, m * per_frame, cfg.n_group), generator=generator,
                    device=mel.device) * sigma
    outs = []
    for start in range(0, m, chunk_frames):
        end = min(start + chunk_frames, m)
        lo, hi = max(0, start - ctx), min(m, end + ctx)
        audio = _infer_chunk(model, mel[:, lo:hi],
                             z[:, lo * per_frame:hi * per_frame], cfg=cfg)
        keep = (start - lo) * cfg.hop_length
        outs.append(audio[:, keep:keep + (end - start) * cfg.hop_length])
    return torch.cat(outs, dim=1)
