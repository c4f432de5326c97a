"""Repairs of the port's open faults against the reference, on the CPU.

- ``kv_cache_dtype``: the reference stores the decode caches in e4m3 when
  asked; the port once ignored the knob, then refused it.  It now stores
  them in e4m3 or a 16-bit dtype as the reference does (parity in
  ``tests/test_torch_decode_modes.py``), and ``decode_greedy`` and
  ``Synthesizer`` still refuse e5m2, which the reference's ``_dtype`` has
  no entry for.
- ``param_dtype``: the reference builds its parameters in that dtype; the
  port builds float32 only, so both ``init`` functions refuse the rest.
- K2's gradient: ``depthwise_conv1d`` is an ``autograd.Function`` whose
  backward is autograd of the plain f32 conv, as the reference's
  ``custom_vjp``; its CPU gradients are held against the JAX vjp of
  ``depthwise_conv1d_pallas`` in Pallas interpret mode.  And the vocoder's
  depthwise stage hands K2 its float32 weight and bias as stored, so no
  cast runs before it.
- ``save_config`` without PyYAML (the card's machine has none): the
  trainers write ``config.yaml`` first, so both failed to start there; it
  now always writes YAML's flow style itself, which both packages read
  back to the same tree.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtts.ops.depthwise_conv import depthwise_conv1d_pallas
from rtts_torch.config import Config, ReformerTTSConfig, SqueezeWaveConfig
from rtts_torch.infer.decode import _kv_dtype, decode_greedy
from rtts_torch.infer.synthesize import Synthesizer
from rtts_torch.models import reformer_tts as TM
from rtts_torch.models import squeezewave as TS
from rtts_torch.ops import depthwise_conv as DW

ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent

# f32 on both sides at "highest" precision: conv gradients summed in
# another order (~1e-7 relative)
TOL = 1e-5


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2",
                                  "bfloat16"])
def test_decode_and_synthesizer_refuse_unported_kv_cache_dtypes(name):
    """e4m3 and bf16 decode and serve; e5m2 raises in both."""
    from rtts.config import to_dict
    from rtts_torch.config import from_dict
    from tests.test_model_m1 import tiny_cfg

    model_cfg = from_dict(ReformerTTSConfig, dict(
        to_dict(tiny_cfg(d=32)), kv_cache_dtype=name))
    cfg = dataclasses.replace(Config(), model=model_cfg)
    memory = torch.zeros(1, 4, model_cfg.d_model)
    mask = torch.ones(1, 4, dtype=bool)
    if name == "float8_e5m2":
        with pytest.raises(KeyError, match="kv_cache_dtype"):
            decode_greedy(None, model_cfg, memory, mask, max_frames=4)
        with pytest.raises(KeyError, match="kv_cache_dtype"):
            Synthesizer(cfg, None)
        return
    tm = TM.init(model_cfg, torch.Generator().manual_seed(0), "cpu")
    out = decode_greedy(tm, model_cfg, memory, mask, max_frames=4,
                        stop_threshold=2.0)
    assert out.mel_post.shape == (1, 4, model_cfg.n_mels)
    assert bool(torch.isfinite(out.mel_post).all())
    assert Synthesizer(cfg, tm).tts is tm


@pytest.mark.parametrize("name", ["compute", None, ""])
def test_kv_cache_dtype_compute_is_accepted(name):
    for cdt in (torch.float32, torch.bfloat16):
        assert _kv_dtype(dataclasses.replace(ReformerTTSConfig(),
                                             kv_cache_dtype=name),
                         cdt) is cdt


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_inits_refuse_unported_param_dtypes(name):
    with pytest.raises(NotImplementedError, match="param_dtype"):
        TM.init(ReformerTTSConfig(vocab_size=40, param_dtype=name),
                torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="param_dtype"):
        TS.init(SqueezeWaveConfig(param_dtype=name),
                torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("taps", [3, 4])
def test_depthwise_function_grads_match_jax_vjp(taps):
    rng = np.random.default_rng(taps)
    b, l, c = 2, 64, 16
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    w = rng.standard_normal((taps, 1, c)).astype(np.float32)
    bias = rng.standard_normal((c,)).astype(np.float32)
    ct = rng.standard_normal((b, l, c)).astype(np.float32)
    want_y, vjp = jax.vjp(
        lambda x, w, bias: depthwise_conv1d_pallas(x, w, bias,
                                                   interpret=True),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    wants = vjp(jnp.asarray(ct))
    xt, wt, bt = (torch.from_numpy(t).requires_grad_() for t in (x, w, bias))
    y = DW.depthwise_conv1d(xt, wt, bt)
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               atol=TOL, rtol=0)
    for got, want in zip((xt.grad, wt.grad, bt.grad), wants):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL * scale,
                                   rtol=0)


def test_depthwise_function_rounds_f32_params_to_x_dtype():
    """bf16 x with f32 w and b: the forward is the conv of the rounded
    parameters (what casting them first gave), and the gradients come back
    in each input's dtype, w's and b's unrounded."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 33, 8, generator=g).bfloat16().requires_grad_()
    w = torch.randn(3, 1, 8, generator=g).requires_grad_()
    b = torch.randn(8, generator=g).requires_grad_()
    y = DW.depthwise_conv1d(x, w, b)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, DW.depthwise_conv1d_reference(
        x, w.bfloat16(), b.bfloat16()))
    dy = torch.randn(y.shape, generator=g).bfloat16()
    y.backward(dy)
    assert (x.grad.dtype, w.grad.dtype, b.grad.dtype) == (
        torch.bfloat16, torch.float32, torch.float32)
    # dw[k] = sum over (batch, t) of x[t + k - 1] dy[t], zero padded
    xp = torch.nn.functional.pad(x.detach().float(), (0, 0, 1, 1))
    want_w = torch.stack([(xp[:, k:k + 33] * dy.float()).sum((0, 1))
                          for k in range(3)])[:, None, :]
    torch.testing.assert_close(w.grad, want_w, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b.grad, dy.float().sum((0, 1)))


def test_wn_conv_hands_k2_the_stored_f32_weight_and_bias(monkeypatch):
    """The depthwise stage of a bf16 vocoder passes the folded f32 weight
    and bias themselves (no cast launches); the result equals the old
    cast-first call."""
    cfg = SqueezeWaveConfig(n_mels=8, n_flows=1, n_group=8, n_early_every=4,
                            n_early_size=2, wn_layers=1, wn_channels=16)
    model = TS.fold_weightnorm(TS.init(cfg, torch.Generator().manual_seed(1),
                                       "cpu"))
    p = model.flows[0].wn.depth[0]
    seen = []

    def spy(x, w, b):
        seen.append((x.dtype, w, b))
        return DW.depthwise_conv1d(x, w, b)

    monkeypatch.setattr(TS, "depthwise_conv1d", spy)
    x = torch.randn(2, 20, 16, generator=torch.Generator().manual_seed(2))
    got = TS.wn_conv(p, x, torch.bfloat16)
    (x_dtype, w, b), = seen
    assert x_dtype == torch.bfloat16
    assert w is p.w and b is p.b and w.dtype == b.dtype == torch.float32
    want = DW.depthwise_conv1d_reference(
        x.bfloat16(), p.w.bfloat16(), p.b.bfloat16())
    assert torch.equal(got, want)


def test_vocoder_depth_weights_get_a_gradient_on_the_cpu():
    """A backward through one WN (weight-norm form, "end" made live) gives
    every depth stage's v, g and b a nonzero gradient."""
    cfg = SqueezeWaveConfig(n_mels=8, n_flows=1, n_group=8, n_early_every=4,
                            n_early_size=2, wn_layers=2, wn_channels=16,
                            compute_dtype="float32")
    model = TS.init(cfg, torch.Generator().manual_seed(3), "cpu")
    wn = model.flows[0].wn
    with torch.no_grad():
        wn.end.w.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    out = TS.wn_apply(wn, torch.randn(2, 24, 4, generator=g),
                      torch.randn(2, 24, 8, generator=g), 2, 16)
    out.square().sum().backward()
    for depth in wn.depth:
        for t in (depth.v, depth.g, depth.b):
            assert t.grad is not None and bool(t.grad.abs().sum() > 0)


@pytest.mark.parametrize("name", ["base.yaml", "flagship.yaml",
                                  "longform_8k.yaml"])
def test_save_config_without_pyyaml_reads_back(tmp_path, monkeypatch, name):
    import sys

    from rtts.config import load_config as jax_load_config
    from rtts_torch.config import load_config, load_yaml, save_config, to_dict

    cfg = load_config(str(ROOT / "configs" / name))
    monkeypatch.setitem(sys.modules, "yaml", None)   # import yaml raises
    save_config(cfg, tmp_path / "config.yaml")
    with pytest.raises(ImportError):
        load_yaml(tmp_path / "config.yaml")
    monkeypatch.undo()
    # the tree as YAML gives it back: lists where to_dict has tuples
    assert load_yaml(tmp_path / "config.yaml") == \
        json.loads(json.dumps(to_dict(cfg)))
    assert load_config(str(tmp_path / "config.yaml")) == cfg
    assert jax_load_config(str(tmp_path / "config.yaml")) == \
        jax_load_config(str(ROOT / "configs" / name))
