"""rtts_torch modules against their rtts (JAX) counterparts, at small size.

One parameter tree, made by the JAX package's own init, is loaded into the
port through the bridge (``rtts_torch.convert.from_numpy_tree``); the same
numpy inputs go through both.  Everything runs in float32 on the CPU; the
JAX side runs at "highest" matmul precision (tests/conftest.py) and its
flash kernel in Pallas interpret mode.  Tolerance: 1e-5 max abs error for
single modules (summation order only), 1e-4 for whole stacks and the
vocoder, whose outputs reach magnitudes ~5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtts.attention import full as jfull
from rtts.config import SqueezeWaveConfig
from rtts.models import reformer_tts as JM
from rtts.models import squeezewave as JS
from rtts.models.stack import stack_apply as jax_stack_apply
from rtts.nn import conv as jconv
from rtts.nn import layers as jlayers
from rtts.nn import posenc as jposenc
from rtts.reversible.ffn import _ffn_body as jax_ffn_body
from rtts_torch.attention import full as tfull
from rtts_torch.convert import from_numpy_tree
from rtts_torch.models import reformer_tts as TM
from rtts_torch.models import squeezewave as TS
from rtts_torch.models.stack import stack_apply
from rtts_torch.nn.conv import Conv1d
from rtts_torch.nn.layers import Dense, Embedding, LayerNorm, PrenetMLP, activation
from rtts_torch.nn.posenc import ScaledPosEnc
from rtts_torch.reversible.ffn import _ffn_body
from tests.test_model_m1 import tiny_cfg

TOL = 1e-5
STACK_TOL = 1e-4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def tt(x):
    return torch.from_numpy(np.array(x))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_cfg(d=64)
    jp = JM.init(jax.random.PRNGKey(0), cfg)
    return cfg, jp, from_numpy_tree(TM.init(cfg, device="cpu"), np_tree(jp))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    b, l, t = 2, 21, 13
    return {
        "x": rng.standard_normal((b, l, 64)).astype(np.float32),
        "tokens": rng.integers(3, 60, (b, l)).astype(np.int32),
        "mask": np.arange(l)[None, :] < np.asarray([l, 14])[:, None],
        "dec": rng.standard_normal((b, t, 64)).astype(np.float32),
        "dec_mask": np.arange(t)[None, :] < np.asarray([t, 9])[:, None],
        "mel": rng.standard_normal((b, t, 20)).astype(np.float32),
    }


def test_layers(data):
    key = jax.random.PRNGKey(1)
    x = data["x"]
    jd = jlayers.dense_init(key, 64, 24)
    jd["b"] = jnp.linspace(-1, 1, 24)
    close(from_numpy_tree(Dense(64, 24), np_tree(jd))(tt(x)).detach(),
          jlayers.dense(jd, x))
    jln = {"scale": jnp.linspace(0.5, 1.5, 64), "bias": jnp.linspace(-1, 1, 64)}
    close(from_numpy_tree(LayerNorm(64), np_tree(jln))(tt(x)).detach(),
          jlayers.layer_norm(jln, x))
    je = jlayers.embedding_init(key, 60, 64)
    close(from_numpy_tree(Embedding(60, 64), np_tree(je))(
        tt(data["tokens"]).long()).detach(), jlayers.embedding(je, data["tokens"]))
    for name in ("relu", "gelu", "tanh", "silu"):
        close(activation(name)(tt(x)), jlayers.activation(name)(x))
    jpre = jlayers.prenet_mlp_init(key, 20, 16, 64)
    got = from_numpy_tree(PrenetMLP(20, 16, 64), np_tree(jpre))(
        tt(data["mel"]), 0.0, None).detach()
    close(got, jlayers.prenet_mlp(jpre, data["mel"], None, 0.0))


@pytest.mark.parametrize("kernel", [3, 4, 5])
@pytest.mark.parametrize("groups", [1, 64])
def test_conv1d_same_padding(data, kernel, groups):
    jp = jconv.conv1d_init(jax.random.PRNGKey(kernel), 64, 64, kernel,
                           groups=groups)
    jp["b"] = jnp.linspace(-1, 1, 64)
    conv = from_numpy_tree(Conv1d(64, 64, kernel, groups=groups), np_tree(jp))
    close(conv(tt(data["x"])).detach(),
          jconv.conv1d(jp, data["x"], padding="SAME", groups=groups))


def test_scaled_posenc(data):
    jp = jposenc.scaled_posenc_init(64, 64)
    jp["alpha"] = jnp.asarray(0.7)
    pe = from_numpy_tree(ScaledPosEnc(64, 64), np_tree(jp))
    close(pe(tt(data["x"]), offset=3).detach(),
          jposenc.scaled_posenc(jp, data["x"], offset=3))


@pytest.mark.parametrize("causal", [False, True])
def test_shared_qk_self_attention(model, data, causal):
    cfg, jp, tm = model
    jattn = jp["encoder"]["layers"][0]["f"]["attn"]
    want = jfull.shared_qk_self_attention(
        jattn, data["x"], mask=data["mask"], causal=causal, num_heads=2,
        impl="flash")
    got = tfull.shared_qk_self_attention(
        tm.encoder.layers[0].f.attn, tt(data["x"]), mask=tt(data["mask"]),
        causal=causal, num_heads=2, impl="flash")
    close(got.detach(), want)


def test_cross_attention(model, data):
    cfg, jp, tm = model
    jattn = jp["decoder"]["layers"][1]["f"]["attn"]
    want = jfull.cross_attention(jattn, data["dec"], data["x"],
                                 memory_mask=data["mask"], num_heads=2,
                                 impl="flash")
    got = tfull.cross_attention(tm.decoder.layers[1].f.attn, tt(data["dec"]),
                                tt(data["x"]), memory_mask=tt(data["mask"]),
                                num_heads=2, impl="flash")
    close(got.detach(), want)


def test_ffn(model, data):
    cfg, jp, tm = model
    want = jax_ffn_body(jp["encoder"]["layers"][1]["g"], data["x"], "gelu")
    got = _ffn_body(tm.encoder.layers[1].g, tt(data["x"]), "gelu")
    close(got.detach(), want)


def test_stack_apply_encoder_and_decoder(model, data):
    cfg, jp, tm = model
    want = jax_stack_apply(jp["encoder"], cfg.encoder, data["x"], data["mask"])
    with torch.no_grad():
        got = stack_apply(tm.encoder, cfg.encoder, tt(data["x"]),
                          tt(data["mask"]))
    close(got, want, STACK_TOL)
    want = jax_stack_apply(jp["decoder"], cfg.decoder, data["dec"],
                           data["dec_mask"], memory=data["x"],
                           memory_mask=data["mask"])
    with torch.no_grad():
        got = stack_apply(tm.decoder, cfg.decoder, tt(data["dec"]),
                          tt(data["dec_mask"]), memory=tt(data["x"]),
                          memory_mask=tt(data["mask"]))
    close(got, want, STACK_TOL)


def test_local_encoder_stack_matches_jax(model, data):
    """kind: local (ported; its own tests are tests/test_torch_local.py):
    the encoder stack against JAX's, padded to the chunk as the model
    pads it."""
    cfg, jp, tm = model
    local = dataclasses.replace(cfg.encoder, attention=dataclasses.replace(
        cfg.encoder.attention, kind="local", chunk_length=8))
    x = np.pad(data["x"], ((0, 0), (0, 3), (0, 0)))
    mask = np.pad(data["mask"], ((0, 0), (0, 3)))
    want = jax_stack_apply(jp["encoder"], local, x, mask)
    with torch.no_grad():
        got = stack_apply(tm.encoder, local, tt(x), tt(mask))
    close(got, want, STACK_TOL)


def test_unported_attention_kinds_raise(model, data):
    cfg, jp, tm = model
    seq_parallel = dataclasses.replace(cfg.encoder, seq_parallel_axis="seq")
    with pytest.raises(NotImplementedError, match="parallel"):
        stack_apply(tm.encoder, seq_parallel, tt(data["x"]), tt(data["mask"]))


def test_encode(model, data):
    cfg, jp, tm = model
    want = JM.encode(jp, cfg, jnp.asarray(data["tokens"]),
                     jnp.asarray(data["mask"]))
    with torch.no_grad():   # encode is differentiable; serving runs it so
        got = TM.encode(tm, cfg, tt(data["tokens"]).long(), tt(data["mask"]))
    assert got.shape == want.shape
    close(got, want, STACK_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_postnet_apply(model, data, masked):
    cfg, jp, tm = model
    fm = data["dec_mask"] if masked else None
    want = JM.postnet_apply(jp["postnet"], cfg, data["mel"], None, True,
                            jnp.float32, frame_mask=fm)
    with torch.no_grad():
        got = TM.postnet_apply(tm.postnet, tt(data["mel"]), torch.float32,
                               frame_mask=None if fm is None else tt(fm))
    close(got, want)


VOC_CFG = SqueezeWaveConfig(n_mels=20, n_flows=4, n_group=32, n_early_every=2,
                            n_early_size=8, wn_layers=2, wn_channels=16,
                            hop_length=64, compute_dtype="float32")


@pytest.fixture(scope="module")
def vocoder():
    """Folded vocoder with a nonzero "end" conv: zero-initialized, it would
    keep every WN output (and the depthwise stage) out of the audio."""
    rng = np.random.default_rng(2)
    jp = np_tree(JS.fold_weightnorm(JS.init(jax.random.PRNGKey(3), VOC_CFG)))
    for f in jp["flows"]:
        for k in ("w", "b"):
            f["wn"]["end"][k] = (0.1 * rng.standard_normal(
                f["wn"]["end"][k].shape)).astype(np.float32)
    return jp, from_numpy_tree(TS.fold_weightnorm(TS.init(VOC_CFG, device="cpu")), jp)


def test_wn_apply(vocoder, data):
    jp, tm = vocoder
    rng = np.random.default_rng(4)
    a0 = rng.standard_normal((2, 26, 16)).astype(np.float32)
    mel_up = rng.standard_normal((2, 26, 20)).astype(np.float32)
    want = JS.wn_apply(jax.tree.map(jnp.asarray, jp["flows"][0]["wn"]), a0,
                       mel_up, 2, 16)
    with torch.no_grad():
        got = TS.wn_apply(tm.flows[0].wn, tt(a0), tt(mel_up), 2, 16)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2   # "end" is live
    close(got, want)


def test_infer_chunk(vocoder, data):
    jp, tm = vocoder
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 13 * 2, 32)).astype(np.float32)
    want = JS._infer_chunk(jax.tree.map(jnp.asarray, jp), data["mel"], z,
                           cfg=VOC_CFG)
    got = TS._infer_chunk(tm, tt(data["mel"]), tt(z), cfg=VOC_CFG)
    assert got.shape == want.shape == (2, 13 * 64)
    close(got, want, STACK_TOL)


def test_fold_weightnorm_matches_jax(data):
    """The port's fold of an unfolded tree equals the JAX fold."""
    jp = np_tree(JS.init(jax.random.PRNGKey(6), VOC_CFG))
    tm = from_numpy_tree(TS.init(VOC_CFG, device="cpu"), jp)
    assert not TS.is_folded(tm)
    folded = TS.ensure_folded(tm)
    assert TS.is_folded(folded) and TS.ensure_folded(folded) is folded
    want = np_tree(JS.fold_weightnorm(jax.tree.map(jnp.asarray, jp)))
    state = folded.state_dict()
    for i, f in enumerate(want["flows"]):
        close(state[f"flows.{i}.wn.depth.1.w"], f["wn"]["depth"][1]["w"])
        close(state[f"flows.{i}.inv1x1.w_1x1_inv"], f["inv1x1"]["w_1x1_inv"],
              1e-4)
