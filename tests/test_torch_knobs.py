"""The model knobs ``pos_encoding: axial`` and ``param_dtype`` in the port
against the JAX package, on the CPU.

The model is ``tests/test_torch_decode_modes.py``'s (d 32, 2 + 2 layers, 2
heads x 16, n_mels 20, f32 compute, every dropout 0 in the train step),
with the axial positions of shape (16, 16) and dims (16, 16) (capacity
256), or with its
parameters in bfloat16.  JAX's init is carried across (bf16 leaves through
f32, exactly), then:

- axial: the leaves ``ax1`` (16, 1, 16) and ``ax2`` (1, 16, 16) equal;
  ``encode``, the teacher-forced ``forward`` and ``decode_greedy``
  (kv_full, stop pinned at 2.0) against JAX at 1e-4 (max |port - JAX| /
  max(1, |JAX|)), the lengths equal; a sequence past the capacity raises
  the reference's ValueError in both;
- bf16 parameters: one train step (Adam with the clip, constant lr 1e-3,
  moments in bf16 as optax keeps them) against JAX + optax: the loss at
  1e-3 relative (f32 compute from the same bf16 leaves); every gradient
  (bf16) within two bf16 ulps of its leaf's largest; the gradient norm,
  which the port sums as ``optax.global_norm`` does (per leaf in bf16,
  the squares accumulated in f32 as XLA's CPU reduction does, then the
  leaves added in bf16), within one bf16 ulp of JAX's (equal at seed 1,
  one ulp apart at seed 0); every parameter after the update within two
  bf16 ulps of its magnitude (the update is bf16 arithmetic on both sides,
  rounded in a different order).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtts import config as JC
from rtts.infer import decode as JD
from rtts.models import reformer_tts as JM
from rtts.text import vocab_size
from rtts.train import losses as JL
from rtts.train import optim as JO
from rtts.train.train_tts import make_train_step as jax_make_train_step
from rtts_torch.convert import from_numpy_tree
from rtts_torch.infer.decode import decode_greedy
from rtts_torch.models import reformer_tts as TM
from rtts_torch.train import optim as TO
from rtts_torch.train.train_tts import make_train_step, step_generator
from tests.test_torch_decode_modes import jax_cfg, port_cfg, scaled_err, tt
from torch_twin import one_thread  # noqa: F401  (autouse)


TOL = 1e-4
OPTIM = JC.OptimConfig(schedule="constant", learning_rate=1e-3,
                       grad_clip_norm=1.0)


def _f32_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.float32)),
                        tree)


def _batch(seed=0, b=2, l=16, t=24):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(3, vocab_size(), (b, l)).astype(np.int32),
        "token_mask": np.arange(l)[None, :] < np.asarray([l, 11])[:, None],
        "mel": (0.5 * rng.standard_normal((b, t, 20))).astype(np.float32),
        "mel_mask": np.arange(t)[None, :] < np.asarray([t, 17])[:, None],
    }


def _torch_batch(batch):
    out = {k: tt(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


@pytest.fixture(scope="module")
def axial():
    cfg = dataclasses.replace(jax_cfg("full"), pos_encoding="axial",
                              axial_pos_shape=(16, 16),
                              axial_pos_dims=(16, 16))
    jp = JM.init(jax.random.PRNGKey(2), cfg)
    tcfg = port_cfg(cfg)
    tm = from_numpy_tree(TM.init(tcfg, device="cpu"), _f32_tree(jp))
    return cfg, tcfg, jp, tm


def test_axial_init_carries_across(axial):
    cfg, tcfg, jp, tm = axial
    for side in ("enc_pos", "dec_pos"):
        pe = getattr(tm, side)
        assert tuple(pe.ax1.shape) == (16, 1, 16)
        assert tuple(pe.ax2.shape) == (1, 16, 16)
        np.testing.assert_array_equal(pe.ax1.detach().numpy(),
                                      np.asarray(jp[side]["ax1"]))
        np.testing.assert_array_equal(pe.ax2.detach().numpy(),
                                      np.asarray(jp[side]["ax2"]))
    # the port's own init draws the same shapes, N(0, 0.02^2)
    own = TM.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert 0.01 < float(own.enc_pos.ax1.detach().std()) < 0.03
    assert {n for n, _ in own.named_parameters()} == {
        n for n, _ in tm.named_parameters()}


def test_axial_encode_and_forward_match_jax(axial):
    cfg, tcfg, jp, tm = axial
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = jax.jit(lambda p, t, m: JM.encode(p, cfg, t, m))(
        jp, jb["tokens"], jb["token_mask"])
    with torch.no_grad():
        got = TM.encode(tm, tcfg, tt(b["tokens"]).long(),
                        tt(b["token_mask"]))
    assert scaled_err(got, want) < TOL
    want = jax.jit(lambda p, *a: JM.forward(p, cfg, *a, deterministic=True))(
        jp, jb["tokens"], jb["token_mask"], jb["mel"], jb["mel_mask"])
    with torch.no_grad():
        got = TM.forward(tm, tcfg, tt(b["tokens"]).long(),
                         tt(b["token_mask"]), tt(b["mel"]), tt(b["mel_mask"]))
    for g, w in zip(got, want):
        assert scaled_err(g, w) < TOL


def test_axial_decode_greedy_matches_jax(axial):
    cfg, tcfg, jp, tm = axial
    b = _batch(seed=1)
    mask = jnp.asarray(b["token_mask"])
    memory = jax.jit(lambda p, t, m: JM.encode(p, cfg, t, m))(
        jp, jnp.asarray(b["tokens"]), mask)
    want = JD.decode_greedy(jp, cfg, memory, mask, 32,
                            rng=jax.random.PRNGKey(0), stop_threshold=2.0)
    got = decode_greedy(tm, tcfg, tt(memory), tt(mask), max_frames=32,
                        stop_threshold=2.0)
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    assert scaled_err(got.mel_post, want.mel_post) < TOL
    assert scaled_err(got.stop_logits, want.stop_logits) < TOL


def test_axial_capacity_raises_like_jax(axial):
    cfg, tcfg, jp, tm = axial
    x = np.zeros((1, 257, 32), np.float32)
    with pytest.raises(ValueError, match="exceeds axial capacity 256"):
        from rtts.nn.posenc import axial_posenc
        axial_posenc(jp["enc_pos"], jnp.asarray(x))
    with pytest.raises(ValueError, match="exceeds axial capacity 256"):
        tm.enc_pos(tt(x))


@pytest.fixture(scope="module")
def bf16_jax():
    """The JAX side of the bf16-parameter step, compiled once for every
    seed: the config, optax's chain, the jitted gradient of the loss and
    the jitted train step (the batch an argument of both)."""
    cfg = dataclasses.replace(jax_cfg("full"), param_dtype="bfloat16",
                              enc_prenet_dropout=0.0, postnet_dropout=0.0)
    j_opt = JO.make_optimizer(OPTIM)

    def loss_fn(p, jb):
        pre, post, stop = JM.forward(p, cfg, jb["tokens"], jb["token_mask"],
                                     jb["mel"], jb["mel_mask"])
        return JL.tts_loss(pre, post, stop, jb["mel"],
                           JL.make_stop_target(jb["mel_mask"]),
                           jb["mel_mask"], cfg.stop_pos_weight)[0]

    return (cfg, j_opt, jax.jit(jax.grad(loss_fn)),
            jax.jit(jax_make_train_step(cfg, j_opt)))


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_param_step_matches_jax_and_optax(seed, bf16_jax):
    cfg, j_opt, j_grad, j_step = bf16_jax
    tcfg = port_cfg(cfg)
    jp = JM.init(jax.random.PRNGKey(3 + seed), cfg)
    tm = from_numpy_tree(TM.init(tcfg, device="cpu"), _f32_tree(jp))
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
    j_state = j_opt.init(jp)
    t_opt = TO.make_optimizer(port_cfg_optim())
    t_state = t_opt.init(list(tm.parameters()))
    assert {t.dtype for t in t_state["mu"] + t_state["nu"]} == {
        torch.bfloat16}
    b = _batch(seed=seed)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    j_grads = j_grad(jp, jb)
    jp, j_state, j_metrics = j_step(jp, j_state, jb, jax.random.PRNGKey(0),
                                    0)
    metrics, grads = make_train_step(tcfg, t_opt)(
        tm, t_state, _torch_batch(b), step_generator(0, 0, "cpu"), 0,
        return_grads=True)
    ulp = 2.0 ** -7
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(j_metrics["loss"]), rtol=1e-3)
    want = dict(from_numpy_tree(TM.init(tcfg, device="cpu"),
                                _f32_tree(j_grads)).named_parameters())
    for (name, _), g in zip(tm.named_parameters(), grads):
        assert g.dtype == torch.bfloat16, name
        w = want[name].detach().float()
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=0,
                                   atol=2 * ulp * max(float(w.abs().max()),
                                                      1e-6), err_msg=name)
    # optax's bf16 norm, summed as the port sums it: within one bf16 ulp of
    # JAX's (the gradients themselves differ in their last bits)
    j_norm = float(j_metrics["grad_norm"])
    assert metrics["grad_norm"].dtype == torch.bfloat16
    assert abs(float(metrics["grad_norm"]) - j_norm) <= 2.0 ** (
        np.floor(np.log2(j_norm)) - 7)
    want = dict(from_numpy_tree(TM.init(tcfg, device="cpu"),
                                _f32_tree(jp)).named_parameters())
    for name, p in tm.named_parameters():
        w = want[name].detach().float()
        np.testing.assert_allclose(p.detach().float().numpy(), w.numpy(),
                                   atol=2 * ulp * max(float(w.abs().max()),
                                                      1e-3), rtol=0,
                                   err_msg=name)


@pytest.fixture(scope="module")
def f16_jax():
    """The JAX side of the f16-parameter step (as ``bf16_jax``)."""
    cfg = dataclasses.replace(jax_cfg("full"), param_dtype="float16",
                              enc_prenet_dropout=0.0, postnet_dropout=0.0)
    j_opt = JO.make_optimizer(OPTIM)

    def loss_fn(p, jb):
        pre, post, stop = JM.forward(p, cfg, jb["tokens"], jb["token_mask"],
                                     jb["mel"], jb["mel_mask"])
        return JL.tts_loss(pre, post, stop, jb["mel"],
                           JL.make_stop_target(jb["mel_mask"]),
                           jb["mel_mask"], cfg.stop_pos_weight)[0]

    return (cfg, j_opt, jax.jit(jax.grad(loss_fn)),
            jax.jit(jax_make_train_step(cfg, j_opt)))


@pytest.mark.parametrize("seed", [0, 1])
def test_f16_param_step_matches_jax_and_optax(seed, f16_jax):
    """One train step with every parameter in float16 (f32 compute; Adam
    with the clip, constant lr 1e-3, moments in f16 as optax keeps them)
    against JAX + optax.  JAX's own step is not finite: optax's eps 1e-8
    is 0 in f16, so wherever a gradient's square underflows f16 the second
    moment is 0 and the update 0/0 (113 of 117 leaves hold a NaN at seed
    1).  The port is held to the same: the same leaves non-finite, and on
    the elements finite on both sides within four f16 ulps of the leaf's
    largest where JAX's second moment is a normal f16 (the update's six
    f16 roundings, in another order on each side; the bias leaves start
    at 0, so their +-lr steps carry the relative error of mu / sqrt(nu)),
    and within lr where it is subnormal (there a last-bit difference in
    the gradient moves nu by a whole quantum of 2^-24); the second
    moments within two ulps plus that quantum; the loss at 1e-3 relative, every gradient (f16) within two
    f16 ulps of its leaf's largest, the gradient norm (optax's per-leaf
    f16 sums) within one f16 ulp, the first moments within two ulps."""
    cfg, j_opt, j_grad, j_step = f16_jax
    tcfg = port_cfg(cfg)
    jp = JM.init(jax.random.PRNGKey(3 + seed), cfg)
    tm = from_numpy_tree(TM.init(tcfg, device="cpu"), _f32_tree(jp))
    assert {p.dtype for p in tm.parameters()} == {torch.float16}
    j_state = j_opt.init(jp)
    t_opt = TO.make_optimizer(port_cfg_optim())
    t_state = t_opt.init(list(tm.parameters()))
    assert {t.dtype for t in t_state["mu"] + t_state["nu"]} == {
        torch.float16}
    b = _batch(seed=seed)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    j_grads = j_grad(jp, jb)
    jp, j_state, j_metrics = j_step(jp, j_state, jb, jax.random.PRNGKey(0),
                                    0)
    metrics, grads = make_train_step(tcfg, t_opt)(
        tm, t_state, _torch_batch(b), step_generator(0, 0, "cpu"), 0,
        return_grads=True)
    ulp = 2.0 ** -10
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(j_metrics["loss"]), rtol=1e-3)
    want = dict(from_numpy_tree(TM.init(tcfg, device="cpu"),
                                _f32_tree(j_grads)).named_parameters())
    for (name, _), g in zip(tm.named_parameters(), grads):
        assert g.dtype == torch.float16, name
        w = want[name].detach().float()
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=0,
                                   atol=2 * ulp * max(float(w.abs().max()),
                                                      1e-4), err_msg=name)
    j_norm = float(j_metrics["grad_norm"])
    assert metrics["grad_norm"].dtype == torch.float16
    assert abs(float(metrics["grad_norm"]) - j_norm) <= 2.0 ** (
        np.floor(np.log2(j_norm)) - 10)
    names = [n for n, _ in tm.named_parameters()]
    j_mu = from_numpy_tree(TM.init(tcfg, device="cpu"), _f32_tree(
        _adam_state(j_state).mu))
    for name, mu, w in zip(names, t_state["mu"], j_mu.parameters()):
        w = w.detach().float()
        np.testing.assert_allclose(mu.float().numpy(), w.numpy(), rtol=0,
                                   atol=2 * ulp * max(float(w.abs().max()),
                                                      1e-6), err_msg=name)
    j_nu = dict(from_numpy_tree(TM.init(tcfg, device="cpu"), _f32_tree(
        _adam_state(j_state).nu)).named_parameters())
    for name, nu in zip(names, t_state["nu"]):
        w = j_nu[name].detach().float()
        np.testing.assert_allclose(nu.float().numpy(), w.numpy(), rtol=0,
                                   atol=2 * ulp * float(w.abs().max())
                                   + 2.0 ** -24, err_msg=name)
    want = dict(from_numpy_tree(TM.init(tcfg, device="cpu"),
                                _f32_tree(jp)).named_parameters())
    bad = {n for n, p in want.items() if not torch.isfinite(p).all()}
    assert bad, "JAX's f16 step became finite: tighten this test"
    assert {n for n, p in tm.named_parameters()
            if not torch.isfinite(p).all()} == bad
    lr = OPTIM.learning_rate
    for name, p in tm.named_parameters():
        got, w = p.detach().float(), want[name].detach().float()
        both = torch.isfinite(got) & torch.isfinite(w)
        normal = both & (j_nu[name].detach().float() >= 2.0 ** -14)
        if normal.any():
            np.testing.assert_allclose(
                got[normal].numpy(), w[normal].numpy(), rtol=0,
                atol=4 * ulp * max(float(w[normal].abs().max()), 1e-3),
                err_msg=name)
        sub = both & ~normal
        if sub.any():
            assert float((got[sub] - w[sub]).abs().max()) <= lr, name


def _adam_state(state):
    """optax's ScaleByAdamState inside the chain's state."""
    import optax

    for s in jax.tree.leaves(state, is_leaf=lambda x: isinstance(
            x, optax.ScaleByAdamState)):
        if isinstance(s, optax.ScaleByAdamState):
            return s
    raise AssertionError("no ScaleByAdamState in the optimizer state")


def port_cfg_optim():
    from rtts_torch import config as TC

    return TC.from_dict(TC.OptimConfig, dataclasses.asdict(OPTIM))


def test_bf16_params_checkpoint_round_trip(tmp_path):
    """numpy has no bfloat16: a bf16 model and its bf16 moments are saved as
    f32 (exactly) and restore into bf16 bit for bit."""
    from rtts_torch.train.checkpoint import (restore_checkpoint,
                                             save_checkpoint)

    tcfg = port_cfg(dataclasses.replace(jax_cfg("full"),
                                        param_dtype="bfloat16"))
    opt = TO.make_optimizer(port_cfg_optim())
    tm = TM.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    state = opt.init(list(tm.parameters()))
    for t in state["mu"]:
        t.normal_()
    path = save_checkpoint(tmp_path, tm, state, 3)
    back = TM.init(tcfg, torch.Generator().manual_seed(1), "cpu")
    back_state = opt.init(list(back.parameters()))
    assert restore_checkpoint(path, back, back_state) == 3
    for a, b in zip(list(tm.parameters()) + state["mu"],
                    list(back.parameters()) + back_state["mu"]):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b)
