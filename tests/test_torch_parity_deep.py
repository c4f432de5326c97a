"""``configs/parity_deep.yaml`` and ``configs/parity_deep_guided.yaml`` in
the port against the JAX package, on the CPU, at their full width (d 256,
4 + 4 LSH layers of 4 x 64 heads, 2 hash rounds, chunk 32, reduction
factor 2; parity_deep's decoder reversible, parity_deep_guided's plain
with guided attention 2.0 decaying over 1500 steps) and a short length:
b2, 64 tokens (one row 50) and 128 frames (one row 100), so the decoder
sees 64 positions in 2 chunks.

One parameter tree made by the JAX package's init is loaded into the port;
the same numpy batch goes through both.  Every dropout rate is 0 and both
stacks set ``hash_seed`` (JAX's Threefry bits cannot be matched): the
port's LSH layers get JAX's rotations of PRNGKey(hash_seed) through
``rtts_torch.attention.lsh.draw_rotations``, its decode JAX's decode
rotations through ``rtts_torch.infer.draws.draw_rotations``, as in
``tests/test_torch_lsh.py`` and ``tests/test_torch_decode_modes.py``.  The
JAX side is jitted whole at "highest" matmul precision
(``tests/conftest.py``).

Cases and tolerances (f32 unless named):
- the teacher-forced forward (mel before and after the postnet, stop
  logits), the loss and every gradient, ``MODEL_TOL`` = 1e-4 (gradients
  relative to each leaf's largest), as ``tests/test_torch_lsh.py``'s LSH
  train step;
- one train step against JAX's ``make_train_step`` + optax (Adam, clip
  1.0, constant lr 1e-3): loss and grad_norm ``MODEL_TOL``; Adam's update
  in units of lr within ``UPDATE_TOL`` of JAX's on every entry whose
  gradient is above ``GRAD_FLOOR`` x its leaf's largest (Adam's first
  step moves such an entry by lr x sign(g), so a missing or reversed
  update fails), every other entry within 3 lr; for parity_deep_guided at
  steps 0, 750 and 1500, where the guided weight is 2.0, 1.0 and 0.0;
- bf16 (as shipped) of parity_deep (at inference and in the shared layers
  the two configs are one network; its decoder adds the reversible
  recompute and K1/K3's plain versions on the cross-attention): the
  forward's outputs within ``NOISE_RATIO`` and the gradients within
  ``GRAD_RATIO`` x JAX's own bf16-vs-f32 distance, the units of
  ``tests/test_torch_bf16.py``;
- ``decode_greedy`` in kv_full, kv_lsh and kv_lsh_chunk, each with the f32
  and the e4m3 cache, and ``decode_greedy_recompute``, at stop threshold
  2.0 (every row runs 128 frames), of one config (at inference the two
  are one network): lengths equal, mel and stop logits within
  ``tests/test_torch_decode_modes.py``'s 1e-4 (scaled), the e4m3 decodes
  within ``E4M3_RATIO`` x JAX's own e4m3-vs-f32 distance;
- ``python -m rtts_torch.scripts.eval_decode_fidelity`` against
  ``scripts/eval_decode_fidelity.py`` (a subprocess) on a 3-step
  parity_deep_guided checkpoint that ``rtts_torch/scripts/
  run_training.sh`` trains on a synthetic corpus (f32, ground truth cut
  to 32 frames): ``tests/test_torch_eval_fidelity.py``'s comparison.

Every JAX reference compiles once per config: one jitted
``make_train_step`` (``step`` traced) gives the train steps and, read
back from Adam's first moment, the gradients; one jitted forward the
outputs.  The checkpoint's training and the JAX script's evaluation run in
a background thread from the module's first test on, so that their
subprocesses overlap the tests in this process.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pathlib
import subprocess
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtts import config as JC
from rtts.infer import decode as JD
from rtts.models import reformer_tts as JM
from rtts.text import vocab_size
from rtts.train import losses as JLS
from rtts.train import optim as JO
from rtts.train.train_tts import make_train_step as jax_make_train_step
from rtts_torch import config as TC
from rtts_torch.attention import lsh as TL
from rtts_torch.convert import from_numpy_tree
from rtts_torch.infer import decode as TD
from rtts_torch.infer import draws
from rtts_torch.models import reformer_tts as TM
from rtts_torch.train import optim as TO
from rtts_torch.train.train_tts import (_guided_weight, make_train_step,
                                        step_generator)
from tests.test_torch_bf16 import GRAD_RATIO, NOISE_RATIO, dist, f32
from tests.test_torch_decode_modes import assert_decodes_match, scaled_err
from tests.test_torch_eval_fidelity import (FRAMES, _assert_match,
                                            _jax_eval, _port_eval)
from torch_twin import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAMES = ["parity_deep", "parity_deep_guided"]
B, TOKENS, MEL = 2, 64, 128
HASH_SEED = 5
MODEL_TOL = 1e-4
LR = 1e-3
OPTIM = dict(schedule="constant", learning_rate=LR, grad_clip_norm=1.0)
BETA1 = JC.OptimConfig().beta1
# Adam's update / lr on the entries whose gradient is above GRAD_FLOOR x
# its leaf's largest (there sign and size are far above the two packages'
# 1e-4-relative gradient difference)
UPDATE_TOL = 1e-2
GRAD_FLOOR = 1e-3


def tt(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_cfg(name: str, dtype: str = "float32") -> JC.ReformerTTSConfig:
    """The config's model as the JAX package loads it, in ``dtype``, with
    every dropout rate 0, ``hash_seed`` on both stacks and the decoder's
    ``use_pallas`` false (see ``test_kernel_route_differs_only_on_self_
    only_rows``)."""
    m = JC.load_config(str(ROOT / "configs" / f"{name}.yaml")).model

    def stack(s, **att):
        return dataclasses.replace(
            s, dropout=0.0, attention=dataclasses.replace(
                s.attention, attention_dropout=0.0, hash_seed=HASH_SEED,
                **att))

    return dataclasses.replace(
        m, vocab_size=vocab_size(), compute_dtype=dtype,
        enc_prenet_dropout=0.0, dec_prenet_dropout=0.0, postnet_dropout=0.0,
        encoder=stack(m.encoder), decoder=stack(m.decoder, use_pallas=False))


def port_cfg(cfg: JC.ReformerTTSConfig) -> TC.ReformerTTSConfig:
    return TC.from_dict(TC.ReformerTTSConfig, JC.to_dict(cfg))


def batch_np(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(3, vocab_size(), (B, TOKENS)).astype(np.int32),
        "token_mask": np.arange(TOKENS)[None, :] < np.asarray(
            [TOKENS, 50])[:, None],
        "mel": (0.5 * rng.standard_normal((B, MEL, 80))).astype(np.float32),
        "mel_mask": np.arange(MEL)[None, :] < np.asarray([MEL, 100])[:, None],
    }


def torch_batch(batch: dict) -> dict:
    out = {k: tt(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


@pytest.fixture
def jax_rotations(monkeypatch):
    """The port's LSH layers draw JAX's rotations of PRNGKey(HASH_SEED)."""
    def draw(h, d, n_hashes, half, generator, device):
        return tt(jax.random.normal(jax.random.PRNGKey(HASH_SEED),
                                    (h, d, n_hashes, half), jnp.float32))

    monkeypatch.setattr(TL, "draw_rotations", draw)


@functools.lru_cache(maxsize=None)
def jax_params(name: str):
    return np_tree(JM.init(jax.random.PRNGKey(7), jax_cfg(name)))


def port_model(name: str, dtype: str = "float32"):
    return from_numpy_tree(TM.init(port_cfg(jax_cfg(name, dtype)),
                                   device="cpu"), jax_params(name))


def _jax_loss(cfg):
    """The JAX train step's loss at step 0 (guided weight undecayed) ->
    (loss, (mel_pre, mel_post, stop_logits))."""
    def loss_fn(p, b):
        sink = [] if cfg.guided_attention_weight > 0.0 else None
        pre, post, stop = JM.forward(p, cfg, b["tokens"], b["token_mask"],
                                     b["mel"], b["mel_mask"], attn_sink=sink)
        total, _ = JLS.tts_loss(pre, post, stop, b["mel"],
                                JLS.make_stop_target(b["mel_mask"]),
                                b["mel_mask"], cfg.stop_pos_weight)
        if sink is not None:
            total = total + cfg.guided_attention_weight * \
                JLS.guided_attention_loss(sink, b["token_mask"],
                                          b["mel_mask"], cfg.reduction_factor,
                                          cfg.guided_attention_sigma)
        return total, (pre, post, stop)

    return loss_fn


def jax_batch() -> dict:
    return {k: jnp.asarray(v) for k, v in batch_np().items()}


@functools.lru_cache(maxsize=None)
def jax_grads(name: str, dtype: str):
    """JAX's loss, forward outputs and gradients on ``batch_np()`` in
    ``dtype`` (the loss's own ``value_and_grad``)."""
    cfg = jax_cfg(name, dtype)
    (loss, outs), grads = jax.jit(jax.value_and_grad(
        _jax_loss(cfg), has_aux=True))(jax_params(name), jax_batch())
    return loss, outs, np_tree(grads)


@functools.lru_cache(maxsize=None)
def jax_forward(name: str):
    """JAX's teacher-forced forward on ``batch_np()``: (mel_pre, mel_post,
    stop_logits)."""
    cfg = jax_cfg(name)
    return np_tree(jax.jit(lambda p, b: JM.forward(
        p, cfg, b["tokens"], b["token_mask"], b["mel"], b["mel_mask"]))(
            jax_params(name), jax_batch()))


@functools.lru_cache(maxsize=None)
def jax_train_step(name: str):
    opt = JO.make_optimizer(JC.OptimConfig(**OPTIM))
    return opt, jax.jit(jax_make_train_step(jax_cfg(name), opt))


@functools.lru_cache(maxsize=None)
def jax_step(name: str, step: int = 0):
    """One step of JAX's ``make_train_step`` from ``jax_params`` at
    ``step`` -> (the parameters after Adam, every gradient, the metrics).
    The gradients are read back from Adam's first moment after its first
    step: mu = (1 - beta1) x the gradient clipped to global norm 1."""
    opt, fn = jax_train_step(name)
    jp = jax_params(name)
    p2, state, metrics = fn(jp, opt.init(jp), jax_batch(),
                            jax.random.PRNGKey(0), step)
    metrics = {k: float(v) for k, v in metrics.items()}
    unclip = max(1.0, metrics["grad_norm"] / OPTIM["grad_clip_norm"])
    mu = next(s for s in state if hasattr(s, "mu")).mu
    grads = jax.tree.map(lambda m: np.asarray(m) * (unclip / (1 - BETA1)),
                         mu)
    return np_tree(p2), grads, metrics


@functools.lru_cache(maxsize=None)
def port_step(name: str, step: int = 0, dtype: str = "float32"):
    """The port's forward outputs and one train step (``return_grads``)
    from the same parameters at ``step`` -> (metrics, outputs, {name:
    gradient}, {name: parameter after Adam})."""
    cfg = port_cfg(jax_cfg(name, dtype))
    model = port_model(name, dtype)
    tb = torch_batch(batch_np())
    with torch.no_grad():
        outs = TM.forward(model, cfg, tb["tokens"], tb["token_mask"],
                          tb["mel"], tb["mel_mask"])
    opt = TO.make_optimizer(TC.from_dict(TC.OptimConfig, OPTIM))
    metrics, grads = make_train_step(cfg, opt)(
        model, opt.init(list(model.parameters())), tb,
        step_generator(0, step, "cpu"), step, return_grads=True)
    names = [n for n, _ in model.named_parameters()]
    return (metrics, outs, dict(zip(names, grads)),
            {n: p.detach() for n, p in model.named_parameters()})


def named(name: str, tree) -> dict:
    """A JAX tree under the port's parameter names."""
    model = from_numpy_tree(TM.init(port_cfg(jax_cfg(name)), device="cpu"),
                            tree)
    return {n: p.detach() for n, p in model.named_parameters()}


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=0)


# -- the chunk attend's two routes at the decoder's shape ---------------------


def test_kernel_route_differs_only_on_self_only_rows(jax_rotations):
    """The decoder's LSH core at these configs' shape (b2 h4 L64 d64, 2
    rounds of 2 chunks of 32, causal): the port's plain attend (JAX's
    exp(s - lse) probabilities) equals JAX's ``lsh_attention_core`` within
    1e-5 on every row; the kernels' route (K4's plain version on the CPU,
    the probabilities divided by the joint sum, as K4 and the TPU kernel
    compute them) equals it within 1e-5 except at position 0, which sees
    nothing but itself (the -1e5 self score, in both rounds' windows),
    where f32 rounding at |lse| ~ 1e5 (an ulp of 2^-7) moves the output by
    under 1% of the largest |v|.  The parity tests above therefore run the
    decoder with ``use_pallas: false``; K4 is held to its plain version at
    these configs' shapes on the card (``chip_smoke.py`` phase 11)."""
    from rtts.attention import lsh as JL

    att = jax_cfg("parity_deep").decoder.attention
    rng = np.random.default_rng(4)
    qk, v = (rng.standard_normal((B, 4, 64, 64)).astype(np.float32)
             for _ in range(2))
    want = np.asarray(jax.jit(lambda a, b: JL.lsh_attention_core(
        a, b, att, None, True, jax.random.PRNGKey(HASH_SEED))[0])(qk, v))
    routes = {}
    for use in (False, "auto"):
        cfg = TC.from_dict(TC.AttentionConfig, JC.to_dict(dataclasses.replace(
            att, use_pallas=use)))
        routes[use] = TL.lsh_attention_core(tt(qk), tt(v), cfg, None, True,
                                            None)[0].numpy()
    np.testing.assert_allclose(routes[False], want, atol=1e-5, rtol=0)
    diff = np.abs(routes["auto"] - want).max(-1)        # (B, H, L)
    rows = np.argwhere(diff > 1e-5)
    assert len(rows) and set(rows[:, 2]) == {0}, rows
    assert diff.max() <= 1e-2 * np.abs(v).max()


# -- the forward, the loss and the train step ---------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_forward_loss_and_gradients_match_jax(name, jax_rotations):
    """The teacher-forced forward's mel before and after the postnet and
    its stop logits, the loss (with guided attention at 2.0 for
    parity_deep_guided) and every gradient (relative to the leaf's
    largest), within MODEL_TOL of JAX's."""
    _, grads, jm = jax_step(name)
    metrics, got, got_g, _ = port_step(name)
    for g, w in zip(got, jax_forward(name)):
        close(g, w, MODEL_TOL)
    close(metrics["loss"], jm["loss"], MODEL_TOL)
    want = named(name, grads)
    assert sorted(want) == sorted(got_g)
    for n, w in want.items():
        scale = max(float(w.abs().max()), 1e-6)
        close(got_g[n] / scale, w / scale, MODEL_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax_and_optax(name, jax_rotations):
    """One step of JAX's ``make_train_step`` (Adam, clip 1.0, a constant
    lr) against the port's from the same parameters: loss, grad_norm and
    Adam's update; parity_deep_guided at steps 0, 750 and 1500, where its
    guided weight decays 2.0 -> 1.0 -> 0.0 (the loss's guided part too)."""
    guided = jax_cfg(name).guided_attention_weight > 0.0
    steps = (0, 750, 1500) if guided else (0,)
    if guided:
        assert [float(_guided_weight(2.0, 1500, s)) for s in steps] == [
            2.0, 1.0, 0.0]
    before = named(name, jax_params(name))
    for step in steps:
        jp2, grads, jm = jax_step(name, step)
        tm, _, _, got = port_step(name, step)
        for key in ("loss", "grad_norm", "loss_guided_attn"):
            assert (key in tm) == (key in jm), key
            if key in jm:
                close(tm[key], jm[key], MODEL_TOL)
        grad = named(name, grads)
        checked = total = 0
        for n, w in named(name, jp2).items():
            want_u, got_u = (w - before[n]) / LR, (got[n] - before[n]) / LR
            big = grad[n].abs() > GRAD_FLOOR * grad[n].abs().max()
            close(got_u[big], want_u[big], UPDATE_TOL)
            close(got_u, want_u, 3.0)
            checked, total = checked + int(big.sum()), total + big.numel()
        # 84% of parity_deep's entries at step 0
        assert checked >= 0.75 * total, (step, checked, total)


def test_bf16_forward_and_gradients_within_jax_noise(jax_rotations):
    """parity_deep as shipped, bf16: the forward's outputs within
    NOISE_RATIO and every gradient (the largest distance over leaves, each
    relative to its largest) within GRAD_RATIO x JAX's own bf16-vs-f32
    distance."""
    name = "parity_deep"
    _, grads32, _ = jax_step(name)
    _, outs16, grads16 = jax_grads(name, "bfloat16")
    _, got16, got_g16, _ = port_step(name, 0, "bfloat16")
    for what, a, b, c in zip(("mel_pre", "mel_post", "stop"), got16,
                             outs16, jax_forward(name)):
        assert dist(a, b) <= NOISE_RATIO * dist(b, c), what
    w16, w32 = named(name, grads16), named(name, grads32)
    scale = {n: max(float(w.abs().max()), 1e-12) for n, w in w32.items()}
    port_jax = max(dist(got_g16[n], w16[n]) / scale[n] for n in w16)
    jax_jax = max(dist(w16[n], w32[n]) / scale[n] for n in w16)
    assert port_jax <= GRAD_RATIO * jax_jax, (port_jax, jax_jax)


# -- decoding -----------------------------------------------------------------

# At inference the two configs are one network: reversible residuals
# compute the plain residuals' function, guided attention is a training
# loss, and the parameter trees are alike (test_configs_decode_as_one).
DECODE_NAME = "parity_deep_guided"
# An e4m3 cache rounds f32 values to 3 mantissa bits: where the two
# packages' f32 values (5e-6 apart here) straddle a rounding boundary the
# stored values differ by one e4m3 step, 2^-3 relative, a few of the
# 262,144 cached values a decode, and the AR loop carries it on.  So the
# e4m3 decodes are held in units of JAX's own e4m3-vs-f32 distance on the
# same decode (0.09-0.17 of it at this seed).
E4M3_RATIO = 0.25


@functools.lru_cache(maxsize=None)
def jax_memory(name: str):
    b = batch_np()
    cfg = jax_cfg(name)
    return np.asarray(jax.jit(lambda p, t, m: JM.encode(p, cfg, t, m))(
        jax_params(name), b["tokens"], b["token_mask"])), b["token_mask"]


@functools.lru_cache(maxsize=None)
def port_decoder(name: str):
    return port_model(name)


def test_configs_decode_as_one():
    """The two configs' models differ only in the decoder's residuals and
    the guided-attention loss, and their parameter trees are alike."""
    a, b = (JC.to_dict(jax_cfg(n)) for n in NAMES)
    assert a["decoder"].pop("reversible") and not b["decoder"].pop(
        "reversible")
    for key in ("guided_attention_weight", "guided_attention_decay_steps"):
        assert a.pop(key) != b.pop(key)
    assert a == b
    sa, sb = (jax.tree.map(np.shape, jax_params(n)) for n in NAMES)
    assert sa == sb


def _decode(mode, kv, monkeypatch):
    """-> (the port's decode, JAX's) of DECODE_NAME in ``mode`` with the
    ``kv`` cache, and the port's rotation draws."""
    name = DECODE_NAME
    memory, mask = jax_memory(name)
    jcfg = dataclasses.replace(jax_cfg(name), kv_cache_dtype=kv)
    rots, _ = JD._decode_rotations(jcfg, jax.random.PRNGKey(0), MEL)
    drawn = []

    def draw(h, d, n_hashes, half, generator, device):
        drawn.append((h, d, n_hashes, half))
        return tt(rots[(len(drawn) - 1) % len(rots)]).to(device)

    monkeypatch.setattr(draws, "draw_rotations", draw)
    want = JD.decode_greedy(jax_params(name), jcfg, jnp.asarray(memory),
                            jnp.asarray(mask), max_frames=MEL,
                            stop_threshold=2.0, mode=mode, staged=False)
    got = TD.decode_greedy(port_decoder(name), port_cfg(jcfg), tt(memory),
                           tt(mask), max_frames=MEL, stop_threshold=2.0,
                           mode=mode)
    return got, want, drawn


@pytest.mark.parametrize("mode", ["kv_full", "kv_lsh", "kv_lsh_chunk"])
def test_decode_matches_jax(mode, monkeypatch):
    """Free-running greedy decode of JAX's encoder memory, 128 frames (64
    groups at r 2, 2 chunks), against JAX's ``decode_greedy``, JAX's decode
    rotations injected: with the f32 cache, lengths equal and mel and stop
    logits within 1e-4 (scaled); with the e4m3 cache, lengths equal and
    both within E4M3_RATIO x JAX's own e4m3-vs-f32 distance."""
    got, want, drawn = _decode(mode, "compute", monkeypatch)
    assert_decodes_match(got, want)
    assert len(drawn) == (4 if mode != "kv_full" else 0)
    got8, want8, _ = _decode(mode, "float8_e4m3fn", monkeypatch)
    np.testing.assert_array_equal(got8.lengths.numpy(),
                                  np.asarray(want8.lengths))
    for key in ("mel_post", "stop_logits"):
        g8, w8, w32 = (getattr(r, key) for r in (got8, want8, want))
        assert scaled_err(g8, w8) <= E4M3_RATIO * scaled_err(
            np.asarray(w8), w32), key


def test_recompute_matches_jax(jax_rotations):
    """``decode_greedy_recompute`` (the whole decoder re-run every group)
    against JAX's: lengths equal, mel and stop logits within 1e-4."""
    name = DECODE_NAME
    memory, mask = jax_memory(name)
    jcfg = jax_cfg(name)
    want = JD.decode_greedy_recompute(
        jax_params(name), jcfg, jnp.asarray(memory), jnp.asarray(mask),
        max_frames=MEL, stop_threshold=2.0)
    got = TD.decode_greedy_recompute(
        port_decoder(name), port_cfg(jcfg), tt(memory), tt(mask),
        max_frames=MEL, stop_threshold=2.0)
    assert_decodes_match(got, want)


# -- the decode-fidelity evaluation on a trained checkpoint -------------------


EVAL_TEST = "test_eval_fidelity_matches_the_jax_script"
E4M3 = ["--kv-dtype", "float8_e4m3fn"]


def _train(root, cfg, opts):
    env = dict(os.environ, RTTS_SKIP_VOCODER="1", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        ["bash", str(ROOT / "rtts_torch" / "scripts" / "run_training.sh"),
         cfg, str(root / "run")] + opts + [
            "-o", "experiment.max_steps=3", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]


@pytest.fixture(scope="module", autouse=True)
def trained(request, tmp_path_factory):
    """Where the evaluation test is selected, started at the module's first
    test in a background thread: 3 f32 steps of parity_deep_guided through
    the port's ``run_training.sh`` (generate-corpus, preprocess,
    train-tts; no vocoder) on the CPU, ground truth cut to FRAMES, the
    decoder prenet's always-on dropout at 0 and hash_seed on both stacks,
    then the JAX script's evaluation of its checkpoint with the e4m3 cache
    -> (workdir, the scripts' arguments, the JAX model config, the
    training's future, the JAX evaluation's future)."""
    if not any(item.name == EVAL_TEST for item in request.session.items):
        yield None
        return
    root = tmp_path_factory.mktemp("parity_deep_fidelity")
    cfg = str(ROOT / "configs" / "parity_deep_guided.yaml")
    over = [f"dataset.data_dir={root / 'data'}",
            f"dataset.max_mel_len={FRAMES}", "dataset.batch_size=2",
            "model.compute_dtype=float32",
            "model.dec_prenet_dropout=0.0",
            f"model.encoder.attention.hash_seed={HASH_SEED}",
            f"model.decoder.attention.hash_seed={HASH_SEED}"]
    opts = [a for o in over for a in ("-o", o)]
    model = dataclasses.replace(JC.load_config(cfg, over).model,
                                vocab_size=vocab_size())
    args = ["-c", cfg] + opts + ["--ckpt", str(root / "run" / "tts" /
                                               "checkpoints")]
    # one worker: the JAX evaluation starts once the training is done
    with ThreadPoolExecutor(1) as pool:
        yield (root, args, model, pool.submit(_train, root, cfg, opts),
               pool.submit(_jax_eval, args + E4M3, root))


def test_eval_fidelity_matches_the_jax_script(trained, jax_rotations,
                                              monkeypatch, capsys):
    """The port's evaluation of the 3-step checkpoint (every mode, and the
    e4m3 cache) against the JAX script's on the same checkpoint: the
    lengths and stop scores equal, mel L1 and MCD within 1e-4 relative,
    the e4m3 cost within 0.02 points (``tests/test_torch_eval_fidelity.
    py``'s comparison)."""
    root, args, model, training, jax_eval = trained
    training.result()
    assert (root / "run" / "tts" / "checkpoints" / "step_3").is_dir()
    got, drawn = _port_eval(args + E4M3, model, monkeypatch, capsys)
    want = jax_eval.result()
    _assert_match(got, want)
    assert want["step"] == 3 and want["max_frames"] == FRAMES
    assert len(drawn) == 4 * model.decoder.num_layers
