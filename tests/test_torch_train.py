"""The rtts_torch training slice against rtts (JAX), at small size on the CPU.

The same numpy inputs and one parameter tree (the JAX package's init,
loaded through ``rtts_torch.convert``) go through both.  The JAX flash
kernel runs in Pallas interpret mode, its matmuls at "highest" precision
(tests/conftest.py); the port runs the plain versions of K1 and K3 inside
the same ``torch.autograd.Function`` the card uses.  Everything is float32.

Tolerances (max abs error): 1e-5 for one attention call and its gradients
(summation order only), 1e-5 for the losses, 1e-4 for whole-model outputs
(as the serving tests), gradients of the whole step 1e-4 relative to each
leaf's largest gradient, parameters after Adam updates 3 x lr (Adam turns a
gradient of rounding-noise size into a step of about +-lr).  Dropout is
held at 0 for whole-model parity: the generators of the two frameworks
cannot match; the flash keep mask is held bit for bit.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtts.config import (AttentionConfig, CheckpointConfig, Config,
                         DatasetConfig, ExperimentConfig, LoggingConfig,
                         OptimConfig, ReformerStackConfig, ReformerTTSConfig)
from rtts.models import reformer_tts as JM
from rtts.ops import flash_attention as JF
from rtts.train import losses as JL
from rtts.train import optim as JO
from rtts.train.checkpoint import restore_checkpoint as jax_restore
from rtts.train.checkpoint import save_checkpoint as jax_save
from rtts.train.train_tts import make_train_step as jax_make_train_step
from rtts_torch.convert import from_numpy_tree
from rtts_torch.models import reformer_tts as TM
from rtts_torch.ops import flash_attention as TF
from rtts_torch.train import checkpoint as TC
from rtts_torch.train import losses as TL
from rtts_torch.train import optim as TO
from rtts_torch.train.train_tts import make_train_step, step_generator
from tests.test_model_m1 import tiny_cfg

TOL = 1e-5
MODEL_TOL = 1e-4
ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def tt(x):
    return torch.from_numpy(np.array(x))


def close(got, want, tol=TOL):
    got, want = (x.detach().numpy() if isinstance(x, torch.Tensor) else x
                 for x in (got, want))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


# -- K1 with dropout and lse, K3, the keep mask ----------------------------------

ATTN_CASES = {
    # name: (b, h, lq, lk, d, kv lengths, causal, self_mask, sm_scale,
    #        shared_qk, q_offset)
    "causal_self": (2, 2, 128, 128, 32, (128, 100), True, True, 1.0, True, 0),
    "self_ragged_77": (2, 2, 77, 77, 32, (77, 50), False, True, 1.0, True, 0),
    "cross_lq_ne_lk": (2, 2, 64, 128, 32, (128, 40), False, False,
                       32 ** -0.5, False, 0),
    "q_offset_causal_self": (2, 2, 64, 128, 32, (128, 100), True, True,
                             32 ** -0.5, False, 64),
}


def _attn_inputs(name, seed=0):
    (b, h, lq, lk, d, lens, causal, self_mask, scale, shared,
     q_offset) = ATTN_CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, lk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, lk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, lq, d)).astype(np.float32)
    if shared:   # the shared-QK contract: k = len_norm(q) / sqrt(d)
        k = (q / np.sqrt(np.mean(q * q, -1, keepdims=True) + 1e-6)
             * d ** -0.5).astype(np.float32)
    mask = np.arange(lk)[None, :] < np.asarray(lens)[:, None]
    kw = dict(causal=causal, self_mask=self_mask, sm_scale=scale,
              q_offset=q_offset)
    return (q, k, v, do, mask), kw


@pytest.mark.parametrize("seed,q_offset", [(0, 0), (12345, 5),
                                           (0xFFFFFFFF, 0), (2 ** 31 + 7, 64)])
def test_dropout_keep_mask_equals_jax_bit_for_bit(seed, q_offset):
    want = np.asarray(JF.dropout_keep_mask(jnp.uint32(seed), 3, 70, 130, 0.1,
                                           q_offset=q_offset))
    got = TF.dropout_keep_mask(seed, 3, 70, 130, 0.1, q_offset).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.85 < got.mean() < 0.95


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_flash_forward_and_grads_match_jax(name, rate):
    """The Function's forward (plain K1 with dropout) and backward (plain
    K3) against JAX flash_attend and jax.grad of it, interpret mode."""
    (q, k, v, do, mask), kw = _attn_inputs(name)
    seed = 0x9E3779B9

    def jax_loss(q, k, v):
        out = JF.flash_attend(q, k, v, jnp.asarray(mask), interpret=True,
                              dropout_rate=rate,
                              dropout_seed=jnp.uint32(seed), **kw)
        return jnp.sum(out * do), out

    (_, want), want_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = TF.flash_attend(tq, tk, tv, tt(mask), dropout_rate=rate,
                          dropout_seed=seed, **kw)
    (got * tt(do)).sum().backward()
    close(got, want)
    for t, g in zip((tq, tk, tv), want_grads):
        close(t.grad, g)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_flash_lse_matches_jax_kernel(rate):
    """lse of the plain K1 against the JAX kernel's saved lse (its forward
    with save_lse, interpret mode), at a 128-multiple length."""
    (q, k, v, _, mask), kw = _attn_inputs("causal_self")
    b, h, l, d = q.shape
    thr = JF._drop_threshold(rate)
    _, lse = JF._fwd_impl(
        jnp.asarray(q.reshape(b * h, l, d)), jnp.asarray(k.reshape(b * h, l, d)),
        jnp.asarray(v.reshape(b * h, l, d)),
        jnp.asarray(mask, jnp.float32).reshape(b, 1, l),
        jnp.zeros((1,), jnp.float32), JF._seed_to_smem(jnp.uint32(3)), h,
        True, True, 1.0, JF.MASK_VALUE, JF.SELF_MASK_VALUE, 128, 128, True,
        save_lse=True, drop_thr=thr,
        drop_scale=1.0 / (1.0 - rate) if thr else 1.0)
    _, got = TF.flash_attend(tt(q), tt(k), tt(v), tt(mask), dropout_rate=rate,
                             dropout_seed=3, return_lse=True,
                             **{**kw, "q_offset": 0})
    close(got, np.asarray(lse)[:, :, 0])


def test_bwd_reference_is_autograd_of_the_forward():
    """On rows the model produces, the kernels' backward formula equals
    autograd of the plain forward."""
    (q, k, v, do, mask), kw = _attn_inputs("causal_self", seed=3)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = TF.flash_attend_reference(tq, tk, tv, tt(mask), dropout_rate=0.2,
                                         dropout_seed=9, return_lse=True, **kw)
    want = torch.autograd.grad(out, (tq, tk, tv), tt(do))
    got = TF.flash_attend_bwd_reference(
        tt(q), tt(k), tt(v), out.detach(), tt(do), lse.detach(), tt(mask),
        dropout_rate=0.2, dropout_seed=9, **kw)
    for g, w in zip(got, want):
        close(g, w)


# -- losses, schedules --------------------------------------------------------------


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    b, t, c, l = 3, 17, 20, 9
    pre, post, mel = (rng.standard_normal((b, t, c)).astype(np.float32)
                      for _ in range(3))
    stop = rng.standard_normal((b, t)).astype(np.float32)
    mmask = np.arange(t)[None, :] < np.asarray([17, 11, 4])[:, None]
    tmask = np.arange(l)[None, :] < np.asarray([9, 6, 3])[:, None]
    probs = rng.random((b, 2, 9, l)).astype(np.float32)
    np.testing.assert_array_equal(TL.make_stop_target(tt(mmask)).numpy(),
                                  np.asarray(JL.make_stop_target(mmask)))
    stop_t = np.asarray(JL.make_stop_target(mmask))
    want_total, want = JL.tts_loss(pre, post, stop, mel, stop_t, mmask, 8.0)
    got_total, got = TL.tts_loss(tt(pre), tt(post), tt(stop), tt(mel),
                                 tt(stop_t), tt(mmask), 8.0)
    close(got_total, want_total)
    assert got.keys() == want.keys()
    for key in want:
        close(got[key], want[key])
    for r in (1, 2):
        close(TL.guided_attention_loss([tt(probs), tt(probs[::-1].copy())],
                                       tt(tmask), tt(mmask), r, 0.3),
              JL.guided_attention_loss([probs, probs[::-1]], tmask, mmask,
                                       r, 0.3))


@pytest.mark.parametrize("schedule", ["constant", "noam", "cosine"])
def test_schedules_match_optax(schedule):
    cfg = OptimConfig(schedule=schedule, learning_rate=2e-4, warmup_steps=10,
                      total_steps=50)
    sched = TO.make_schedule(cfg)
    for step in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80):
        assert TO.lr_at_step(cfg, step) == pytest.approx(
            JO.lr_at_step(cfg, step), rel=1e-6, abs=1e-9)
        assert sched(step) == TO.lr_at_step(cfg, step)
    assert TO.make_schedule(dataclasses.replace(cfg, schedule="noam"))(0) == 0.0


# -- gradient accumulation -------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["noam", "cosine"])
def test_gradient_accumulation_matches_optax_multisteps(schedule):
    """2 cycles x 3 micro-steps of Adam + clip under a warmup schedule: the
    parameters, the running mean and the counters after every micro-step
    against ``optax.MultiSteps`` (the JAX ``make_optimizer`` with
    accumulate_steps 3); ``lr_at_step`` counts updates."""
    import optax

    optim = OptimConfig(schedule=schedule, learning_rate=1e-2, warmup_steps=1,
                        total_steps=10, grad_clip_norm=0.5, accumulate_steps=3)
    rng = np.random.default_rng(3)
    keys = ("a", "b")
    jp = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    j_opt = JO.make_optimizer(optim)
    j_state = j_opt.init(jp)
    t_params = [tt(jp[k]) for k in keys]
    t_opt = TO.make_optimizer(optim)
    t_state = t_opt.init(t_params)
    for micro in range(6):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in jp.items()}
        updates, j_state = j_opt.update(grads, j_state, jp)
        jp = optax.apply_updates(jp, updates)
        t_opt.step(t_params, [tt(grads[k]) for k in keys], t_state)
        for t, a, k in zip(t_params, t_state["acc"], keys):
            close(t, jp[k], 1e-6)
            close(a, j_state.acc_grads[k], 1e-7)
        assert t_state["mini_step"] == int(j_state.mini_step)
        assert t_state["count"] == int(j_state.gradient_step)
        assert TO.lr_at_step(optim, micro) == pytest.approx(
            JO.lr_at_step(optim, micro), rel=1e-6, abs=1e-12)
    assert t_state["count"] == 2 and t_state["mini_step"] == 0
    with pytest.raises(ValueError, match="accumulate_steps"):
        TO.make_optimizer(dataclasses.replace(optim, accumulate_steps=0))


# -- the model's training forward ---------------------------------------------------


def _train_cfg(r=1, d=64, guided=0.0, rate=0.0):
    """tiny_cfg with reduction factor r; ``rate`` sets every dropout but the
    decoder prenet's (which the reference applies even when deterministic)."""
    cfg = tiny_cfg(d=d, dropout=rate)
    stacks = {name: dataclasses.replace(
        stack, attention=dataclasses.replace(stack.attention,
                                             attention_dropout=rate))
        for name, stack in (("encoder", cfg.encoder),
                            ("decoder", cfg.decoder))}
    return dataclasses.replace(cfg, reduction_factor=r, enc_prenet_dropout=rate,
                               postnet_dropout=rate, dec_prenet_dropout=0.0,
                               guided_attention_weight=guided,
                               guided_attention_decay_steps=10, **stacks)


def _batch(cfg, seed=0, b=2, l=13, t=21):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(3, cfg.vocab_size, (b, l)).astype(np.int32),
        "token_mask": np.arange(l)[None, :] < np.asarray([l, 8])[:, None],
        "mel": (0.5 * rng.standard_normal((b, t, cfg.n_mels))).astype(
            np.float32),
        "mel_mask": np.arange(t)[None, :] < np.asarray([t, 14])[:, None],
    }


def _torch_batch(batch):
    return {"tokens": tt(batch["tokens"]).long(),
            "token_mask": tt(batch["token_mask"]),
            "mel": tt(batch["mel"]), "mel_mask": tt(batch["mel_mask"])}


@pytest.mark.parametrize("r", [1, 2])
def test_forward_and_attn_sink_match_jax(r):
    cfg = _train_cfg(r)
    jp = JM.init(jax.random.PRNGKey(3), cfg)
    tm = from_numpy_tree(TM.init(cfg, device="cpu"), np_tree(jp))
    batch = _batch(cfg, seed=r)

    @jax.jit
    def jax_forward(p, b):
        sink = []
        out = JM.forward(p, cfg, b["tokens"], b["token_mask"], b["mel"],
                         b["mel_mask"], attn_sink=sink)
        return out, sink

    want, j_sink = jax_forward(jp, {k: jnp.asarray(v) for k, v in
                                    batch.items()})
    t_sink = []
    tb = _torch_batch(batch)
    with torch.no_grad():
        got = TM.forward(tm, cfg, tb["tokens"], tb["token_mask"], tb["mel"],
                         tb["mel_mask"], attn_sink=t_sink)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w, MODEL_TOL)
    assert len(t_sink) == len(j_sink) == cfg.decoder.num_layers
    for g, w in zip(t_sink, j_sink):
        close(g, w, MODEL_TOL)


def test_forward_without_generator_drops_nothing():
    """Every dropout rate at 0.1 and no generator: the port's forward is the
    deterministic one, as the reference's without an rng."""
    cfg = _train_cfg(rate=0.1)
    jp = JM.init(jax.random.PRNGKey(4), cfg)
    tm = from_numpy_tree(TM.init(cfg, device="cpu"), np_tree(jp))
    batch = _batch(cfg, seed=7)
    want = jax.jit(lambda p, b: JM.forward(
        p, cfg, b["tokens"], b["token_mask"], b["mel"], b["mel_mask"]))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = _torch_batch(batch)
    with torch.no_grad():
        got = TM.forward(tm, cfg, tb["tokens"], tb["token_mask"], tb["mel"],
                         tb["mel_mask"])
    for g, w in zip(got, want):
        close(g, w, MODEL_TOL)


def _jax_loss_and_grads(cfg, jp, batch, step):
    """The loss and gradients of the JAX train step's loss_fn, dropout 0."""
    def loss_fn(p):
        sink = []
        pre, post, stop = JM.forward(p, cfg, batch["tokens"],
                                     batch["token_mask"], batch["mel"],
                                     batch["mel_mask"], attn_sink=sink)
        total, _ = JL.tts_loss(pre, post, stop, batch["mel"],
                               JL.make_stop_target(batch["mel_mask"]),
                               batch["mel_mask"], cfg.stop_pos_weight)
        gal = JL.guided_attention_loss(sink, batch["token_mask"],
                                       batch["mel_mask"], cfg.reduction_factor,
                                       cfg.guided_attention_sigma)
        w = jnp.float32(cfg.guided_attention_weight) * jnp.clip(
            1.0 - jnp.float32(step) / cfg.guided_attention_decay_steps, 0, 1)
        return total + w * gal

    return jax.jit(jax.value_and_grad(loss_fn))(jp)


def test_train_step_matches_jax():
    """Two f32 train steps, dropout 0, guided attention on, Adam + clip at a
    constant lr: loss, grad_norm and every gradient of the first step, the
    parameters after each update."""
    cfg = _train_cfg(r=2, d=32, guided=2.0)
    optim = OptimConfig(schedule="constant", learning_rate=1e-3,
                        grad_clip_norm=1.0)
    lr = optim.learning_rate
    jp = JM.init(jax.random.PRNGKey(5), cfg)
    tm = from_numpy_tree(TM.init(cfg, device="cpu"), np_tree(jp))
    names = [n for n, _ in tm.named_parameters()]

    j_opt = JO.make_optimizer(optim)
    j_state = j_opt.init(jp)
    j_step = jax.jit(jax_make_train_step(cfg, j_opt))
    t_opt = TO.make_optimizer(optim)
    t_state = t_opt.init(list(tm.parameters()))
    t_step = make_train_step(cfg, t_opt)
    for step in range(2):
        batch = _batch(cfg, seed=10 + step)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if step == 0:
            want_loss, want_grads = _jax_loss_and_grads(cfg, jp, jb, step)
        jp, j_state, j_metrics = j_step(jp, j_state, jb,
                                        jax.random.PRNGKey(0), step)
        metrics, grads = t_step(tm, t_state, _torch_batch(batch),
                                step_generator(0, step, "cpu"), step,
                                return_grads=True)
        close(metrics["loss"], j_metrics["loss"], MODEL_TOL)
        close(metrics["loss_guided_attn"], j_metrics["loss_guided_attn"],
              MODEL_TOL)
        close(metrics["grad_norm"], j_metrics["grad_norm"], MODEL_TOL)
        if step == 0:
            close(metrics["loss"], want_loss, MODEL_TOL)
            want = dict(from_numpy_tree(TM.init(cfg, device="cpu"), np_tree(want_grads))
                        .named_parameters())
            for name, g in zip(names, grads):
                w = want[name].detach()
                scale = max(float(w.abs().max()), 1e-6)
                close(g / scale, w / scale, MODEL_TOL)
        got_params = dict(tm.named_parameters())
        want_params = from_numpy_tree(TM.init(cfg, device="cpu"), np_tree(jp))
        for name, p in want_params.named_parameters():
            close(got_params[name], p, 3 * lr)
    assert t_state["count"] == 2


# -- checkpoints ------------------------------------------------------------------


def test_checkpoint_round_trip_and_jax_interop(tmp_path):
    cfg = _train_cfg()
    jp = JM.init(jax.random.PRNGKey(8), cfg)
    tm = from_numpy_tree(TM.init(cfg, device="cpu"), np_tree(jp))
    opt = TO.make_optimizer(OptimConfig())
    state = opt.init(list(tm.parameters()))
    for i, (mu, nu) in enumerate(zip(state["mu"], state["nu"])):
        mu.fill_(0.5 * i)
        nu.fill_(0.25 * i)
    state["count"] = 7
    # the port's checkpoint: format, retention, restore, the JAX reader
    for step, metric in ((1, 3.0), (2, 1.0), (3, 2.0), (4, None)):
        TC.save_checkpoint(tmp_path / "port", tm, state, step, metric, keep=2)
    kept = sorted(p.name for p in (tmp_path / "port").glob("step_*"))
    assert kept == ["step_2", "step_4"]
    latest = TC.latest_checkpoint(tmp_path / "port")
    meta = json.loads((tmp_path / "port" / "step_4" / "meta.json").read_text())
    assert meta["format_version"] == 2 and meta["step"] == 4
    fresh = TM.init(cfg, device="cpu")
    fresh_state = opt.init(list(fresh.parameters()))
    assert TC.restore_checkpoint(latest, fresh, fresh_state) == 4
    for (n, a), (_, b) in zip(tm.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), n
    assert fresh_state["count"] == 7
    assert all(torch.equal(a, b) for a, b in zip(state["nu"],
                                                 fresh_state["nu"]))
    restored, step = jax_restore(latest, {"params": jp})
    assert step == 4
    for a, b in zip(jax.tree.leaves(restored["params"]), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the JAX package's checkpoint (params + optax state) read by the port
    jax_opt = JO.make_optimizer(OptimConfig())
    jax_dir = jax_save(tmp_path / "jax", {"params": jp,
                                          "opt_state": jax_opt.init(jp)}, 9)
    other = TM.init(cfg, device="cpu")
    assert TC.restore_checkpoint(jax_dir, other) == 9
    for (n, a), (_, b) in zip(tm.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), n
    with pytest.raises(ValueError, match="optimizer state"):
        TC.restore_checkpoint(jax_dir, other, opt.init(list(other.parameters())))


def test_async_checkpointer_snapshots_before_updates(tmp_path):
    cfg = _train_cfg()
    tm = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    saver = TC.AsyncCheckpointer()
    saver.save(tmp_path, tm, None, 1)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(1.0)
    saver.wait()
    fresh = TM.init(cfg, device="cpu")
    TC.restore_checkpoint(TC.latest_checkpoint(tmp_path), fresh)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, before[k]), k


# -- the trainer --------------------------------------------------------------------


def _trainer_cfg(data_dir):
    from rtts.text import vocab_size

    att = AttentionConfig(kind="auto", num_heads=2, head_dim=16,
                          attention_dropout=0.1)
    stack = dict(d_model=32, d_ff=64, dropout=0.1, attention=att,
                 reversible="auto", ffn_chunk_size="auto")
    return Config(
        dataset=DatasetConfig(data_dir=data_dir, batch_size=4,
                              val_fraction=0.25, num_workers=0),
        model=ReformerTTSConfig(
            vocab_size=vocab_size(), d_model=32, n_mels=80,
            encoder=ReformerStackConfig(num_layers=1, causal=False, **stack),
            decoder=ReformerStackConfig(num_layers=1, causal=True, **stack),
            dec_prenet_hidden=16, postnet_channels=16, max_pos=2048,
            guided_attention_weight=2.0, guided_attention_decay_steps=100,
            compute_dtype="float32"),
        experiment=ExperimentConfig(
            seed=0, optim=OptimConfig(learning_rate=1e-3, warmup_steps=2),
            checkpoint=CheckpointConfig(save_every_steps=2, keep=2),
            logging=LoggingConfig(log_every_steps=2, eval_every_steps=4),
            eval_batches=1),
    )


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    from rtts.data.corpus import generate_corpus
    from rtts.data.preprocess import preprocess_corpus

    root = tmp_path_factory.mktemp("torch_train")
    data_dir = str(root / "data")
    generate_corpus(root, n_utterances=8)
    preprocess_corpus(_trainer_cfg(data_dir).dataset,
                      str(root / "transcripts.txt"))
    return data_dir


def test_train_tts_runs_resumes_and_replays(prepared, tmp_path):
    """4 steps with dropout on, then a resume to 6, equal to 6 steps in one
    run: the resumed run replays batches and dropout."""
    from rtts_torch.train.train_tts import train_tts

    cfg = _trainer_cfg(prepared)
    work = tmp_path / "a"
    m1 = train_tts(cfg, str(work), max_steps=4, device="cpu")
    assert np.isfinite(m1["loss"]) and np.isfinite(m1["grad_norm"])
    lines = [json.loads(l) for l in open(work / "metrics.jsonl")]
    assert any("train/loss_guided_attn" in l for l in lines)
    val = next(l for l in lines if "val/loss" in l)
    for key in ("val/mcd", "val/stop_len_mae", "val/loss_mel_post",
                "val/mr_stft_gl", "val/spectral_convergence_gl",
                "val/attn_diagonality", "val/attn_focus"):
        assert np.isfinite(val[key]), (key, val)
    for name in ("audio_step4.wav", "mel_step4.png", "align_step4.png"):
        assert (work / "artifacts" / name).stat().st_size > 44, name
    assert (work / "checkpoints" / "step_4").exists()
    m2 = train_tts(cfg, str(work), max_steps=6, device="cpu")
    m3 = train_tts(cfg, str(tmp_path / "b"), max_steps=6, device="cpu")
    assert m2["loss"] == m3["loss"]
    for name in ("step_6",):
        a = np.load(work / "checkpoints" / name / "leaves.npz")
        b = np.load(tmp_path / "b" / "checkpoints" / name / "leaves.npz")
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_trainer_refuses_what_is_not_ported(prepared, tmp_path):
    from rtts_torch.train.train_tts import train_tts

    cfg = _trainer_cfg(prepared)
    exp = cfg.experiment
    for bad in (dataclasses.replace(exp, mesh=dataclasses.replace(
                    exp.mesh, data_parallel=2)),
                dataclasses.replace(exp, debug_nans=True),
                dataclasses.replace(exp, logging=dataclasses.replace(
                    exp.logging, tensorboard_dir=str(tmp_path / "tb")))):
        with pytest.raises(NotImplementedError):
            train_tts(dataclasses.replace(cfg, experiment=bad),
                      str(tmp_path / "x"), max_steps=1, device="cpu")
    rev = dataclasses.replace(cfg.model, decoder=dataclasses.replace(
        cfg.model.decoder, reversible=True))
    with pytest.raises(ValueError, match="plain residuals"):
        train_tts(dataclasses.replace(cfg, model=rev), str(tmp_path / "y"),
                  max_steps=1, device="cpu")
    # without the guided-attention capture a reversible decoder trains
    rev = dataclasses.replace(rev, guided_attention_weight=0.0)
    metrics = train_tts(dataclasses.replace(cfg, model=rev),
                        str(tmp_path / "z"), max_steps=1, device="cpu")
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])


def test_accumulation_resumes_in_mid_cycle(tmp_path):
    """accumulate_steps 3: 4 micro-steps, a checkpoint (one micro-step
    folded into the second cycle), a restore into a fresh model and state,
    2 more micro-steps: equal to 6 in one run, parameters and optimizer
    state bit for bit."""
    cfg = _train_cfg()
    opt = TO.make_optimizer(OptimConfig(learning_rate=1e-2, warmup_steps=1,
                                        accumulate_steps=3))

    def fresh():
        model = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
        return model, opt.init(list(model.parameters()))

    gen = torch.Generator().manual_seed(1)
    shapes = [p.shape for p in fresh()[0].parameters()]
    grads = [[torch.randn(s, generator=gen) for s in shapes] for _ in range(6)]

    def run(model, state, micro_grads):
        for g in micro_grads:
            opt.step(list(model.parameters()), g, state)

    first, state = fresh()
    run(first, state, grads[:4])
    TC.save_checkpoint(tmp_path, first, state, 4)
    resumed = TM.init(cfg, device="cpu")
    resumed_state = opt.init(list(resumed.parameters()))
    assert TC.restore_checkpoint(TC.latest_checkpoint(tmp_path), resumed,
                                 resumed_state) == 4
    assert resumed_state["mini_step"] == 1 and resumed_state["count"] == 1
    run(resumed, resumed_state, grads[4:])
    whole, whole_state = fresh()
    run(whole, whole_state, grads)
    for a, b in zip(resumed.parameters(), whole.parameters()):
        assert torch.equal(a, b)
    assert resumed_state["count"] == whole_state["count"] == 2
    assert resumed_state["mini_step"] == whole_state["mini_step"] == 0
    for key in ("mu", "nu", "acc"):
        for a, b in zip(resumed_state[key], whole_state[key]):
            assert torch.equal(a, b), key
