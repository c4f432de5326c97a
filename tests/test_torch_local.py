"""The rtts_torch local (sliding-chunk) attention against rtts (JAX), small,
on the CPU.

``local_attention_core`` and ``local_self_attention`` forward and
gradients (masked and padded, below and above one chunk, causal or not,
and with attention dropout, whose positional keep mask both packages draw
from the same seed); a mixed ``[local, lsh, local, lsh]`` decoder stack;
one f32 train step of a parity_local-shaped model against JAX
``make_train_step`` + optax; and the attend each route takes.  The port's
chunk attend is K4/K5's ``autograd.Function`` running its plain versions
here; JAX's is its jnp attend.  The LSH layers set ``hash_seed`` and get
JAX's rotations through the port's ``draw_rotations``.  Everything is
float32, JAX at "highest" matmul precision (tests/conftest.py).

Tolerances, max |port - JAX|: 1e-5 for the core's output (summation
order only), 1e-4 for its gradients and for whole layers, stacks and the
train step (loss and grad norm 1e-4, each gradient leaf 1e-4 of its
largest entry, the parameters after the update 3 x lr), as
``tests/test_torch_lsh.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtts.attention import local as JLOC
from rtts.config import AttentionConfig, OptimConfig
from rtts.models import reformer_tts as JM
from rtts.models.stack import stack_apply as jax_stack_apply
from rtts.ops import flash_attention as JF
from rtts.train import optim as JO
from rtts.train.train_tts import make_train_step as jax_make_train_step
from rtts_torch.attention import local as TLOC
from rtts_torch.attention import lsh as TL
from rtts_torch.convert import from_numpy_tree
from rtts_torch.models import reformer_tts as TM
from rtts_torch.models.stack import stack_apply
from rtts_torch.train import optim as TO
from rtts_torch.train.train_tts import make_train_step, step_generator
from tests.test_model_m1 import tiny_cfg
from tests.test_torch_lsh import (_attn_params, close, jax_rotations,
                                  scaled_close, tt)
from torch_twin import one_thread  # noqa: F401  (autouse)


TOL = 1e-5
GRAD_TOL = 1e-4
MODEL_TOL = 1e-4


def _loc_cfg(**kw):
    base = dict(kind="local", num_heads=2, head_dim=16, num_hashes=2,
                chunk_length=8, num_chunks_before=1, hash_seed=7)
    return AttentionConfig(**{**base, **kw})


@pytest.fixture
def inject_rotations(monkeypatch):
    """The port's rotations become JAX's of PRNGKey(seed), as JAX draws
    them with ``hash_seed`` set; counts draws."""
    calls = []

    def install(seed):
        def draw(h, d, n_hashes, half, generator, device):
            calls.append((h, d, n_hashes, half))
            return tt(jax_rotations(seed, h, d, n_hashes, half)).to(device)

        monkeypatch.setattr(TL, "draw_rotations", draw)
        return calls

    return install


@pytest.mark.parametrize("causal,masked,after", [
    (True, True, 0), (False, True, 1), (True, False, 0), (False, False, 0)])
def test_local_core_matches_jax(causal, masked, after):
    cfg = _loc_cfg(num_chunks_after=after)
    rng = np.random.default_rng(after + 2 * causal)
    b, h, l, d = 2, 2, 32, 16
    qk = rng.standard_normal((b, h, l, d)).astype(np.float32)
    v = rng.standard_normal((b, h, l, d)).astype(np.float32)
    mask = (np.arange(l)[None, :] < np.asarray([l, l - 11])[:, None]
            if masked else None)
    jmask = None if mask is None else jnp.asarray(mask)
    cot = rng.standard_normal(qk.shape).astype(np.float32)

    def jax_loss(qk, v):
        out = JLOC.local_attention_core(qk, v, cfg, jmask, causal)
        return jnp.sum(out * cot), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(qk),
                                                 jnp.asarray(v))
    tqk, tv = (torch.tensor(x, requires_grad=True) for x in (qk, v))
    out = TLOC.local_attention_core(tqk, tv, cfg,
                                    None if mask is None else tt(mask), causal)
    scaled_close(out, want, TOL)
    for g, w in zip(torch.autograd.grad(out, (tqk, tv), tt(cot)), want_grads):
        scaled_close(g, w, GRAD_TOL)
    with pytest.raises(ValueError, match="multiple"):
        TLOC.local_attention_core(tqk[:, :, :30], tv[:, :, :30], cfg, None,
                                  causal)


@pytest.mark.parametrize("causal,l,dropout", [
    (True, 40, False), (False, 24, False), (True, 40, True),
    (True, 8, False), (False, 5, False)])  # l <= chunk: full attention
def test_local_self_attention_matches_jax(causal, l, dropout):
    cfg = _loc_cfg(attention_dropout=0.1 if dropout else 0.0)
    jp, tp = _attn_params(3)
    rng = np.random.default_rng(l)
    x = rng.standard_normal((2, l, 32)).astype(np.float32)
    mask = np.arange(l)[None, :] < np.asarray([l, l - 3])[:, None]
    cot = rng.standard_normal(x.shape).astype(np.float32)
    key = jax.random.PRNGKey(21)
    seed = (int(JF.dropout_seed_from_key(jax.random.fold_in(key, 7)))
            if dropout else None)

    def jax_loss(p, x):
        out = JLOC.local_self_attention(p, x, jnp.asarray(mask), causal, cfg,
                                        rng=key, deterministic=not dropout)
        return jnp.sum(out * cot), out

    (_, want), (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    out = TLOC.local_self_attention(tp, tx, tt(mask), causal, cfg,
                                    dropout_seed=seed)
    close(out, want, MODEL_TOL)
    grads = torch.autograd.grad(out, [tx, *tp.parameters()], tt(cot))
    close(grads[0], want_gx, MODEL_TOL)
    want_p = dict(from_numpy_tree(
        type(tp)(32, 2, 16, True),
        jax.tree.map(np.asarray, want_gp)).named_parameters())
    for (name, _), g in zip(tp.named_parameters(), grads[1:]):
        close(g, want_p[name].detach(), MODEL_TOL)


def test_dropout_takes_the_plain_attend(monkeypatch):
    """Without dropout the local layer takes ``_pick_attend_fn``'s attend
    (K4/K5 on the card); with dropout on it takes the plain attend, which
    the kernels' Function never sees."""
    calls = []
    kernel = TL.lsh_attend_chunks_kernel

    def counting(*args):
        calls.append(args[0].shape)
        return kernel(*args)

    monkeypatch.setattr(TL, "lsh_attend_chunks_kernel", counting)
    _, tp = _attn_params(3)
    x = torch.randn(2, 32, 32, generator=torch.Generator().manual_seed(0))
    TLOC.local_self_attention(tp, x, None, True, _loc_cfg())
    assert calls == [(2, 2, 4, 8, 16)]
    TLOC.local_self_attention(tp, x, None, True,
                              _loc_cfg(attention_dropout=0.1),
                              dropout_seed=5)
    assert len(calls) == 1
    TLOC.local_self_attention(tp, x, None, True, _loc_cfg(use_pallas=False))
    assert len(calls) == 1


def _mixed_cfg(num_layers=4):
    """parity_local's decoder pattern at a tiny size: [local, lsh] x
    num_layers / 2, chunk 8, reduction factor 2; a full-attention encoder.  The plain
    attend (use_pallas false, JAX's CPU path): the LSH rounds wrap, so a
    row can hold nothing but its own entry twice, where the kernels'
    normalisation and JAX's exp(s - lse) differ in f32 rounding."""
    cfg = tiny_cfg(d=32)
    att = _loc_cfg(kind="lsh", use_pallas=False)
    dec = dataclasses.replace(cfg.decoder, num_layers=num_layers,
                              attention=att,
                              attn_layers=["local", "lsh"] * (num_layers // 2))
    return dataclasses.replace(cfg, decoder=dec, reduction_factor=2,
                               enc_prenet_dropout=0.0, dec_prenet_dropout=0.0,
                               postnet_dropout=0.0)


def test_mixed_decoder_stack_matches_jax(inject_rotations):
    cfg = _mixed_cfg()
    calls = inject_rotations(cfg.decoder.attention.hash_seed)
    jp = JM.init(jax.random.PRNGKey(4), cfg)
    tm = from_numpy_tree(TM.init(cfg, device="cpu"),
                         jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(4)
    b, t, l = 2, 32, 20
    x = rng.standard_normal((b, t, 32)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.asarray([t, 21])[:, None]
    mem = rng.standard_normal((b, l, 32)).astype(np.float32)
    mem_mask = np.arange(l)[None, :] < np.asarray([l, 13])[:, None]
    want = jax.jit(lambda p, *a: jax_stack_apply(
        p, cfg.decoder, a[0], a[1], memory=a[2], memory_mask=a[3]))(
            jp["decoder"], x, mask, mem, mem_mask)
    with torch.no_grad():
        got = stack_apply(tm.decoder, cfg.decoder, tt(x), tt(mask),
                          memory=tt(mem), memory_mask=tt(mem_mask))
    close(got, want, MODEL_TOL)
    assert len(calls) == 2          # the two LSH layers


def test_local_train_step_matches_jax(inject_rotations):
    """One f32 train step of a mixed [local, lsh] decoder (dropout 0, Adam
    + clip at a constant lr): loss, grad_norm, every gradient leaf and the
    parameters after the update."""
    cfg = _mixed_cfg(num_layers=2)
    calls = inject_rotations(cfg.decoder.attention.hash_seed)
    optim = OptimConfig(schedule="constant", learning_rate=1e-3,
                        grad_clip_norm=1.0)
    lr = optim.learning_rate
    jp = JM.init(jax.random.PRNGKey(6), cfg)
    tm = from_numpy_tree(TM.init(cfg, device="cpu"),
                         jax.tree.map(np.asarray, jp))
    names = [n for n, _ in tm.named_parameters()]
    rng = np.random.default_rng(13)
    b, l, t = 2, 24, 60
    batch = {
        "tokens": rng.integers(3, cfg.vocab_size, (b, l)).astype(np.int32),
        "token_mask": np.arange(l)[None, :] < np.asarray([l, 17])[:, None],
        "mel": (0.5 * rng.standard_normal((b, t, cfg.n_mels))).astype(
            np.float32),
        "mel_mask": np.arange(t)[None, :] < np.asarray([t, 45])[:, None],
    }
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    j_opt = JO.make_optimizer(optim)
    jp2, _, j_metrics = jax.jit(jax_make_train_step(cfg, j_opt))(
        jp, j_opt.init(jp), jb, jax.random.PRNGKey(0), 0)

    def loss_fn(p):
        from rtts.train import losses as JLS

        pre, post, stop = JM.forward(p, cfg, jb["tokens"], jb["token_mask"],
                                     jb["mel"], jb["mel_mask"])
        total, _ = JLS.tts_loss(pre, post, stop, jb["mel"],
                                JLS.make_stop_target(jb["mel_mask"]),
                                jb["mel_mask"], cfg.stop_pos_weight)
        return total

    want_grads = jax.jit(jax.grad(loss_fn))(jp)
    t_opt = TO.make_optimizer(optim)
    metrics, grads = make_train_step(cfg, t_opt)(
        tm, t_opt.init(list(tm.parameters())),
        {"tokens": tt(batch["tokens"]).long(),
         "token_mask": tt(batch["token_mask"]), "mel": tt(batch["mel"]),
         "mel_mask": tt(batch["mel_mask"])},
        step_generator(0, 0, "cpu"), 0, return_grads=True)
    assert len(calls) == 1          # the decoder's LSH layer
    close(metrics["loss"], j_metrics["loss"], MODEL_TOL)
    close(metrics["grad_norm"], j_metrics["grad_norm"], MODEL_TOL)
    want = dict(from_numpy_tree(TM.init(cfg, device="cpu"), jax.tree.map(
        np.asarray, want_grads)).named_parameters())
    for name, g in zip(names, grads):
        w = want[name].detach()
        scale = max(float(w.abs().max()), 1e-6)
        close(g / scale, w / scale, MODEL_TOL)
    want_params = from_numpy_tree(TM.init(cfg, device="cpu"),
                                  jax.tree.map(np.asarray, jp2))
    got_params = dict(tm.named_parameters())
    for name, p in want_params.named_parameters():
        close(got_params[name], p.detach(), 3 * lr)
