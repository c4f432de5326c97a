"""Reversible residuals, the chunked FFN and K6 of rtts_torch against rtts
(JAX), small, on the CPU.

The same numpy inputs and one parameter tree (the JAX package's init,
loaded through ``rtts_torch.convert``) go through both.  The JAX side runs
at "highest" matmul precision (tests/conftest.py), its K6 in Pallas
interpret mode; the port runs K6's plain version inside the
``torch.autograd.Function`` the card uses.  Sizes: d 32, d_ff 64, 2 + 2
layers, L 64 (or 48 after autopad) with LSH chunk 16 and FFN chunk 16.

Tolerances, max |port - JAX|: K6's plain version 1e-5 in f32 (summation
order only) and 1e-2 scaled by max(1, |JAX|) in bf16 (the same rounding
points, so one bf16 ulp at most); its gradients 1e-4 (as
``tests/test_pallas_ffn_conv.py``); ``chunked_ffn`` 1e-5, its gradients
(sums over 128 rows, up to ~20) 1e-5 scaled by max(1, |JAX|); a reversible
stack as JAX's own reversible-vs-plain test (``tests/test_model_lsh.py``:
loss rtol 1e-5, gradients atol 5e-4 of the largest, rtol 2e-3); the train
step as ``tests/test_torch_lsh.py``.  JAX's Threefry rotations are injected
through the port's ``draw_rotations`` with ``hash_seed`` set.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtts.config import AttentionConfig, OptimConfig, ReformerStackConfig
from rtts.models import reformer_tts as JM
from rtts.models import stack as JS
from rtts.ops.chunked_ffn import chunked_ffn_pallas
from rtts.reversible.ffn import chunked_ffn as jax_chunked_ffn
from rtts.reversible.ffn import ffn_init
from rtts.train import optim as JO
from rtts.train.train_tts import make_train_step as jax_make_train_step
from rtts_torch.attention import lsh as TL
from rtts_torch.convert import from_numpy_tree
from rtts_torch.models import reformer_tts as TM
from rtts_torch.models import stack as TS
from rtts_torch.ops import chunked_ffn as TK6
from rtts_torch.reversible import rev as TR
from rtts_torch.reversible.ffn import FFN, chunked_ffn
from rtts_torch.train import optim as TO
from rtts_torch.train.train_tts import make_train_step, step_generator
from tests.test_model_m1 import tiny_cfg
from tests.test_torch_lsh import inject_rotations, jax_rotations  # noqa: F401

MODEL_TOL = 1e-4
ACTS = ("relu", "gelu", "tanh", "silu")


def tt(x):
    return torch.from_numpy(np.array(x))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def scaled_err(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)))


# -- K6 --------------------------------------------------------------------------


def _ffn(seed=0, d=32, f=64):
    jp = ffn_init(jax.random.PRNGKey(seed), d, f)
    # nonzero biases and LN parameters, so every term of the kernel counts
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    return jp, from_numpy_tree(FFN(d, f), jp)


def _k6_args(tp):
    return (tp.ln.scale, tp.ln.bias, tp.w_in.w, tp.w_in.b, tp.w_out.w,
            tp.w_out.b)


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_k6_reference_matches_jax_kernel(act, mxu):
    """64 rows, row_block 16: the JAX side runs its Pallas kernel."""
    jp, tp = _ffn(seed=1)
    x = np.random.default_rng(2).standard_normal((2, 32, 32)).astype(
        np.float32)
    want = chunked_ffn_pallas(jp, jnp.asarray(x), act, row_block=16,
                              interpret=True, mxu_dtype=mxu)
    got = TK6.ffn_fused_reference(tt(x).reshape(64, 32), *_k6_args(tp), act,
                                  getattr(torch, mxu)).reshape(x.shape)
    if mxu == "float32":
        close(got, want, 1e-5)
    else:
        assert scaled_err(got, want) <= 1e-2


def test_k6_reference_ragged_rows_match_jax():
    """13 rows tile by no block: the JAX wrapper falls back to its f32 jnp
    body, which the f32 plain version matches."""
    jp, tp = _ffn(seed=3)
    x = np.random.default_rng(4).standard_normal((1, 13, 32)).astype(
        np.float32)
    want = chunked_ffn_pallas(jp, jnp.asarray(x), "gelu", interpret=True,
                              mxu_dtype="float32")
    got = TK6.ffn_fused_reference(tt(x)[0], *_k6_args(tp), "gelu",
                                  torch.float32)
    close(got, np.asarray(want)[0], 1e-5)


@pytest.mark.parametrize("act,mxu", [("gelu", "float32"), ("gelu", "bfloat16"),
                                     ("relu", "float32"), ("tanh", "bfloat16"),
                                     ("silu", "float32")])
def test_k6_function_grads_match_jax(act, mxu):
    """The port's Function against jax.grad through chunked_ffn_pallas:
    both backwards are autograd of the f32 body, whatever mxu_dtype."""
    jp, tp = _ffn(seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jg = jax.grad(lambda p, xx: jnp.sum(chunked_ffn_pallas(
        p, xx, act, row_block=16, interpret=True, mxu_dtype=mxu) * cot),
        argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    out = TK6.chunked_ffn_fused(tp, tx, act, getattr(torch, mxu))
    names = ["x"] + [n for n, _ in tp.named_parameters()]
    got = torch.autograd.grad(out, [tx, *tp.parameters()], tt(cot))
    want = dict(from_numpy_tree(FFN(32, 64), np_tree(jg[0])).named_parameters())
    want["x"] = tt(jg[1])
    for name, g in zip(names, got):
        close(g, want[name].detach(), MODEL_TOL)


def test_k6_refuses_what_it_does_not_take():
    _, tp = _ffn()
    x = torch.zeros(4, 32)
    with pytest.raises(ValueError, match="activation"):
        TK6.ffn_fused_reference(x, *_k6_args(tp), "swish", torch.float32)
    with pytest.raises(ValueError, match="device"):
        TK6.ffn_fused(x, *_k6_args(tp), "gelu", torch.float32)


# -- chunked_ffn -------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 16])
def test_chunked_ffn_matches_jax(chunk):
    jp, tp = _ffn(seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    @jax.jit
    def jax_vjp(p, xx, ct):
        out, vjp = jax.vjp(lambda p, xx: jax_chunked_ffn(p, xx, chunk, "gelu"),
                           p, xx)
        return out, vjp(ct)

    jout, (jgp, jgx) = jax_vjp(jp, jnp.asarray(x), jnp.asarray(cot))
    tx = torch.tensor(x, requires_grad=True)
    out = chunked_ffn(tp, tx, chunk, "gelu")
    close(out, jout, 1e-5)
    got = torch.autograd.grad(out, [tx, *tp.parameters()], tt(cot))
    assert scaled_err(got[0], jgx) <= 1e-5
    want = dict(from_numpy_tree(FFN(32, 64), np_tree(jgp)).named_parameters())
    for (name, _), g in zip(tp.named_parameters(), got[1:]):
        assert scaled_err(g, want[name].detach()) <= 1e-5, name


def test_chunked_ffn_refuses_a_ragged_length():
    _, tp = _ffn()
    with pytest.raises(ValueError, match="not a multiple of ffn chunk 16"):
        chunked_ffn(tp, torch.zeros(1, 40, 32), 16)


# -- the reversible stack against JAX ----------------------------------------------


def _att(kind="lsh", **kw):
    # use_pallas false: the port attends as the JAX package does on the CPU
    # (its jnp attend, exp(s - lse)); K4's exact normalisation differs from
    # it by up to ~0.4% on causal rows left with only their self entry
    base = dict(kind=kind, num_heads=2, head_dim=16, num_hashes=2,
                chunk_length=16, num_chunks_before=1, hash_seed=7,
                use_pallas=False)
    return AttentionConfig(**{**base, **kw})


def _stack_cfg(kind, causal, reversible=True, dropout=0.0, **att):
    return ReformerStackConfig(num_layers=2, d_model=32, d_ff=64,
                               dropout=dropout, reversible=reversible,
                               ffn_chunk_size=16, causal=causal,
                               attention=_att(kind, **att))


STACK_CASES = {
    # name: (attention kind, causal, cross-attention)
    "encoder full": ("full", False, False),
    "encoder lsh": ("lsh", False, False),
    "decoder lsh + cross": ("lsh", True, True),
}


@pytest.mark.parametrize("name", sorted(STACK_CASES))
def test_reversible_stack_matches_jax(inject_rotations, monkeypatch, name):
    """An MSE loss and every gradient (parameters, input, memory) of the
    port's reversible stack against JAX ``reversible_sequence(reversible=
    True)`` under ``stack_apply``, f32, dropout 0; the port's backward is
    the reversible one."""
    kind, causal, cross = STACK_CASES[name]
    cfg = _stack_cfg(kind, causal)
    inject_rotations(cfg.attention.hash_seed)
    backwards = []
    bwd = TR._Reversible.backward
    monkeypatch.setattr(TR._Reversible, "backward", staticmethod(
        lambda ctx, *cts: backwards.append(1) or bwd(ctx, *cts)))
    rng = np.random.default_rng(11)
    b, l, lm = 2, 64, 48
    x = rng.standard_normal((b, l, 32)).astype(np.float32)
    mask = np.arange(l)[None, :] < np.asarray([l, l - 9])[:, None]
    mem = rng.standard_normal((b, lm, 32)).astype(np.float32) if cross else None
    mem_mask = (np.arange(lm)[None, :] < np.asarray([lm, 30])[:, None]
                if cross else None)
    target = rng.standard_normal(x.shape).astype(np.float32)
    jp = JS.stack_init(jax.random.PRNGKey(12), cfg, cross)

    def jax_loss(p, xx, mm):
        out = JS.stack_apply(p, cfg, xx, jnp.asarray(mask), mm,
                             None if mem_mask is None else jnp.asarray(mem_mask))
        return jnp.mean(jnp.square(out - target))

    args = (jp, jnp.asarray(x), None if mem is None else jnp.asarray(mem))
    want_loss, want = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2) if cross else (0, 1)))(*args)
    stack = from_numpy_tree(TS.Stack(cfg, cross), np_tree(jp))
    tx = torch.tensor(x, requires_grad=True)
    tm = None if mem is None else torch.tensor(mem, requires_grad=True)
    out = TS.stack_apply(stack, cfg, tx, tt(mask), tm,
                         None if mem_mask is None else tt(mem_mask))
    loss = (out - tt(target)).square().mean()
    inputs = [tx] + ([tm] if cross else []) + list(stack.parameters())
    got = torch.autograd.grad(loss, inputs)
    assert backwards == [1]
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    want_p = dict(from_numpy_tree(TS.Stack(cfg, cross), np_tree(want[0]))
                  .named_parameters())
    wants = [want[1]] + ([want[2]] if cross else []) + [
        want_p[n].detach() for n, _ in stack.named_parameters()]
    scale = max(float(np.abs(np.asarray(w)).max()) for w in wants)
    for g, w in zip(got, wants):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=5e-4 * scale, rtol=2e-3)


# -- reversible == plain inside the port, dropout on --------------------------------


def _lsh_model_cfg(reversible=True, dropout=0.0, hash_seed=None, **stack_kw):
    """A serving_fast-shaped tiny model: LSH in both stacks (2 hashes,
    chunk 16), reversible residuals, FFN chunk 16."""
    cfg = tiny_cfg(d=32, dropout=dropout)
    stacks = {name: dataclasses.replace(
        stack, reversible=reversible, ffn_chunk_size=16,
        attention=_att(hash_seed=hash_seed, attention_dropout=dropout),
        **stack_kw)
        for name, stack in (("encoder", cfg.encoder), ("decoder", cfg.decoder))}
    return dataclasses.replace(cfg, enc_prenet_dropout=dropout,
                               dec_prenet_dropout=0.0, postnet_dropout=dropout,
                               **stacks)


def _batch(cfg, seed, b=2, l=40, t=50):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(3, cfg.vocab_size, (b, l)).astype(np.int32),
        "token_mask": np.arange(l)[None, :] < np.asarray([l, 29])[:, None],
        "mel": (0.5 * rng.standard_normal((b, t, cfg.n_mels))).astype(
            np.float32),
        "mel_mask": np.arange(t)[None, :] < np.asarray([t, 37])[:, None],
    }


def _torch_batch(batch):
    return {"tokens": tt(batch["tokens"]).long(),
            "token_mask": tt(batch["token_mask"]),
            "mel": tt(batch["mel"]), "mel_mask": tt(batch["mel_mask"])}


def _port_step(cfg, weights, batch, optim=OptimConfig(schedule="constant")):
    """One port train step from ``weights`` -> (metrics, grads, names)."""
    model = TM.init(cfg, device="cpu")
    model.load_state_dict(weights)
    opt = TO.make_optimizer(optim)
    metrics, grads = make_train_step(cfg, opt)(
        model, opt.init(list(model.parameters())), _torch_batch(batch),
        step_generator(3, 0, "cpu"), 0, return_grads=True)
    return metrics, grads, [n for n, _ in model.named_parameters()]


def test_reversible_equals_plain_with_dropout(monkeypatch):
    """Stack dropout 0.1 and attention dropout 0.1, rotations drawn from the
    step's generator: the reversible step gives the plain step's loss and
    gradients, every gradient nonzero where plain's is (a backward that
    wrote .grad instead of returning gradients would give zeros here), and
    the backward attends with the forward's buckets, hashing nothing."""
    calls = []
    core = TL.lsh_attention_core

    def recording(*args, buckets=None, **kw):
        out, got = core(*args, buckets=buckets, **kw)
        calls.append((buckets, got))
        return out, got

    monkeypatch.setattr(TL, "lsh_attention_core", recording)
    rev_cfg = _lsh_model_cfg(True, dropout=0.1)
    plain_cfg = _lsh_model_cfg(False, dropout=0.1)
    weights = TM.init(rev_cfg, torch.Generator().manual_seed(0),
                      "cpu").state_dict()
    batch = _batch(rev_cfg, seed=1)
    plain = _port_step(plain_cfg, weights, batch)
    assert all(b is None for b, _ in calls) and len(calls) == 4
    calls.clear()
    rev = _port_step(rev_cfg, weights, batch)
    fwd = [got for b, got in calls if b is None]
    bwd = [b for b, _ in calls if b is not None]
    assert len(fwd) == len(bwd) == 4
    for a, b in zip(reversed(bwd), fwd):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(rev[0]["loss"]), float(plain[0]["loss"]),
                               rtol=1e-6)
    scale = max(float(g.abs().max()) for g in plain[1])
    for name, g, p in zip(rev[2], rev[1], plain[1]):
        torch.testing.assert_close(g, p, rtol=0, atol=5e-4 * scale,
                                   msg=name)
        assert bool((g != 0).any()) == bool((p != 0).any()), name


def test_reversible_backward_returns_gradients_not_grad_attrs():
    """The gradients come back through torch.autograd.grad and no
    parameter's .grad is written."""
    cfg = _lsh_model_cfg(True)
    model = TM.init(cfg, torch.Generator().manual_seed(1), "cpu")
    tb = _torch_batch(_batch(cfg, seed=2))
    pre, _, _ = TM.forward(model, cfg, tb["tokens"], tb["token_mask"],
                           tb["mel"], tb["mel_mask"])
    params = list(model.encoder.parameters()) + list(model.decoder.parameters())
    grads = torch.autograd.grad(pre.square().sum(), params)
    assert all(g is not None and bool((g != 0).any()) for g in grads)
    assert all(p.grad is None for p in model.parameters())


def _saved_activation_bytes(reversible, num_layers):
    """Bytes autograd saves in one LSH stack forward (2 x 64 x 32, FFN
    chunk 16), parameters not counted."""
    cfg = dataclasses.replace(_stack_cfg("lsh", True, reversible),
                              num_layers=num_layers)
    stack = TS.Stack(cfg, False, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    own = {p.untyped_storage().data_ptr() for p in stack.parameters()}
    saved = []

    def pack(t):
        if t.untyped_storage().data_ptr() not in own:
            saved.append(t.numel() * t.element_size())
        return t

    x = torch.randn(2, 64, 32, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        TS.stack_apply(stack, cfg, x, torch.ones(2, 64, dtype=torch.bool))
    return sum(saved)


def test_reversible_saves_no_per_layer_activations():
    """What a reversible stack saves does not grow with depth (the final
    streams and the final LN's input); plain residuals save every layer's."""
    rev = [_saved_activation_bytes(True, n) for n in (2, 4)]
    plain = [_saved_activation_bytes(False, n) for n in (2, 4)]
    assert rev[0] == rev[1]
    assert plain[1] > plain[0] > rev[0]


# -- the slice: f32 train steps of a serving_fast-shaped model against JAX ----------


def _capturing(opt):
    """``opt`` whose state also keeps the gradients of its last update, so
    one compiled JAX train step yields them."""
    def init(params):
        return opt.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = opt.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def test_serving_fast_shaped_train_steps_match_jax(inject_rotations):
    """Two f32 train steps (reversible, FFN chunk 16, LSH in both stacks,
    dropout 0, Adam + clip at a constant lr) against JAX make_train_step:
    loss, grad norm and every gradient of both, the parameters after each
    update."""
    cfg = _lsh_model_cfg(True, hash_seed=7)
    calls = inject_rotations(7)
    optim = OptimConfig(schedule="constant", learning_rate=1e-3,
                        grad_clip_norm=1.0)
    lr = optim.learning_rate
    jp = JM.init(jax.random.PRNGKey(6), cfg)
    tm = from_numpy_tree(TM.init(cfg, device="cpu"), np_tree(jp))
    names = [n for n, _ in tm.named_parameters()]
    j_opt = _capturing(JO.make_optimizer(optim))
    j_state = j_opt.init(jp)
    j_step = jax.jit(jax_make_train_step(cfg, j_opt))
    t_opt = TO.make_optimizer(optim)
    t_state = t_opt.init(list(tm.parameters()))
    t_step = make_train_step(cfg, t_opt)
    for step in range(2):
        batch = _batch(cfg, seed=20 + step)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jp, j_state, j_metrics = j_step(jp, j_state, jb,
                                        jax.random.PRNGKey(0), step)
        metrics, grads = t_step(tm, t_state, _torch_batch(batch),
                                step_generator(0, step, "cpu"), step,
                                return_grads=True)
        close(metrics["loss"], j_metrics["loss"], MODEL_TOL)
        close(metrics["grad_norm"], j_metrics["grad_norm"], MODEL_TOL)
        want = dict(from_numpy_tree(TM.init(cfg, device="cpu"),
                                    np_tree(j_state[1])).named_parameters())
        for name, g in zip(names, grads):
            w = want[name].detach()
            s = max(float(w.abs().max()), 1e-6)
            close(g / s, w / s, MODEL_TOL)
        want_params = from_numpy_tree(TM.init(cfg, device="cpu"), np_tree(jp))
        got_params = dict(tm.named_parameters())
        for name, p in want_params.named_parameters():
            close(got_params[name], p.detach(), 3 * lr)
    # one draw per LSH layer and step: the backward hashes nothing
    assert len(calls) == 2 * 4
    assert t_state["count"] == 2


# -- the K6 path in the stack -------------------------------------------------------


def _k6_cfg(on, reversible=True):
    return _lsh_model_cfg(reversible, hash_seed=7, use_pallas_ffn=on)


def test_k6_path_in_reversible_step(monkeypatch):
    """With the K6 gate forced on the CPU, one f32 reversible step equals
    the chunked path.  Then K6's output gets a position-dependent offset
    that its backward (the f32 body) does not see: the reversible step
    still equals the plain one, because the reconstruction subtracts K6's
    own output; subtracting the f32 recompute would be off by the offset."""
    monkeypatch.setattr(TS, "use_ffn_kernel", lambda x: True)
    weights = TM.init(_k6_cfg(False), torch.Generator().manual_seed(2),
                      "cpu").state_dict()
    batch = _batch(_k6_cfg(False), seed=3)
    chunked = _port_step(_k6_cfg(False), weights, batch)
    runs = []
    reference = TK6.ffn_fused_reference

    def counted(*args):
        runs.append(1)
        return reference(*args)

    monkeypatch.setattr(TK6, "ffn_fused_reference", counted)
    k6 = _port_step(_k6_cfg(True), weights, batch)
    n_ffn = 2 + 2 * 2   # encoder pairs + decoder pairs
    assert len(runs) == 2 * n_ffn   # forward + reconstruction
    close(k6[0]["loss"], chunked[0]["loss"], 1e-5)
    for name, g, w in zip(k6[2], k6[1], chunked[1]):
        close(g, w, 1e-5)

    def offset(*args):
        out = reference(*args)
        return out + 0.05 * torch.linspace(-1, 1, out.shape[-1])

    monkeypatch.setattr(TK6, "ffn_fused_reference", offset)
    rev = _port_step(_k6_cfg(True), weights, batch)
    plain = _port_step(_k6_cfg(True, reversible=False), weights, batch)
    assert abs(float(rev[0]["loss"]) - float(chunked[0]["loss"])) > 1e-4
    close(rev[0]["loss"], plain[0]["loss"], 1e-5)
    scale = max(float(g.abs().max()) for g in plain[1])
    for name, g, w in zip(rev[2], rev[1], plain[1]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * scale, msg=name)
