"""The rtts_torch LSH attention slice against rtts (JAX), small, on the CPU.

The same numpy inputs go through both.  Op-level cases run the JAX chunk
attend kernel (K4, with its backward K5) in Pallas interpret mode; the
model-level cases run the JAX package's jnp attend, as the CPU does.  The
JAX side multiplies at "highest" precision (tests/conftest.py).  The port
runs the plain versions of K4 and K5 inside the ``torch.autograd.Function``
that launches the kernels on the card.  Everything is float32.

JAX's Threefry rotations cannot be drawn in torch, so every model-level case
sets ``hash_seed`` (JAX then uses the rotations of PRNGKey(hash_seed) in
every layer) and injects those rotations through the port's
``draw_rotations``; the buckets are held equal first.

Tolerances, max |port - JAX| (scaled by max(1, |JAX|) where noted): hashing
and sorting exact; the attend's out and lse 1e-5 scaled (summation order
only); its gradients 1e-4 scaled (longer sums: dK and dV add every query of
every window); whole-layer outputs and gradients 1e-4; the train step as
``tests/test_torch_train.py``: loss 1e-4, each gradient leaf 1e-4 of its
largest entry, params after the update 3 x lr.  Dropout keep masks are
bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtts.attention import full as JFULL
from rtts.attention import lsh as JL
from rtts.config import AttentionConfig, OptimConfig, ReformerStackConfig
from rtts.models import reformer_tts as JM
from rtts.ops import flash_attention as JF
from rtts.ops import lsh_attention as JK
from rtts.train import optim as JO
from rtts.train.train_tts import make_train_step as jax_make_train_step
from rtts_torch.attention import full as TFULL
from rtts_torch.attention import lsh as TL
from rtts_torch.convert import from_numpy_tree
from rtts_torch.models import reformer_tts as TM
from rtts_torch.models import stack as TS
from rtts_torch.ops import lsh_attention as TK
from rtts_torch.train import optim as TO
from rtts_torch.train.train_tts import make_train_step, step_generator
from tests.test_model_m1 import tiny_cfg
from torch_twin import one_thread  # noqa: F401  (autouse)


TOL = 1e-5
GRAD_TOL = 1e-4
MODEL_TOL = 1e-4


def tt(x):
    return torch.from_numpy(np.array(x))


def scaled_close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)))
    assert err <= tol, err


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def jax_rotations(seed, h, d, n_hashes, half):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (h, d, n_hashes, half), jnp.float32))


@pytest.fixture
def inject_rotations(monkeypatch):
    """The port's rotations become JAX's of PRNGKey(seed); counts draws."""
    calls = []

    def install(seed):
        def draw(h, d, n_hashes, half, generator, device):
            calls.append((h, d, n_hashes, half))
            return tt(jax_rotations(seed, h, d, n_hashes, half)).to(device)

        monkeypatch.setattr(TL, "draw_rotations", draw)
        return calls

    return install


# -- hashing and sorting ------------------------------------------------------------


def _heads(seed=0, b=2, h=2, l=64, d=16, pad=10):
    rng = np.random.default_rng(seed)
    qk = rng.standard_normal((b, h, l, d)).astype(np.float32)
    v = rng.standard_normal((b, h, l, d)).astype(np.float32)
    mask = np.arange(l)[None, :] < np.asarray([l, l - pad])[:, None]
    return qk, v, mask


@pytest.mark.parametrize("num_buckets,n_hashes,masked,l,pad", [
    pytest.param(8, 2, True, 64, 10, id="8-2-True"),
    pytest.param(8, 3, False, 64, 10, id="8-3-False"),
    pytest.param([4, 6], 2, True, 64, 10, id="num_buckets2-2-True"),
    # lengths that are not a power of two, at the auto bucket counts of
    # chunk 16 and 64; one round; one batch row masked whole
    pytest.param(TL.auto_num_buckets(96, 16), 2, True, 96, 30, id="L96-c16"),
    pytest.param(TL.auto_num_buckets(960, 64), 2, True, 960, 300,
                 id="L960-c64"),
    pytest.param(8, 1, True, 64, 10, id="nh1"),
    pytest.param(8, 2, True, 64, 64, id="row-masked"),
])
def test_hash_and_sort_equal_jax(num_buckets, n_hashes, masked, l, pad):
    qk, _, mask = _heads(l=l, pad=pad)
    mask = mask if masked else None
    rot_size = TL.total_buckets(num_buckets) if isinstance(num_buckets, int) \
        else sum(num_buckets)
    rot = jax_rotations(3, 2, 16, n_hashes, rot_size // 2)
    want = JL.hash_vectors(jnp.asarray(qk), num_buckets, n_hashes, None,
                           None if mask is None else jnp.asarray(mask),
                           rotations=jnp.asarray(rot))
    got = TL.hash_vectors(tt(qk), num_buckets, n_hashes, None,
                          None if mask is None else tt(mask), rotations=tt(rot))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, w in zip(TL._sort_by_bucket(got), JL._sort_by_bucket(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bucket_helpers_equal_jax():
    for l, c in ((1024, 64), (100, 64), (8192, 64), (48, 16), (16, 16)):
        assert TL.auto_num_buckets(l, c) == JL.auto_num_buckets(l, c)
    assert TL.total_buckets([4, 6]) == JL.total_buckets([4, 6]) == 24
    x = np.arange(2 * 5 * 3 * 2, dtype=np.float32).reshape(1, 2, 5, 3, 2)
    for before, after in ((1, 0), (1, 1), (0, 0), (2, 1)):
        np.testing.assert_array_equal(
            TK.look_adjacent(tt(x), before, after).numpy(),
            np.asarray(JL._look_adjacent(jnp.asarray(x), before, after)))


def test_gathers_have_inverse_gather_backward():
    """The permutation gathers against autograd of a plain index gather."""
    rng = np.random.default_rng(1)
    bh, nh, l, w = 3, 2, 10, 4
    idx = np.stack([np.stack([rng.permutation(l) for _ in range(nh)])
                    for _ in range(bh)])
    inv = np.argsort(idx, axis=-1)
    x = torch.tensor(rng.standard_normal((bh, l, w)), requires_grad=True)
    g = torch.tensor(rng.standard_normal((bh, nh * l, w)))
    out = TL._perm_rows_take(x, tt(idx), tt(inv))
    want = x[torch.arange(bh)[:, None], tt(idx).reshape(bh, nh * l)]
    assert torch.equal(out, want)
    (dx,) = torch.autograd.grad(out, x, g)
    (dx_want,) = torch.autograd.grad(want, x, g)
    torch.testing.assert_close(dx, dx_want, rtol=1e-12, atol=1e-12)
    y = torch.tensor(rng.standard_normal((1, bh, nh, l, w)), requires_grad=True)
    out = TL._perm_round_take(y, tt(idx)[None], tt(inv)[None])
    want = torch.gather(y, 3, tt(idx)[None, ..., None].expand(y.shape))
    assert torch.equal(out, want)
    gy = torch.randn(y.shape, dtype=y.dtype)
    torch.testing.assert_close(torch.autograd.grad(out, y, gy)[0],
                               torch.autograd.grad(want, y, gy)[0])


# -- K4 and K5: plain versions against the JAX kernels (interpret mode) ----------


def _chunk_inputs(seed=0, b=2, h=2, nh=2, l=64, c=16, d=32, p_valid=0.85):
    """Sorted-chunk inputs as the pipeline makes them: per round a random
    permutation of the positions (so the wrap across rounds can repeat a
    position in a window), keys the length-normalised queries, and key
    validity from a padded tail."""
    rng = np.random.default_rng(seed)
    nc = nh * l // c
    q = rng.standard_normal((b, h, nc, c, d)).astype(np.float32)
    k = (q / np.sqrt(np.mean(q * q, -1, keepdims=True) + 1e-6)
         * d ** -0.5).astype(np.float32)
    v = rng.standard_normal((b, h, nc, c, d)).astype(np.float32)
    pos = np.stack([np.concatenate([rng.permutation(l) for _ in range(nh)])
                    for _ in range(b * h)]).reshape(b, h, nc, c).astype(np.int32)
    n_valid = int(l * p_valid)
    val = pos < n_valid
    return q, k, v, pos, val


ATTEND_CASES = [(False, 1, 0), (True, 1, 0), (False, 1, 1), (True, 1, 1)]


@pytest.mark.parametrize("causal,before,after", ATTEND_CASES)
def test_attend_reference_matches_jax_kernel(causal, before, after):
    q, k, v, pos, val = _chunk_inputs()
    assert q.shape[2] % 8 == 0   # so the JAX side really runs its kernel
    want_out, want_lse = JK.lsh_attend_chunks_pallas(
        *(jnp.asarray(x) for x in (q, k, v, pos, val)), causal, before, after,
        interpret=True)
    out, lse = TK.lsh_attend_chunks_reference(
        *(tt(x) for x in (q, k, v, pos, val)), causal, before, after)
    scaled_close(out, want_out, TOL)
    scaled_close(lse, want_lse, TOL)


@pytest.mark.parametrize("causal,before,after", ATTEND_CASES)
def test_attend_backward_matches_jax_kernel(causal, before, after):
    """K5's plain version and the port's Function on the CPU against
    jax.vjp of the interpret-mode kernel, cotangents on out and lse."""
    q, k, v, pos, val = _chunk_inputs(seed=1)
    rng = np.random.default_rng(2)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    dlse = rng.standard_normal(q.shape[:4]).astype(np.float32)

    def f(q, k, v):
        return JK.lsh_attend_chunks_pallas(q, k, v, jnp.asarray(pos),
                                           jnp.asarray(val), causal, before,
                                           after, interpret=True)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp((jnp.asarray(dout), jnp.asarray(dlse)))
    got = TK.lsh_attend_bwd_reference(
        *(tt(x) for x in (q, k, v, pos, val, dout, dlse)), causal, before,
        after)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = TK.lsh_attend_chunks_kernel(tq, tk, tv, tt(pos), tt(val),
                                           causal, before, after)
    fn_grads = torch.autograd.grad((out, lse), (tq, tk, tv),
                                   (tt(dout), tt(dlse)))
    for g, f_g, w in zip(got, fn_grads, want):
        scaled_close(g, w, GRAD_TOL)
        assert torch.equal(g, f_g)


def test_attend_reference_is_autograd_of_itself():
    """The written-out backward equals autograd of the plain forward (both
    in f32: summation order only)."""
    q, k, v, pos, val = _chunk_inputs(seed=3, nh=3)
    rng = np.random.default_rng(4)
    dout = tt(rng.standard_normal(q.shape).astype(np.float32))
    dlse = tt(rng.standard_normal(q.shape[:4]).astype(np.float32))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = TK.lsh_attend_chunks_reference(tq, tk, tv, tt(pos), tt(val),
                                              True, 1, 1)
    want = torch.autograd.grad((out, lse), (tq, tk, tv), (dout, dlse))
    got = TK.lsh_attend_bwd_reference(tq.detach(), tk.detach(), tv.detach(),
                                      tt(pos), tt(val), dout, dlse, True, 1, 1)
    for g, w in zip(got, want):
        scaled_close(g, w, TOL)


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, pos, val = (tt(x) for x in _chunk_inputs(d=64))
    with pytest.raises(ValueError, match="device"):
        TK.lsh_attend_fwd(q, k, v, pos, val, True, 1, 0)
    with pytest.raises(ValueError, match="device"):
        TK.lsh_attend_bwd(q, k, v, pos, val, q, pos.float(), True, 1, 0)


# -- positional dropout -------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 12345, 0xFFFFFFFF])
def test_positional_dropout_keep_mask_equals_jax(seed):
    b, h, nc, c, rate = 2, 3, 6, 8, 0.1
    rng = np.random.default_rng(5)
    q_pos = rng.integers(0, 1000, (b, h, nc, c)).astype(np.int32)
    k_pos = rng.integers(0, 1000, (b, h, nc, 2 * c)).astype(np.int32)
    ones = np.ones((b, h, nc, c, 2 * c), np.float32)
    want = JL.positional_dropout(
        jnp.asarray(ones), jnp.asarray(q_pos), jnp.asarray(k_pos),
        JL.dropout_lane(b, h, jnp.arange(nc), 3), jnp.uint32(seed), rate)
    got = TL.positional_dropout(tt(ones), tt(q_pos), tt(k_pos),
                                TL.dropout_lane(b, h, torch.arange(nc), 3),
                                seed, rate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.85 < (got.numpy() > 0).mean() < 0.95


# -- lsh_attention_core and lsh_self_attention -------------------------------------


def _att_cfg(**kw):
    base = dict(kind="lsh", num_heads=2, head_dim=16, num_hashes=2,
                chunk_length=16, num_chunks_before=1, hash_seed=7)
    return AttentionConfig(**{**base, **kw})


@pytest.mark.parametrize("n_hashes,causal,masked", [
    (1, False, True), (2, True, True), (2, False, False), (3, True, False)])
def test_lsh_core_matches_jax(inject_rotations, n_hashes, causal, masked):
    """Forward and gradients w.r.t. qk and v of the whole pipeline."""
    cfg = _att_cfg(num_hashes=n_hashes)
    inject_rotations(cfg.hash_seed)
    qk, v, mask = _heads(seed=n_hashes, l=64)
    mask = mask if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    cot = np.random.default_rng(9).standard_normal(qk.shape).astype(np.float32)

    def jax_loss(qk, v):
        out, buckets = JL.lsh_attention_core(
            qk, v, cfg, jmask, causal, jax.random.PRNGKey(cfg.hash_seed))
        return jnp.sum(out * cot), (out, buckets)

    (_, (want, want_buckets)), want_grads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(qk),
                                                 jnp.asarray(v))
    tqk, tv = (torch.tensor(x, requires_grad=True) for x in (qk, v))
    out, buckets = TL.lsh_attention_core(tqk, tv, cfg,
                                         None if mask is None else tt(mask),
                                         causal, None)
    np.testing.assert_array_equal(buckets.numpy(), np.asarray(want_buckets))
    close(out, want, MODEL_TOL)
    for g, w in zip(torch.autograd.grad(out, (tqk, tv), tt(cot)), want_grads):
        close(g, w, MODEL_TOL)


def test_lsh_core_dropout_matches_jax():
    """Attention dropout 0.1 through the plain attend: the same uint32 seed
    gives the same keep mask, so the outputs agree."""
    cfg = _att_cfg(attention_dropout=0.1)
    qk, v, mask = _heads(seed=4, l=64)
    rot = jax_rotations(cfg.hash_seed, 2, 16, 2, 4)
    key = jax.random.PRNGKey(11)
    seed = int(JF.dropout_seed_from_key(key))
    buckets = jax.jit(lambda qk, mask, rot: JL.hash_vectors(
        qk, 8, 2, None, mask, rotations=rot))(
            jnp.asarray(qk), jnp.asarray(mask), jnp.asarray(rot))

    @jax.jit
    def jax_core(rng):
        return JL.lsh_attention_core(jnp.asarray(qk), jnp.asarray(v), cfg,
                                     jnp.asarray(mask), True, None,
                                     buckets=buckets, dropout_rng=rng)[0]

    want, no_drop = jax_core(key), jax_core(None)
    got, _ = TL.lsh_attention_core(tt(qk), tt(v), cfg, tt(mask), True, None,
                                   buckets=tt(np.asarray(buckets)).long(),
                                   dropout_seed=seed)
    assert np.abs(np.asarray(want) - np.asarray(no_drop)).max() > 1e-2
    close(got, want, MODEL_TOL)


def _attn_params(seed, d_model=32, heads=2, head_dim=16):
    jp = JFULL.attention_init(jax.random.PRNGKey(seed), d_model, heads,
                              head_dim, shared_qk=True)
    tp = from_numpy_tree(TFULL.Attention(d_model, heads, head_dim, True),
                         jax.tree.map(np.asarray, jp))
    return jp, tp


@pytest.mark.parametrize("n_hashes,causal,l,dropout", [
    (1, True, 64, False), (2, False, 48, False), (2, True, 64, True),
    (2, True, 16, False)])   # L <= chunk: the full-attention fallback
def test_lsh_self_attention_matches_jax(inject_rotations, n_hashes, causal, l,
                                        dropout):
    cfg = _att_cfg(num_hashes=n_hashes,
                   attention_dropout=0.1 if dropout else 0.0)
    calls = inject_rotations(cfg.hash_seed)
    jp, tp = _attn_params(n_hashes)
    rng = np.random.default_rng(l)
    x = rng.standard_normal((2, l, 32)).astype(np.float32)
    mask = np.arange(l)[None, :] < np.asarray([l, l - 5])[:, None]
    cot = rng.standard_normal(x.shape).astype(np.float32)
    key = jax.random.PRNGKey(21)
    seed = (int(JF.dropout_seed_from_key(jax.random.fold_in(key, 7)))
            if dropout else None)

    def jax_loss(p, x):
        out, _ = JL.lsh_self_attention(p, x, jnp.asarray(mask), causal, cfg,
                                       key, deterministic=not dropout)
        return jnp.sum(out * cot), out

    (_, want), (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    out, cache = TL.lsh_self_attention(tp, tx, tt(mask), causal, cfg, None,
                                       dropout_seed=seed)
    close(out, want, MODEL_TOL)
    names = [n for n, _ in tp.named_parameters()]
    grads = torch.autograd.grad(out, [tx, *tp.parameters()], tt(cot))
    close(grads[0], want_gx, MODEL_TOL)
    want_p = dict(from_numpy_tree(
        TFULL.Attention(32, 2, 16, True),
        jax.tree.map(np.asarray, want_gp)).named_parameters())
    for name, g in zip(names, grads[1:]):
        close(g, want_p[name].detach(), MODEL_TOL)
    assert len(calls) == (0 if l <= cfg.chunk_length else 1)
    assert cache.buckets.shape == ((0,) if l <= cfg.chunk_length
                                   else (2, 2, n_hashes, l))


def test_use_pallas_knob_and_sort_gather():
    assert TL._pick_attend_fn(_att_cfg()) is TK.lsh_attend_chunks_kernel
    assert TL._pick_attend_fn(_att_cfg(use_pallas=True)) \
        is TK.lsh_attend_chunks_kernel
    assert TL._pick_attend_fn(_att_cfg(use_pallas=False)) is TL.plain_attend
    assert TL.plain_attend.func is TK.lsh_attend_chunks_reference
    with pytest.raises(ValueError):
        TL._pick_attend_fn(_att_cfg(use_pallas="always"))
    qk, v, mask = (tt(x) for x in _heads())
    with pytest.raises(ValueError, match="sort_gather"):
        TL.lsh_attention_core(qk, v, _att_cfg(sort_gather="gather"), mask,
                              True, None)
    with pytest.raises(ValueError, match="overflow"):
        TL.lsh_attention_core(qk, v, _att_cfg(num_buckets=2**26), mask, True,
                              None)


# -- sort_gather: the one-hot matmul permutation (tests/test_sort_gather.py) -------


def _sg_cfg(sort_gather, nh=2, **kw):
    return _att_cfg(**{"num_hashes": nh, "hash_seed": 5,
                       "sort_gather": sort_gather, **kw})


def _sg_core(mode, nh, causal, dtype=torch.float32, **kw):
    """Both modes on the same inputs and generator: (out, dqk, dv) of the
    loss sum(out ** 2)."""
    qk, v, mask = _heads(seed=nh)
    tqk, tv = (torch.tensor(x, dtype=dtype, requires_grad=True)
               for x in (qk, v))
    out, _ = TL.lsh_attention_core(tqk, tv, _sg_cfg(mode, nh, **kw),
                                   tt(mask), causal,
                                   torch.Generator().manual_seed(3))
    return (out, *torch.autograd.grad(out.float().square().sum(), (tqk, tv)))


@pytest.mark.parametrize("nh", [1, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_onehot_equals_take_f32(nh, causal):
    """One matched element per one-hot row: the gather is exact, and the
    folded combine sums the same two products."""
    take, onehot = (_sg_core(mode, nh, causal) for mode in ("take", "onehot"))
    assert torch.equal(onehot[0], take[0])


def test_onehot_close_to_take_bf16():
    # the combine weight multiplies in bf16 in the onehot path, in f32 in
    # take's (JAX's test_sort_gather.py tolerance)
    take, onehot = (_sg_core(mode, 2, True, torch.bfloat16)[0].float()
                    for mode in ("take", "onehot"))
    torch.testing.assert_close(onehot, take, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("nh,causal", [(1, True), (2, True), (3, False)])
def test_grads_match_between_modes(nh, causal):
    take, onehot = (_sg_core(mode, nh, causal) for mode in ("take", "onehot"))
    for a, b in zip(onehot[1:], take[1:]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_hashes,causal,masked", [
    (1, True, True), (2, False, True), (2, True, False)])
def test_onehot_core_matches_jax(inject_rotations, n_hashes, causal, masked):
    """Forward and gradients of the onehot pipeline against JAX's, both on
    the plain attend with exp(s - lse) (use_pallas false, JAX's CPU path)."""
    cfg = _sg_cfg("onehot", n_hashes, use_pallas=False)
    inject_rotations(cfg.hash_seed)
    qk, v, mask = _heads(seed=10 + n_hashes)
    mask = mask if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    cot = np.random.default_rng(4).standard_normal(qk.shape).astype(np.float32)

    def jax_loss(qk, v):
        out, _ = JL.lsh_attention_core(qk, v, cfg, jmask, causal,
                                       jax.random.PRNGKey(cfg.hash_seed))
        return jnp.sum(out * cot), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(qk),
                                                 jnp.asarray(v))
    tqk, tv = (torch.tensor(x, requires_grad=True) for x in (qk, v))
    out, _ = TL.lsh_attention_core(tqk, tv, cfg,
                                   None if mask is None else tt(mask), causal,
                                   None)
    scaled_close(out, want, TOL)
    for g, w in zip(torch.autograd.grad(out, (tqk, tv), tt(cot)), want_grads):
        scaled_close(g, w, GRAD_TOL)


def test_sort_gather_mode_rule():
    """The reference's arguments; "auto" stays "take" (JAX's v5e size gate
    picks "onehot" at these shapes), explicit modes are honoured."""
    for bh, nh, l in ((64, 4, 1024), (16, 4, 4096), (16, 4, 8192)):
        assert TL._sort_gather_mode(_sg_cfg("auto"), bh, nh, l,
                                    torch.bfloat16) == "take"
    assert JL._sort_gather_mode(_sg_cfg("auto"), 64, 4, 1024,
                                jnp.bfloat16) == "onehot"
    for mode in ("take", "onehot"):
        assert TL._sort_gather_mode(_sg_cfg(mode), 1, 1, 64,
                                    torch.float32) == mode
    with pytest.raises(ValueError, match="bogus"):
        TL._sort_gather_mode(_sg_cfg("bogus"), 1, 1, 64, torch.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_reversible_lsh_stack_with_onehot_equals_plain(causal):
    """A reversible LSH stack in onehot mode: its backward replays the
    forward's buckets through the one-hot matmuls and gives the loss and
    gradients of plain residuals; onehot equals take there too."""
    results = {}
    for mode, reversible in (("onehot", True), ("onehot", False),
                             ("take", True)):
        cfg = ReformerStackConfig(
            num_layers=2, d_model=32, d_ff=64, dropout=0.0,
            reversible=reversible, ffn_chunk_size=16, causal=causal,
            attention=_sg_cfg(mode, use_pallas=False, hash_seed=7))
        stack = TS.Stack(cfg, False, generator=torch.Generator().manual_seed(0),
                         device="cpu")
        rng = np.random.default_rng(12)
        x = torch.tensor(rng.standard_normal((2, 64, 32)).astype(np.float32),
                         requires_grad=True)
        mask = tt(np.arange(64)[None, :] < np.asarray([64, 51])[:, None])
        loss = TS.stack_apply(stack, cfg, x, mask).square().mean()
        results[mode, reversible] = (loss, *torch.autograd.grad(
            loss, [x, *stack.parameters()]))
    plain = results["onehot", False]
    scale = max(float(g.abs().max()) for g in plain[1:])
    for key in (("onehot", True), ("take", True)):
        torch.testing.assert_close(results[key][0], plain[0], rtol=1e-5,
                                   atol=0)
        for g, p in zip(results[key][1:], plain[1:]):
            torch.testing.assert_close(g, p, rtol=2e-3, atol=5e-4 * scale)


def test_plain_attend_equals_kernel_path_on_ordinary_rows():
    """use_pallas false (autograd of the plain attend, exp(s - lse)) and the
    kernel path (on the CPU, the autograd.Function: K4's plain version and
    the written-out K5 backward) give the same layer output and gradients
    where no row is left with only a self entry seen twice."""
    cfg = _att_cfg()
    qk, v, _ = _heads(seed=6)
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    cot = tt(np.random.default_rng(8).standard_normal(qk.shape).astype(
        np.float32))
    results = []
    for use_pallas in (True, False):
        tqk, tv = (torch.tensor(x, requires_grad=True) for x in (qk, v))
        out, _ = TL.lsh_attention_core(tqk, tv, dataclasses.replace(
            cfg, use_pallas=use_pallas), None, False, gen())
        results.append((out, *torch.autograd.grad(out, (tqk, tv), cot)))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


# -- the slice: one f32 train step of a tiny LSH model ------------------------------


def _lsh_model_cfg():
    cfg = tiny_cfg(d=32)
    att = _att_cfg(num_hashes=2, chunk_length=16)
    stacks = {name: dataclasses.replace(stack, num_layers=1, attention=att)
              for name, stack in (("encoder", cfg.encoder),
                                  ("decoder", cfg.decoder))}
    return dataclasses.replace(cfg, enc_prenet_dropout=0.0,
                               dec_prenet_dropout=0.0, postnet_dropout=0.0,
                               **stacks)


def _lsh_batch(cfg, seed, b=2, l=40, t=50):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(3, cfg.vocab_size, (b, l)).astype(np.int32),
        "token_mask": np.arange(l)[None, :] < np.asarray([l, 29])[:, None],
        "mel": (0.5 * rng.standard_normal((b, t, cfg.n_mels))).astype(
            np.float32),
        "mel_mask": np.arange(t)[None, :] < np.asarray([t, 37])[:, None],
    }


def test_lsh_train_step_matches_jax(inject_rotations):
    """One f32 train step (1 + 1 LSH layers, 2 hashes, chunk 16, dropout 0,
    Adam + clip at a constant lr): loss, grad_norm, every gradient leaf and
    the parameters after the update."""
    cfg = _lsh_model_cfg()
    calls = inject_rotations(cfg.encoder.attention.hash_seed)
    optim = OptimConfig(schedule="constant", learning_rate=1e-3,
                        grad_clip_norm=1.0)
    lr = optim.learning_rate
    jp = JM.init(jax.random.PRNGKey(6), cfg)
    tm = from_numpy_tree(TM.init(cfg, device="cpu"),
                         jax.tree.map(np.asarray, jp))
    names = [n for n, _ in tm.named_parameters()]
    batch = _lsh_batch(cfg, seed=13)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}

    def loss_fn(p):
        from rtts.train import losses as JLS

        pre, post, stop = JM.forward(p, cfg, jb["tokens"], jb["token_mask"],
                                     jb["mel"], jb["mel_mask"])
        total, _ = JLS.tts_loss(pre, post, stop, jb["mel"],
                                JLS.make_stop_target(jb["mel_mask"]),
                                jb["mel_mask"], cfg.stop_pos_weight)
        return total

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    j_opt = JO.make_optimizer(optim)
    jp2, _, j_metrics = jax.jit(jax_make_train_step(cfg, j_opt))(
        jp, j_opt.init(jp), jb, jax.random.PRNGKey(0), 0)

    t_opt = TO.make_optimizer(optim)
    t_state = t_opt.init(list(tm.parameters()))
    metrics, grads = make_train_step(cfg, t_opt)(
        tm, t_state, {"tokens": tt(batch["tokens"]).long(),
                      "token_mask": tt(batch["token_mask"]),
                      "mel": tt(batch["mel"]), "mel_mask": tt(batch["mel_mask"])},
        step_generator(0, 0, "cpu"), 0, return_grads=True)
    # one draw per LSH layer: the encoder's (48 tokens) and the decoder's
    assert len(calls) == 2
    close(metrics["loss"], want_loss, MODEL_TOL)
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


def test_stack_draws_rotations_per_layer(monkeypatch):
    """No hash_seed and no generator: one device generator seeded 0 feeds
    the layers in turn (the layers' rotations differ, and two serving calls
    draw the same ones); a training generator draws others; hash_seed gives
    every layer the rotations of its seed."""
    drawn = []
    draw = TL.draw_rotations

    def recording(*args):
        drawn.append(draw(*args))
        return drawn[-1]

    monkeypatch.setattr(TL, "draw_rotations", recording)
    base = _lsh_model_cfg()
    cfg = dataclasses.replace(base, encoder=dataclasses.replace(
        base.encoder, num_layers=2, attention=_att_cfg(hash_seed=None)))
    tm = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    b = _lsh_batch(cfg, seed=3)
    tokens, mask = tt(b["tokens"]).long(), tt(b["token_mask"])
    with torch.no_grad():
        one = TM.encode(tm, cfg, tokens, mask)
        two = TM.encode(tm, cfg, tokens, mask)
        TM.encode(tm, cfg, tokens, mask,
                  generator=torch.Generator().manual_seed(5))
        seeded = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, attention=_att_cfg(hash_seed=3)))
        TM.encode(tm, seeded, tokens, mask)
    assert torch.equal(one, two) and len(drawn) == 8
    assert not torch.equal(drawn[0], drawn[1])
    assert torch.equal(drawn[0], drawn[2]) and torch.equal(drawn[1], drawn[3])
    assert not torch.equal(drawn[4], drawn[0])
    assert torch.equal(drawn[6], drawn[7])
