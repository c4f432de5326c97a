"""The port's bf16 LSH and local paths against the JAX package's, on the
CPU: the chunk attend (K4/K5's plain versions), LSH and local attention
layers, and ``configs/serving_fast.yaml``'s (reversible LSH stacks, the
e4m3 cache), ``configs/longform_8k.yaml``'s (LSH, ``kv_lsh_chunk``) and
``configs/parity_local.yaml``'s (local decoder layers) structures at d 32,
2 heads x 16, 2 + 2 layers, chunks of 8.

As ``tests/test_torch_bf16.py`` (its helpers and its three distances per
case, ``pytest -s``).  JAX's Threefry rotations cannot be drawn in torch:
every config sets ``hash_seed``, JAX's rotations are injected through the
port's ``draw_rotations`` (training) and ``draws.draw_rotations``
(decoding), and the buckets are compared first: hashing runs in f32 from
the bf16 projections on both sides (``rtts/attention/lsh.py``), and a
one-ulp difference in qk could flip a bucket, which would change rows by
O(1).  At these seeds no bucket differs (asserted), so every row is held.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtts import config as JC
from rtts.attention import lsh as JLSH
from rtts.attention import local as JLOC
from rtts.infer import decode as JD
from rtts.models import reformer_tts as JM
from rtts.text import vocab_size
from rtts_torch.attention import lsh as TLSH
from rtts_torch.attention import local as TLOC
from rtts_torch.convert import from_numpy_tree
from rtts_torch.infer import decode as TD
from rtts_torch.infer import draws
from rtts_torch.models import reformer_tts as TM
from rtts_torch.ops import lsh_attention as TK
from tests.test_torch_bf16 import (BF, F32, FORWARD_RATIO, GRAD_RATIO, JDT,
                                   NOISE_RATIO, ROOT, TDT, batch_np, dist,
                                   f32, leaf_distances, np_tree, port_cfg,
                                   record, same_dtype, torch_batch, tt)
from tests.test_torch_lsh import jax_rotations
from torch_twin import one_thread  # noqa: F401  (autouse)


HASH_SEED = 5
STRUCTURES = {
    # config file: its decode mode
    "serving_fast": "kv_full",
    "longform_8k": "kv_lsh_chunk",
    "parity_local": "kv_local",
}


def structure_cfg(name, dtype=BF) -> JC.ReformerTTSConfig:
    """The config file's model at d 32, 2 heads x 16, 2 + 2 layers,
    n_mels 20, chunks of 8 (its hash count, reversibility, layer kinds,
    reduction factor and cache dtype kept); dropout 0."""
    layers = ["num_layers=2", "d_model=32", "d_ff=64", "dropout=0.0",
              "attention.num_heads=2", "attention.head_dim=16",
              "attention.chunk_length=8", f"attention.hash_seed={HASH_SEED}",
              "attention.attention_dropout=0.0"]
    over = ["model.d_model=32", "model.n_mels=20", "model.max_pos=256",
            f"model.vocab_size={vocab_size()}", "model.dec_prenet_hidden=16",
            "model.postnet_channels=16", "model.dec_prenet_dropout=0.0",
            "model.enc_prenet_dropout=0.0", "model.postnet_dropout=0.0",
            f"model.compute_dtype={dtype}",
            *(f"model.{s}.{k}" for s in ("encoder", "decoder")
              for k in layers)]
    if name == "parity_local":
        over.append('model.decoder.attn_layers=["local", "lsh"]')
    if name != "parity_local":
        over += [f"model.{s}.ffn_chunk_size=8"
                 for s in ("encoder", "decoder")]
    return JC.load_config(ROOT / "configs" / f"{name}.yaml", over).model


@pytest.fixture
def inject(monkeypatch):
    """The port draws JAX's rotations of PRNGKey(HASH_SEED) in training
    and JAX's decode rotations for (cfg, max_frames) when decoding."""
    def install(cfg=None, max_frames=None):
        monkeypatch.setattr(
            TLSH, "draw_rotations",
            lambda h, d, n, half, generator, device: tt(jax_rotations(
                HASH_SEED, h, d, n, half)).to(device))
        if cfg is not None:
            rots, _ = JD._decode_rotations(cfg, jax.random.PRNGKey(0),
                                           max_frames)
            calls = []

            def draw(h, d, n_hashes, half, generator, device):
                calls.append(h)
                return tt(rots[(len(calls) - 1) % len(rots)]).to(device)

            monkeypatch.setattr(draws, "draw_rotations", draw)

    return install


# -- the chunk attend ----------------------------------------------------------------


def _attend_inputs(dt, seed=0, b=2, h=2, nc=6, c=8, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, nc, c, d)).astype(np.float32)
    k = q / np.sqrt(np.mean(q * q, -1, keepdims=True)) * d ** -0.5
    v = rng.standard_normal((b, h, nc, c, d)).astype(np.float32)
    pos = np.stack([rng.permutation(nc * c) for _ in range(b * h)]).reshape(
        b, h, nc, c).astype(np.int32)
    valid = pos < nc * c - 5
    do = rng.standard_normal((b, h, nc, c, d)).astype(np.float32)
    dlse = rng.standard_normal((b, h, nc, c)).astype(np.float32)
    low = [f32(jnp.asarray(a).astype(JDT[dt])) for a in (q, k, v, do)]
    return (*low, pos, valid, dlse)


@pytest.mark.parametrize("attend", ["kernel", "plain"])
def test_chunk_attend_matches_jax(attend):
    """K4's plain version (through its Function, as a layer with
    ``use_pallas`` true or "auto" runs it; normalised P by a softmax) and
    the plain attend (exp(s - lse), as JAX's jnp attend), P rounded to
    bf16 before P.V in both, against the path JAX takes on the CPU (its
    jnp attend, ``rtts/attention/lsh.py``) and its vjp: the output within
    one bf16 ulp (the softmax and exp(s - lse) may round P differently),
    lse within f32 ulps, dQ/dK/dV within GRAD_RATIO x JAX's own
    bf16-vs-f32 distance (K5's plain version keeps K5's f32 P and dS and
    sums the windows in f32; JAX rounds them to bf16)."""
    fn = (TK.lsh_attend_chunks_kernel if attend == "kernel"
          else TLSH.plain_attend)
    res = {}
    for dt in (BF, F32):
        q, k, v, do, pos, valid, dlse = _attend_inputs(dt)
        jargs = [jnp.asarray(a).astype(JDT[dt]) for a in (q, k, v)]
        (jo, jl), vjp = jax.vjp(jax.jit(lambda q, k, v: JLSH.lsh_attend_chunks(
            q, k, v, jnp.asarray(pos), jnp.asarray(valid), True, 1, 0)),
            *jargs)
        jg = vjp((jnp.asarray(do).astype(JDT[dt]), jnp.asarray(dlse)))
        tq, tk, tv = (tt(a).to(TDT[dt]).requires_grad_() for a in (q, k, v))
        to, tl = fn(tq, tk, tv, tt(pos), tt(valid), True, 1, 0)
        torch.autograd.backward((to, tl), (tt(do).to(TDT[dt]), tt(dlse)))
        res[dt] = (jo, jl, jg, to, tl, (tq.grad, tk.grad, tv.grad))
    (jo16, jl16, jg16, to16, tl16, tg16) = res[BF]
    (jo32, jl32, jg32, to32, tl32, tg32) = res[F32]
    d = record(f"chunk attend ({attend}) out", to16, jo16, jo32, to32)
    same_dtype(to16, jo16)
    assert d["port_jax"] <= 2.0 ** -7 * np.abs(f32(jo16)).max()
    record(f"chunk attend ({attend}) lse", tl16, jl16, jl32, tl32)
    assert dist(tl16, jl16) <= 1e-5 * max(1.0, np.abs(f32(jl16)).max())
    for what, a, b, c, e in zip(("dq", "dk", "dv"), tg16, jg16, jg32, tg32):
        d = record(f"chunk attend ({attend}) {what}", a, b, c, e)
        same_dtype(a, b)
        assert d["port_jax"] <= GRAD_RATIO * d["jax16_jax32"], what


# -- the layers ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["lsh_take", "lsh_auto", "local"])
def test_attention_layer_matches_jax(kind, inject):
    """serving_fast's LSH layer (4 hashes) and parity_local's local layer
    on a bf16 stream of 48 positions (6 chunks), causal, padded: the
    buckets equal and the output bit-equal, with ``sort_gather: take`` on
    both sides.  With "auto" (the configs' setting) JAX picks the one-hot
    gather below 4 GiB and the port "take" (a speed choice, PERF.md PR 5);
    JAX's one-hot mode folds the round combine into its unsort matmul in
    bf16, rounding each round's weighted output, where "take" combines in
    f32: within one bf16 ulp of the output's largest."""
    inject()
    name = "parity_local" if kind == "local" else "serving_fast"
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 48, 32)).astype(np.float32)
    mask = np.arange(48)[None] < np.array([48, 37])[:, None]
    cfg = structure_cfg(name)
    if kind == "lsh_take":
        att = dataclasses.replace(cfg.decoder.attention, sort_gather="take")
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, attention=att))
    acfg = cfg.decoder.attention
    tacfg = port_cfg(cfg).decoder.attention
    jp = jax.jit(lambda k: JM.init(k, cfg))(jax.random.PRNGKey(1))
    a = jp["decoder"]["layers"][0]["f"]["attn"]
    ta = from_numpy_tree(TM.init(port_cfg(cfg), device="cpu"),
                         np_tree(jp)).decoder.layers[0].f.attn
    out = {}
    for dt in (BF, F32):
        if kind != "local":
            jo, jc = jax.jit(lambda p, x, m: JLSH.lsh_self_attention(
                p, x, m, True, acfg, None, JDT[dt]))(a, x, mask)
            with torch.no_grad():
                to, tc = TLSH.lsh_self_attention(ta, tt(x), tt(mask), True,
                                                 tacfg, None, TDT[dt])
            np.testing.assert_array_equal(tc.buckets.numpy(), np.asarray(
                jc.buckets))
        else:
            jo = jax.jit(lambda p, x, m: JLOC.local_self_attention(
                p, x, m, True, acfg, JDT[dt]))(a, x, mask)
            with torch.no_grad():
                to = TLOC.local_self_attention(ta, tt(x), tt(mask), True,
                                               tacfg, TDT[dt])
        out[dt] = (jo, to)
    d = record(f"{kind} attention layer", out[BF][1], out[BF][0],
               out[F32][0], out[F32][1])
    same_dtype(out[BF][1], out[BF][0])
    if kind == "lsh_auto":
        assert d["port_jax"] <= 2.0 ** -7 * np.abs(f32(out[BF][0])).max()
    else:
        np.testing.assert_array_equal(f32(out[BF][1]), f32(out[BF][0]))


# -- the structures ----------------------------------------------------------------


@pytest.fixture(scope="module")
def structures():
    """Each structure's configs, JAX params and port models by dtype."""
    out = {}
    for name in STRUCTURES:
        cfgs = {dt: structure_cfg(name, dt) for dt in (BF, F32)}
        jp = jax.jit(lambda k: JM.init(k, cfgs[BF]))(jax.random.PRNGKey(2))
        tms = {dt: from_numpy_tree(TM.init(port_cfg(cfgs[dt]),
                                           device="cpu"), np_tree(jp))
               for dt in (BF, F32)}
        out[name] = (cfgs, jp, tms)
    return out


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_structure_forward_matches_jax(name, structures, inject):
    """The teacher-forced forward (32 tokens, 40 frames: every stack
    longer than one chunk, so LSH and local attention run): mel before and
    after the postnet and the stop logits within FORWARD_RATIO x JAX's
    own bf16-vs-f32 distance where every sublayer matches JAX's bits, else
    within NOISE_RATIO: with ``sort_gather: auto`` JAX's one-hot gather
    rounds the LSH round combine where the port's "take" does not
    (``test_attention_layer_matches_jax``), and the difference spreads as
    bf16 noise (the per-output ratio is printed)."""
    inject()
    cfgs, jp, tms = structures[name]
    batch = batch_np(seed=4, l=32, t=40)
    res = {}
    for dt in (BF, F32):
        cfg = cfgs[dt]
        want = jax.jit(lambda p, b: JM.forward(
            p, cfg, b["tokens"], b["token_mask"], b["mel"], b["mel_mask"]))(
                jp, {k: jnp.asarray(v) for k, v in batch.items()})
        tb = torch_batch(batch)
        with torch.no_grad():
            got = TM.forward(tms[dt], port_cfg(cfg), tb["tokens"],
                             tb["token_mask"], tb["mel"], tb["mel_mask"])
        res[dt] = (want, got)
    for i, out in enumerate(("mel_pre", "mel_post", "stop_logits")):
        d = record(f"{name} forward {out}", res[BF][1][i], res[BF][0][i],
                   res[F32][0][i], res[F32][1][i])
        same_dtype(res[BF][1][i], res[BF][0][i])
        bound = FORWARD_RATIO if d["port_jax"] == 0 else NOISE_RATIO
        assert d["port_jax"] <= bound * d["jax16_jax32"], out


def test_serving_fast_gradients_match_jax(structures, inject):
    """serving_fast's reversible LSH stacks in bf16: the gradient of the
    TTS loss, every leaf within GRAD_RATIO x JAX's own bf16-vs-f32
    distance of its largest (X2 = Y2 - g(Y1) is rebuilt through bf16
    sublayers in both programs, so gradients are compared, not the
    reconstruction)."""
    from rtts.train import losses as JL
    from rtts_torch.train import losses as TL

    inject()
    cfgs, jp, tms = structures["serving_fast"]
    batch = batch_np(seed=5, l=32, t=40)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = torch_batch(batch)
    res = {}
    for dt in (BF, F32):
        cfg, tcfg = cfgs[dt], port_cfg(cfgs[dt])
        assert cfg.encoder.reversible and cfg.decoder.reversible

        def loss(p):
            pre, post, stop = JM.forward(p, cfg, jb["tokens"],
                                         jb["token_mask"], jb["mel"],
                                         jb["mel_mask"])
            return JL.tts_loss(pre, post, stop, jb["mel"],
                               JL.make_stop_target(jb["mel_mask"]),
                               jb["mel_mask"], cfg.stop_pos_weight)[0]

        jg = jax.jit(jax.grad(loss))(jp)
        tm = tms[dt]
        tm.zero_grad(set_to_none=True)
        pre, post, stop = TM.forward(tm, tcfg, tb["tokens"],
                                     tb["token_mask"], tb["mel"],
                                     tb["mel_mask"])
        TL.tts_loss(pre, post, stop, tb["mel"],
                    TL.make_stop_target(tb["mel_mask"]), tb["mel_mask"],
                    tcfg.stop_pos_weight)[0].backward()
        want = dict(from_numpy_tree(TM.init(tcfg, device="cpu"),
                                    np_tree(jg)).named_parameters())
        res[dt] = {n: (p.grad, want[n]) for n, p in tm.named_parameters()
                   if p.grad is not None}
        tm.zero_grad(set_to_none=True)
    assert len(res[BF]) == len(res[F32]) > 0
    port_jax, jax_jax = leaf_distances(res[BF], res[F32])
    print(f"[bf16] serving_fast gradients: port-jax {port_jax:.6g}, "
          f"jax16-jax32 {jax_jax:.6g} (max over leaves, relative)")
    assert port_jax <= GRAD_RATIO * jax_jax


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_structure_decode_matches_jax(name, structures, inject):
    """Each structure's decode mode (serving_fast: kv_full with the e4m3
    cache; longform_8k: kv_lsh_chunk; parity_local: kv_local) on JAX's
    memory, never stopping: the lengths equal, mel and stop logits within
    NOISE_RATIO x JAX's own bf16-vs-f32 distance (each decode step is
    bit-equal, ``tests/test_torch_bf16.py::test_decode_steps_match_jax``;
    over the loop the f32 LayerNorms' ulps flip a bf16 cast now and then,
    and the flip spreads as bf16 noise)."""
    cfgs, jp, tms = structures[name]
    mode = STRUCTURES[name]
    frames = 32
    inject(cfgs[BF], frames)
    rng = np.random.default_rng(6)
    tokens = rng.integers(3, vocab_size(), (2, 24)).astype(np.int32)
    mask = np.arange(24)[None] < np.array([24, 17])[:, None]
    res = {}
    for dt in (BF, F32):
        cfg = cfgs[dt]
        if name == "serving_fast":
            assert cfg.kv_cache_dtype == "float8_e4m3fn"
        mem = jax.jit(lambda p, t, m: JM.encode(p, cfg, t, m))(jp, tokens,
                                                               mask)
        want = JD.decode_greedy(jp, cfg, mem, jnp.asarray(mask),
                                max_frames=frames, stop_threshold=2.0,
                                mode=mode, staged=False)
        with torch.no_grad():
            got = TD.decode_greedy(tms[dt], port_cfg(cfg),
                                   tt(np.asarray(mem)), tt(mask),
                                   max_frames=frames, stop_threshold=2.0,
                                   mode=mode)
        res[dt] = (want, got)
    (w16, g16), (w32, g32) = res[BF], res[F32]
    np.testing.assert_array_equal(g16.lengths.numpy(), np.asarray(
        w16.lengths))
    for f in ("mel_post", "stop_logits"):
        d = record(f"{name} decode {mode} {f}", getattr(g16, f),
                   getattr(w16, f), getattr(w32, f), getattr(g32, f))
        assert d["port_jax"] <= NOISE_RATIO * d["jax16_jax32"], f
