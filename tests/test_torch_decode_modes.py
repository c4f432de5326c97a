"""The rtts_torch decode caches and the rest of ``decode.py`` against rtts
(JAX), small, on the CPU: kv_local, kv_lsh, kv_lsh_chunk (once with a ring
small enough to evict), the e4m3 cache, staged buffers, ``unroll``,
``attn_window``, ``decode_greedy_recompute``, ``decode_teacher_check``, the
Synthesizer's decode arguments, and the alignment diagnostics with the
eval's scalars.

One parameter tree made by the JAX package's init is loaded into the port;
both decoders read the same encoder memory (the JAX encoder's; the
Synthesizer case encodes on each side).  Every dropout rate is 0 (JAX's
Threefry bits cannot be matched); the LSH decoders set ``hash_seed``, and
JAX's rotations (``_decode_rotations``) are injected through the port's
``draw_rotations``.  Everything is float32, the JAX side at "highest"
matmul precision (tests/conftest.py).

Tolerances, max |port - JAX| / max(1, |JAX|) on mel and stop logits, with
the lengths equal: 1e-4 for every mode and cache dtype (summation order
compounded through the AR loop; the e4m3 casts of both sides round the
same f32 values to nearest even, and a value on a rounding boundary would
show as one e4m3 step, 2^-3 relative, far above this); the reference's own
block-vs-eager tolerance (atol 2e-3, rtol 1e-2, ``tests/test_decode_modes.
py``) for ``unroll`` > 1 against JAX's block decoding; the stored e4m3
caches bit for bit; ``decode_teacher_check`` against the port's
``decode_train`` at the JAX test's 2e-4 / 1e-3; kv_lsh_chunk against kv_lsh
inside the port 1e-5; the alignment map 1e-5 and its scalars 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtts import config as JC
from rtts.infer import decode as JD
from rtts.infer import diagnostics as JDG
from rtts.models import reformer_tts as JM
from rtts.text import vocab_size
from rtts.train.quality import attention_diagonality as jax_diagonality
from rtts_torch import config as TC
from rtts_torch.attention import lsh as TL
from rtts_torch.convert import from_numpy_tree
from rtts_torch.infer import decode as TD
from rtts_torch.infer import diagnostics as TDG
from rtts_torch.models import reformer_tts as TM
from rtts_torch.train.quality import attention_diagonality

TOL = 1e-4
BLOCK_ATOL, BLOCK_RTOL = 2e-3, 1e-2
TEACHER_ATOL, TEACHER_RTOL = 2e-4, 1e-3
TIGHT = 1e-5
B, L = 2, 16
CHUNK = 4


def jax_cfg(dec_kind="full", attn_layers=None, r=1, kv="compute", **att):
    enc = JC.AttentionConfig(kind="full", num_heads=2, head_dim=16)
    dec = JC.AttentionConfig(kind=dec_kind, num_heads=2, head_dim=16,
                             chunk_length=CHUNK, num_chunks_before=1,
                             num_hashes=2, hash_seed=5, **att)
    stack = dict(d_model=32, d_ff=64, dropout=0.0, reversible=False)
    return JC.ReformerTTSConfig(
        vocab_size=vocab_size(), d_model=32, n_mels=20,
        encoder=JC.ReformerStackConfig(num_layers=2, causal=False,
                                       attention=enc, **stack),
        decoder=JC.ReformerStackConfig(num_layers=2, causal=True,
                                       attention=dec, attn_layers=attn_layers,
                                       **stack),
        dec_prenet_hidden=16, dec_prenet_dropout=0.0, postnet_channels=16,
        max_pos=256, compute_dtype="float32", reduction_factor=r,
        kv_cache_dtype=kv)


def port_cfg(cfg):
    return TC.from_dict(TC.ReformerTTSConfig, JC.to_dict(cfg))


def tt(x):
    return torch.from_numpy(np.array(x))


def scaled_err(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


class Case:
    """One config's JAX params, port model and encoder memory."""

    def __init__(self, cfg, seed=1):
        self.cfg, self.tcfg = cfg, port_cfg(cfg)
        self.jp = JM.init(jax.random.PRNGKey(seed), cfg)
        self.tm = from_numpy_tree(TM.init(self.tcfg, device="cpu"),
                                  jax.tree.map(np.asarray, self.jp))
        rng = np.random.default_rng(seed)
        self.tokens = rng.integers(3, vocab_size(), (B, L)).astype(np.int32)
        self.mask = np.arange(L)[None, :] < np.asarray([L, 11])[:, None]
        self.memory = JM.encode(self.jp, cfg, jnp.asarray(self.tokens),
                                jnp.asarray(self.mask))

    def with_kv(self, kv):
        """The same weights under another kv_cache_dtype."""
        other = object.__new__(Case)
        other.__dict__.update(self.__dict__)
        other.cfg = dataclasses.replace(self.cfg, kv_cache_dtype=kv)
        other.tcfg = port_cfg(other.cfg)
        return other

    def jax(self, max_frames, mode, thr=2.0, **kw):
        kw.setdefault("staged", False)
        return JD.decode_greedy(self.jp, self.cfg, self.memory,
                                jnp.asarray(self.mask), max_frames=max_frames,
                                stop_threshold=thr, mode=mode, **kw)

    def port(self, max_frames, mode, thr=2.0, **kw):
        return TD.decode_greedy(self.tm, self.tcfg, tt(self.memory),
                                tt(self.mask), max_frames=max_frames,
                                stop_threshold=thr, mode=mode, **kw)


@pytest.fixture(scope="module")
def full_case():
    return Case(jax_cfg("full"))


@pytest.fixture(scope="module")
def local_case():
    # parity_local's decoder shape: [local, lsh] with reduction factor 2;
    # 24 groups wrap the 8-slot ring three times
    return Case(jax_cfg("lsh", ["local", "lsh"], r=2))


@pytest.fixture(scope="module")
def local_full_case():
    # [local, full]: kv_local serves both layers exactly as training runs
    # them (an LSH layer it serves through the full-prefix superset)
    return Case(jax_cfg("local", ["local", "full"], r=2))


@pytest.fixture(scope="module")
def lsh_case():
    return Case(jax_cfg("lsh"))


@pytest.fixture(scope="module")
def evict_case():
    # 2 buckets over 32 groups: each bucket gets ~16 keys for a ring of 8
    return Case(jax_cfg("lsh", num_buckets=2))


@pytest.fixture
def inject_rotations(monkeypatch):
    """The port's decode draws JAX's rotations for (cfg, max_frames), layer
    by layer; returns the draw count."""
    calls = []

    def install(cfg, max_frames):
        rots, _ = JD._decode_rotations(cfg, jax.random.PRNGKey(0), max_frames)

        def draw(h, d, n_hashes, half, generator, device):
            calls.append((h, d, n_hashes, half))
            return tt(rots[(len(calls) - 1) % len(rots)]).to(device)

        monkeypatch.setattr(TL, "draw_rotations", draw)
        return calls

    return install


def assert_decodes_match(got, want, tol=TOL):
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    assert scaled_err(got.mel_post, want.mel_post) <= tol
    assert scaled_err(got.stop_logits, want.stop_logits) <= tol


# -- the modes ------------------------------------------------------------------


@pytest.mark.parametrize("which,mode,max_frames", [
    ("local", "kv_local", 48),
    ("lsh", "kv_lsh", 32),
    ("lsh", "kv_lsh_chunk", 32),
    ("evict", "kv_lsh_chunk", 32),
])
def test_mode_matches_jax(request, inject_rotations, which, mode,
                          max_frames):
    case = request.getfixturevalue(f"{which}_case")
    calls = inject_rotations(case.cfg, max_frames)
    want = case.jax(max_frames, mode)
    got = case.port(max_frames, mode)
    assert_decodes_match(got, want)
    assert len(calls) == (2 if mode != "kv_local" else 0)


def test_ring_evicts_and_lsh_chunk_equals_lsh_without_overflow(
        lsh_case, evict_case, inject_rotations):
    """kv_lsh_chunk gathers what kv_lsh's bucket mask admits while no
    bucket outgrows its ring (8 groups for a ring of 8 can never
    overflow), and differs once one does (evict_case: 2 buckets over 32
    groups)."""
    inject_rotations(lsh_case.cfg, 8)
    ring = lsh_case.port(8, "kv_lsh_chunk")
    mask = lsh_case.port(8, "kv_lsh")
    assert scaled_err(ring.mel_post, mask.mel_post) <= TIGHT
    inject_rotations(evict_case.cfg, 32)
    ring = evict_case.port(32, "kv_lsh_chunk")
    mask = evict_case.port(32, "kv_lsh")
    assert scaled_err(ring.mel_post, mask.mel_post) > 1e-3


def test_rotations_from_hash_seed_alone_and_apart_from_the_prenet(lsh_case):
    cfg = lsh_case.tcfg
    a, nb = TD._decode_rotations(cfg, torch.Generator().manual_seed(3), 32,
                                 "cpu")
    b, _ = TD._decode_rotations(cfg, None, 32, "cpu")
    assert nb == TL.total_buckets(TL.auto_num_buckets(32, CHUNK))
    assert a[0].shape == (2, 16, 2, nb // 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    free = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, attention=dataclasses.replace(cfg.decoder.attention,
                                                   hash_seed=None)))
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()
    c, _ = TD._decode_rotations(free, gen, 32, "cpu")
    assert torch.equal(gen.get_state(), before)
    d, _ = TD._decode_rotations(free, torch.Generator().manual_seed(4), 32,
                                "cpu")
    assert not torch.equal(c[0], d[0])


@pytest.mark.parametrize("name", ["longform_8k", "serving_fast",
                                  "parity_local", "base"])
def test_auto_mode_and_helpers_equal_jax(name):
    from rtts_torch.config import Config, from_dict, load_yaml

    path = f"configs/{name}.yaml"
    jcfg = JC.from_dict(JC.Config, JC.load_yaml(path)).model
    tcfg = from_dict(Config, load_yaml(path)).model
    frames = {"longform_8k": 8192, "serving_fast": 1024,
              "parity_local": 512}.get(name, 1024)
    assert TD._auto_mode(tcfg, frames) == JD._auto_mode(jcfg, frames)
    groups = frames // tcfg.reduction_factor
    assert TD._local_spec(tcfg, groups) == JD._local_spec(jcfg, groups)
    for n, m in ((groups, 128), (48, 8), (96, 16)):
        assert TD._stage_sizes(n, m) == JD._stage_sizes(n, m)
    assert TD._auto_staged(groups) == JD._auto_staged(groups)
    want = {"longform_8k": "kv_lsh_chunk", "serving_fast": "kv_full",
            "parity_local": "kv_local", "base": "kv_full"}[name]
    assert TD._auto_mode(tcfg, frames) == want


# -- the cache dtype ------------------------------------------------------------


def test_e4m3_stores_equal_jax_bit_for_bit(full_case):
    """One kv_full step's stored K/V, the cross-attention K/V, and values
    past +-448 (saturated, not NaN) and in the subnormal range."""
    x = np.array([0.0, 1e-3, -3e-3, 0.1, 447.0, 460.0, 1e4, -1e4, np.inf,
                  -700.0, 2.0 ** -9, 3.3], np.float32)
    want = np.asarray(JD._to_kv(jnp.asarray(x), jnp.float8_e4m3fn))
    got = TD._to_kv(tt(x), torch.float8_e4m3fn)
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  want.view(np.uint8))
    assert np.isfinite(got.float().numpy()).all()
    case = full_case.with_kv("float8_e4m3fn")
    p = case.jp["decoder"]["layers"][0]["f"]["attn"]
    rng = np.random.default_rng(5)
    h = (rng.standard_normal((B, 32)) * 300).astype(np.float32)
    shape = (B, 8, 2, 16)
    _, jk, jv = JD._self_attn_step(p, jnp.asarray(h),
                                   jnp.zeros(shape, jnp.float8_e4m3fn),
                                   jnp.zeros(shape, jnp.float8_e4m3fn),
                                   jnp.asarray(3), 2, jnp.float32)
    tk, tv = (TD._zeros(shape, torch.float8_e4m3fn, "cpu") for _ in range(2))
    TD._self_attn_step(case.tm.decoder.layers[0].f.attn, tt(h), tk, tv, 3, 2,
                       torch.float32)
    assert np.abs(np.asarray(jv, np.float32)).max() == 448.0
    for g, w in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(g.view(torch.uint8).numpy(),
                                      np.asarray(w).view(np.uint8))
    jmk, jmv = JD._init_mem_kv(case.jp, case.cfg, case.memory * 300,
                               jnp.float32)
    tmk, tmv = TD._init_mem_kv(case.tm, case.tcfg, tt(case.memory) * 300,
                               torch.float32, torch.float8_e4m3fn)
    for g, w in zip(tmk + tmv, jmk + jmv):
        np.testing.assert_array_equal(g.view(torch.uint8).numpy(),
                                      np.asarray(w).view(np.uint8))


@pytest.mark.parametrize("which,mode,kv", [
    ("full", "kv_full", "float8_e4m3fn"),
    ("lsh", "kv_lsh", "float8_e4m3fn"),
    ("evict", "kv_lsh_chunk", "float8_e4m3fn"),
    # a 16-bit cache under f32 compute takes the quantized layout too
    ("full", "kv_full", "bfloat16"),
])
def test_cache_dtype_decode_matches_jax(request, inject_rotations, which,
                                        mode, kv):
    case = request.getfixturevalue(f"{which}_case").with_kv(kv)
    inject_rotations(case.cfg, 32)
    assert_decodes_match(case.port(32, mode), case.jax(32, mode))


def test_e4m3_changes_the_output(full_case):
    base = full_case.port(32, "kv_full")
    f8 = full_case.with_kv("float8_e4m3fn").port(32, "kv_full")
    assert scaled_err(f8.mel_post, base.mel_post) > 1e-4


# -- staged, unroll, attn_window --------------------------------------------------


@pytest.mark.parametrize("staged", [True, False])
def test_staged_matches_jax(full_case, staged):
    """stage_min 8 at 32 groups: stages 8, 16, 32; early stops on."""
    thr = 0.3
    want = full_case.jax(32, "kv_full", thr, staged=staged, stage_min=8)
    got = full_case.port(32, "kv_full", thr, staged=staged, stage_min=8)
    assert_decodes_match(got, want)


def test_staged_lsh_buckets_grow(lsh_case, inject_rotations):
    inject_rotations(lsh_case.cfg, 32)
    want = lsh_case.jax(32, "kv_lsh", staged=True, stage_min=8)
    got = lsh_case.port(32, "kv_lsh", staged=True, stage_min=8)
    assert_decodes_match(got, want)


@pytest.mark.parametrize("unroll", [1, 2, 4])
def test_unroll_matches_jax_and_eager(full_case, unroll):
    """A stop threshold that lets rows stop on their own, so blocks run
    past the last stop; unroll 1 exact as the other modes."""
    thr = 0.3
    eager = full_case.port(32, "kv_full", thr)
    got = full_case.port(32, "kv_full", thr, unroll=unroll)
    want = full_case.jax(32, "kv_full", thr, unroll=unroll)
    for a, b in zip(got, eager):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    tol = dict(atol=TOL, rtol=0) if unroll == 1 else dict(atol=BLOCK_ATOL,
                                                          rtol=BLOCK_RTOL)
    np.testing.assert_allclose(got.mel_post.numpy(),
                               np.asarray(want.mel_post), **tol)
    np.testing.assert_allclose(got.stop_logits.numpy(),
                               np.asarray(want.stop_logits), **tol)


def test_unroll_replay_equals_eager_in_the_lsh_modes(local_case):
    eager = local_case.port(48, "kv_local", 0.3)
    block = local_case.port(48, "kv_local", 0.3, unroll=5)  # snaps to 4
    for a, b in zip(block, eager):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["kv_full", "kv_local"])
def test_attn_window_matches_jax(full_case, local_case, mode):
    case = full_case if mode == "kv_full" else local_case
    frames = 32 if mode == "kv_full" else 48
    want = case.jax(frames, mode, attn_window=(1, 2))
    got = case.port(frames, mode, attn_window=(1, 2))
    assert_decodes_match(got, want)
    base = case.port(frames, mode)
    assert scaled_err(got.mel_post, base.mel_post) > 1e-3
    wide = case.port(frames, mode, attn_window=(L, L))
    assert torch.equal(wide.mel_post, base.mel_post)


def test_validation_errors(full_case, local_case):
    with pytest.raises(ValueError, match="attn_window"):
        full_case.port(32, "kv_full", attn_window=(0, 0))
    with pytest.raises(ValueError, match="unroll"):
        full_case.port(32, "kv_full", attn_window=(1, 1), unroll=2)
    with pytest.raises(ValueError, match="kv_local"):
        full_case.port(32, "kv_local")
    with pytest.raises(ValueError, match="unknown decode mode"):
        full_case.port(32, "kv_sparse")
    with pytest.raises(ValueError, match="multiple"):
        local_case.port(31, "kv_local")
    bad = dataclasses.replace(full_case.tcfg, kv_cache_dtype="float8_e5m2")
    with pytest.raises(KeyError, match="kv_cache_dtype"):
        TD.decode_greedy(full_case.tm, bad, tt(full_case.memory),
                         tt(full_case.mask), max_frames=8)


# -- recompute and teacher check -----------------------------------------------------


def test_recompute_matches_jax(full_case):
    want = JD.decode_greedy_recompute(full_case.jp, full_case.cfg,
                                      full_case.memory,
                                      jnp.asarray(full_case.mask),
                                      max_frames=16, stop_threshold=0.3)
    got = TD.decode_greedy_recompute(full_case.tm, full_case.tcfg,
                                     tt(full_case.memory),
                                     tt(full_case.mask), max_frames=16,
                                     stop_threshold=0.3)
    assert_decodes_match(got, want)
    inc = full_case.port(16, "kv_full", 0.3)
    np.testing.assert_array_equal(inc.lengths.numpy(), got.lengths.numpy())
    np.testing.assert_allclose(inc.mel_post.numpy(), got.mel_post.numpy(),
                               atol=5e-4, rtol=1e-3)


def test_teacher_check_kv_local_equals_decode_train(local_full_case):
    """Teacher-forced kv_local against the port's decode_train on a mixed
    local + full decoder (the exact window), and against JAX's teacher
    check."""
    case = local_full_case
    rng = np.random.default_rng(11)
    mel = (0.5 * rng.standard_normal((B, 48, 20))).astype(np.float32)
    teacher = np.asarray(JM.shift_mel(jnp.asarray(mel), 2))
    full = np.ones((B, 48), bool)
    with torch.no_grad():
        pre, _, stop = TM.decode_train(case.tm, case.tcfg, tt(teacher),
                                       tt(full), tt(case.memory),
                                       tt(case.mask))
    got_pre, got_stop = TD.decode_teacher_check(
        case.tm, case.tcfg, tt(case.memory), tt(case.mask), tt(teacher),
        mode="kv_local")
    np.testing.assert_allclose(got_pre.numpy(), pre.numpy(),
                               atol=TEACHER_ATOL, rtol=TEACHER_RTOL)
    np.testing.assert_allclose(got_stop.numpy(), stop.numpy(),
                               atol=TEACHER_ATOL, rtol=TEACHER_RTOL)
    want_pre, want_stop = JD.decode_teacher_check(
        case.jp, case.cfg, case.memory, jnp.asarray(case.mask),
        jnp.asarray(teacher), mode="kv_local")
    assert scaled_err(got_pre, want_pre) <= TOL
    assert scaled_err(got_stop, want_stop) <= TOL
    # the window matters: kv_full's superset differs from training
    sup, _ = TD.decode_teacher_check(case.tm, case.tcfg, tt(case.memory),
                                     tt(case.mask), tt(teacher))
    assert np.abs(sup.numpy() - pre.numpy()).max() > 1e-3


# -- the Synthesizer -------------------------------------------------------------------


def test_synthesizer_takes_the_decode_arguments(local_case):
    """attn_window, unroll and staged reach the decode, against the JAX
    Synthesizer (mode auto resolves kv_local on both)."""
    from rtts.infer.synthesize import Synthesizer as JaxSynthesizer
    from rtts_torch.infer.synthesize import Synthesizer

    case = local_case
    data = {"model": JC.to_dict(case.cfg),
            "dataset": {"audio": {"n_mels": case.cfg.n_mels}}}
    jfull = JC.from_dict(JC.Config, data)
    tfull = TC.from_dict(TC.Config, data)
    texts = ["hello world", "a second, longer sentence"]
    kw = dict(max_frames=32, staged=True, attn_window=(2, 3))
    want_mel, want_len = JaxSynthesizer(jfull, case.jp, **kw).text_to_mel(
        texts)
    syn = Synthesizer(tfull, case.tm, **kw)
    got_mel, got_len = syn.text_to_mel(texts)
    np.testing.assert_array_equal(got_len, want_len)
    assert scaled_err(got_mel, want_mel) <= TOL
    blocks = Synthesizer(tfull, case.tm, max_frames=32, unroll=4)
    np.testing.assert_array_equal(
        blocks.text_to_mel(texts)[0],
        Synthesizer(tfull, case.tm, max_frames=32).text_to_mel(texts)[0])


# -- diagnostics -----------------------------------------------------------------------


def test_alignment_map_and_eval_scalars_match_jax(local_full_case):
    case = local_full_case
    rng = np.random.default_rng(12)
    mel = (0.5 * rng.standard_normal((B, 40, 20))).astype(np.float32)
    mmask = np.arange(40)[None, :] < np.asarray([40, 27])[:, None]
    args = (case.tokens, case.mask, mel, mmask)
    want = np.asarray(JDG.alignment_map(case.jp, case.cfg,
                                        *map(jnp.asarray, args)))
    got = TDG.alignment_map(case.tm, case.tcfg, *map(tt, args)).numpy()
    assert got.shape == want.shape == (B, 20, L)
    np.testing.assert_allclose(got, want, atol=TIGHT, rtol=0)
    for layer in (0, 1):
        probs = TDG.decoder_cross_attention(case.tm, case.tcfg,
                                            *map(tt, args))[layer]
        np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=TIGHT)
    for i in range(B):
        n_rows = -(-int(mmask[i].sum()) // 2)
        n_tok = int(case.mask[i].sum())
        np.testing.assert_allclose(
            attention_diagonality(got[i], n_rows, n_tok),
            jax_diagonality(want[i], n_rows, n_tok), atol=TIGHT)
    # the replay's hidden state is decode_train's (same stack, same math)
    with torch.no_grad():
        _, y = TDG._replay(case.tm, case.tcfg, *map(tt, args))
    _, jy = JDG._replay(case.jp, case.cfg, *map(jnp.asarray, args))
    assert scaled_err(y, jy) <= TOL
