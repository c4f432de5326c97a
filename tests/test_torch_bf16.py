"""The port's bf16 path against the JAX package's, module by module and for
``configs/flagship.yaml``'s and ``configs/base.yaml``'s structures, on the
CPU, at small widths (d 32, 2 heads x 16, 2 + 2 layers, n_mels 20).

The same numpy inputs and one parameter tree (the JAX package's init,
loaded through ``rtts_torch.convert``) go through both packages, the JAX
side jitted as the repo runs it (matmuls at "highest", tests/conftest.py),
in bf16 and in f32.  Every case records three distances at its seed,
printed as ``[bf16] NAME: port-jax A, jax16-jax32 B, port16-port32 C``
(``pytest -s``): port bf16 vs JAX bf16, JAX bf16 vs JAX f32, port bf16 vs
port f32.  Each case asserts the output dtype equals JAX's, then:

- bit equality where the port rounds where the JAX program does: Dense,
  the bf16 LayerNorm, the embedding, GELU, sigmoid, the shared keys
  (``shared_keys``), positions, the decoder prenet, K1's plain version and
  both attention modules, the FFN, K2's plain version in the WN and the WN
  itself, the decode steps, the whole teacher-forced forward at its seed;
- where XLA's CPU backend evaluates otherwise and the JAX source does not
  say so, a bound with the cause at the case: the f32 LayerNorm (XLA's
  reductions and its approximate rsqrt: a few f32 ulps), the conv
  (XLA's f32 accumulation lands on the other side of a bf16 rounding now
  and then: at most one bf16 ulp; the postnet's convs likewise), the
  attention sink (f32 softmax ulps); and where the port keeps the
  kernels' arithmetic on purpose, K3's plain backward (f32 P and dS), a
  bound in units of JAX's own bf16-vs-f32 distance;
- for whole-model outputs, a bound in units of JAX's own bf16-vs-f32
  distance measured in the test: <= 0.5 on the forward; the train step's
  gradients, the decode loop and the vocoder, which carry a rounding
  that differs (see each case), are held to the bound they reach; the
  vocoder is also held to f32 ulps of JAX run eagerly
  (``jax.disable_jit``), where every op rounds to the dtype the source
  states.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtts import config as JC
from rtts.attention import full as JA
from rtts.infer import decode as JD
from rtts.models import reformer_tts as JM
from rtts.models import squeezewave as JS
from rtts.models import stack as JST
from rtts.nn import conv as JCV
from rtts.nn import layers as JL
from rtts.nn import posenc as JP
from rtts.reversible import ffn as JF
from rtts.text import vocab_size
from rtts.train import losses as JLS
from rtts.train import optim as JO
from rtts.train.vocoder_loss import squeezewave_loss as jax_voc_loss
from rtts_torch import config as TC
from rtts_torch.attention import full as TA
from rtts_torch.convert import from_numpy_tree
from rtts_torch.infer import decode as TD
from rtts_torch.models import reformer_tts as TM
from rtts_torch.models import squeezewave as TS
from rtts_torch.models import stack as TST
from rtts_torch.nn import layers as TL
from rtts_torch.ops import flash_attention as TF
from rtts_torch.reversible import ffn as TFF
from rtts_torch.train import optim as TO
from rtts_torch.train.train_tts import make_train_step, step_generator
from rtts_torch.train.train_vocoder import make_train_step as voc_train_step
from tests.test_torch_decode_modes import port_cfg
from tests.test_torch_train import np_tree
from torch_twin import one_thread  # noqa: F401  (autouse)


BF, F32 = "bfloat16", "float32"
JDT = {BF: jnp.bfloat16, F32: jnp.float32}
TDT = {BF: torch.bfloat16, F32: torch.float32}
FORWARD_RATIO = 0.5      # port-vs-JAX <= this x JAX's bf16-vs-f32
# A stack's f32 LayerNorms differ from XLA's by f32 ulps; when one such
# output lies within an ulp of a bf16 rounding boundary, its cast to bf16
# flips, and the flip spreads through the later bf16 sublayers as rounding
# noise of the size bf16 itself adds (decoder stack at this seed: 0.41)
STACK_RATIO = 1.0
# Gradients: torch's autograd rounds where XLA's transposes do not
# (GELU's and tanh's derivatives; the bias gradients, which XLA sums in
# bf16 row by row; K3/K5's plain versions keep f32 P and dS), so every
# gradient carries bf16 noise of its own: 0.35-1.02 of JAX's own
# bf16-vs-f32 distance at these tests' seeds
GRAD_RATIO = 1.5
# Paths that XLA evaluates in excess precision (it fuses across ops and
# drops bf16 roundings the JAX source states) or that meet an f32-ulp flip
# before a bf16 cast: end to end within this x JAX's bf16-vs-f32 distance
# (0.52-1.33 at these tests' seeds)
NOISE_RATIO = 1.5
ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def tt(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def dist(a, b) -> float:
    return float(np.max(np.abs(f32(a) - f32(b)))) if f32(a).size else 0.0


def bf16_ulps(got, want) -> float:
    """Largest |got - want| in bf16 ulps of each element of ``want``
    (elements below 2^-20 count in ulps of 2^-20)."""
    w = np.maximum(np.abs(f32(want)), 2.0 ** -20)
    return float(np.max(np.abs(f32(got) - f32(want))
                        / 2.0 ** (np.floor(np.log2(w)) - 7)))


def record(name, port16, jax16, jax32, port32) -> dict:
    """The three distances of one case, printed for PERF.md's table."""
    d = {"port_jax": dist(port16, jax16), "jax16_jax32": dist(jax16, jax32),
         "port16_port32": dist(port16, port32)}
    print(f"[bf16] {name}: port-jax {d['port_jax']:.6g}, jax16-jax32 "
          f"{d['jax16_jax32']:.6g}, port16-port32 {d['port16_port32']:.6g}")
    return d


def same_dtype(port, jax_out):
    want = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
            jnp.dtype(jnp.float32): torch.float32}[jnp.dtype(jax_out.dtype)]
    assert port.dtype == want, (port.dtype, jax_out.dtype)


# -- the configurations -------------------------------------------------------------


def flagship_cfg(dtype=BF, **kw) -> JC.ReformerTTSConfig:
    """configs/flagship.yaml's model at d 32, 2 heads x 16, 2 + 2 layers,
    n_mels 20: reduction 2, guided attention 2.0 with its decay, kind and
    FFN chunk "auto", a reversible-"auto" encoder and a plain decoder;
    dropout 0 (the frameworks' generators cannot match)."""
    cfg = JC.load_config(ROOT / "configs" / "flagship.yaml", [
        "model.d_model=32", "model.n_mels=20",
        f"model.vocab_size={vocab_size()}", "model.dec_prenet_hidden=16",
        "model.postnet_channels=16", "model.max_pos=256",
        "model.dec_prenet_dropout=0.0", "model.enc_prenet_dropout=0.0",
        "model.postnet_dropout=0.0",
        "model.guided_attention_decay_steps=10",
        *(f"model.{s}.{k}" for s in ("encoder", "decoder") for k in (
            "num_layers=2", "d_model=32", "d_ff=64", "dropout=0.0",
            "attention.num_heads=2", "attention.head_dim=16",
            "attention.attention_dropout=0.0")),
        f"model.compute_dtype={dtype}"]).model
    return dataclasses.replace(cfg, **kw)


def batch_np(seed=2, b=2, l=13, t=21, n_mels=20):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(3, vocab_size(), (b, l)).astype(np.int32),
        "token_mask": np.arange(l)[None, :] < np.asarray([l, 8])[:, None],
        "mel": (0.5 * rng.standard_normal((b, t, n_mels))).astype(
            np.float32),
        "mel_mask": np.arange(t)[None, :] < np.asarray([t, 14])[:, None],
    }


def torch_batch(batch):
    out = {k: tt(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


@pytest.fixture(scope="module")
def model():
    """flagship's structure in bf16 and f32 from one JAX init: (cfgs, JAX
    params, port models) keyed by dtype."""
    cfgs = {dt: flagship_cfg(dt) for dt in (BF, F32)}
    jp = jax.jit(lambda k: JM.init(k, cfgs[BF]))(jax.random.PRNGKey(3))
    tms = {dt: from_numpy_tree(TM.init(port_cfg(cfgs[dt]), device="cpu"),
                               np_tree(jp)) for dt in (BF, F32)}
    return cfgs, jp, tms


# -- layers ------------------------------------------------------------------------


def _layer_cases(jp, tm, rng):
    """name -> (jax fn(dt) -> (function, its arguments), port fn(dt),
    bound): bound "bits", or ("bf16_ulps", n), or ("f32", atol).  The
    arguments go into the jit as arguments: as closure constants XLA would
    fold them at compile time, in other arithmetic."""
    x = rng.standard_normal((2, 12, 32)).astype(np.float32) * 2.0
    xb = f32(jnp.asarray(x).astype(jnp.bfloat16))  # bf16-exact inputs
    g = jp["encoder"]["layers"][0]["g"]
    tg = tm.encoder.layers[0].g
    mel = rng.standard_normal((2, 12, 40)).astype(np.float32)
    tok = rng.integers(3, vocab_size(), (2, 12)).astype(np.int32)
    qk = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    fmask = np.arange(12)[None] < np.array([[12], [9]])
    t = lambda a, dt: tt(a).to(TDT[dt])  # noqa: E731
    return {
        "dense": (lambda dt: (lambda p, x: JL.dense(p, x, JDT[dt]),
                              (g["w_in"], x)),
                  lambda dt: tg.w_in(tt(x), TDT[dt]), "bits"),
        # XLA's f32 mean/variance and its approximate rsqrt: f32 ulps
        "layer_norm_f32_in": (lambda dt: (JL.layer_norm, (g["ln"], x)),
                              lambda dt: tg.ln(tt(x)), ("f32", 1e-6)),
        "layer_norm_bf16_in": (
            lambda dt: (lambda p, x: JL.layer_norm(p, x.astype(JDT[dt])),
                        (g["ln"], xb)),
            lambda dt: tg.ln(t(xb, dt)), "bits"),
        "embedding": (lambda dt: (lambda p, i: JL.embedding(p, i, JDT[dt]),
                                  (jp["embed"], tok)),
                      lambda dt: tm.embed(tt(tok).long(), TDT[dt]), "bits"),
        "gelu": (lambda dt: (lambda x: jax.nn.gelu(x.astype(JDT[dt])), (x,)),
                 lambda dt: TL.activation("gelu")(t(x, dt)), "bits"),
        "sigmoid": (lambda dt: (lambda x: jax.nn.sigmoid(x.astype(JDT[dt])),
                                (x,)),
                    lambda dt: TL.sigmoid(t(x, dt)), "bits"),
        # XLA's f32 conv accumulation rounds to the other bf16 neighbour
        # of an exact sum now and then
        "conv1d": (lambda dt: (lambda p, x: JCV.conv1d(
            p, x, compute_dtype=JDT[dt]), (jp["enc_prenet"][0]["conv"], xb)),
                   lambda dt: tm.enc_prenet[0].conv(tt(xb), TDT[dt]),
                   ("bf16_ulps", 1)),
        "scaled_posenc": (
            lambda dt: (lambda p, x: JP.scaled_posenc(p, x.astype(JDT[dt])),
                        (jp["enc_pos"], x)),
            lambda dt: tm.enc_pos(t(x, dt)), "bits"),
        "dec_prenet_mlp": (
            lambda dt: (lambda p, m: JL.prenet_mlp(
                p, m.astype(JDT[dt]), None, 0.0, compute_dtype=JDT[dt]),
                (jp["dec_prenet"], mel)),
            lambda dt: tm.dec_prenet(t(mel, dt), 0.0, None,
                                     compute_dtype=TDT[dt]), "bits"),
        "shared_keys": (
            lambda dt: (lambda q: JA._len_norm(q.astype(JDT[dt]))
                        * (16 ** -0.5), (qk,)),
            lambda dt: TA.shared_keys(t(qk, dt)), "bits"),
        "chunked_ffn": (lambda dt: (lambda p, x: JF.chunked_ffn(
            p, x, 0, "gelu", JDT[dt]), (g, x)),
                        lambda dt: TFF.chunked_ffn(tg, tt(x), 0, "gelu",
                                                   TDT[dt]), "bits"),
        "chunked_ffn_chunks_of_4": (
            lambda dt: (lambda p, x: JF.chunked_ffn(p, x, 4, "gelu",
                                                    JDT[dt]), (g, x)),
            lambda dt: TFF.chunked_ffn(tg, tt(x), 4, "gelu", TDT[dt]),
            "bits"),
        # its convs: XLA's f32 accumulation, as conv1d
        "postnet": (
            lambda dt: (lambda p, m, fm: JM.postnet_apply(
                p, None, m.astype(JDT[dt]), None, True, JDT[dt],
                frame_mask=fm), (jp["postnet"], mel[..., :20], fmask)),
            lambda dt: TM.postnet_apply(tm.postnet, t(mel[..., :20], dt),
                                        TDT[dt], frame_mask=tt(fmask)),
            ("bf16_ulps", 1)),
    }


LAYERS = ["dense", "layer_norm_f32_in", "layer_norm_bf16_in", "embedding",
          "gelu", "sigmoid", "conv1d", "scaled_posenc", "dec_prenet_mlp",
          "shared_keys", "chunked_ffn", "chunked_ffn_chunks_of_4", "postnet"]


@pytest.mark.parametrize("name", LAYERS)
def test_layer_matches_jax(name, model):
    cfgs, jp, tms = model
    jfn, tfn, bound = _layer_cases(jp, tms[BF], np.random.default_rng(0))[
        name]
    outs = {}
    for dt in (BF, F32):
        fn, args = jfn(dt)
        outs["jax", dt] = jax.jit(fn)(*args)
        with torch.no_grad():
            outs["port", dt] = tfn(dt)
    p16, j16 = outs["port", BF], outs["jax", BF]
    record(name, p16, j16, outs["jax", F32], outs["port", F32])
    same_dtype(p16, j16)
    if bound == "bits":
        np.testing.assert_array_equal(f32(p16), f32(j16))
    elif bound[0] == "bf16_ulps":
        assert bf16_ulps(p16, j16) <= bound[1]
    else:
        assert dist(p16, j16) <= bound[1]


def test_gelu_and_sigmoid_on_the_card_form_differ_by_an_ulp():
    """The card's forms (``F.gelu`` tanh, ``torch.sigmoid``: f32 inside,
    one rounding) against the CPU's op-by-op forms, on 1e5 bf16 inputs
    in [-6, 6]: at most one bf16 ulp of max(|a|, |b|, 1) apart (0.0156 at
    most for GELU, 0.0039 for sigmoid), the card's bound in PERF.md."""
    x = (torch.rand(100_000, generator=torch.Generator().manual_seed(0))
         * 12 - 6).bfloat16()
    gelu_card = torch.nn.functional.gelu(x, approximate="tanh")
    for card, cpu in ((gelu_card, TL.gelu(x)), (torch.sigmoid(x),
                                                 TL.sigmoid(x))):
        a, b = card.float(), cpu.float()
        scale = torch.maximum(torch.maximum(a.abs(), b.abs()),
                              torch.ones(()))
        ulp = 2.0 ** (torch.floor(torch.log2(scale)) - 7)
        assert float(((a - b).abs() / ulp).max()) <= 1
        assert 0 < float((a != b).float().mean()) < 0.5


# -- attention -------------------------------------------------------------------


def _attn_case(name, dt, rng_seed=1):
    rng = np.random.default_rng(rng_seed)
    b, h, l, d = 2, 2, 24, 16
    mask = np.arange(l)[None] < np.array([l, 17])[:, None]
    q, k, v, do = (rng.standard_normal((b, h, l, d)).astype(np.float32)
                   for _ in range(4))
    causal, self_mask, scale = {"causal_self": (True, True, 1.0),
                                "cross": (False, False, d ** -0.5)}[name]
    if self_mask:
        k = f32(JA._len_norm(jnp.asarray(q).astype(JDT[dt])) * (d ** -0.5))
    return (q, k, v, do, mask), (causal, self_mask, scale)


def _jax_attend(q, k, v, mask, causal, self_mask, scale):
    """JAX's naive attention as full.py writes it (the CPU path of
    flash "auto")."""
    l = q.shape[2]
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k).astype(jnp.float32) * scale
    pos = jnp.arange(l)
    if self_mask:
        s = JA.shared_qk_scores_mask(s, pos[None, None], pos[None, None],
                                     mask[:, None, :], causal)
    else:
        s = jnp.where(mask[:, None, None, :], s, JA.MASK_VALUE)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", p.astype(v.dtype), v)


@pytest.mark.parametrize("name", ["causal_self", "cross"])
def test_flash_plain_versions_match_jax_attention(name):
    """K1's plain version (P rounded before P.V) and K3's through their
    Function, against JAX's attention and its vjp: the output bit-equal;
    dQ, dK and dV within GRAD_RATIO x JAX's own bf16-vs-f32 distance.
    K3's plain version keeps the kernels' f32 P, D = rowsum(O o dO) and
    f32 dS, where JAX's bf16 backward rounds P for dV, takes D = rowsum(P
    o dP) and rounds dS (rounding as JAX does puts the plain backward 3.7%
    of its largest from f32, past the 1e-2 the card holds K3 to)."""
    res = {}
    for dt in (BF, F32):
        (q, k, v, do, mask), (causal, self_mask, scale) = _attn_case(name, dt)
        jq, jk, jv, jdo = (jnp.asarray(a).astype(JDT[dt])
                           for a in (q, k, v, do))
        out, vjp = jax.vjp(jax.jit(lambda a, b, c: _jax_attend(
            a, b, c, jnp.asarray(mask), causal, self_mask, scale)), jq, jk,
            jv)
        grads = vjp(jdo)
        tq, tk, tv = (tt(f32(a)).to(TDT[dt]).requires_grad_()
                      for a in (jq, jk, jv))
        got = TF.flash_attend(tq, tk, tv, tt(mask), causal=causal,
                              self_mask=self_mask, sm_scale=scale)
        got.backward(tt(f32(jdo)).to(TDT[dt]))
        res[dt] = (out, grads, got, (tq.grad, tk.grad, tv.grad))
    (j16, jg16, p16, pg16), (j32, jg32, p32, pg32) = res[BF], res[F32]
    record(f"K1 plain {name}", p16, j16, j32, p32)
    same_dtype(p16, j16)
    np.testing.assert_array_equal(f32(p16), f32(j16))
    for what, a, b, c, d in zip(("dq", "dk", "dv"), pg16, jg16, jg32, pg32):
        record(f"K3 plain {name} {what}", a, b, c, d)
        same_dtype(a, b)
        assert dist(a, b) <= GRAD_RATIO * dist(b, c), what


@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("which", ["self", "cross"])
def test_attention_modules_match_jax(which, impl, model):
    """Shared-QK self attention and cross attention (with the attn sink
    on the naive path) on projected bf16 heads: bit-equal outputs; the
    sink's f32 probabilities within 1e-7 (f32 softmax ulps)."""
    cfgs, jp, tms = model
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    mem = rng.standard_normal((2, 10, 32)).astype(np.float32)
    mask = np.arange(12)[None] < np.array([12, 9])[:, None]
    mmask = np.arange(10)[None] < np.array([10, 7])[:, None]
    outs = {}
    for dt in (BF, F32):
        if which == "self":
            p, tp = jp["decoder"]["layers"][0]["f"]["attn"], tms[dt].decoder.layers[0].f.attn
            j = jax.jit(lambda p, x: JA.shared_qk_self_attention(
                p, x, jnp.asarray(mask), True, 2, JDT[dt]))(p, x)
            with torch.no_grad():
                t = TA.shared_qk_self_attention(tp, tt(x), tt(mask), True, 2,
                                                TDT[dt], impl=impl)
            js = ts = None
        else:
            p, tp = jp["decoder"]["layers"][1]["f"]["attn"], tms[dt].decoder.layers[1].f.attn

            def jfn(p, x, m, sink=impl == "naive"):
                s = [] if sink else None
                out = JA.cross_attention(p, x, m, jnp.asarray(mmask), 2,
                                         JDT[dt], probs_sink=s)
                return out, (s[0] if sink else out)

            j, js = jax.jit(jfn)(p, x, mem)
            tsink = [] if impl == "naive" else None
            with torch.no_grad():
                t = TA.cross_attention(tp, tt(x), tt(mem), tt(mmask), 2,
                                       TDT[dt], impl=impl, probs_sink=tsink)
            ts = tsink[0] if tsink else t
        outs[dt] = (j, t, js, ts)
    (j16, p16, js16, ps16), (j32, p32, js32, ps32) = outs[BF], outs[F32]
    record(f"{which} attention ({impl})", p16, j16, j32, p32)
    same_dtype(p16, j16)
    np.testing.assert_array_equal(f32(p16), f32(j16))
    if which == "cross" and impl == "naive":
        record("attention sink", ps16, js16, js32, ps32)
        same_dtype(ps16, js16)
        assert dist(ps16, js16) <= 1e-7


# -- the stacks and the model ---------------------------------------------------------


@pytest.mark.parametrize("which", ["encoder", "decoder"])
def test_stack_matches_jax(which, model):
    """A plain stack (f32 streams, bf16 sublayers): the f32 output within
    2e-6 (the f32 LayerNorms' ulps: XLA's reductions and rsqrt; every bf16
    sublayer output is bit-equal at this seed)."""
    cfgs, jp, tms = model
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    mask = np.arange(12)[None] < np.array([12, 9])[:, None]
    mem = rng.standard_normal((2, 10, 32)).astype(np.float32)
    mmask = np.arange(10)[None] < np.array([10, 7])[:, None]
    outs = {}
    for dt in (BF, F32):
        scfg = getattr(cfgs[dt], which)
        extra = {} if which == "encoder" else {"memory": mem,
                                               "memory_mask": mmask}
        j = jax.jit(lambda p, x, m, e: JST.stack_apply(
            p, scfg, x, m, compute_dtype=JDT[dt], **e))(jp[which], x, mask,
                                                       extra)
        with torch.no_grad():
            t = TST.stack_apply(getattr(tms[dt], which),
                                getattr(port_cfg(cfgs[dt]), which), tt(x),
                                tt(mask), compute_dtype=TDT[dt],
                                **{k: tt(v) for k, v in extra.items()})
        outs[dt] = (j, t)
    (j16, p16), (j32, p32) = outs[BF], outs[F32]
    d = record(f"{which} stack", p16, j16, j32, p32)
    same_dtype(p16, j16)
    assert d["port_jax"] <= STACK_RATIO * d["jax16_jax32"]


def _forward_both(cfgs, jp, tms, batch, dt):
    cfg = cfgs[dt]

    @jax.jit
    def jax_forward(p, b):
        sink = []
        out = JM.forward(p, cfg, b["tokens"], b["token_mask"], b["mel"],
                         b["mel_mask"], attn_sink=sink)
        return out, sink

    want, j_sink = jax_forward(jp, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    tb = torch_batch(batch)
    t_sink = []
    with torch.no_grad():
        got = TM.forward(tms[dt], port_cfg(cfg), tb["tokens"],
                         tb["token_mask"], tb["mel"], tb["mel_mask"],
                         attn_sink=t_sink)
    return list(want) + [j_sink[0]], list(got) + [t_sink[0]]


def test_flagship_forward_and_sink_match_jax(model):
    """flagship.yaml's teacher-forced forward in bf16: mel before and after
    the postnet, stop logits and the first cross layer's sink, each within
    0.5 x JAX's own bf16-vs-f32 distance (at this seed the outputs are
    bit-equal and the sink within f32 ulps)."""
    cfgs, jp, tms = model
    batch = batch_np()
    j16, p16 = _forward_both(cfgs, jp, tms, batch, BF)
    j32, p32 = _forward_both(cfgs, jp, tms, batch, F32)
    for name, a, b, c, d in zip(("mel_pre", "mel_post", "stop_logits",
                                 "attn_sink"), p16, j16, j32, p32):
        dd = record(f"flagship forward {name}", a, b, c, d)
        same_dtype(a, b)
        assert dd["port_jax"] <= FORWARD_RATIO * dd["jax16_jax32"], name


def test_flagship_encode_decode_train_and_postnet_match_jax(model):
    """The pieces of the forward: ``encode`` (f32 memory, the last
    LayerNorm's f32 ulps), ``decode_train`` on the same memory and
    ``postnet_apply`` on the same mel (bit-equal)."""
    cfgs, jp, tms = model
    batch = batch_np(seed=6)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = torch_batch(batch)
    res = {}
    for dt in (BF, F32):
        cfg, tcfg = cfgs[dt], port_cfg(cfgs[dt])
        jmem = jax.jit(lambda p, t, m: JM.encode(p, cfg, t, m))(
            jp, jb["tokens"], jb["token_mask"])
        jd = jax.jit(lambda p, mi, mm, mem, tm_: JM.decode_train(
            p, cfg, mi, mm, mem, tm_))(jp, JM.shift_mel(jb["mel"], 2),
                                       jb["mel_mask"], jmem,
                                       jb["token_mask"])
        with torch.no_grad():
            tmem = TM.encode(tms[dt], tcfg, tb["tokens"], tb["token_mask"])
            td = TM.decode_train(tms[dt], tcfg, TM.shift_mel(tb["mel"], 2),
                                 tb["mel_mask"], tt(np.asarray(jmem)),
                                 tb["token_mask"])
        res[dt] = (jmem, tmem, jd, td)
    (jm16, pm16, jd16, pd16), (jm32, pm32, jd32, pd32) = res[BF], res[F32]
    record("encode", pm16, jm16, jm32, pm32)
    same_dtype(pm16, jm16)
    assert dist(pm16, jm16) <= 2e-6
    for name, a, b, c, d in zip(("mel_pre", "mel_post", "stop_logits"),
                                pd16, jd16, jd32, pd32):
        record(f"decode_train {name}", a, b, c, d)
        same_dtype(a, b)
        np.testing.assert_array_equal(f32(a), f32(b))


@pytest.mark.parametrize("reversible", [False, True])
def test_stack_gradients_match_jax(reversible, model):
    """The encoder stack's gradients in bf16 (plain, and reversible: X2 =
    Y2 - g(Y1) reconstructed through bf16 sublayers in both programs, so
    the gradients are compared, not the reconstruction) against jax.grad:
    every leaf within GRAD_RATIO x JAX's own bf16-vs-f32 distance of the
    largest leaf's, and the plain stack's dX as well."""
    cfgs, jp, tms = model
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    mask = np.arange(12)[None] < np.array([12, 9])[:, None]
    ct = rng.standard_normal((2, 12, 32)).astype(np.float32)
    res = {}
    for dt in (BF, F32):
        scfg = dataclasses.replace(cfgs[dt].encoder, reversible=reversible)
        tcfg = port_cfg(dataclasses.replace(cfgs[dt], encoder=scfg))

        def loss(p, x, m):
            return jnp.sum(JST.stack_apply(p, scfg, x, m,
                                           compute_dtype=JDT[dt]) * ct)

        jg = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp["encoder"], x, mask)
        stack = tms[dt].encoder
        stack.zero_grad(set_to_none=True)
        tx = tt(x).requires_grad_()
        out = TST.stack_apply(stack, tcfg.encoder, tx, tt(mask),
                              compute_dtype=TDT[dt])
        (out * tt(ct)).sum().backward()
        want = dict(from_numpy_tree(TM.init(tcfg, device="cpu").encoder,
                                    np_tree(jg[0])).named_parameters())
        res[dt] = ({n: (p.grad, want[n]) for n, p in stack.named_parameters()},
                   (tx.grad, jg[1]))
    port_jax, jax_jax = leaf_distances(res[BF][0], res[F32][0])
    print(f"[bf16] encoder stack grads (reversible={reversible}): port-jax "
          f"{port_jax:.6g}, jax16-jax32 {jax_jax:.6g} (max over leaves, "
          "relative to each leaf's largest f32 gradient)")
    assert port_jax <= GRAD_RATIO * jax_jax
    d = record(f"encoder stack dX (reversible={reversible})", res[BF][1][0],
               res[BF][1][1], res[F32][1][1], res[F32][1][0])
    assert d["port_jax"] <= GRAD_RATIO * d["jax16_jax32"]


def leaf_distances(got16, got32):
    """(max over leaves of |port16 - jax16|, of |jax16 - jax32|), each
    relative to the leaf's largest f32 (JAX) value; ``got*`` map a name
    to (port, JAX)."""
    scale = {n: max(float(np.abs(f32(w)).max()), 1e-12)
             for n, (_, w) in got32.items()}
    return (max(dist(*got16[n]) / scale[n] for n in got16),
            max(dist(got16[n][1], got32[n][1]) / scale[n] for n in got16))


def test_flagship_train_step_matches_jax_and_optax(model):
    """One bf16 train step of flagship.yaml's structure (guided attention
    at 2.0, weight decaying from step 0; Adam with the clip at 1.0, a
    constant lr 1e-3) against JAX + optax: the loss and its guided part
    bit-equal to f32 rounding (the forward is bit-equal at this seed; the
    losses sum in f32), grad_norm and every gradient within GRAD_RATIO x
    JAX's bf16-vs-f32 distance, the parameters after Adam likewise (Adam
    turns each gradient's bf16 noise into a step of +-lr where the
    gradient is small)."""
    cfgs, jp, _ = model
    optim = JC.OptimConfig(schedule="constant", learning_rate=1e-3,
                           grad_clip_norm=1.0)
    batch = batch_np(seed=10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    res = {}
    for dt in (BF, F32):
        cfg, tcfg = cfgs[dt], port_cfg(cfgs[dt])
        tm = from_numpy_tree(TM.init(tcfg, device="cpu"), np_tree(jp))
        jloss, jg = jax.jit(jax.value_and_grad(_jax_loss(cfg)))(jp, jb)
        jp2, jm = _optax_step(optim, jp, jg, jloss)
        t_opt = TO.make_optimizer(TC.from_dict(TC.OptimConfig,
                                               dataclasses.asdict(optim)))
        tmets, tgrads = make_train_step(tcfg, t_opt)(
            tm, t_opt.init(list(tm.parameters())), torch_batch(batch),
            step_generator(0, 0, "cpu"), 0, return_grads=True)
        names = [n for n, _ in tm.named_parameters()]
        want_g = dict(from_numpy_tree(TM.init(tcfg, device="cpu"),
                                      np_tree(jg)).named_parameters())
        want_p = dict(from_numpy_tree(TM.init(tcfg, device="cpu"),
                                      np_tree(jp2)).named_parameters())
        res[dt] = (jm, tmets,
                   {n: (g, want_g[n]) for n, g in zip(names, tgrads)},
                   {n: (p, want_p[n]) for n, p in tm.named_parameters()})
    (jm16, tm16, g16, p16), (jm32, tm32, g32, p32) = res[BF], res[F32]
    d = record("train step loss", tm16["loss"], jm16["loss"], jm32["loss"],
               tm32["loss"])
    assert d["port_jax"] <= 1e-6 * abs(float(jm16["loss"]))
    d = record("train step grad_norm", tm16["grad_norm"], jm16["grad_norm"],
               jm32["grad_norm"], tm32["grad_norm"])
    assert d["port_jax"] <= GRAD_RATIO * d["jax16_jax32"]
    port_jax, jax_jax = leaf_distances(g16, g32)
    print(f"[bf16] train step gradients: port-jax {port_jax:.6g}, "
          f"jax16-jax32 {jax_jax:.6g} (max over leaves, relative to each "
          "leaf's largest)")
    assert port_jax <= GRAD_RATIO * jax_jax
    port_jax = max(dist(a, b) for a, b in p16.values())
    jax_jax = max(dist(p16[n][1], p32[n][1]) for n in p16)
    print(f"[bf16] train step parameters after Adam: port-jax {port_jax:.6g}"
          f", jax16-jax32 {jax_jax:.6g} (max abs over leaves; lr 1e-3)")
    assert port_jax <= GRAD_RATIO * jax_jax


def _optax_step(optim, params, grads, loss):
    """What the JAX train step does with a loss and its gradients: optax's
    chain from the JAX package's ``make_optimizer``, and the metrics ->
    (new params, {"loss", "grad_norm"})."""
    opt = JO.make_optimizer(optim)

    @jax.jit
    def update(p, g):
        updates, _ = opt.update(g, opt.init(p), p)
        return optax.apply_updates(p, updates), optax.global_norm(g)

    new, norm = update(params, grads)
    return new, {"loss": loss, "grad_norm": norm}


def _jax_loss(cfg):
    """The JAX train step's loss at step 0, dropout 0."""
    def loss_fn(p, b):
        sink = []
        pre, post, stop = JM.forward(p, cfg, b["tokens"], b["token_mask"],
                                     b["mel"], b["mel_mask"], attn_sink=sink)
        total, _ = JLS.tts_loss(pre, post, stop, b["mel"],
                                JLS.make_stop_target(b["mel_mask"]),
                                b["mel_mask"], cfg.stop_pos_weight)
        gal = JLS.guided_attention_loss(sink, b["token_mask"], b["mel_mask"],
                                        cfg.reduction_factor,
                                        cfg.guided_attention_sigma)
        return total + cfg.guided_attention_weight * gal

    return loss_fn


# -- serving ---------------------------------------------------------------------

MAX_FRAMES = 24


@pytest.fixture(scope="module")
def serving(model):
    """Encoder memory of each side and the JAX decodes (jitted as the
    repo runs them, and eagerly: every op rounds as the source says) at a
    threshold that never stops and at one that stops rows at different
    steps (row 0 within the first half, a margin of 2e-3 to every stop
    probability of the eager decode)."""
    cfgs, jp, tms = model
    rng = np.random.default_rng(8)
    b, l = 2, 15
    tokens = rng.integers(3, vocab_size(), (b, l)).astype(np.int32)
    mask = np.arange(l)[None, :] < np.asarray([l, 10])[:, None]
    out = {}
    for dt in (BF, F32):
        cfg = cfgs[dt]
        jmem = jax.jit(lambda p, t, m: JM.encode(p, cfg, t, m))(
            jp, tokens, mask)
        with torch.no_grad():
            tmem = TM.encode(tms[dt], port_cfg(cfg), tt(tokens).long(),
                             tt(mask))
        out[dt] = (jmem, tmem)

    def jax_decode(dt, thr):
        return JD.decode_greedy(jp, cfgs[dt], out[dt][0], jnp.asarray(mask),
                                max_frames=MAX_FRAMES, stop_threshold=thr,
                                mode="kv_full", staged=False)

    never = jax_decode(BF, 2.0)
    return cfgs, tms, mask, out, jax_decode, _stopping_threshold(never, 2)


def _stopping_threshold(never, r, margin=5e-3):
    """The lowest threshold at which the rows stop at different frames
    before the end, with ``margin`` to every stop probability of the
    never-stopping decode (bf16 noise in the logits cannot flip a stop)."""
    probs = np.asarray(jax.nn.sigmoid(never.stop_logits))[:, ::r]
    levels = np.unique(probs)
    for lo, hi in zip(levels[:-1], levels[1:]):
        thr = (lo + hi) / 2
        if hi - lo < 2 * margin:
            continue
        fired = probs > thr
        steps = np.where(fired.any(1), fired.argmax(1), probs.shape[1])
        if steps.max() < probs.shape[1] and len(set(steps)) == len(steps):
            return float(thr)
    raise AssertionError("no threshold stops the rows apart with a margin")


@pytest.mark.parametrize("stopping", [False, True])
def test_flagship_serving_matches_jax(stopping, serving):
    """encode, then decode_greedy in kv_full (a bf16 cache), once never
    stopping and once stopping the rows at different frames: the lengths
    equal JAX's, mel and stop logits within NOISE_RATIO x JAX's bf16-vs-f32
    distance.  Each decode step is bit-equal to JAX's
    (``test_decode_steps_match_jax``); over the loop the f32 LayerNorms of
    the streams differ from XLA's by f32 ulps, and the first one whose
    cast to bf16 flips spreads as bf16 noise (here from the 5th group on,
    against JAX run eagerly)."""
    cfgs, tms, mask, mem, jax_decode, stop = serving
    thr = stop if stopping else 2.0
    d = {}
    for dt in (BF, F32):
        d["jax", dt] = jax_decode(dt, thr)
        with torch.no_grad():
            d["port", dt] = TD.decode_greedy(
                tms[dt], port_cfg(cfgs[dt]), mem[dt][1], tt(mask),
                max_frames=MAX_FRAMES, stop_threshold=thr)
    got = d["port", BF]
    lengths = np.asarray(d["jax", BF].lengths)
    np.testing.assert_array_equal(got.lengths.numpy(), lengths)
    if stopping:
        assert lengths.max() < MAX_FRAMES and lengths.min() < lengths.max()
    else:
        assert (lengths == MAX_FRAMES).all()
    tag = "stopping" if stopping else "never stopping"
    record("encode (serving)", mem[BF][1], mem[BF][0], mem[F32][0],
           mem[F32][1])
    for f in ("mel_post", "stop_logits"):
        dd = record(f"decode kv_full {tag} {f}", getattr(got, f),
                    getattr(d["jax", BF], f), getattr(d["jax", F32], f),
                    getattr(d["port", F32], f))
        assert dd["port_jax"] <= NOISE_RATIO * dd["jax16_jax32"], f


@pytest.mark.parametrize("kv", ["compute", "float8_e4m3fn"])
def test_decode_steps_match_jax(kv, model):
    """One decode step's sublayers on the same inputs, bit-equal in bf16:
    the cross attention over the memory's precomputed K/V, the causal
    self attention over a cache it fills for 6 steps (the compute-dtype
    cache stores pre-scaled keys; the e4m3 one stores them unscaled,
    clipped to +-448, and the query takes 1/sqrt(d) rounded to bf16), the
    FFN; and the stored caches."""
    cfgs, jp, tms = model
    cfg = dataclasses.replace(cfgs[BF], kv_cache_dtype=kv)
    tcfg = port_cfg(cfg)
    jdt, cdt = jnp.bfloat16, torch.bfloat16
    jw = JD._precast_weights(jp, jdt)
    tm = tms[BF]
    kdt = TD._kv_dtype(tcfg, cdt)
    rng = np.random.default_rng(12)
    mem = rng.standard_normal((2, 10, 32)).astype(np.float32)
    mmask = np.arange(10)[None] < np.array([10, 7])[:, None]
    mk, mv = jax.jit(lambda p, m: JD._init_mem_kv(p, cfg, m.astype(jdt),
                                                  jdt))(jw, mem)
    with torch.no_grad():
        tmk, tmv = TD._init_mem_kv(tm, tcfg, tt(mem).to(cdt), cdt, kdt)
    np.testing.assert_array_equal(f32(tmk[0]), f32(mk[0]))
    layers, tl = jw["decoder"]["layers"], tm.decoder.layers
    h = rng.standard_normal((2, 32)).astype(np.float32)
    jo, _ = jax.jit(lambda p, h, k, v, m: JD._cross_attn_step(
        p, h, k, v, m, 2, jdt))(layers[1]["f"]["attn"], h, mk[0], mv[0],
                                mmask)
    with torch.no_grad():
        to, _ = TD._cross_attn_step(tl[1].f.attn, tt(h), tmk[0], tmv[0],
                                    tt(mmask), 2, cdt)
    np.testing.assert_array_equal(f32(to), f32(jo))
    jk = jnp.zeros((2, 8, 2, 16), JD._kv_dtype(cfg, jdt))
    jv = jnp.zeros_like(jk)
    tk = torch.zeros((2, 8, 2, 16), dtype=kdt)
    tv = torch.zeros_like(tk)
    step = jax.jit(lambda p, h, k, v, t: JD._self_attn_step(p, h, k, v, t,
                                                             2, jdt))
    for t in range(6):
        h = 3.0 * rng.standard_normal((2, 32)).astype(np.float32)
        jo, jk, jv = step(layers[0]["f"]["attn"], h, jk, jv, t)
        with torch.no_grad():
            to = TD._self_attn_step(tl[0].f.attn, tt(h), tk, tv, t, 2, cdt)
        same_dtype(to, jo)
        np.testing.assert_array_equal(f32(to), f32(jo))
        for a, b in ((tk, jk), (tv, jv)):
            assert a.dtype == {jnp.dtype(jnp.bfloat16): torch.bfloat16,
                               jnp.dtype(jnp.float8_e4m3fn):
                               torch.float8_e4m3fn}[jnp.dtype(b.dtype)]
            np.testing.assert_array_equal(f32(a), f32(b))
    y = rng.standard_normal((2, 32)).astype(np.float32)
    jo = jax.jit(lambda p, y: JD._ffn_step(p, y, "gelu", jdt))(
        layers[0]["g"], y)
    with torch.no_grad():
        to = TFF._ffn_body(tl[0].g, tt(y), "gelu", cdt)
    np.testing.assert_array_equal(f32(to), f32(jo))


def _vocoder_cfg(dtype, clamp=None):
    """base.yaml's vocoder (the dataclass defaults: bf16, no log_s clamp)
    or flagship.yaml's (f32, clamp 5.0) at tests/test_full_model_parity.py
    's small widths."""
    from tests.test_full_model_parity import vocoder_cfg
    kw = {} if clamp is None else {"log_s_clamp": clamp}
    return dataclasses.replace(vocoder_cfg(), compute_dtype=dtype, **kw)


def _vocoder_params(cfg):
    from tests.test_torch_vocoder_train import live_params
    return live_params(cfg)


def test_flagship_serving_vocodes_like_jax(serving):
    """flagship's f32 vocoder (clamp 5.0) on the port's bf16 mel with one
    z: the audio within 1e-5 of JAX's on the same mel (f32 throughout)."""
    cfgs, tms, mask, mem, jax_decode, stop = serving
    with torch.no_grad():
        mel = TD.decode_greedy(tms[BF], port_cfg(cfgs[BF]), mem[BF][1],
                               tt(mask), max_frames=MAX_FRAMES,
                               stop_threshold=stop).mel_post
    vcfg = _vocoder_cfg(F32, clamp=5.0)
    jv = np_tree(JS.fold_weightnorm(_vocoder_params(vcfg)))
    tv = from_numpy_tree(TS.fold_weightnorm(TS.init(vcfg, device="cpu")), jv)
    z = np.random.default_rng(9).standard_normal(
        (2, MAX_FRAMES * vcfg.hop_length // vcfg.n_group, vcfg.n_group)
    ).astype(np.float32)
    m = f32(mel)
    want = jax.jit(lambda p, m, z: JS._infer_chunk(p, m, z, cfg=vcfg))(
        jv, m, z)
    with torch.no_grad():
        got = TS._infer_chunk(tv, tt(m), tt(z), cfg=vcfg)
    assert dist(got, want) <= 1e-5 * max(1.0, float(np.abs(want).max()))


# -- base.yaml's bf16 vocoder -----------------------------------------------------


@pytest.fixture(scope="module")
def vocoder():
    """base.yaml's vocoder structure (bf16 WN) in bf16 and f32 from one
    JAX init with live "end" convs, and a mel, audio and z."""
    from tests.test_full_model_parity import vocoder_inputs
    cfgs = {dt: _vocoder_cfg(dt) for dt in (BF, F32)}
    jp = _vocoder_params(cfgs[BF])
    mel, audio, z = vocoder_inputs(cfgs[BF])
    return cfgs, jp, mel, audio, z


def test_base_vocoder_infer_matches_jax(vocoder):
    """``infer`` with one z (``_infer_chunk``): within f32 rounding of JAX
    run eagerly (the 1x1s and the coupling are f32; every bf16 rounding of
    the WN is JAX's); against the jitted JAX no farther than JAX's own jit
    is from its eager run: inside the jitted flow XLA drops the WN
    output's bf16 rounding across its cast to f32 (the WN alone is
    bit-equal, ``test_wn_and_k2_plain_match_jax``), and the inverse flows
    amplify that (1.5 x JAX's bf16-vs-f32 distance at this seed)."""
    cfgs, jp, mel, audio, z = vocoder
    out = {}
    for dt in (BF, F32):
        jv = np_tree(JS.fold_weightnorm(jp))
        tv = from_numpy_tree(TS.fold_weightnorm(TS.init(cfgs[dt],
                                                        device="cpu")), jv)
        out["jax", dt] = jax.jit(lambda p, m, z: JS._infer_chunk(
            p, m, z, cfg=cfgs[dt]))(jv, mel, z)
        with torch.no_grad():
            out["port", dt] = TS._infer_chunk(tv, tt(mel), tt(z),
                                              cfg=cfgs[dt])
        if dt == BF:
            with jax.disable_jit():
                eager = JS._infer_chunk(jv, mel, z, cfg=cfgs[dt])
    d = record("vocoder infer", out["port", BF], out["jax", BF],
               out["jax", F32], out["port", F32])
    record("vocoder infer: JAX jit vs eager", eager, out["jax", BF],
           out["jax", F32], eager)
    same_dtype(out["port", BF], out["jax", BF])
    assert dist(out["port", BF], eager) <= 1e-5 * float(
        np.abs(f32(eager)).max())
    # the port's whole distance to the jitted JAX is XLA's own
    assert d["port_jax"] <= dist(eager, out["jax", BF]) + 1e-5 * float(
        np.abs(f32(eager)).max())


def test_wn_and_k2_plain_match_jax(vocoder):
    """One flow's WN in bf16, bit-equal: K2's plain version rounds the f32
    w and b to x's dtype inside its wrapper, where JAX casts w to the
    compute dtype before its grouped conv; the two give the same bits."""
    cfgs, jp, *_ = vocoder
    rng = np.random.default_rng(11)
    wn = jp["flows"][0]["wn"]
    c_in = wn["in"]["v"].shape[1]
    a0 = rng.standard_normal((2, 32, c_in)).astype(np.float32)
    mel = rng.standard_normal((2, 32, cfgs[BF].n_mels)).astype(np.float32)
    h = rng.standard_normal((2, 32, cfgs[BF].wn_channels)).astype(np.float32)
    out = {}
    for dt in (BF, F32):
        cfg = cfgs[dt]
        tm = from_numpy_tree(TS.init(cfg, device="cpu"), np_tree(jp))
        twn = tm.flows[0].wn
        j = jax.jit(lambda p, a, m: JS.wn_apply(
            p, a.astype(JDT[dt]), m.astype(JDT[dt]), cfg.wn_layers,
            cfg.wn_channels, JDT[dt]))(wn, a0, mel)
        jd = jax.jit(lambda p, x: JS.wn_conv(
            p, x.astype(JDT[dt]), groups=cfg.wn_channels,
            compute_dtype=JDT[dt]))(wn["depth"][0], h)
        with torch.no_grad():
            t = TS.wn_apply(twn, tt(a0).to(TDT[dt]), tt(mel).to(TDT[dt]),
                            cfg.wn_layers, cfg.wn_channels, TDT[dt])
            td = TS.wn_conv(twn.depth[0], tt(h).to(TDT[dt]), TDT[dt])
        out[dt] = (j, t, jd, td)
    (j16, p16, jd16, pd16), (j32, p32, jd32, pd32) = out[BF], out[F32]
    record("depthwise (K2 plain)", pd16, jd16, jd32, pd32)
    record("wn_apply", p16, j16, j32, p32)
    for a, b in ((pd16, jd16), (p16, j16)):
        same_dtype(a, b)
        np.testing.assert_array_equal(f32(a), f32(b))


def test_base_vocoder_train_step_matches_jax_and_optax(vocoder):
    """One bf16 vocoder train step (Adam, clip 1.0, constant lr 1e-3): the
    loss and grad_norm, every gradient and the parameters after the
    update within GRAD_RATIO x JAX's own bf16-vs-f32 distance (the jitted
    JAX keeps WN outputs in f32 where the source rounds them, and autodiff
    rounds its own way; see the infer case)."""
    cfgs, jp, mel, audio, _ = vocoder
    optim = JC.OptimConfig(schedule="constant", learning_rate=1e-3,
                           grad_clip_norm=1.0)
    jb = {"mel": jnp.asarray(mel), "audio": jnp.asarray(audio)}
    res = {}
    for dt in (BF, F32):
        cfg = cfgs[dt]
        tm = from_numpy_tree(TS.init(cfg, device="cpu"), np_tree(jp))
        names = [n for n, _ in tm.named_parameters()]
        def loss_fn(p):
            z, log_s, log_det = JS.forward(p, cfg, jb["mel"], jb["audio"])
            return jax_voc_loss(z, log_s, log_det, cfg.sigma)[0]

        jloss, jg = jax.jit(jax.value_and_grad(loss_fn))(jp)
        jp2, jm = _optax_step(optim, jp, jg, jloss)
        jm["loss_vocoder"] = jm.pop("loss")
        t_opt = TO.make_optimizer(TC.from_dict(TC.OptimConfig,
                                               dataclasses.asdict(optim)))
        tmets, tgrads = voc_train_step(cfg, t_opt)(
            tm, t_opt.init(list(tm.parameters())),
            {"mel": tt(mel), "audio": tt(audio)}, return_grads=True)
        want_g = dict(from_numpy_tree(TS.init(cfg, device="cpu"),
                                      np_tree(jg)).named_parameters())
        want_p = dict(from_numpy_tree(TS.init(cfg, device="cpu"),
                                      np_tree(jp2)).named_parameters())
        res[dt] = (jm, tmets, {n: (g, want_g[n]) for n, g in zip(names,
                                                                 tgrads)},
                   {n: (p, want_p[n]) for n, p in tm.named_parameters()})
    (jm16, tm16, g16, p16), (jm32, tm32, g32, p32) = res[BF], res[F32]
    for key in ("loss_vocoder", "grad_norm"):
        d = record(f"vocoder step {key}", tm16[key], jm16[key], jm32[key],
                   tm32[key])
        assert d["port_jax"] <= GRAD_RATIO * d["jax16_jax32"], key
    port_jax, jax_jax = leaf_distances(g16, g32)
    print(f"[bf16] vocoder step gradients: port-jax {port_jax:.6g}, "
          f"jax16-jax32 {jax_jax:.6g} (max over leaves, relative)")
    assert port_jax <= GRAD_RATIO * jax_jax
    port_jax = max(dist(a, b) for a, b in p16.values())
    jax_jax = max(dist(p16[n][1], p32[n][1]) for n in p16)
    print(f"[bf16] vocoder step parameters after Adam: port-jax "
          f"{port_jax:.6g}, jax16-jax32 {jax_jax:.6g} (max abs)")
    assert port_jax <= GRAD_RATIO * jax_jax
