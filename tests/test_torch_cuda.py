"""The CUDA kernels of rtts_torch against their plain versions, on the card.

Marked ``cuda``: each test skips when no GPU is present.  They import no JAX,
so on a machine without JAX they run with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import pytest
import torch

from rtts_torch.attention import lsh as TL
from rtts_torch.config import AttentionConfig
from rtts_torch.ops import bitonic_sort as BS
from rtts_torch.ops.bitonic_sort import (MAX_ROWS, bitonic_sort_cols,
                                         bitonic_sort_cols_reference,
                                         sort_by_bucket,
                                         sort_by_bucket_reference)
from rtts_torch.ops.chunked_ffn import (chunked_ffn_fused, ffn_fused,
                                        ffn_fused_reference)
from rtts_torch.ops.depthwise_conv import (depthwise_conv1d,
                                           depthwise_conv1d_reference)
from rtts_torch.ops import flash_attention as FA
from rtts_torch.ops.flash_attention import (dropout_keep_mask, flash_attend,
                                            flash_attend_bwd_reference,
                                            flash_attend_reference,
                                            flash_bwd_dkv, flash_bwd_dq,
                                            flash_fwd)
from rtts_torch.ops.lsh_attention import (lsh_attend_bwd,
                                          lsh_attend_bwd_reference,
                                          lsh_attend_chunks_kernel,
                                          lsh_attend_chunks_reference,
                                          lsh_attend_fwd)
from rtts_torch.ops.row_gather import row_gather, row_gather_reference
from rtts_torch.reversible.ffn import FFN, _ffn_body
from torch_twin import one_thread  # noqa: F401  (autouse)


pytestmark = pytest.mark.cuda

# Errors are |kernel - reference| / max(1, |reference|).  f32: the kernel
# sums in another order than the reference (and expf vs torch.exp differ in
# the last ulps); bf16: both round nearly the same f32 value, so they differ
# by at most one bf16 ulp (2^-7 relative).  The training cases hold the bf16
# kernels against the plain versions run in f32 on the same bf16 inputs:
# the kernels accumulate in f32 too, so the error is the final bf16 rounding
# (at most half an ulp, 2^-8 relative) plus f32 summation order.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, h, lq, lk, dh, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, n, dh, generator=g).to(dev, dtype)
            for n in (lq, lk, lk)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [
    # (b, h, lq, lk, dh, causal, self_mask, kv_lengths, sm_scale, lse,
    #  q_offset)
    (8, 8, 256, 256, 64, False, True, (256, 200, 131, 77, 256, 1, 64, 250),
     1.0, True, 0),
    (2, 2, 200, 200, 64, True, True, (200, 150), 1.0, False, 0),
    (2, 4, 512, 256, 64, False, False, (256, 99), 0.125, False, 0),
    (2, 2, 77, 77, 128, False, True, None, 1.0, True, 0),
    (1, 2, 128, 128, 64, False, False, (0,), 0.125, True, 0),  # all keys masked
    # a sequence-parallel query shard: rows 128..227 of 256 keys
    (2, 4, 100, 256, 64, True, True, (256, 180), 1.0, True, 128),
])
def test_flash_kernel_matches_reference(dev, dtype, case):
    b, h, lq, lk, dh, causal, self_mask, lens, scale, want_lse, q_offset = case
    q, k, v = _qkv(b, h, lq, lk, dh, dtype, dev)
    mask = None
    if lens is not None:
        mask = (torch.arange(lk)[None, :] < torch.tensor(lens)[:, None]).to(dev)
    kw = dict(causal=causal, self_mask=self_mask, sm_scale=scale,
              q_offset=q_offset, return_lse=want_lse)
    before = flash_attend.launches
    got = flash_attend(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    assert flash_attend.launches == before + 1
    # the plain version on f32 copies: in bf16 it rounds P as the JAX
    # package's attention does, a second rounding of the kernel's
    want = flash_attend_reference(q.float(), k.float(), v.float(), mask,
                                  **kw)
    if want_lse:
        (got, got_lse), (want, want_lse_t) = got, want
        # fully masked rows sit at -1e9, where one f32 ulp is 64
        torch.testing.assert_close(got_lse, want_lse_t, rtol=1e-6, atol=1e-3)
    assert got.dtype == dtype and got.shape == want.shape
    err = _err(got, want)
    assert err < TOL[dtype], err


ENCODER_LENS = (256, 200, 131, 77, 256, 1, 64, 250)
TRAIN_CASES = {
    # name: (b, h, lq, lk, dh, causal, self_mask, kv_lengths, sm_scale,
    #        q_offset); self-attention cases use the shared-QK keys
    "encoder": (8, 8, 256, 256, 64, False, True, ENCODER_LENS, 1.0, 0),
    "decoder": (8, 8, 1024, 1024, 64, True, True, None, 1.0, 0),
    "cross": (8, 8, 1024, 256, 64, False, False, ENCODER_LENS, 0.125, 0),
    # the longform_8k.yaml decoder's cross-attention
    "cross_longform": (2, 8, 8192, 1024, 64, False, False, (1024, 700),
                       0.125, 0),
    "q_offset": (2, 4, 100, 256, 64, True, True, (256, 180), 1.0, 128),
    "dh128_ragged": (2, 2, 77, 77, 128, False, True, (77, 50), 1.0, 0),
}


def train_case(name, dtype, dev, seed=0):
    """(q, k, v, dout, kv_mask) and the flash options of a training case."""
    b, h, lq, lk, dh, causal, self_mask, lens, scale, q_offset = \
        TRAIN_CASES[name]
    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(b, h, n, dh, generator=g)
                     for n in (lq, lk, lk, lq))
    if self_mask and lq == lk:
        k = q * torch.rsqrt((q * q).mean(-1, keepdim=True) + 1e-6) * dh ** -0.5
    mask = None
    if lens is not None:
        mask = (torch.arange(lk)[None, :] < torch.tensor(lens)[:, None]).to(dev)
    opts = dict(causal=causal, self_mask=self_mask, sm_scale=scale,
                q_offset=q_offset)
    return [t.to(dev, dtype) for t in (q, k, v, dout)] + [mask], opts


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_flash_train_kernels_match_reference(dev, name, dtype, rate):
    """K1 with dropout and lse, then K3 (dK/dV and dQ), against the plain
    forward and backward run in f32 on the same inputs."""
    (q, k, v, dout, mask), opts = train_case(name, dtype, dev)
    drop = dict(dropout_rate=rate, dropout_seed=0x9E3779B9)
    args = (opts["causal"], opts["self_mask"], opts["sm_scale"],
            opts["q_offset"], rate, drop["dropout_seed"])
    out, lse = flash_fwd(q, k, v, mask, *args)
    dk, dv = flash_bwd_dkv(q, k, v, out, dout, lse, mask, *args)
    dq = flash_bwd_dq(q, k, v, out, dout, lse, mask, *args)
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v)]
    want, want_lse = flash_attend_reference(*f, mask, return_lse=True,
                                            **opts, **drop)
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-4)
    assert _err(out, want) < TOL[dtype], _err(out, want)
    wants = flash_attend_bwd_reference(*f, out.float(), dout.float(), lse,
                                       mask, **opts, **drop)
    for got_t, want_t, what in zip((dq, dk, dv), wants, ("dq", "dk", "dv")):
        assert got_t.dtype == dtype and got_t.shape == want_t.shape
        err = _err(got_t, want_t)
        assert err < TOL[dtype], (what, err)


def test_flash_autograd_launches_k1_and_k3(dev):
    (q, k, v, dout, mask), opts = train_case("encoder", torch.bfloat16, dev)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = (flash_attend.launches, flash_bwd_dkv.launches,
              flash_bwd_dq.launches)
    out = flash_attend(q, k, v, mask, dropout_rate=0.1, dropout_seed=5,
                       **opts)
    out.backward(dout)
    torch.cuda.synchronize()
    after = (flash_attend.launches, flash_bwd_dkv.launches,
             flash_bwd_dq.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.parametrize("q_offset", [0, 37])
def test_kernel_keep_masks_equal_dropout_keep_mask(dev, q_offset):
    """With q = k = 0 every probability is 1/L, so K1 with v = I returns
    keep / (L keep_prob) and K3's dV with dO = I returns its transpose:
    both give the kernels' keep bits, held against the dense mask."""
    b, h, l, rate, seed = 2, 3, 128, 0.1, 0xDEADBEEF
    zeros = torch.zeros(b, h, l, l, device=dev)
    eye = torch.eye(l, device=dev).expand(b, h, l, l).contiguous()
    args = (False, False, 1.0, q_offset, rate, seed)
    out, lse = flash_fwd(zeros, zeros, eye, None, *args)
    _, dv = flash_bwd_dkv(zeros, zeros, eye, out, eye, lse, None, *args)
    torch.cuda.synchronize()
    want = dropout_keep_mask(seed, b * h, l, l, rate, q_offset,
                             dev).reshape(b, h, l, l)
    assert torch.equal((out > 0).float(), want)
    assert torch.equal((dv.transpose(-1, -2) > 0).float(), want)


@pytest.mark.parametrize("q_offset", [0, 37])
def test_bf16_kernel_keep_masks_equal_dropout_keep_mask(dev, q_offset):
    """The bf16 kernels' keep bits, as above: every kept entry of K1's
    output and of K3's dV is 1 / (L keep_prob) rounded to bf16, every
    dropped one 0, so their zero patterns are the dense mask."""
    b, h, l, rate, seed = 2, 3, 128, 0.1, 0xDEADBEEF
    zeros = torch.zeros(b, h, l, l, device=dev, dtype=torch.bfloat16)
    eye = torch.eye(l, device=dev, dtype=torch.bfloat16)
    eye = eye.expand(b, h, l, l).contiguous()
    args = (False, False, 1.0, q_offset, rate, seed)
    out, lse = flash_fwd(zeros, zeros, eye, None, *args)
    _, dv = flash_bwd_dkv(zeros, zeros, eye, out, eye, lse, None, *args)
    torch.cuda.synchronize()
    want = dropout_keep_mask(seed, b * h, l, l, rate, q_offset,
                             dev).reshape(b, h, l, l)
    assert torch.equal((out > 0).float(), want)
    assert torch.equal((dv.transpose(-1, -2) > 0).float(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b_offset,h_offset", [(0, 0), (4, 4), (1, 5)])
def test_rank_keep_masks_are_the_global_masks_slice(dev, dtype, b_offset,
                                                    h_offset):
    """A rank holding batch rows b_offset.. and heads h_offset.. of 8 hashes
    the global (b, h): K1's and K3's keep bits (as above) equal the slice
    of the one-device mask of 8 x 8 heads."""
    b, h, l, rate, seed = 2, 3, 128, 0.1, 0xDEADBEEF
    zeros = torch.zeros(b, h, l, l, device=dev, dtype=dtype)
    eye = torch.eye(l, device=dev, dtype=dtype).expand(b, h, l, l)
    eye = eye.contiguous()
    args = (False, False, 1.0, 0, rate, seed, b_offset, h_offset, 8)
    out, lse = flash_fwd(zeros, zeros, eye, None, *args)
    _, dv = flash_bwd_dkv(zeros, zeros, eye, out, eye, lse, None, *args)
    torch.cuda.synchronize()
    want = dropout_keep_mask(seed, 8 * 8, l, l, rate, 0, dev).reshape(
        8, 8, l, l)[b_offset:b_offset + b, h_offset:h_offset + h]
    assert torch.equal((out > 0).float(), want)
    assert torch.equal((dv.transpose(-1, -2) > 0).float(), want)


@pytest.mark.parametrize("splits", [2, 3, 7])
@pytest.mark.parametrize("name", ["decoder", "q_offset", "dh128_ragged",
                                  "cross"])
def test_flash_dkv_query_splits_match_reference_and_repeat(dev, monkeypatch,
                                                          name, splits):
    """The bf16 dK/dV kernel with each key tile's query range split over
    blocks (forced, where the automatic rule would not split): within the
    bf16 tolerance of the plain backward, and the same bits run to run."""
    monkeypatch.setattr(FA, "dkv_query_splits", lambda *shape: splits)
    (q, k, v, dout, mask), opts = train_case(name, torch.bfloat16, dev)
    args = (opts["causal"], opts["self_mask"], opts["sm_scale"],
            opts["q_offset"], 0.1, 0x9E3779B9)
    out, lse = flash_fwd(q, k, v, mask, *args)
    got = flash_bwd_dkv(q, k, v, out, dout, lse, mask, *args)
    again = flash_bwd_dkv(q, k, v, out, dout, lse, mask, *args)
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v)]
    wants = flash_attend_bwd_reference(
        *f, out.float(), dout.float(), lse, mask, **opts, dropout_rate=0.1,
        dropout_seed=0x9E3779B9)[1:]
    for got_t, want_t, same, what in zip(got, wants, again, ("dk", "dv")):
        err = _err(got_t, want_t)
        assert err < TOL[torch.bfloat16], (what, err)
        assert torch.equal(got_t, same), what


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_dkv_split_is_bit_equal_run_to_run(dev, rate):
    """The longform cross-attention's shape splits every key tile's 8192
    queries (the automatic rule): dK/dV are the same bits on every run."""
    (q, k, v, dout, mask), opts = train_case("cross_longform",
                                             torch.bfloat16, dev)
    args = (opts["causal"], opts["self_mask"], opts["sm_scale"],
            opts["q_offset"], rate, 0x9E3779B9)
    out, lse = flash_fwd(q, k, v, mask, *args)
    runs = [flash_bwd_dkv(q, k, v, out, dout, lse, mask, *args)
            for _ in range(3)]
    torch.cuda.synchronize()
    for dk, dv in runs[1:]:
        assert torch.equal(dk, runs[0][0]) and torch.equal(dv, runs[0][1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,taps", [((8, 1024, 128), 3), ((2, 37, 128), 4),
                                        ((2, 50, 6), 3)])
def test_depthwise_kernel_matches_reference(dev, dtype, shape, taps):
    g = torch.Generator().manual_seed(1)
    c = shape[-1]
    x = torch.randn(*shape, generator=g).to(dev, dtype)
    w = torch.randn(taps, 1, c, generator=g).to(dev, dtype)
    b = torch.randn(c, generator=g).to(dev, dtype)
    before = depthwise_conv1d.launches
    got = depthwise_conv1d(x, w, b)
    torch.cuda.synchronize()
    assert depthwise_conv1d.launches == before + 1
    want = depthwise_conv1d_reference(x, w, b)
    err = _err(got, want)
    assert err < (1e-5 if dtype == torch.float32 else TOL[dtype]), err


@pytest.mark.parametrize("shape,taps", [((1, 1024, 128), 3),
                                        ((8, 1024, 128), 3),
                                        ((2, 50, 6), 4)])
def test_depthwise_kernel_reads_f32_params_with_bf16_x(dev, shape, taps):
    """The vocoder's call: bf16 x with the folded f32 weight and bias, which
    the kernel rounds to bf16 itself; the plain version rounds the same."""
    g = torch.Generator().manual_seed(2)
    c = shape[-1]
    x = torch.randn(*shape, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(taps, 1, c, generator=g).to(dev)
    b = torch.randn(c, generator=g).to(dev)
    before = depthwise_conv1d.launches
    got = depthwise_conv1d(x, w, b)
    torch.cuda.synchronize()
    assert depthwise_conv1d.launches == before + 1
    want = depthwise_conv1d_reference(x, w, b)
    assert torch.equal(want, depthwise_conv1d_reference(x, w.bfloat16(),
                                                        b.bfloat16()))
    assert got.dtype == torch.bfloat16
    assert _err(got, want) < TOL[torch.bfloat16], _err(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_depthwise_function_backward_matches_plain_conv(dev, dtype):
    """K2's Function: forward one K2 launch, gradients of x, w and b equal
    to autograd of the plain version's conv in f32."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 1024, 128, generator=g).to(dev, dtype)
    w, b = (torch.randn(*s, generator=g).to(dev) for s in ((3, 1, 128),
                                                          (128,)))
    dy = torch.randn(8, 1024, 128, generator=g).to(dev, dtype)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    before = depthwise_conv1d.launches
    depthwise_conv1d(*leaves).backward(dy)
    torch.cuda.synchronize()
    assert depthwise_conv1d.launches == before + 1
    # the plain version's function: w and b rounded to x's dtype
    plain = [t.detach().to(dtype).float().requires_grad_() for t in (x, w, b)]
    y = torch.nn.functional.conv1d(
        torch.nn.functional.pad(plain[0].transpose(1, 2), (1, 1)),
        plain[1].reshape(3, 128).t().unsqueeze(1), plain[2], groups=128)
    y.transpose(1, 2).backward(dy.float())
    for got, want in zip(leaves, plain):
        assert got.grad.dtype == got.dtype
        assert _err(got.grad, want.grad) < TOL[dtype], _err(got.grad,
                                                            want.grad)


def test_vocoder_backward_gives_depth_weights_the_plain_conv_gradient(
        dev, monkeypatch):
    """A backward through one WN layer stack of a full-width vocoder flow
    (f32, weight-norm form, the "end" conv made live) on the card: K2's
    Function gives every depth stage's v, g and b the gradient that the
    plain conv's autograd gives."""
    from rtts_torch.config import SqueezeWaveConfig
    from rtts_torch.models import squeezewave as SW

    cfg = SqueezeWaveConfig(compute_dtype="float32")
    model = SW.init(cfg, torch.Generator().manual_seed(4), dev)
    wn = model.flows[0].wn
    with torch.no_grad():
        wn.end.w.copy_(0.02 * torch.randn(
            wn.end.w.shape, generator=torch.Generator().manual_seed(5)))
    g = torch.Generator().manual_seed(6)
    audio = torch.randn(2, 512, cfg.n_group // 2, generator=g).to(dev)
    mel = torch.randn(2, 512, cfg.n_mels, generator=g).to(dev)

    def depth_grads():
        model.zero_grad()
        out = SW.wn_apply(wn, audio, mel, cfg.wn_layers, cfg.wn_channels)
        out.square().sum().backward()
        return [t.grad.clone() for d in wn.depth for t in (d.v, d.g, d.b)]

    before = depthwise_conv1d.launches
    got = depth_grads()
    assert depthwise_conv1d.launches == before + cfg.wn_layers
    monkeypatch.setattr(SW, "depthwise_conv1d", depthwise_conv1d_reference)
    want = depth_grads()
    assert depthwise_conv1d.launches == before + cfg.wn_layers
    for a, b in zip(got, want):
        scale = b.abs().max()
        assert bool(scale > 0)
        assert ((a - b).abs().max() / scale).item() < TOL[torch.float32]


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q, k, v = _qkv(1, 1, 16, 16, 32, torch.float32, dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attend(q, k, v)
    q, k, v = _qkv(1, 1, 16, 16, 64, torch.float16, dev)
    with pytest.raises(TypeError):
        flash_attend(q, k, v)
    x = torch.zeros(1, 8, 16, device=dev)
    with pytest.raises(ValueError):
        depthwise_conv1d(x, torch.zeros(3, 1, 8, device=dev),
                         torch.zeros(16, device=dev))
    with pytest.raises(ValueError, match="taps"):
        depthwise_conv1d(x, torch.zeros(9, 1, 16, device=dev),
                         torch.zeros(16, device=dev))
    with pytest.raises(TypeError):
        depthwise_conv1d(x, torch.zeros(3, 1, 16, device=dev),
                         torch.zeros(16, device=dev, dtype=torch.bfloat16))
    q = torch.zeros(1, 1, 2, 16, 32, device=dev)
    pos = torch.zeros(1, 1, 2, 16, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        lsh_attend_fwd(q, q, q, pos, pos.bool(), True, 1, 0)
    q = torch.zeros(1, 1, 2, 24, 64, device=dev)
    pos = torch.zeros(1, 1, 2, 24, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="chunk length"):
        lsh_attend_fwd(q, q, q, pos, pos.bool(), True, 1, 0)


LSH_CASES = {
    # name: (b, h, n_hashes, L, c, dh, causal, before, after, valid length)
    "test_c16_causal": (2, 2, 2, 64, 16, 64, True, 1, 0, 50),
    "test_c32_dh128_window3": (2, 2, 3, 64, 32, 128, False, 1, 1, 64),
    "nc_not_multiple_of_8": (1, 2, 3, 96, 32, 64, True, 1, 0, 80),
    "encoder_L1024": (2, 8, 4, 1024, 64, 64, False, 1, 0, 900),
    "decoder_L8192": (2, 8, 4, 8192, 64, 64, True, 1, 0, 8192),
    "serving_fast_decoder_L1024": (8, 8, 4, 1024, 64, 64, True, 1, 0, 800),
    "serving_fast_encoder_L256": (8, 8, 4, 256, 64, 64, False, 1, 0, 200),
    # a window on both sides: K5's per-key-chunk walk meets offsets -1, 0, 1
    "window3_c64_causal": (2, 2, 4, 256, 64, 64, True, 1, 1, 200),
    # windows that wrap onto their own chunk: nc 1 (the chunk twice), nc 2
    # (the other chunk on both sides); c 16 with a window on both sides
    "nc1_c64_causal": (2, 2, 1, 64, 64, 64, True, 1, 0, 50),
    "nc2_c32_window3": (2, 2, 1, 64, 32, 64, False, 1, 1, 40),
    "c16_window3_causal": (1, 2, 2, 128, 16, 64, True, 1, 1, 100),
}


def lsh_case(name, dtype, dev, seed=0):
    """Sorted-chunk inputs as the LSH pipeline makes them: per round a
    permutation of the positions, keys the length-normalised queries, key
    validity from the valid length; and cotangents for out and lse."""
    b, h, nh, l, c, dh, causal, before, after, n_valid = LSH_CASES[name]
    g = torch.Generator().manual_seed(seed)
    nc = nh * l // c
    q, v, dout = (torch.randn(b, h, nc, c, dh, generator=g) for _ in range(3))
    k = q * torch.rsqrt((q * q).mean(-1, keepdim=True) + 1e-6) * dh ** -0.5
    pos = torch.stack([torch.randperm(l, generator=g) for _ in range(b * h * nh)])
    pos = pos.reshape(b, h, nc, c)
    dlse = torch.randn(b, h, nc, c, generator=g)
    tensors = [t.to(dev, dtype) for t in (q, k, v, dout)]
    return (tensors, pos.to(dev), (pos < n_valid).to(dev), dlse.to(dev),
            (causal, before, after))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(LSH_CASES))
def test_lsh_kernels_match_reference(dev, name, dtype):
    """K4 and K5 against their plain versions run in f32 on the same
    inputs; K5 twice, bit-equal."""
    (q, k, v, dout), pos, valid, dlse, opts = lsh_case(name, dtype, dev)
    out, lse = lsh_attend_fwd(q, k, v, pos, valid, *opts)
    grads = lsh_attend_bwd(q, k, v, pos, valid, dout, dlse, *opts)
    again = lsh_attend_bwd(q, k, v, pos, valid, dout, dlse, *opts)
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v)]
    want, want_lse = lsh_attend_chunks_reference(*f, pos, valid, *opts)
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-4)
    assert out.dtype == dtype and _err(out, want) < TOL[dtype], _err(out, want)
    wants = lsh_attend_bwd_reference(*f, pos, valid, dout.float(), dlse, *opts)
    for got_t, want_t, same, what in zip(grads, wants, again, "qkv"):
        assert got_t.dtype == dtype and got_t.shape == want_t.shape
        assert _err(got_t, want_t) < TOL[dtype], (what, _err(got_t, want_t))
        assert torch.equal(got_t, same), what


@pytest.mark.parametrize("name", sorted(LSH_CASES))
def test_lsh_fwd_bf16_tensor_cores_match_reference_and_repeat(dev, name):
    """K4's bf16 route (tensor cores, P rounded to bf16 once) against its
    plain version in f32 on the same inputs, lse included; twice,
    bit-equal."""
    (q, k, v, _), pos, valid, _, opts = lsh_case(name, torch.bfloat16, dev)
    out, lse = lsh_attend_fwd(q, k, v, pos, valid, *opts)
    out2, lse2 = lsh_attend_fwd(q, k, v, pos, valid, *opts)
    torch.cuda.synchronize()
    want, want_lse = lsh_attend_chunks_reference(
        *(t.float() for t in (q, k, v)), pos, valid, *opts)
    assert _err(out, want) < TOL[torch.bfloat16], _err(out, want)
    assert _err(lse, want_lse) < 1e-5, _err(lse, want_lse)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


def test_lsh_autograd_launches_k4_and_k5(dev):
    (q, k, v, dout), pos, valid, dlse, opts = lsh_case(
        "test_c16_causal", torch.bfloat16, dev)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = (lsh_attend_fwd.launches, lsh_attend_bwd.launches)
    out, lse = lsh_attend_chunks_kernel(q, k, v, pos, valid, *opts)
    torch.autograd.backward((out, lse), (dout, dlse))
    torch.cuda.synchronize()
    after = (lsh_attend_fwd.launches, lsh_attend_bwd.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1]
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def ffn_case(rows, d, f, dev, seed=0):
    """f32 rows and FFN parameters at the init's scales, LN and biases
    perturbed so every term counts."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, d, generator=g)
    params = (1.0 + 0.1 * torch.randn(d, generator=g),
              0.1 * torch.randn(d, generator=g),
              torch.randn(d, f, generator=g) * d ** -0.5,
              0.1 * torch.randn(f, generator=g),
              torch.randn(f, d, generator=g) * f ** -0.5,
              0.1 * torch.randn(d, generator=g))
    return x.to(dev), [t.to(dev) for t in params]


# chip_smoke.py's K6_CASES (the decoder's and encoder's FFN, a ragged row
# count, a narrow width with each activation), and one width past 512 (32
# rows a block on tensor cores)
K6_SHAPES = [(8 * 1024, 512, 2048, "gelu"), (1000 + 13, 96, 200, "silu"),
             (8 * 256, 512, 2048, "gelu"), (8 * 1000 + 13, 512, 2048, "gelu"),
             (1037, 96, 200, "relu"), (1037, 96, 200, "gelu"),
             (1037, 96, 200, "tanh"), (3000, 1024, 256, "relu")]


@pytest.mark.parametrize("mxu", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d,f,act", K6_SHAPES)
def test_ffn_kernel_matches_reference(dev, rows, d, f, act, mxu):
    """K6 against its plain version on the same f32 rows, multiplying in
    bf16 (tensor cores) or f32 (FMA); twice, bit-equal."""
    x, params = ffn_case(rows, d, f, dev)
    before = ffn_fused.launches
    got = ffn_fused(x, *params, act, mxu)
    again = ffn_fused(x, *params, act, mxu)
    torch.cuda.synchronize()
    assert ffn_fused.launches == before + 2
    want = ffn_fused_reference(x, *params, act, mxu)
    assert got.dtype == x.dtype and _err(got, want) < TOL[mxu], _err(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("rows,d,f", [(8 * 1024, 512, 2048),
                                      (8 * 256, 512, 2048)])
def test_ffn_kernel_takes_bf16_rows(dev, rows, d, f):
    """The train path's input: bf16 rows, bf16 out, multiplying in bf16;
    twice, bit-equal."""
    x, params = ffn_case(rows, d, f, dev)
    x = x.bfloat16()
    got = ffn_fused(x, *params, "gelu", torch.bfloat16)
    again = ffn_fused(x, *params, "gelu", torch.bfloat16)
    torch.cuda.synchronize()
    want = ffn_fused_reference(x, *params, "gelu", torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _err(got, want) < TOL[torch.bfloat16], _err(got, want)
    assert torch.equal(got, again)


def test_ffn_autograd_launches_k6_once(dev):
    """The Function's forward is one K6 launch, its backward the f32 body's
    autograd (no launch)."""
    x, params = ffn_case(2 * 64, 64, 128, dev)
    x = x.reshape(2, 64, 64).requires_grad_()
    p = FFN(64, 128, device=dev)
    with torch.no_grad():
        for t, value in zip(p.parameters(), params):
            t.copy_(value)
    params = list(p.parameters())
    before = ffn_fused.launches
    out = chunked_ffn_fused(p, x, "gelu", torch.bfloat16)
    dout = torch.randn_like(out)
    got = torch.autograd.grad(out, [x, *params], dout)
    torch.cuda.synchronize()
    assert ffn_fused.launches == before + 1
    want = torch.autograd.grad(_ffn_body(p, x, "gelu"), [x, *params], dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_ffn_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    x, params = ffn_case(4, 1040, 8, dev)
    with pytest.raises(ValueError, match="width"):
        ffn_fused(x, *params, "gelu", torch.float32)
    x, params = ffn_case(4, 64, 8, dev)
    with pytest.raises(ValueError, match="activation"):
        ffn_fused(x, *params, "swish", torch.float32)
    with pytest.raises(ValueError, match="w_in"):
        ffn_fused(x, params[0], params[1], params[2].t(), *params[3:], "gelu",
                  torch.float32)


# -- K7 and K8: they move values, so they equal their plain versions exactly --


@pytest.mark.parametrize("n,cols", [
    (1, 3), (2, 5), (64, 8), (4096, 128), (8192, 64), (1024, 256),
    (1024, 2048),            # 8 adjacent columns a block
    (MAX_ROWS, 4)])
def test_bitonic_kernel_matches_sort_and_reference(dev, n, cols):
    g = torch.Generator().manual_seed(n)
    x = torch.randint(-2**31, 2**31 - 1, (n, cols), generator=g,
                      dtype=torch.int64).int()
    x[: n // 4] = x[n // 2: n // 2 + n // 4]        # duplicates
    if n >= 4:
        x[0, 0], x[1, 0] = -2**31, 2**31 - 1
    x = x.to(dev)
    before = bitonic_sort_cols.launches
    got = bitonic_sort_cols(x)
    again = bitonic_sort_cols(x)
    torch.cuda.synchronize()
    assert bitonic_sort_cols.launches == before + 2
    assert torch.equal(got, torch.sort(x, dim=0).values)
    assert torch.equal(got, again)
    if n <= 8192:
        assert torch.equal(got, bitonic_sort_cols_reference(x))


def test_bitonic_kernel_sorts_packed_lsh_keys(dev):
    """Packed keys bucket * L + pos of b2 h8 nh4 L8192: key % L is the
    stable order of the buckets."""
    g = torch.Generator().manual_seed(1)
    l = 8192
    buckets = torch.randint(0, 256, (64, l), generator=g)
    keys = (buckets * l + torch.arange(l)).t().contiguous().int().to(dev)
    got = bitonic_sort_cols(keys)
    want = torch.sort(buckets, dim=-1, stable=True).indices.t().to(dev)
    assert torch.equal((got % l).long(), want)


def test_bitonic_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    with pytest.raises(ValueError, match="power of two"):
        bitonic_sort_cols(torch.zeros((96, 4), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="shared memory"):
        bitonic_sort_cols(torch.zeros((2 * MAX_ROWS, 1), dtype=torch.int32,
                                      device=dev))
    with pytest.raises(ValueError, match="int32"):
        bitonic_sort_cols(torch.zeros((64, 4), dtype=torch.int64, device=dev))


def bucket_case(shape, dev, seed=0, masked_rows=0):
    """Buckets (..., L) in [0, nb] as ``hash_vectors`` gives them (nb the
    auto count at chunk 64, nb itself the overflow bucket of padding): a
    ragged tail of each batch row padded, and the last ``masked_rows``
    batch rows padded whole."""
    g = torch.Generator().manual_seed(seed)
    l = shape[-1]
    nb = TL.auto_num_buckets(l, 64)
    buckets = torch.randint(0, nb, shape, generator=g)
    if len(shape) == 4:
        lens = torch.randint(1, l + 1, (shape[0],), generator=g)
        lens[: shape[0] - masked_rows].clamp_(min=l // 2)
        lens[shape[0] - masked_rows:] = 0
        pad = torch.arange(l)[None, :] >= lens[:, None]
        buckets = torch.where(pad[:, None, None, :], nb, buckets)
    return buckets.to(dev)


SORT_SHAPES = [
    (2, 8, 4, 8192),      # longform decoder
    (2, 8, 4, 1024),      # longform encoder
    (8, 8, 4, 1024),      # serving_fast decoder
    (8, 8, 4, 256),       # serving_fast encoder
    (2, 3, 2, 960), (1, 2, 1, 96), (3, 5), (7, 1), (4, 777), (1, 9000),
    (1, 2, 1, MAX_ROWS), (3, 2, 25, 5000)]


@pytest.mark.parametrize("masked_rows", [0, 1])
@pytest.mark.parametrize("shape", SORT_SHAPES)
def test_sort_by_bucket_kernel_equals_its_plain_version(dev, shape,
                                                        masked_rows):
    buckets = bucket_case(shape, dev, masked_rows=masked_rows)
    before = sort_by_bucket.launches
    got = sort_by_bucket(buckets)
    again = sort_by_bucket(buckets)
    torch.cuda.synchronize()
    assert sort_by_bucket.launches == before + 2
    want = sort_by_bucket_reference(buckets)
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.int64 and g.shape == buckets.shape
        assert torch.equal(g, w)
        assert torch.equal(g, a)


@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("shape", [(2, 8, 4, 8192), (64, 1024), (5, MAX_ROWS),
                                   (2, 8, 4, 1000), (40, 16), (3, 5000)])
def test_sort_by_bucket_kernel_on_both_routes(dev, monkeypatch, shape,
                                              cluster):
    """One CTA a row and a 2-CTA cluster a row, whatever the route would
    take (the fewest rows a block that make whole warps): the same bits."""
    def route(rows, l, sms):
        p = max(1 << (l - 1).bit_length(), 8 * cluster)
        return cluster, max(1, 32 // BS._threads_a_row(p // cluster))

    monkeypatch.setattr(BS, "sort_route", route)
    buckets = bucket_case(shape, dev, seed=3)
    for g, w in zip(sort_by_bucket(buckets), sort_by_bucket_reference(buckets)):
        assert torch.equal(g, w)


def test_sort_by_bucket_takes_the_plain_version_past_max_rows(dev):
    buckets = bucket_case((2, MAX_ROWS + 1), dev)
    before = sort_by_bucket.launches
    got = sort_by_bucket(buckets)
    assert sort_by_bucket.launches == before
    for g, w in zip(got, sort_by_bucket_reference(buckets)):
        assert torch.equal(g, w)


def test_sort_by_bucket_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    with pytest.raises(ValueError, match="int64"):
        sort_by_bucket(torch.zeros((4, 8), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="int64"):
        sort_by_bucket(torch.zeros((), dtype=torch.int64, device=dev))


def test_lsh_layer_forward_launches_k7_once(dev):
    cfg = AttentionConfig(kind="lsh", num_heads=2, head_dim=64, num_hashes=2,
                          chunk_length=64)
    g = torch.Generator().manual_seed(0)
    qk, v = (torch.randn(2, 2, 512, 64, generator=g).to(dev)
             for _ in range(2))
    mask = (torch.arange(512)[None, :] < torch.tensor([512, 300])[:, None])
    before = sort_by_bucket.launches
    out, buckets = TL.lsh_attention_core(
        qk, v, cfg, mask.to(dev), True, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    assert sort_by_bucket.launches == before + 1
    assert out.shape == qk.shape and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d,m", [
    (4096, 128, 4096), (4096, 256, 4096),
    (16 * 8192, 128, 4 * 16 * 8192),      # the longform LSH gather
    (64 * 1024, 128, 4 * 64 * 1024),      # serving_fast's
    (1000, 3, 1000), (1000, 5, 2500), (1000, 6, 700), (1000, 100, 1000),
    (7, 64, 0)])
def test_row_gather_kernel_matches_index_select(dev, dtype, rows, d, m):
    g = torch.Generator().manual_seed(rows + d)
    x = torch.randn(rows, d, generator=g).to(dev, dtype)
    idx = (torch.randperm(rows, generator=g).repeat(m // rows + 1)[:m]
           if m % rows == 0 else torch.randint(0, rows, (m,), generator=g))
    idx = idx.int().to(dev)
    before = row_gather.launches
    got = row_gather(x, idx)
    again = row_gather(x, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 2
    assert got.dtype == dtype and got.shape == (m, d)
    assert torch.equal(got, torch.index_select(x, 0, idx))
    assert torch.equal(got, row_gather_reference(x, idx))
    assert torch.equal(got, again)


def test_row_gather_kernel_takes_unaligned_rows(dev):
    """A view that starts one value in: no 16-byte vectors."""
    x = torch.randn(513 * 64 + 1, device=dev)[1:].reshape(513, 64)
    idx = torch.randint(0, 513, (300,), device=dev, dtype=torch.int32)
    assert torch.equal(row_gather(x, idx), x[idx.long()])


def test_row_gather_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    x = torch.zeros((8, 4), device=dev)
    with pytest.raises(TypeError, match="dtype"):
        row_gather(x.half(), torch.zeros(8, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="int32"):
        row_gather(x, torch.zeros(8, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="idx on"):
        row_gather(x, torch.zeros(8, dtype=torch.int32))


# -- the registered operators (rtts_torch/ops/registry.py) --------------------


def _op_case(name, dev):
    """(operator arguments, plain version, launch-counted wrapper) at a
    small shape, bf16 where the kernel multiplies on tensor cores."""
    g = torch.Generator().manual_seed(9)
    r = lambda *s: torch.randn(s, generator=g).to(dev)  # noqa: E731
    bf = torch.bfloat16
    if name == "flash_fwd":
        q, k, v = (r(2, 64, 4, 64).to(bf).transpose(1, 2) for _ in range(3))
        mask = torch.arange(64, device=dev)[None, :] < torch.tensor(
            [[64], [40]], device=dev)
        args = (q, k, v, mask, False, True, 1.0, 0, 0.0, 0, 0, 0, None)
        return args, lambda: flash_attend_reference(
            q, k, v, mask, self_mask=True, return_lse=True), flash_attend
    if name == "depthwise_conv1d":
        x, w, b = r(2, 96, 128).to(bf), r(3, 1, 128), r(128)
        return (x, w, b), lambda: depthwise_conv1d_reference(x, w, b), \
            depthwise_conv1d
    if name == "lsh_attend_fwd":
        q, k, v = (r(1, 2, 4, 16, 64).to(bf) for _ in range(3))
        pos = torch.stack([torch.randperm(64, generator=g)
                           for _ in range(2)]).reshape(1, 2, 4, 16).to(dev)
        valid = torch.ones(1, 2, 4, 16, dtype=torch.bool, device=dev)
        args = (q, k, v, pos, valid, False, 1, 0, FA.MASK_VALUE,
                FA.SELF_MASK_VALUE)
        return args, lambda: lsh_attend_chunks_reference(*args), \
            lsh_attend_fwd
    if name == "ffn_fused":
        args = (r(96, 64), 1 + r(64), r(64), r(64, 128) / 8, r(128),
                r(128, 64) / 11, r(64), "gelu", bf)
        return args, lambda: ffn_fused_reference(*args), ffn_fused
    buckets = torch.randint(0, 8, (2, 4, 2, 128), generator=g).to(dev)
    return (buckets,), lambda: torch.stack(
        sort_by_bucket_reference(buckets)), sort_by_bucket


@pytest.mark.parametrize("name", ["flash_fwd", "depthwise_conv1d",
                                  "lsh_attend_fwd", "ffn_fused",
                                  "sort_by_bucket"])
def test_registered_op_launches_its_kernel(dev, name):
    """On the card an ``rtts::`` operator is its kernel's launcher: one
    launch counted, the plain version's values, and the fake
    implementation's shapes, dtypes and strides."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    args, plain, counted = _op_case(name, dev)
    op = getattr(torch.ops.rtts, name).default
    before = counted.launches
    got = op(*args)
    torch.cuda.synchronize()
    assert counted.launches == before + 1
    want = plain()
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got_t, want_t):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _err(g, w) <= TOL[torch.bfloat16]
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args))
    fake_t = fake if isinstance(fake, tuple) else (fake,)
    for f, g in zip(fake_t, got_t):
        assert (f.shape, f.dtype, f.stride()) == (g.shape, g.dtype,
                                                  g.stride())
