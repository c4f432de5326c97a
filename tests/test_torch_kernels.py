"""Plain versions of the rtts_torch kernels against the JAX Pallas kernels.

K1 (flash-attention forward) and K2 (depthwise conv): the same numpy inputs
go through the JAX kernel in Pallas interpret mode and through the port's
plain PyTorch version, which is what the port's wrapper runs on the CPU (and
what ``tests/test_torch_cuda.py`` holds the CUDA kernels against on a GPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtts.ops.depthwise_conv import depthwise_conv1d_pallas
from rtts.ops.flash_attention import flash_attend as jax_flash_attend
from rtts_torch.ops.depthwise_conv import (depthwise_conv1d,
                                           depthwise_conv1d_reference)
from rtts_torch.ops.flash_attention import (flash_attend,
                                            flash_attend_reference,
                                            resolve_flash_impl)
from torch_twin import one_thread  # noqa: F401  (autouse)


# f32 on both sides at "highest" matmul precision: the only differences are
# summation order and the online softmax's rescaling (~1e-7 relative)
TOL = 1e-5


def _len_norm(x):
    return x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True) + 1e-6)


FLASH_CASES = {
    # name: (b, h, lq, lk, d, kv lengths, causal, self_mask, sm_scale,
    #        shared_qk, q_offset)
    "shared_qk_self_ragged_mask": (2, 2, 128, 128, 32, (128, 90), False, True,
                                   1.0, True, 0),
    "causal_self": (2, 2, 128, 128, 32, (128, 100), True, True, 1.0, True, 0),
    "cross_lq_ne_lk": (2, 2, 64, 128, 32, (128, 40), False, False,
                       32 ** -0.5, False, 0),
    "length_77": (2, 2, 77, 77, 32, (77, 50), False, True, 1.0, True, 0),
    "fully_masked_row": (2, 2, 128, 128, 32, (128, 0), False, False,
                         32 ** -0.5, False, 0),
    # a sequence-parallel query shard: rows 64..127 of a 128-key sequence,
    # so the causal and self masks compare q_offset + row with the key
    "q_offset_causal_self": (2, 2, 64, 128, 32, (128, 100), True, True, 1.0,
                             False, 64),
}


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_reference_matches_jax_kernel(name):
    (b, h, lq, lk, d, lens, causal, self_mask, scale, shared,
     q_offset) = FLASH_CASES[name]
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, h, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, lk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, lk, d)).astype(np.float32)
    if shared:   # the shared-QK contract: k = len_norm(q) / sqrt(d)
        k = (_len_norm(q) * d ** -0.5).astype(np.float32)
    mask = np.arange(lk)[None, :] < np.asarray(lens)[:, None]
    kw = dict(causal=causal, self_mask=self_mask, sm_scale=scale,
              q_offset=q_offset)
    want = np.asarray(jax_flash_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        interpret=True, **kw))
    got = flash_attend_reference(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(mask),
                                 **kw).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("kernel", [3, 4])
def test_depthwise_reference_matches_jax_kernel(kernel):
    rng = np.random.default_rng(1)
    b, l, c = 2, 37, 16
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    w = rng.standard_normal((kernel, 1, c)).astype(np.float32)
    bias = rng.standard_normal((c,)).astype(np.float32)
    want = np.asarray(depthwise_conv1d_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), interpret=True))
    got = depthwise_conv1d_reference(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_wrappers_run_the_plain_version_on_cpu_without_counting():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 20, 8, generator=g) for _ in range(3))
    mask = torch.arange(20)[None, :] < 15
    before = flash_attend.launches
    out, lse = flash_attend(q, k, v, mask, self_mask=True, return_lse=True)
    ref, ref_lse = flash_attend_reference(q, k, v, mask, self_mask=True,
                                          return_lse=True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert lse.shape == (2, 20)
    assert flash_attend.launches == before
    x = torch.randn(2, 9, 4, generator=g)
    w, b = torch.randn(3, 1, 4, generator=g), torch.randn(4, generator=g)
    before = depthwise_conv1d.launches
    assert torch.equal(depthwise_conv1d(x, w, b),
                       depthwise_conv1d_reference(x, w, b))
    assert depthwise_conv1d.launches == before
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attend(q, k, v, dropout_rate=0.1)


def test_resolve_flash_impl_takes_the_kernel_at_every_length():
    # no length threshold yet: one is set once the crossover is measured
    assert resolve_flash_impl("auto") == "flash"
    assert resolve_flash_impl(True) == "flash"
    assert resolve_flash_impl(False) == "naive"
    with pytest.raises(ValueError):
        resolve_flash_impl("sometimes")
