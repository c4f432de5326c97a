"""The kernels an inference path launches, as registered operators.

``torch.export`` records operators; it cannot trace through the ctypes
call that launches a kernel (``_build``).  So each forward launcher that a
serving path reaches is an operator of the ``rtts`` namespace, defined
here with ``torch.library``:

==========================  ===  ==========================================
operator                    K    CUDA implementation (the launcher)
==========================  ===  ==========================================
``rtts::flash_fwd``         K1   ``flash_attention.flash_fwd``
``rtts::depthwise_conv1d``  K2   ``depthwise_conv.depthwise_conv1d_kernel``
``rtts::lsh_attend_fwd``    K4   ``lsh_attention.lsh_attend_fwd``
``rtts::ffn_fused``         K6   ``chunked_ffn.ffn_fused``
``rtts::sort_by_bucket``    K7   ``bitonic_sort.sort_by_bucket_packed``
==========================  ===  ==========================================

The CUDA implementation is the launcher itself, so an operator call on the
card launches the hand-written kernel and counts in the launcher's
``.launches``; the CPU implementation is the kernel's plain version.  The
dispatcher picks one by the tensors' device.  Each operator has a fake
implementation with the exact output shapes, dtypes and (contiguous)
strides, which the plain versions' outputs are made to share, so an
exported graph keeps one node per call, and an artifact on the card
launches the kernel at every call.

The wrappers' no-grad routes (``flash_attend``, ``depthwise_conv1d``,
``lsh_attend_chunks_kernel``, ``chunked_ffn_fused``, ``sort_by_bucket``)
call these operators, so the live ``Synthesizer`` and an exported artifact
run the same thing; the training ``autograd.Function``s call the same
launchers.  The operators are defined with ``Library.define`` and
``Library.impl`` rather than ``custom_op``: the dispatcher calls the Python
implementation directly, with none of ``custom_op``'s per-call wrapping.

Importing any kernel module (or this one) defines all five; loading an
exported artifact needs them defined first (``rtts_torch.infer.export``
imports this module).
"""

from __future__ import annotations

import torch

from rtts_torch.ops import bitonic_sort as BS
from rtts_torch.ops import chunked_ffn as CF
from rtts_torch.ops import depthwise_conv as DW
from rtts_torch.ops import flash_attention as FA
from rtts_torch.ops import lsh_attention as LA

NAMESPACE = "rtts"
LIB = torch.library.Library(NAMESPACE, "DEF")

SCHEMAS = {
    "flash_fwd": "(Tensor q, Tensor k, Tensor v, Tensor? kv_mask, "
                 "bool causal, bool self_mask, float sm_scale, int q_offset, "
                 "float dropout_rate, int dropout_seed, int b_offset, "
                 "int h_offset, int? h_total) -> (Tensor, Tensor)",
    "depthwise_conv1d": "(Tensor x, Tensor w, Tensor b) -> Tensor",
    "lsh_attend_fwd": "(Tensor q, Tensor k, Tensor v, Tensor pos, "
                      "Tensor valid, bool causal, int before, int after, "
                      "float mask_value, float self_mask_value) "
                      "-> (Tensor, Tensor)",
    "ffn_fused": "(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor w_in, "
                 "Tensor b_in, Tensor w_out, Tensor b_out, str act, "
                 "ScalarType mxu_dtype) -> Tensor",
    "sort_by_bucket": "(Tensor buckets) -> Tensor",
}


def _late(module, name: str):
    """``module.name`` (a launcher or a plain version), looked up at each
    call: a stand-in set on the module (``chip_smoke.py``'s tallies of the
    launches by shape, a test's counted plain version) sees the
    operator's calls too."""
    def call(*args):
        return getattr(module, name)(*args)
    return call


def _define(name, cuda, cpu, fake) -> None:
    def plain(*args):   # contiguous outputs, as the kernels write them
        out = cpu(*args)
        if isinstance(out, tuple):
            return tuple(t.contiguous() for t in out)
        return out.contiguous()

    LIB.define(name + SCHEMAS[name])
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, plain, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)


def _empty(x, shape=None, dtype=None):
    """A contiguous fake output: x's shape and dtype unless given."""
    return x.new_empty(x.shape if shape is None else shape,
                       dtype=x.dtype if dtype is None else dtype)


# -- K1 ------------------------------------------------------------------------


def _flash_cpu(q, k, v, kv_mask, causal, self_mask, sm_scale, q_offset,
               dropout_rate, dropout_seed, b_offset, h_offset, h_total):
    return FA.flash_attend_reference(
        q, k, v, kv_mask, causal=causal, self_mask=self_mask,
        sm_scale=sm_scale, q_offset=q_offset, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed, return_lse=True, b_offset=b_offset,
        h_offset=h_offset, h_total=h_total)


def _flash_fake(q, k, v, kv_mask, *_):
    b, h, l_q, _ = q.shape
    return _empty(q), _empty(q, (b * h, l_q), torch.float32)


_define("flash_fwd", _late(FA, "flash_fwd"), _flash_cpu, _flash_fake)


# -- K2 ------------------------------------------------------------------------


def _dw_fake(x, w, b):
    return _empty(x)


_define("depthwise_conv1d", _late(DW, "depthwise_conv1d_kernel"),
        _late(DW, "depthwise_conv1d_reference"), _dw_fake)


# -- K4 ------------------------------------------------------------------------


def _lsh_fake(q, k, v, pos, valid, *_):
    return _empty(q), _empty(q, q.shape[:4], torch.float32)


_define("lsh_attend_fwd", _late(LA, "lsh_attend_fwd"),
        _late(LA, "lsh_attend_chunks_reference"), _lsh_fake)


# -- K6 ------------------------------------------------------------------------


def _ffn_fake(x, *_):
    return _empty(x)


_define("ffn_fused", _late(CF, "ffn_fused"),
        _late(CF, "ffn_fused_reference"), _ffn_fake)


# -- K7 ------------------------------------------------------------------------


def _sort_cpu(buckets):
    return torch.stack(BS.sort_by_bucket_reference(buckets))


def _sort_fake(buckets):
    return _empty(buckets, (3, *buckets.shape), torch.int64)


_define("sort_by_bucket", _late(BS, "sort_by_bucket_packed"), _sort_cpu,
        _sort_fake)
