#!/usr/bin/env python3
"""What K3's hi + lo bf16 operands cost on one NVIDIA GPU.

The bf16 path of ``rtts_torch/csrc/flash_bwd.cu`` feeds P o R and dS to
the tensor cores as two bf16 parts each (hi + lo), so that the kernel
holds the port's tolerance against the f32 plain backward; the TPU kernel
rounds each of them to bf16 once.  A build with
``-DRTTS_FLASH_BWD_ROUND_ONCE`` leaves the lo products out.  This script
builds the kernel library both ways and, for each build:

- holds dQ, dK and dV against the f32 plain backward at every
  ``TRAIN_FLASH_CASES`` shape of ``chip_smoke.py`` (bf16, dropout 0 and
  0.1), the error relative to max(1, |value|) as the smoke run measures it;
- times the dK/dV and dQ kernels at the decoder self-attention (b8 h8
  L1024 causal) and the longform cross-attention (b2 h8 Lq8192 Lk1024):
  CUDA events around back-to-back calls, the two builds in the order
  A B B A, and the device time from torch.profiler's kernel events.

    python3 tools/flash_bwd_rounding_cost.py

Prints one line per case and a last JSON line of the times and the largest
errors of each build.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402
from rtts_torch.ops import _build  # noqa: E402
from rtts_torch.ops.flash_attention import (  # noqa: E402
    flash_attend_bwd_reference, flash_bwd_dkv, flash_bwd_dq, flash_fwd)

BUILDS = ("hi+lo", "round once")
TIMED = {"decoder b8 h8 L1024 causal+self": 20,
         "cross b2 h8 Lq8192 Lk1024 pad": 10}


def _load_builds() -> dict:
    """Each build's (library, resolved functions), the shipped one first."""
    flags = list(_build.NVCC_FLAGS)
    libs = {}
    for name, extra in zip(BUILDS, ([], ["-DRTTS_FLASH_BWD_ROUND_ONCE"])):
        _build.NVCC_FLAGS = flags + extra
        _build._lib, _build._functions = None, {}
        libs[name] = (_build.library(), _build._functions)
    _build.NVCC_FLAGS = flags
    return libs


def _use(libs: dict, name: str) -> None:
    _build._lib, _build._functions = libs[name]


def _errors(libs: dict) -> dict:
    """Largest error of each build over every case, and per case."""
    worst = {name: 0.0 for name in BUILDS}
    for case_name, case in S.TRAIN_FLASH_CASES.items():
        for rate in (0.0, 0.1):
            (q, k, v, dout), mask, opts = S._train_flash_case(
                *case, torch.bfloat16)
            args = (*opts, rate, S.DROP_SEED)
            _use(libs, BUILDS[0])
            out, lse = flash_fwd(q, k, v, mask, *args)
            kw = dict(zip(("causal", "self_mask", "sm_scale", "q_offset"),
                          opts), dropout_rate=rate, dropout_seed=S.DROP_SEED)
            want = flash_attend_bwd_reference(
                *(t.float() for t in (q, k, v, out, dout)), lse, mask, **kw)
            line = []
            for name in BUILDS:
                _use(libs, name)
                dk, dv = flash_bwd_dkv(q, k, v, out, dout, lse, mask, *args)
                dq = flash_bwd_dq(q, k, v, out, dout, lse, mask, *args)
                errs = [S._scaled_err(g, w) for g, w in zip((dq, dk, dv),
                                                            want)]
                worst[name] = max(worst[name], *errs)
                line.append(f"{name}: dq {errs[0]:.3e} dk {errs[1]:.3e} "
                            f"dv {errs[2]:.3e}")
            print(f"[rounding] {case_name} dropout {rate}: "
                  + "; ".join(line) + f" (tol {S.KERNEL_TOL[torch.bfloat16]:g})")
    return worst


def _times(libs: dict, case_name: str, n: int) -> dict:
    (q, k, v, dout), mask, opts = S._train_flash_case(
        *S.TRAIN_FLASH_CASES[case_name], torch.bfloat16)
    args = (*opts, 0.0, 0)
    _use(libs, BUILDS[0])
    out, lse = flash_fwd(q, k, v, mask, *args)

    def backward(name):
        def run():
            _use(libs, name)
            flash_bwd_dkv(q, k, v, out, dout, lse, mask, *args)
            flash_bwd_dq(q, k, v, out, dout, lse, mask, *args)
        return run

    runs = [backward(name) for name in BUILDS]
    ms = S._interleaved_ms(runs, n)
    res = {}
    for name, run, t in zip(BUILDS, runs, ms):
        res[name] = {
            "ms": t,
            "dkv_device_ms": S._device_ms(run, n, ("flash_bwd_di",
                                                   "flash_bwd_dkv")),
            "dq_device_ms": S._device_ms(run, n, ("flash_bwd_dq",))}
    print(f"[rounding] {case_name} bf16, dK/dV + dQ: " + "; ".join(
        f"{name} {r['ms']:.4f} ms (device dK/dV {r['dkv_device_ms']:.4f} + "
        f"dQ {r['dq_device_ms']:.4f})" for name, r in res.items()))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_rounding_cost: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    S.phase_device()
    libs = _load_builds()
    worst = _errors(libs)
    times = {case: _times(libs, case, n) for case, n in TIMED.items()}
    _use(libs, BUILDS[0])
    print(json.dumps({"max_err": worst, "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
