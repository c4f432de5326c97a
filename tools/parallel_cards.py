#!/usr/bin/env python3
"""Train base.yaml over several NVIDIA GPUs of one host, one rank a card
(the backend rule picks nccl), and hold each run against one process.

    python3 tools/parallel_cards.py [CARDS]

CARDS (default: every visible card, at least 2).  In a temporary
directory it writes a 24-utterance synthetic corpus and runs, through the
command line (``rtts_torch.cli``), ``train-tts --max-steps 3`` at
base.yaml's full width in one process, then over CARDS ranks with
``RTTS_MULTIHOST=1 python -m torch.distributed.run --standalone
--nproc-per-node CARDS``: data parallel with ZeRO-1 over every rank, and,
when CARDS is even, data parallel x a model group of 2 three ways: tensor
parallel, the decoder's sequence split (``seq_parallel_axis``, allgather
and ring), and the decoder pipelined (``pipeline_axis``, 4 microbatches,
interleave 1 and 3; its hops nccl's point-to-point sends).  The pipelined
runs and their one-process run set guided attention and the decoder's
dropout to 0 and keep 8 validation utterances (the eval batch, whole on
the first data rank's model group, must divide into data x microbatches,
as the reference requires).  Each run's checkpoint (rank 0's, the whole tree)
is compared leaf by leaf with its one process's: parameters within 1e-6
(Noam's first learning rates are at most 1e-7), Adam moments within 2e-2
of each leaf's largest entry (the gradients sum bf16 products over a
batch split another way), the counts equal.  Prints each run's wall, the
ranks' backend lines, the worst differences, the card's name and power
limit, and one JSON line; exits non-zero when a run fails or differs.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PARAM_TOL = 1e-6
MOMENT_TOL = 2e-2
PIPE = ["model.guided_attention_weight=0.0", "model.decoder.dropout=0.0",
        "model.decoder.attention.attention_dropout=0.0",
        "dataset.val_fraction=0.34"]


def _o(overrides):
    return [a for o in overrides for a in ("-o", o)]


def _run(cmd, env=None) -> float:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=1200)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if "rtts_torch.parallel" in line:
            print(f"  {line.strip()}")
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[:8])} ... exited "
                           f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-6000:]}")
    return wall


def _compare(got_dir: pathlib.Path, want_dir: pathlib.Path) -> dict:
    step = "checkpoints/step_3/leaves.npz"
    worst = {"params": 0.0, "moments": 0.0}
    with np.load(got_dir / step) as got, np.load(want_dir / step) as want:
        if sorted(got.files) != sorted(want.files):
            raise RuntimeError("the checkpoints hold different leaves")
        for k in want.files:
            a, b = got[k].astype(np.float64), want[k].astype(np.float64)
            if k.startswith("params/"):
                worst["params"] = max(worst["params"],
                                      float(np.abs(a - b).max()))
            elif "/mu/" in k or "/nu/" in k:
                worst["moments"] = max(worst["moments"], float(
                    np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)))
            elif not np.array_equal(a, b):
                raise RuntimeError(f"{k} differs")
    return worst


def main() -> int:
    cards = int(sys.argv[1]) if len(sys.argv) > 1 else \
        torch.cuda.device_count()
    if not torch.cuda.is_available() or cards < 2 \
            or cards > torch.cuda.device_count():
        print(f"parallel_cards: needs 2 or more cards, has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    work = pathlib.Path(tempfile.mkdtemp(prefix="rtts_cards_"))
    top = [sys.executable, "-m", "rtts_torch.cli", "-c",
           str(ROOT / "configs" / "base.yaml"), "-o",
           f"dataset.data_dir={work / 'data'}"]
    runs, ok = {}, True
    try:
        _run(top + ["generate-corpus", "-n", "24"])
        _run(top + ["preprocess"])
        for one, extra in (("one", []), ("one_pipe", PIPE)):
            print(f"{one}:")
            runs[one] = {"wall": _run(top + _o(extra) + [
                "train-tts", "--workdir", str(work / one),
                "--max-steps", "3"])}
        # name -> (overrides, the one-process run it equals)
        meshes = {f"dp{cards}_zero": (["experiment.mesh.zero_sharding=true"],
                                      "one")}
        if cards % 2 == 0:
            dp, mp2 = cards // 2, ["experiment.mesh.model_parallel=2"]
            meshes[f"dp{dp}xtp2"] = (mp2, "one")
            for ex in ("allgather", "ring"):
                meshes[f"dp{dp}xsp2_{ex}"] = (mp2 + [
                    "model.decoder.seq_parallel_axis=model",
                    f"model.decoder.seq_parallel_exchange={ex}"], "one")
            for v in (1, 3):
                meshes[f"dp{dp}xpp2_v{v}"] = (mp2 + PIPE + [
                    "model.decoder.pipeline_axis=model",
                    "model.decoder.pipeline_microbatches=4",
                    f"model.decoder.pipeline_interleave={v}"], "one_pipe")
        env = dict(os.environ, RTTS_MULTIHOST="1", OMP_NUM_THREADS="1")
        for name, (extra, one) in meshes.items():
            print(f"{name}:")
            wall = _run([sys.executable, "-m", "torch.distributed.run",
                         "--standalone", "--nproc-per-node", str(cards)]
                        + top[1:] + _o(extra) + ["train-tts", "--workdir",
                                                 str(work / name),
                                                 "--max-steps", "3"], env)
            worst = _compare(work / name, work / one)
            good = (worst["params"] <= PARAM_TOL
                    and worst["moments"] <= MOMENT_TOL)
            ok = ok and good
            runs[name] = {"wall": wall, **worst, "ok": good}
            print(f"  {name}: {wall:.1f} s (one process "
                  f"{runs[one]['wall']:.1f} s); params max |diff| "
                  f"{worst['params']:.3e} (tol {PARAM_TOL:g}), moments "
                  f"{worst['moments']:.3e} of their leaf's largest (tol "
                  f"{MOMENT_TOL:g}): {'equal' if good else 'DIFFER'}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(f"cards: {smi}")
    print(json.dumps({"cards": cards, "runs": runs}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
