"""The port's command line over two processes, on the CPU: the counterpart
of ``scripts/multihost_dryrun.py``.

``RTTS_MULTIHOST=1 python -m torch.distributed.run --standalone
--nproc-per-node 2 -m rtts_torch.cli -c configs/tiny.yaml ... --device cpu
train-tts --max-steps 2`` (gloo; ``--standalone`` picks a free port) trains
the tiny config over the mesh that ``experiment.mesh`` gives: data parallel
2 with ZeRO-1, tensor parallel 2, and the vocoder data parallel 2.  Each
run's checkpoint (written by rank 0, the whole tree) equals the one of the
same two steps in one process, dropout on (0.1 in the stacks and the
prenets): a rank draws the whole batch's masks and keeps its rows.
Tolerance 1e-4 abs + 1e-3 rel, a tenth of the learning rate: the sums over
ranks reorder f32 additions, and Adam's first steps move a weight by about
lr whatever its gradient's size, so last-bit differences in a small
gradient reach the weight at ~1e-5.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from rtts_torch import cli as TCLI

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = str(ROOT / "configs" / "tiny.yaml")
CASES = {
    "tts_dp_zero": ("tts", ["experiment.mesh.zero_sharding=true"]),
    "tts_tp": ("tts", ["experiment.mesh.model_parallel=2"]),
    "vocoder_dp": ("vocoder", []),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_parallel_cli")
    top = ["-c", TINY, "-o", f"dataset.data_dir={root / 'data'}",
           "--device", "cpu"]
    assert TCLI.main(top + ["generate-corpus", "-n", "8"]) == 0
    assert TCLI.main(top + ["preprocess"]) == 0
    env = dict(os.environ, RTTS_MULTIHOST="1", OMP_NUM_THREADS="1")
    procs = {}
    for name, (verb, overrides) in CASES.items():
        args = [a for o in overrides for a in ("-o", o)]
        log = open(root / f"{name}.log", "w")
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "rtts_torch.cli"] + top + args
            + [f"train-{verb}", "--workdir", str(root / name),
               "--max-steps", "2"],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:   # the one-process runs beside them
        for verb in ("tts", "vocoder"):
            assert TCLI.main(top + [f"train-{verb}", "--workdir",
                                    str(root / f"one_{verb}"),
                                    "--max-steps", "2"]) == 0
    finally:
        for p in procs.values():
            try:
                p.wait(timeout=300)
            finally:
                if p.poll() is None:
                    p.kill()
    return root, {n: p.returncode for n, p in procs.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_two_processes_train_as_one(runs, name):
    root, codes = runs
    log = (root / f"{name}.log").read_text()
    assert codes[name] == 0, log[-6000:]
    assert "backend gloo" in log and "rank 1 of 2" in log
    verb = CASES[name][0]
    step = "checkpoints/step_2/leaves.npz"
    with np.load(root / name / step) as got, \
            np.load(root / f"one_{verb}" / step) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-3,
                                       err_msg=k)
    # host IO is rank 0's: one metrics file, one config
    assert (root / name / "metrics.jsonl").read_text().count("\n") >= 2
