"""The port's command line over two processes, on the CPU: the counterpart
of ``scripts/multihost_dryrun.py``.

``RTTS_MULTIHOST=1 python -m torch.distributed.run --standalone
--nproc-per-node 2 -m rtts_torch.cli -c configs/tiny.yaml ... --device cpu
train-tts --max-steps 2`` (gloo; ``--standalone`` picks a free port) trains
the tiny config over the mesh that ``experiment.mesh`` gives: data parallel
2 with ZeRO-1, tensor parallel 2, the vocoder data parallel 2, and the
decoder split over the model group of 2, its sequence
(``seq_parallel_axis``) or its layers (``pipeline_axis``), and its
sequence split over the data group of 2 (``seq_parallel_axis: data``).  Each run's
checkpoint (written by rank 0, the whole tree) equals the one of the same
two steps in one process, dropout on (0.1 in the stacks and the prenets):
a rank draws the whole batch's masks and keeps its rows.  The split
decoder runs, and its one-process reference, set the decoder's dropout to
0 (pipeline microbatches draw masks of their own) and its FFN chunk to 2
(which pads the decoder's length to an even one, as the sequence split
needs).
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
import torch

from rtts_torch import cli as TCLI
from torch_twin import one_thread  # noqa: F401  (autouse)


ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = str(ROOT / "configs" / "tiny.yaml")
SPLIT = ["model.decoder.ffn_chunk_size=2", "model.decoder.dropout=0.0",
         "model.decoder.attention.attention_dropout=0.0"]
# name -> (verb, overrides, the one-process run it equals)
CASES = {
    "tts_dp_zero": ("tts", ["experiment.mesh.zero_sharding=true"],
                    "one_tts"),
    "tts_tp": ("tts", ["experiment.mesh.model_parallel=2"], "one_tts"),
    "vocoder_dp": ("vocoder", [], "one_vocoder"),
    "tts_seq": ("tts", SPLIT + ["model.decoder.seq_parallel_axis=model",
                                "experiment.mesh.model_parallel=2"],
                "one_split"),
    # the decoder's sequence over the data axis of data parallel 2: each
    # rank's batch rows gathered for its attention, every rank in the eval
    "tts_seq_data": ("tts", SPLIT + ["model.decoder.seq_parallel_axis=data"],
                     "one_split"),
    # one microbatch: the eval batch holds the one validation utterance
    "tts_pipe": ("tts", SPLIT + ["model.decoder.pipeline_axis=model",
                                 "model.decoder.pipeline_microbatches=1",
                                 "experiment.mesh.model_parallel=2"],
                 "one_split"),
}
ONE = {"one_tts": ("tts", []), "one_vocoder": ("vocoder", []),
       "one_split": ("tts", SPLIT)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_parallel_cli")
    top = ["-c", TINY, "-o", f"dataset.data_dir={root / 'data'}",
           "--device", "cpu"]
    assert TCLI.main(top + ["generate-corpus", "-n", "8"]) == 0
    assert TCLI.main(top + ["preprocess"]) == 0
    env = dict(os.environ, RTTS_MULTIHOST="1", OMP_NUM_THREADS="1")
    procs = {}
    for name, (verb, overrides, _) in CASES.items():
        args = [a for o in overrides for a in ("-o", o)]
        log = open(root / f"{name}.log", "w")
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "rtts_torch.cli"] + top + args
            + [f"train-{verb}", "--workdir", str(root / name),
               "--max-steps", "2"],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:   # the one-process runs beside them
        for name, (verb, overrides) in ONE.items():
            args = [a for o in overrides for a in ("-o", o)]
            assert TCLI.main(top + args + [f"train-{verb}", "--workdir",
                                           str(root / name),
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
    step = "checkpoints/step_2/leaves.npz"
    with np.load(root / name / step) as got, \
            np.load(root / CASES[name][2] / step) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-3,
                                       err_msg=k)
    # host IO is rank 0's: one metrics file, one config
    assert (root / name / "metrics.jsonl").read_text().count("\n") >= 2


@pytest.mark.parametrize("verb", ["generate-corpus", "bench"])
def test_main_destroys_the_process_group_it_started(tmp_path, verb):
    """``main`` under a one-rank ``file://`` group leaves no group behind,
    whether the verb returns or raises (a rank must not exit with gloo's
    threads running: ``terminate called without an active exception``)."""
    import torch.distributed as dist

    args = ["-c", TINY, "-o", f"dataset.data_dir={tmp_path / 'data'}",
            "-o", "experiment.mesh.coordinator_address="
            f"file://{tmp_path / 'store'}", "--device", "cpu", verb]
    if verb == "bench":   # raises inside the verb: no such compute dtype
        with pytest.raises(KeyError, match="float64"):
            TCLI.main(args[:2] + ["-o", "model.compute_dtype=float64"]
                      + args[2:] + ["--which", "decode"])
    else:
        assert TCLI.main(args + ["-n", "2"]) == 0
    assert not dist.is_initialized()
