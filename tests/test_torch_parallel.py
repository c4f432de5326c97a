"""Data, tensor and ZeRO-1 parallel training in the port against the JAX
package's sharded step, on the CPU.

The JAX side runs ``make_train_step`` jitted over its virtual 8-device mesh
with the shardings of ``rtts/parallel/sharding.py`` (as
``tests/test_zero_sharding.py`` does).  The port side runs in rank
processes (``tests/torch_parallel_ranks.py``, with JAX and the JAX package
blocked) over gloo: one group of 2 ranks (data parallel 2, tensor parallel
2, tensor parallel 2 with every FFN through K6's wrapper, data parallel 2
with ZeRO-1) and one of 4 (data 2 x model 2 with ZeRO-1), started together
before the JAX side compiles.  The model is
``tests/test_torch_train.py``'s train config at one layer a stack (d 32, 2
heads, r 2, guided attention on, f32, every dropout 0: JAX's Threefry bits
cannot be matched), the batch 4 rows with ragged masks whose shards hold very
different numbers of valid frames, two steps of Adam with the clip at a
constant learning rate.

Tolerances (``tests/test_torch_train.py``'s): loss, guided-attention loss
and gradient norm 1e-4 abs; parameters after the steps 3 x lr abs; the
ranks' gathered trees equal to each other exactly.  The dropout mask of a
rank (batch rows and heads at an offset) equals the slice of JAX's
global ``dropout_keep_mask`` bit for bit.  The sequence-parallel and
pipelined stacks are ``tests/test_torch_parallel_seq.py``'s.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtts.config import MeshConfig as JMeshConfig
from rtts.config import OptimConfig, to_dict
from rtts.models import reformer_tts as JM
from rtts.ops.flash_attention import dropout_keep_mask as jax_keep_mask
from rtts.parallel.mesh import make_mesh as jax_make_mesh
from rtts.parallel.sharding import (batch_sharding, make_param_shardings,
                                    opt_state_shardings)
from rtts.train import optim as JO
from rtts.train.train_tts import make_train_step as jax_make_train_step
from rtts_torch import config as TC
from rtts_torch.models import reformer_tts as TM
from rtts_torch.ops.flash_attention import (dropout_keep_mask,
                                            flash_attend_reference)
from rtts_torch.train import optim as TO
from rtts_torch.train.checkpoint import restore_checkpoint, snapshot
from rtts_torch.train.train_tts import make_train_step, step_generator
from tests.test_torch_train import MODEL_TOL, _train_cfg, np_tree, tt
from torch_twin import one_thread  # noqa: F401  (autouse)


ROOT = pathlib.Path(__file__).resolve().parent.parent
RANKS = ROOT / "tests" / "torch_parallel_ranks.py"
OPTIM = OptimConfig(schedule="constant", learning_rate=1e-3,
                    grad_clip_norm=1.0)
STEPS = 2
# name -> (data, model, zero, world); "tp_k6" runs every FFN through K6's
# wrapper (its plain version here), whose fused LayerNorm takes the
# replicated LN parameters inside the model-sharded computation
MESHES = {"dp": (2, 1, False, 2), "tp": (1, 2, False, 2),
          "zero": (2, 1, True, 2), "dp2xmp2": (2, 2, True, 4),
          "tp_k6": (1, 2, False, 2), "sp": (1, 2, False, 2),
          "pp_zero": (2, 2, True, 4)}
# the JAX run each port run is held against: K6 computes the FFN sublayer's
# function, so "tp_k6" against JAX's tensor-parallel step
JAX_RUN = {name: name for name in MESHES}
JAX_RUN["tp_k6"] = "tp"
T_LENS = [21, 20, 6, 5]      # the two data shards: 41 valid frames vs 11


def spawn(work: pathlib.Path, world: int, cases, inputs):
    """Start ``world`` rank processes on ``cases``; -> their Popens (logs
    in WORKDIR/log{r}.txt)."""
    work.mkdir(parents=True, exist_ok=True)
    (work / "spec.json").write_text(json.dumps({"cases": cases}))
    np.savez(work / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("RTTS_MULTIHOST", None)
    return [subprocess.Popen([sys.executable, str(RANKS), str(work), str(r),
                              str(world)], cwd=ROOT, env=env,
                             stdout=open(work / f"log{r}.txt", "w"),
                             stderr=subprocess.STDOUT)
            for r in range(world)]


def collect(work: pathlib.Path, procs, timeout: float = 300):
    """Wait for the ranks -> their outputs.  A rank that fails (or the
    timeout) kills the others, which would wait in a collective, and
    fails the test with the failing rank's log."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            r = bad[0] if bad else 0
            assert not bad and time.monotonic() < deadline, (
                f"rank {r} failed, or the ranks timed out:\n"
                + (work / f"log{r}.txt").read_text()[-6000:])
            time.sleep(0.2)
        for r, p in enumerate(procs):
            assert p.returncode == 0, (
                f"rank {r}:\n" + (work / f"log{r}.txt").read_text()[-6000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r in range(len(procs)):
        with np.load(work / f"rank{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs


def _batches(cfg):
    rng = np.random.default_rng(7)
    b, l, t = 4, 13, 21
    out = []
    for _ in range(STEPS):
        out.append({
            "tokens": rng.integers(3, cfg.vocab_size, (b, l)).astype(np.int32),
            "token_mask": np.arange(l)[None, :] < np.asarray(
                [13, 8, 11, 4])[:, None],
            "mel": (0.5 * rng.standard_normal((b, t, cfg.n_mels))).astype(
                np.float32),
            "mel_mask": np.arange(t)[None, :] < np.asarray(T_LENS)[:, None],
        })
    return out


def _jax_run(cfg, jp, batches, dp, mp, zero):
    """JAX's sharded steps (tests/test_zero_sharding.py) -> (params,
    metrics per step)."""
    optimizer = JO.make_optimizer(OPTIM)
    mesh = jax_make_mesh(JMeshConfig(data_parallel=dp, model_parallel=mp),
                         jax.devices()[:dp * mp])
    tp = mp > 1
    with mesh:
        params = jax.device_put(
            jp, make_param_shardings(jp, mesh, tensor_parallel=tp))
        state = optimizer.init(jp)
        state = jax.device_put(state, opt_state_shardings(
            state, mesh, tensor_parallel=tp, zero=zero))
        step_fn = jax.jit(jax_make_train_step(cfg, optimizer))
        metrics = []
        for step, batch in enumerate(batches):
            jb = {k: jax.device_put(jnp.asarray(v),
                                    batch_sharding(mesh, v.ndim))
                  for k, v in batch.items()}
            params, state, m = step_fn(params, state, jb,
                                       jax.random.PRNGKey(0), step)
            metrics.append(jax.device_get(m))
    return np_tree(params), metrics


def _cfg(name=None):
    """The train config; "sp" splits the decoder's sequence over the model
    group (chunk 4 and FFN chunks of 4 pad its 11 groups to 12, so the
    sequence-parallel path engages and divides), "pp_zero" pipelines a
    2-layer decoder (guided attention 0: the reference refuses it there)."""
    cfg = _train_cfg(r=2, d=32, guided=0.0 if name == "pp_zero" else 2.0)
    dec = dataclasses.replace(cfg.decoder, num_layers=1)
    if name == "sp":
        dec = dataclasses.replace(
            dec, seq_parallel_axis="model", ffn_chunk_size=4,
            attention=dataclasses.replace(dec.attention, chunk_length=4))
    elif name == "pp_zero":
        dec = dataclasses.replace(dec, num_layers=2, pipeline_axis="model")
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, num_layers=1),
        decoder=dec)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = _cfg()
    jp = JM.init(jax.random.PRNGKey(5), cfg)
    cfgs = {name: _cfg(name) for name in MESHES}
    jps = {name: jp for name in MESHES}
    jps["pp_zero"] = JM.init(jax.random.PRNGKey(5), cfgs["pp_zero"])
    batches = _batches(cfg)
    inputs = {**_paths(np_tree(jp), "p/"),
              **_paths(np_tree(jps["pp_zero"]), "p_pp/")}
    for s, batch in enumerate(batches):
        inputs.update({f"b/{s}/{k}": v for k, v in batch.items()})

    def case(name):
        dp, mp, zero, _ = MESHES[name]
        return {"kind": "train", "name": name, "model": to_dict(cfgs[name]),
                "optim": dataclasses.asdict(OPTIM),
                "params": "p_pp" if name == "pp_zero" else "p",
                "batches": "b", "steps": STEPS, "dp": dp, "mp": mp,
                "zero": zero, "k6": name == "tp_k6"}

    root = tmp_path_factory.mktemp("torch_parallel")
    groups = {w: [case(n) for n in MESHES if MESHES[n][3] == w]
              for w in (2, 4)}
    procs = {w: spawn(root / f"w{w}", w, cases, inputs)
             for w, cases in groups.items()}
    try:   # the JAX side compiles while the ranks run
        jax_out = {name: _jax_run(cfgs[name], jps[name], batches,
                                  *MESHES[name][:3])
                   for name in set(JAX_RUN.values())}
    finally:
        ranks = {w: collect(root / f"w{w}", p) for w, p in procs.items()}
    return dict(cfg=cfg, jp=jp, batches=batches, jax=jax_out, ranks=ranks,
                root=root)


def _rank_outputs(runs, name):
    return runs["ranks"][MESHES[name][3]]


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_step_matches_jax(runs, name):
    """Loss, guided-attention loss and gradient norm of each step, and every
    parameter after the last, on every rank, against JAX's sharded step."""
    want_params, want_metrics = runs["jax"][JAX_RUN[name]]
    outs = _rank_outputs(runs, name)
    for step in range(STEPS):
        for key in ("loss", "loss_guided_attn", "grad_norm"):
            if key not in want_metrics[step]:   # guided attention 0
                continue
            for out in outs:
                np.testing.assert_allclose(
                    out[f"{name}/metric/{step}/{key}"],
                    want_metrics[step][key], atol=MODEL_TOL, rtol=0,
                    err_msg=f"step {step} {key}")
    flat = {k: v for k, v in jax.tree_util.tree_flatten_with_path(
        want_params)[0]}
    for path, want in jax.tree_util.tree_flatten_with_path(want_params)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        for out in outs:
            np.testing.assert_allclose(out[f"{name}/flat/params/{key}"], want,
                                       atol=3 * OPTIM.learning_rate, rtol=0,
                                       err_msg=key)
    assert flat
    for out in outs[1:]:
        for k, v in outs[0].items():
            if k.startswith(f"{name}/flat/"):
                np.testing.assert_array_equal(out[k], v, err_msg=k)


def test_ragged_shards_keep_the_global_loss(runs):
    """The shards hold 41 and 11 valid frames: the data-parallel loss is the
    global batch's (JAX's), far from the mean of the shards' own losses
    (the one-device port's, on each shard)."""
    cfg = runs["cfg"]
    tcfg = TC.from_dict(TC.ReformerTTSConfig, to_dict(cfg))
    from rtts_torch.convert import from_numpy_tree
    from rtts_torch.train.losses import make_stop_target, tts_loss

    model = from_numpy_tree(TM.init(tcfg, device="cpu"), np_tree(runs["jp"]))
    batch = {k: tt(v) for k, v in runs["batches"][0].items()}

    @torch.no_grad()
    def loss(rows):
        b = {k: v[rows] for k, v in batch.items()}
        pre, post, stop = TM.forward(model, tcfg, b["tokens"].long(),
                                     b["token_mask"], b["mel"], b["mel_mask"])
        return float(tts_loss(pre, post, stop, b["mel"],
                              make_stop_target(b["mel_mask"]), b["mel_mask"],
                              tcfg.stop_pos_weight)[0])

    got = float(_rank_outputs(runs, "dp")[0]["dp/metric/0/loss_mel_pre"]
                + _rank_outputs(runs, "dp")[0]["dp/metric/0/loss_mel_post"]
                + _rank_outputs(runs, "dp")[0]["dp/metric/0/loss_stop"])
    whole = loss(slice(0, 4))
    mean_of_shards = 0.5 * (loss(slice(0, 2)) + loss(slice(2, 4)))
    np.testing.assert_allclose(got, whole, atol=MODEL_TOL, rtol=0)
    assert abs(mean_of_shards - whole) > 100 * MODEL_TOL


@pytest.mark.parametrize("name", ["zero", "dp2xmp2"])
def test_zero_moments_gather_to_the_replicated_ones(runs, name):
    """ZeRO-1's moments, gathered from the data ranks' slices, equal those
    of the replicated data-parallel run (the same numerics)."""
    got, want = _rank_outputs(runs, name)[0], _rank_outputs(runs, "dp")[0]
    keys = [k for k in want if k.startswith("dp/flat/opt_state/")]
    assert any("/mu/" in k for k in keys)
    for k in keys:
        np.testing.assert_allclose(got[k.replace("dp/", f"{name}/", 1)],
                                   want[k], atol=1e-6, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["tp", "dp2xmp2"])
def test_sharded_checkpoint_restores_into_one_process(runs, name):
    """Rank 0's checkpoint of a sharded run holds the whole tree under the
    one-device names: it restores into one process, and equals the same
    steps run there."""
    cfg, root = runs["cfg"], runs["root"]
    tcfg = TC.from_dict(TC.ReformerTTSConfig, to_dict(cfg))
    opt = TO.make_optimizer(TC.from_dict(TC.OptimConfig,
                                         dataclasses.asdict(OPTIM)))
    ref = TM.init(tcfg, device="cpu")
    from rtts_torch.convert import from_numpy_tree
    from_numpy_tree(ref, np_tree(runs["jp"]))
    ref_state = opt.init(list(ref.parameters()))
    step_fn = make_train_step(tcfg, opt)
    for s, batch in enumerate(runs["batches"]):
        tb = {k: tt(v) for k, v in batch.items()}
        tb["tokens"] = tb["tokens"].long()
        step_fn(ref, ref_state, tb, step_generator(0, s, "cpu"), s)

    model = TM.init(tcfg, device="cpu")
    state = opt.init(list(model.parameters()))
    world = MESHES[name][3]
    step = restore_checkpoint(root / f"w{world}" / f"ckpt_{name}" /
                              f"step_{STEPS}", model, state)
    assert step == STEPS and state["count"] == STEPS
    got, want = snapshot(model, state), snapshot(ref, ref_state)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)


def test_rank_processes_import_neither_jax_nor_rtts(runs):
    for outs in runs["ranks"].values():
        for out in outs:
            assert bool(out["blocked"])


@pytest.mark.parametrize("b_off,heads,h_off", [(0, 4, 0), (2, 2, 2),
                                               (1, 2, 0), (3, 1, 3)])
def test_rank_dropout_mask_is_the_global_masks_slice(b_off, heads, h_off):
    """A rank holding batch rows b_off.. and heads h_off.. of 4 x 4 hashes
    the global (b, h): its mask is JAX's global mask's slice, bit for bit,
    and K1's plain version with the offsets gives that slice of the
    one-device output."""
    seed, rate, bt, ht, l, b = 1234, 0.3, 4, 4, 24, 1
    want = np.asarray(jax_keep_mask(seed, bt * ht, l, l, rate)).reshape(
        bt, ht, l, l)[b_off:b_off + b, h_off:h_off + heads]
    got = dropout_keep_mask(seed, b * heads, l, l, rate, heads=heads,
                            b_offset=b_off, h_offset=h_off, h_total=ht)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(bt, ht, l, 64, generator=g) for _ in range(3))
    whole = flash_attend_reference(q, k, v, causal=True, dropout_rate=rate,
                                   dropout_seed=seed)
    rows, hs = slice(b_off, b_off + b), slice(h_off, h_off + heads)
    part = flash_attend_reference(q[rows, hs], k[rows, hs], v[rows, hs],
                                  causal=True, dropout_rate=rate,
                                  dropout_seed=seed, b_offset=b_off,
                                  h_offset=h_off, h_total=ht)
    np.testing.assert_array_equal(part.numpy(), whole[rows, hs].numpy())


def _paths(tree, prefix=""):
    """{path: leaf} of a pytree, paths joined by '/'."""
    return {prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                              for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
