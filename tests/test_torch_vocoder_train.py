"""The rtts_torch vocoder training slice against rtts (JAX), at small size on
the CPU.

One parameter tree (the JAX package's init, its zero "end" convs made live
so that the WN stacks reach z and get gradients) goes through both
packages through ``rtts_torch.convert``, with the same numpy inputs.  The
JAX side runs its matmuls at "highest" precision (tests/conftest.py) and
its depthwise stage through the XLA conv (the CPU path of ``wn_conv``);
the port runs K2's plain version inside the ``autograd.Function`` the card
uses.  Everything is float32.

Tolerances (max abs error, relative to the largest entry where said): z,
log_s and the log-dets 1e-5 of their largest entry (summation order
only); the losses 1e-5; gradients 1e-4 relative to each leaf's largest
gradient; parameters after Adam updates 1e-2 x lr (the two packages
differed by at most 1.6e-4 x lr after either update; a wrong update, one
of the wrong sign say, moves a parameter by about 2 x lr).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtts.config import (CheckpointConfig, Config, DatasetConfig,
                         ExperimentConfig, LoggingConfig, MeshConfig,
                         OptimConfig, SqueezeWaveConfig)
from rtts.models import squeezewave as JS
from rtts.train import optim as JO
from rtts.train.checkpoint import save_checkpoint as jax_save
from rtts.train.train_vocoder import make_eval_step as jax_make_eval_step
from rtts.train.train_vocoder import make_train_step as jax_make_train_step
from rtts.train.vocoder_loss import squeezewave_loss as jax_loss
from rtts_torch.convert import from_numpy_tree, load_leaves_npz
from rtts_torch.models import squeezewave as TS
from rtts_torch.ops import depthwise_conv as DW
from rtts_torch.train import optim as TO
from rtts_torch.train.train_vocoder import make_eval_step, make_train_step
from rtts_torch.train.vocoder_loss import squeezewave_loss
from tests.test_full_model_parity import FIXTURE
from tests.test_full_model_parity import TOL as FIXTURE_TOL
from tests.test_full_model_parity import vocoder_cfg, vocoder_inputs
from torch_twin import one_thread  # noqa: F401  (autouse)


TOL = 1e-5
GRAD_TOL = 1e-4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, tol=TOL, scale=1.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol * scale, rtol=0)


def scaled_close(got, want, tol=TOL):
    close(got, want, tol, max(float(np.abs(np.asarray(want)).max()), 1.0))


def live_params(cfg, seed=1):
    """JAX vocoder params with the "end" convs perturbed as
    tests/test_full_model_parity.py perturbs them."""
    params = JS.init(jax.random.PRNGKey(seed), cfg)
    for i, flow in enumerate(params["flows"]):
        k = jax.random.fold_in(jax.random.PRNGKey(2), i)
        flow["wn"]["end"]["w"] = (
            0.3 * jax.random.normal(k, flow["wn"]["end"]["w"].shape))
        flow["wn"]["end"]["b"] = (
            0.1 * jax.random.normal(jax.random.fold_in(k, 1),
                                    flow["wn"]["end"]["b"].shape))
    return params


def port_model(cfg, jp):
    return from_numpy_tree(TS.init(cfg, device="cpu"), np_tree(jp))


@pytest.mark.parametrize("clamp", [0.0, 2.0])
def test_forward_matches_jax(clamp):
    cfg = dataclasses.replace(vocoder_cfg(), log_s_clamp=clamp)
    jp = live_params(cfg)
    mel, audio, _ = vocoder_inputs(cfg)
    want = JS.forward(jp, cfg, jnp.asarray(mel), jnp.asarray(audio))
    got = TS.forward(port_model(cfg, jp), cfg, torch.from_numpy(mel),
                     torch.from_numpy(audio))
    scaled_close(got[0], want[0])
    assert len(got[1]) == len(want[1]) == cfg.n_flows
    for a, b in zip(got[1], want[1]):
        scaled_close(a, b)
    if clamp > 0:
        assert max(float(a.abs().max()) for a in got[1]) < clamp
    for a, b in zip(got[2], want[2]):
        scaled_close(a, b)
    assert all(a.shape == () for a in got[2])


def test_forward_matches_the_golden_fixture():
    """The port's forward and inverse against the torch twin's outputs
    pinned in tests/fixtures/full_model_parity.npz, at that test's
    tolerances."""
    cfg = vocoder_cfg()
    model = port_model(cfg, live_params(cfg))
    mel, audio, z = vocoder_inputs(cfg)
    gold = np.load(FIXTURE)
    zt, log_s, log_det = TS.forward(model, cfg, torch.from_numpy(mel),
                                    torch.from_numpy(audio))
    audio_inv = TS._infer_chunk(model, torch.from_numpy(mel),
                                torch.from_numpy(z), cfg=cfg)
    got = {"voc_z": zt, "voc_log_s0": log_s[0],
           "voc_log_det": torch.stack(log_det), "voc_audio_inv": audio_inv}
    for key, value in got.items():
        scale = max(np.abs(gold[key]).max() + 1e-6, 1.0)
        np.testing.assert_allclose(value.detach().numpy(), gold[key],
                                   atol=FIXTURE_TOL[key] * scale, rtol=2e-3,
                                   err_msg=key)


def test_forward_then_inverse_returns_the_audio():
    """With the log-scale bound on: z from ``forward``, then
    ``_infer_chunk`` on that z, gives the audio back (1e-4: two passes of
    f32 rounding through 4 flows)."""
    cfg = dataclasses.replace(vocoder_cfg(), log_s_clamp=2.0)
    model = port_model(cfg, live_params(cfg, seed=3))
    mel, audio, _ = vocoder_inputs(cfg)
    with torch.no_grad():
        z, _, _ = TS.forward(model, cfg, torch.from_numpy(mel),
                             torch.from_numpy(audio))
    back = TS._infer_chunk(model, torch.from_numpy(mel), z, cfg=cfg)
    assert float(z.std()) > 0.5 * float(np.std(audio))
    close(back, audio, 1e-4)


def test_squeeze_and_unsqueeze_match_jax():
    x = np.arange(2 * 48, dtype=np.float32).reshape(2, 48)
    sq = TS.squeeze_audio(torch.from_numpy(x), 16)
    np.testing.assert_array_equal(sq.numpy(),
                                  np.asarray(JS.squeeze_audio(x, 16)))
    np.testing.assert_array_equal(TS.unsqueeze_audio(sq).numpy(), x)
    with pytest.raises(ValueError, match="divisible"):
        TS.squeeze_audio(torch.zeros(1, 50), 16)


def test_loss_and_eval_step_match_jax():
    """``squeezewave_loss`` on the same z, log_s and log-dets, and the eval
    step end to end (no K2 Function: grad mode is off)."""
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, 16, 16)).astype(np.float32)
    log_s = [rng.standard_normal((2, 16, n)).astype(np.float32) * 0.3
             for n in (8, 8, 6)]
    log_det = [np.float32(v) for v in (0.5, -1.25, 2.0)]
    _, got = squeezewave_loss(torch.from_numpy(z),
                              [torch.from_numpy(a) for a in log_s],
                              [torch.tensor(v) for v in log_det], 0.7)
    _, want = jax_loss(jnp.asarray(z), [jnp.asarray(a) for a in log_s],
                       [jnp.asarray(v) for v in log_det], 0.7)
    assert sorted(got) == sorted(want) == [
        "log_det_mean", "log_s_mean", "loss_vocoder", "z_rms"]
    for k in want:
        close(got[k], want[k])

    cfg = dataclasses.replace(vocoder_cfg(), log_s_clamp=2.0)
    jp = live_params(cfg)
    mel, audio, _ = vocoder_inputs(cfg)
    want = jax.jit(jax_make_eval_step(cfg))(
        jp, {"mel": jnp.asarray(mel), "audio": jnp.asarray(audio)})
    before = DW.depthwise_conv1d.launches
    got = make_eval_step(cfg)(port_model(cfg, jp),
                              {"mel": torch.from_numpy(mel),
                               "audio": torch.from_numpy(audio)})
    assert DW.depthwise_conv1d.launches == before   # the CPU: plain version
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k])


def _jax_grads(cfg, jp, batch):
    def loss_fn(p):
        z, log_s, log_det = JS.forward(p, cfg, batch["mel"], batch["audio"])
        return jax_loss(z, log_s, log_det, cfg.sigma)[0]

    return jax.jit(jax.value_and_grad(loss_fn))(jp)


def test_train_step_matches_jax():
    """Two f32 train steps (Adam, clip 1.0, a constant nonzero lr from the
    first update), the "end" convs live: loss, grad_norm and every
    gradient (v, g, b of each weight-normed conv, the 1x1s, "end") of the
    first step; loss and grad_norm of the second; the parameters after
    each update."""
    cfg = dataclasses.replace(vocoder_cfg(), log_s_clamp=2.0)
    optim = OptimConfig(schedule="constant", learning_rate=1e-3,
                        grad_clip_norm=1.0)
    lr = optim.learning_rate
    jp = live_params(cfg)
    tm = port_model(cfg, jp)
    names = [n for n, _ in tm.named_parameters()]
    assert {n.split(".")[-1] for n in names} == {"v", "g", "b", "w",
                                                 "w_1x1"}
    j_opt = JO.make_optimizer(optim)
    j_state = j_opt.init(jp)
    j_step = jax.jit(jax_make_train_step(cfg, j_opt))
    t_opt = TO.make_optimizer(optim)
    t_state = t_opt.init(list(tm.parameters()))
    t_step = make_train_step(cfg, t_opt)
    for step in range(2):
        mel, audio, _ = vocoder_inputs(cfg)
        audio = audio * (1.0 + step)
        jb = {"mel": jnp.asarray(mel), "audio": jnp.asarray(audio)}
        if step == 0:
            want_loss, want_grads = _jax_grads(cfg, jp, jb)
        jp, j_state, j_metrics = j_step(jp, j_state, jb)
        metrics, grads = t_step(tm, t_state, {
            "mel": torch.from_numpy(mel), "audio": torch.from_numpy(audio)},
            return_grads=True)
        assert sorted(metrics) == sorted(j_metrics)
        for k in j_metrics:
            scaled_close(metrics[k], j_metrics[k], GRAD_TOL)
        if step == 0:
            close(metrics["loss_vocoder"], want_loss, TOL)
            want = dict(port_model(cfg, want_grads).named_parameters())
            for name, g in zip(names, grads):
                w = want[name].detach()
                scale = float(w.abs().max())
                assert scale > 0, name      # every gradient is live
                close(g / scale, w / scale, GRAD_TOL)
            close(metrics["grad_norm"], optax.global_norm(want_grads),
                  GRAD_TOL, float(metrics["grad_norm"]))
        want_params = dict(port_model(cfg, jp).named_parameters())
        for name, p in tm.named_parameters():
            close(p, want_params[name].detach(), 1e-2 * lr)
    assert t_state["count"] == 2


def test_jax_vocoder_checkpoint_loads(tmp_path):
    """A JAX vocoder training checkpoint (params + optax state) fills the
    port's module through ``load_leaves_npz``."""
    cfg = vocoder_cfg()
    jp = live_params(cfg, seed=4)
    opt = JO.make_optimizer(OptimConfig())
    step_dir = jax_save(tmp_path, {"params": jp, "opt_state": opt.init(jp)},
                        7)
    model = load_leaves_npz(TS.init(cfg, device="cpu"), step_dir)
    want = dict(port_model(cfg, jp).named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(p, want[name]), name


# -- the trainer --------------------------------------------------------------------


def _trainer_cfg(data_dir, **exp_overrides):
    return Config(
        dataset=DatasetConfig(data_dir=data_dir, batch_size=4,
                              val_fraction=0.25, num_workers=0),
        vocoder=SqueezeWaveConfig(n_flows=3, n_group=64, n_early_every=2,
                                  n_early_size=16, wn_layers=2,
                                  wn_channels=32, audio_segment_length=4096,
                                  compute_dtype="float32", log_s_clamp=5.0),
        experiment=ExperimentConfig(
            seed=0, optim=OptimConfig(learning_rate=1e-3, warmup_steps=2),
            checkpoint=CheckpointConfig(save_every_steps=3, keep=2),
            logging=LoggingConfig(log_every_steps=2, eval_every_steps=4),
            eval_batches=2, **exp_overrides),
    )


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    from rtts.data.corpus import generate_corpus
    from rtts.data.preprocess import preprocess_corpus

    root = tmp_path_factory.mktemp("torch_voc")
    data_dir = str(root / "data")
    generate_corpus(root, n_utterances=8)
    preprocess_corpus(_trainer_cfg(data_dir).dataset,
                      str(root / "transcripts.txt"))
    return data_dir


def test_train_vocoder_runs_evaluates_and_writes_the_artifact(prepared,
                                                               tmp_path):
    from rtts_torch.train.train_vocoder import train_vocoder

    work = tmp_path / "voc"
    m = train_vocoder(_trainer_cfg(prepared), str(work), max_steps=4,
                      device="cpu")
    for key in ("loss_vocoder", "grad_norm", "z_rms", "log_s_mean",
                "log_det_mean", "steps_per_sec", "val_loss_vocoder"):
        assert np.isfinite(m[key]), (key, m)
    assert m["lr"] > 0
    lines = [json.loads(l) for l in open(work / "metrics.jsonl")]
    assert [l["step"] for l in lines if "train/loss_vocoder" in l] == [1, 2, 4]
    val = next(l for l in lines if "val/loss_vocoder" in l)
    assert val["step"] == 4
    for key in ("val/loss_vocoder", "val/mr_stft",
                "val/spectral_convergence", "val/log_stft_l1"):
        assert np.isfinite(val[key]), (key, val)
    assert (work / "artifacts" / "vocoder_step4.wav").stat().st_size > 44
    assert sorted(p.name for p in (work / "checkpoints").glob("step_*")) == [
        "step_3", "step_4"]


def test_train_vocoder_resume_replays(prepared, tmp_path):
    """4 steps, then a resume to 6, equal to 6 steps in one run: the last
    metrics and the step-6 checkpoint bit for bit."""
    from rtts_torch.train.train_vocoder import train_vocoder

    cfg = _trainer_cfg(prepared)
    work = tmp_path / "a"
    train_vocoder(cfg, str(work), max_steps=4, device="cpu")
    m2 = train_vocoder(cfg, str(work), max_steps=6, device="cpu")
    m3 = train_vocoder(cfg, str(tmp_path / "b"), max_steps=6, device="cpu")
    assert m2 == {**m3, "steps_per_sec": m2["steps_per_sec"]}
    a = np.load(work / "checkpoints" / "step_6" / "leaves.npz")
    b = np.load(tmp_path / "b" / "checkpoints" / "step_6" / "leaves.npz")
    assert a.files == b.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_vocoder_refuses_a_mesh(prepared, tmp_path):
    """A mesh larger than the world raises the reference's ValueError
    (the mesh path itself runs in tests/test_torch_parallel_cli.py)."""
    from rtts_torch.train.train_vocoder import train_vocoder

    for mesh in (MeshConfig(data_parallel=2), MeshConfig(model_parallel=2)):
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            train_vocoder(_trainer_cfg(prepared, mesh=mesh),
                          str(tmp_path / "x"), max_steps=1, device="cpu")
