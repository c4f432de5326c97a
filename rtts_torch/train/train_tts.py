"""TTS training: port of ``rtts/train/train_tts.py`` on one device.

The step is the reference's: teacher-forced forward with dropout on,
masked mel and stop losses plus the guided-attention term (linearly
annealed), gradients by autograd (through K1 and K3 on the card), the
unclipped gradients' global norm as ``grad_norm``, then global-norm clip,
Adam and the learning-rate schedule with optax's semantics, once per
``accumulate_steps`` micro-batches (``rtts_torch/train/optim.py``).
Parameters and optimizer state are updated in place.

``train_tts`` runs the reference's loop: ``EpochBatcher``'s step -> batch
map and a dropout generator seeded from (seed, step), so a resumed run
replays the batches and dropout of an uninterrupted one; logging, eval
(losses, MCD, stop-length error, the alignment scalars ``attn_diagonality``
and ``attn_focus`` of the first val batch's teacher-forced cross-attention,
the predicted-vs-target mel and alignment images when matplotlib is there,
and the Griffin-Lim render of the first val prediction as
``audio_step{N}.wav`` with its MR-STFT distance to the shortest val clip),
periodic and final checkpoints, resume, and a graceful stop on
SIGTERM/SIGINT.  Metrics go to JSONL, TensorBoard and a hosted tracker as
configured (``rtts_torch/utils/metrics.py``), eval artifacts to the
tracker too.  ``experiment.debug_nans`` runs the loop in autograd's anomaly
mode and checks the loss and every gradient before each update
(``rtts_torch.utils.profiling.check_finite``: FloatingPointError naming
the first non-finite one).

Over several ranks (``experiment.mesh``: ``data_parallel``,
``model_parallel``, ``dcn_parallel``, ``zero_sharding``, started by
``initialize_distributed``) the loop runs the reference's mesh path
through ``rtts_torch.parallel.training.MeshTraining``: the batch splits
over the data group (whole on every rank when it does not divide), the
losses keep the global batch's semantics, the gradients sum over the data
group, tensor parallelism shards the attention and FFN projections, and
ZeRO-1 splits the Adam moments.  Host IO (metrics, checkpoints, the
tracker, eval artifacts) is rank 0's; eval runs on the first data rank's
model group, the batch whole.  Checkpoints hold the whole tree under the
one-device names, so any mesh resumes from any.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from rtts_torch.audio.griffin import mel_to_audio
from rtts_torch.audio.wav import write_wav
from rtts_torch.config import Config, save_config, to_dict
from rtts_torch.data import (EpochBatcher, Manifest, TextMelDataset,
                             split_manifest, to_device)
from rtts_torch.infer.diagnostics import alignment_map
from rtts_torch.models import reformer_tts as M
from rtts_torch.parallel.collectives import batch_shard
from rtts_torch.parallel.mesh import (initialize_distributed, make_mesh,
                                      rank_device)
from rtts_torch.parallel.sharding import splits_over_batch, whole_stacks
from rtts_torch.parallel.training import MeshTraining
from rtts_torch.text import frontend_vocab_size
from rtts_torch.train.checkpoint import (AsyncCheckpointer, latest_checkpoint,
                                         restore_checkpoint, snapshot,
                                         write_checkpoint)
from rtts_torch.train.interrupt import GracefulStop
from rtts_torch.train.losses import (guided_attention_loss, make_stop_target,
                                     tts_loss)
from rtts_torch.train.optim import global_norm, lr_at_step, make_optimizer
from rtts_torch.train.quality import (attention_diagonality,
                                     mel_cepstral_distortion,
                                     multi_resolution_stft_distance,
                                     stop_length_mae)
from rtts_torch.utils.metrics import MetricLogger
from rtts_torch.utils.profiling import check_finite, enable_nan_debugging
from rtts_torch.utils.tracking import make_tracker
from rtts_torch.utils.visualize import plot_attention, plot_spectrogram


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of train step ``step``: a function of (seed,
    step) only, so a resumed run draws what an uninterrupted one did."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _guided_weight(weight: float, decay_steps: int, step: int) -> np.float32:
    """The guided-attention weight at ``step``, in f32 as the reference."""
    w = np.float32(weight)
    if decay_steps > 0:
        w = w * np.clip(np.float32(1.0) - np.float32(step) / np.float32(
            decay_steps), np.float32(0.0), np.float32(1.0))
    return np.float32(w)


def make_train_step(model_cfg, optimizer, debug_nans: bool = False,
                    mesh: Optional[MeshTraining] = None):
    """-> train_step(model, opt_state, batch, generator, step=0,
    return_grads=False) -> metrics (0-dim tensors) [, grads].

    ``batch`` holds tensors on the model's device (``rtts_torch.data.
    to_device``); ``generator`` (on that device) draws the dropout.  With
    ``debug_nans`` the loss and every gradient are checked before the
    update (one host synchronization), and a NaN that autograd's anomaly
    mode finds in the backward raises FloatingPointError too.

    With ``mesh`` (a ``MeshTraining``, whose construction sharded the
    model) ``batch`` is this rank's rows, run inside its ``batch_shard``;
    the metrics and the returned gradients are the global batch's (the
    gradients of this rank's shards).  The step runs inside ``with
    mesh.mesh:``."""
    gal_w = model_cfg.guided_attention_weight
    gal_decay = model_cfg.guided_attention_decay_steps
    count = mesh.count if mesh is not None else (lambda t: t)

    def train_step(model, opt_state, batch, generator, step=0,
                   return_grads=False):
        with (mesh.mesh if mesh is not None else contextlib.nullcontext()):
            return _step(model, opt_state, batch, generator, step,
                         return_grads)

    def _step(model, opt_state, batch, generator, step, return_grads):
        params = list(model.parameters())
        sink = [] if gal_w > 0.0 else None
        pre, post, stop = M.forward(
            model, model_cfg, batch["tokens"], batch["token_mask"],
            batch["mel"], batch["mel_mask"], generator=generator,
            attn_sink=sink)
        total, metrics = tts_loss(pre, post, stop, batch["mel"],
                                  make_stop_target(batch["mel_mask"]),
                                  batch["mel_mask"], model_cfg.stop_pos_weight,
                                  count)
        if sink is not None:
            cross = model.decoder.layers[1].f.attn
            heads = (None if cross.w_o.tp is None
                     else (cross.num_heads, cross.w_o.tp[1]))
            gal = guided_attention_loss(
                sink, batch["token_mask"], batch["mel_mask"],
                model_cfg.reduction_factor, model_cfg.guided_attention_sigma,
                count, heads)
            total = total + float(_guided_weight(gal_w, gal_decay, step)) * gal
            metrics = dict(metrics, loss=total, loss_guided_attn=gal)
        # the last postnet layer's LN is never read (as in the reference,
        # whose gradient there is zero): materialize zeros for it
        try:
            grads = torch.autograd.grad(total, params, materialize_grads=True)
        except RuntimeError as e:   # anomaly mode found a NaN
            if not debug_nans or "nan values" not in str(e):
                raise
            raise FloatingPointError(f"debug_nans: {e}") from e
        if debug_nans:
            check_finite([("loss", total)] + [
                (f"the gradient of {name}", g) for (name, _), g in zip(
                    model.named_parameters(), grads)])
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is None:
            metrics["grad_norm"] = global_norm(grads)
            optimizer.step(params, grads, opt_state)
        else:
            mesh.reduce_grads(grads)
            metrics = mesh.reduce_metrics(metrics)
            metrics["grad_norm"] = mesh.norm(grads)
            mesh.update(optimizer, params, grads, opt_state)
        return (metrics, grads) if return_grads else metrics

    return train_step


def make_eval_step(model_cfg):
    """-> eval_step(model, batch) -> (metrics, mel_post): deterministic
    forward, the loss terms, MCD and the stop-length error."""

    @torch.no_grad()
    def eval_step(model, batch):
        pre, post, stop = M.forward(
            model, model_cfg, batch["tokens"], batch["token_mask"],
            batch["mel"], batch["mel_mask"])
        _, metrics = tts_loss(pre, post, stop, batch["mel"],
                              make_stop_target(batch["mel_mask"]),
                              batch["mel_mask"], model_cfg.stop_pos_weight)
        metrics["mcd"] = mel_cepstral_distortion(post, batch["mel"],
                                                 batch["mel_mask"])
        metrics["stop_len_mae"] = stop_length_mae(
            stop, batch["mel_mask"], model_cfg.stop_threshold)
        return metrics, post

    return eval_step


def setup_mesh(cfg: Config, device):
    """Start the process group when the config or ``RTTS_MULTIHOST`` asks
    (``initialize_distributed``) and build this rank's mesh -> (mesh,
    device: the rank's card for "cuda").  A mesh larger than the world
    raises the reference's ValueError."""
    initialize_distributed(cfg.experiment.mesh, device)
    mesh = make_mesh(cfg.experiment.mesh)
    if mesh.data_size * mesh.model_size > 1:
        device = rank_device(device)
        print(f"rtts_torch.parallel: {mesh.describe()}, device {device}",
              flush=True)
    return mesh, device


def train_tts(cfg: Config, workdir: str, max_steps: Optional[int] = None,
              manifest_path: Optional[str] = None, stop: Optional[Any] = None,
              device="cuda") -> Dict[str, Any]:
    """Run TTS training on ``device``; returns the last logged train
    metrics.  Resumable from ``workdir``'s checkpoints.

    ``stop``: an object with a ``stop_requested`` property, polled at every
    step boundary; when None a :class:`GracefulStop` turns SIGTERM/SIGINT
    into a checkpoint-and-return."""
    exp = cfg.experiment
    mesh, device = setup_mesh(cfg, device)
    is_main = mesh.is_main
    work = pathlib.Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    logger = (MetricLogger(
        str(work / exp.logging.jsonl_path), exp.logging.tensorboard_dir,
        tracker=make_tracker(exp.logging.tracker, exp.name,
                             config=to_dict(cfg))) if is_main else None)
    stop_ctx = GracefulStop() if stop is None else contextlib.nullcontext(stop)
    anomaly = (enable_nan_debugging() if exp.debug_nans
               else contextlib.nullcontext())
    # the mesh is the ambient one of the whole loop: a stack that splits
    # its sequence or layers over the model group finds it (eval included)
    with stop_ctx as stopper, anomaly, mesh:
        max_steps = max_steps if max_steps is not None else exp.max_steps
        if is_main:
            save_config(cfg, work / "config.yaml")

        man = Manifest.load(manifest_path or pathlib.Path(cfg.dataset.data_dir)
                            / cfg.dataset.manifest)
        train_man, val_man = split_manifest(man, cfg.dataset.val_fraction,
                                            cfg.dataset.split_seed)
        train_ds = TextMelDataset(train_man, cfg.dataset)
        val_ds = TextMelDataset(val_man, cfg.dataset)
        batcher = EpochBatcher(train_ds, cfg.dataset.batch_size,
                               seed=cfg.dataset.shuffle_seed,
                               drop_last=len(train_ds) > cfg.dataset.batch_size)

        model_cfg = cfg.model
        if model_cfg.vocab_size <= 0:
            model_cfg = dataclasses.replace(
                model_cfg,
                vocab_size=frontend_vocab_size(cfg.dataset.text.level))
        model = M.init(model_cfg, torch.Generator().manual_seed(exp.seed),
                       device)
        optimizer = make_optimizer(exp.optim)
        opt_state = optimizer.init(list(model.parameters()))
        step0 = 0
        ckpt_dir = work / exp.checkpoint.directory
        if exp.checkpoint.resume:
            latest = latest_checkpoint(ckpt_dir)
            if latest:
                step0 = restore_checkpoint(latest, model, opt_state)
                print(f"resumed from {latest} at step {step0}")

        par = None
        if mesh.data_size * mesh.model_size > 1:
            # the whole tree is restored first: any mesh reads any checkpoint
            par = MeshTraining(model, mesh, zero=exp.mesh.zero_sharding,
                               tensor_parallel=exp.mesh.model_parallel > 1,
                               whole=whole_stacks(model_cfg))
            opt_state = par.shard_state(opt_state)
        train_step = make_train_step(model_cfg, optimizer, exp.debug_nans,
                                     par)
        eval_step = make_eval_step(model_cfg)
        saver = AsyncCheckpointer() if exp.checkpoint.async_save else None

        def _save(step, metric):
            # every rank gathers its shards; rank 0 writes
            flat = (snapshot(model, opt_state) if par is None
                    else par.snapshot(model, opt_state))
            if not is_main:
                return
            if saver is not None:
                saver.save_flat(ckpt_dir, flat, step, metric=metric,
                                keep=exp.checkpoint.keep)
            else:
                write_checkpoint(ckpt_dir, flat, step, metric=metric,
                                 keep=exp.checkpoint.keep)

        last_metrics: Dict[str, Any] = {}
        t_last = time.time()
        for step in range(step0, max_steps):
            batch = batcher.batch_at(step)
            shard = contextlib.nullcontext()
            if par is not None:
                batch, (off, total) = par.shard(batch)
                shard = batch_shard(off, total, mesh.data_group)
            with shard:
                metrics = train_step(model, opt_state,
                                     to_device(batch, device),
                                     step_generator(exp.seed, step, device),
                                     step)

            if (step + 1) % exp.logging.log_every_steps == 0 or step == step0:
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                metrics["steps_per_sec"] = (
                    exp.logging.log_every_steps / max(now - t_last, 1e-6))
                metrics["lr"] = lr_at_step(exp.optim, step)
                t_last = now
                if is_main:
                    logger.log(step + 1, metrics, prefix="train/")
                last_metrics = metrics

            saved = False
            if ((step + 1) % exp.logging.eval_every_steps == 0
                    or step + 1 == max_steps):
                val_metrics = {}
                # a stack split over a batch axis needs every data rank
                if mesh.data_index == 0 or splits_over_batch(model_cfg):
                    val_metrics = _run_eval(cfg, model_cfg, eval_step, model,
                                            val_ds, device, work, step + 1,
                                            logger, artifacts=is_main)
                if is_main:
                    logger.log(step + 1, val_metrics, prefix="val/")
                _save(step + 1, metric=float(val_metrics.get("loss", 0.0)))
                saved = True
            elif (step + 1) % exp.checkpoint.save_every_steps == 0:
                _save(step + 1, metric=None)
                saved = True

            if _stop_requested(stopper, par):
                if not saved:
                    _save(step + 1, metric=None)
                last_metrics["interrupted_at_step"] = step + 1
                if is_main:
                    print(f"stop requested: checkpointed step {step + 1}, "
                          "exiting cleanly (resume to continue)")
                break
        if saver is not None:
            saver.wait()   # flush before anyone reads the directory back
        if is_main:
            logger.close()
    return last_metrics


def _stop_requested(stopper, par: Optional[MeshTraining]) -> bool:
    """Whether any rank was asked to stop (every rank must stop at the same
    step, or the others wait in the next collective)."""
    flag = bool(getattr(stopper, "stop_requested", False))
    if par is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    if par.mesh.backend == "nccl":
        t = t.cuda()
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return bool(t.item())


def _run_eval(cfg: Config, model_cfg, eval_step, model, val_ds, device,
              work, step: int, logger=None,
              artifacts: bool = True) -> Dict[str, float]:
    """Mean eval metrics over the first ``eval_batches`` val batches; the
    alignment scalars ``attn_diagonality`` and ``attn_focus`` (means over
    the first batch's rows of its head-averaged last cross-attention
    layer, from the teacher-forced replay); the first prediction's mel
    against its target and its alignment as ``mel_step{step}.png`` and
    ``align_step{step}.png``; the first prediction rendered by Griffin-Lim
    (8 iterations, on ``device``) to ``audio_step{step}.wav``, with
    ``mr_stft_gl`` and ``spectral_convergence_gl`` against the shortest val
    clip's audio; each artifact also goes to ``logger``'s tracker.  A
    failing scalar or artifact (a missing matplotlib included) is reported
    and never stops training.  Without ``artifacts`` (a tensor-parallel
    rank other than the first) it computes the scalars only."""
    agg: Dict[str, float] = {}
    n = 0
    post_example = batch_example = None
    for i, batch in enumerate(val_ds.batches(cfg.dataset.batch_size,
                                             shuffle=False)):
        if i >= cfg.experiment.eval_batches:
            break
        metrics, post = eval_step(model, to_device(batch, device))
        for k, v in metrics.items():
            agg[k] = agg.get(k, 0.0) + float(v)
        n += 1
        if post_example is None:
            post_example, batch_example = post[0], batch
    out = {k: v / max(n, 1) for k, v in agg.items()}
    if post_example is None:
        return out
    align = None
    try:
        b = to_device(batch_example, device)
        align = alignment_map(model, model_cfg, b["tokens"], b["token_mask"],
                              b["mel"], b["mel_mask"]).cpu().numpy()
        r = max(model_cfg.reduction_factor, 1)
        diags, focuses = [], []
        for i in range(align.shape[0]):
            # ceil division: a partial final group is a scored row
            n_rows = -(-int(batch_example["mel_mask"][i].sum()) // r)
            d, f = attention_diagonality(
                align[i], n_rows, int(batch_example["token_mask"][i].sum()))
            diags.append(d)
            focuses.append(f)
        out["attn_diagonality"] = float(np.mean(diags))
        out["attn_focus"] = float(np.mean(focuses))
    except Exception as e:  # scalars must never kill training
        print(f"alignment quality scalars failed: {e!r}")
    if not artifacts:
        return out
    art = pathlib.Path(work) / cfg.experiment.logging.artifacts_dir
    t_len = int(batch_example["mel_mask"][0].sum())
    try:
        plot_spectrogram(post_example[:t_len].float().cpu().numpy(),
                         str(art / f"mel_step{step}.png"),
                         title=f"predicted (step {step})",
                         target=np.asarray(batch_example["mel"][0][:t_len]))
        if align is not None:
            n_tok = int(batch_example["token_mask"][0].sum())
            plot_attention(align[0][:, :n_tok],
                           str(art / f"align_step{step}.png"),
                           title=f"cross-attention (step {step})")
    except Exception as e:  # images must never kill training
        print(f"eval images failed: {e!r}")
    try:
        wav = mel_to_audio(post_example[:t_len].float(), cfg.dataset.audio,
                           n_iter=8).cpu().numpy()
        write_wav(art / f"audio_step{step}.wav", wav,
                  cfg.dataset.audio.sample_rate)
        # the render is Griffin-Lim, so the values carry a phase floor
        # (suffix _gl).  The first eval batch is the first length-sorted
        # chunk, so example 0 is the shortest val clip
        order0 = min(range(len(val_ds)),
                     key=lambda i: val_ds.man.clips[i]["n_frames"])
        gt_audio = val_ds.store.load(val_ds.man.clips[order0]["clip"])["audio"]
        wf = multi_resolution_stft_distance(wav, gt_audio)
        out["mr_stft_gl"] = wf["mr_stft"]
        out["spectral_convergence_gl"] = wf["spectral_convergence"]
    except Exception as e:  # artifacts must never kill training
        print(f"eval artifact generation failed: {e!r}")
    if logger is not None:  # hosted-tracker copies (additive)
        for fname in (f"mel_step{step}.png", f"align_step{step}.png",
                      f"audio_step{step}.wav"):
            if (art / fname).exists():
                logger.log_artifact(art / fname)
    return out
