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
SIGTERM/SIGINT.  Not ported, each refused with a message: a mesh of more
than one device, TensorBoard and hosted trackers, ``debug_nans``.
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
from rtts_torch.config import Config, save_config
from rtts_torch.data import (EpochBatcher, Manifest, TextMelDataset,
                             split_manifest, to_device)
from rtts_torch.infer.diagnostics import alignment_map
from rtts_torch.models import reformer_tts as M
from rtts_torch.text import frontend_vocab_size
from rtts_torch.train.checkpoint import (AsyncCheckpointer, latest_checkpoint,
                                         restore_checkpoint, save_checkpoint)
from rtts_torch.train.interrupt import GracefulStop
from rtts_torch.train.losses import (guided_attention_loss, make_stop_target,
                                     tts_loss)
from rtts_torch.train.optim import global_norm, lr_at_step, make_optimizer
from rtts_torch.train.quality import (attention_diagonality,
                                     mel_cepstral_distortion,
                                     multi_resolution_stft_distance,
                                     stop_length_mae)
from rtts_torch.utils.metrics import make_logger
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


def make_train_step(model_cfg, optimizer):
    """-> train_step(model, opt_state, batch, generator, step=0,
    return_grads=False) -> metrics (0-dim tensors) [, grads].

    ``batch`` holds tensors on the model's device (``rtts_torch.data.
    to_device``); ``generator`` (on that device) draws the dropout."""
    gal_w = model_cfg.guided_attention_weight
    gal_decay = model_cfg.guided_attention_decay_steps

    def train_step(model, opt_state, batch, generator, step=0,
                   return_grads=False):
        params = list(model.parameters())
        sink = [] if gal_w > 0.0 else None
        pre, post, stop = M.forward(
            model, model_cfg, batch["tokens"], batch["token_mask"],
            batch["mel"], batch["mel_mask"], generator=generator,
            attn_sink=sink)
        total, metrics = tts_loss(pre, post, stop, batch["mel"],
                                  make_stop_target(batch["mel_mask"]),
                                  batch["mel_mask"], model_cfg.stop_pos_weight)
        if sink is not None:
            gal = guided_attention_loss(
                sink, batch["token_mask"], batch["mel_mask"],
                model_cfg.reduction_factor, model_cfg.guided_attention_sigma)
            total = total + float(_guided_weight(gal_w, gal_decay, step)) * gal
            metrics = dict(metrics, loss=total, loss_guided_attn=gal)
        # the last postnet layer's LN is never read (as in the reference,
        # whose gradient there is zero): materialize zeros for it
        grads = torch.autograd.grad(total, params, materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        optimizer.step(params, grads, opt_state)
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


def check_single_device(cfg: Config) -> None:
    """Raise on a mesh of more than one device, which no trainer of the
    port runs yet."""
    mesh = cfg.experiment.mesh
    if (mesh.data_parallel not in (-1, 1) or mesh.model_parallel != 1
            or mesh.dcn_parallel != 1 or mesh.num_processes != 1):
        raise NotImplementedError(
            "rtts_torch: training on a mesh of more than one device is not "
            "ported yet (data_parallel, model_parallel, dcn_parallel and "
            "num_processes must be 1)")


def _check_supported(cfg: Config) -> None:
    check_single_device(cfg)
    if cfg.experiment.debug_nans:
        raise NotImplementedError("rtts_torch: debug_nans is not ported")


def train_tts(cfg: Config, workdir: str, max_steps: Optional[int] = None,
              manifest_path: Optional[str] = None, stop: Optional[Any] = None,
              device="cuda") -> Dict[str, Any]:
    """Run TTS training on ``device``; returns the last logged train
    metrics.  Resumable from ``workdir``'s checkpoints.

    ``stop``: an object with a ``stop_requested`` property, polled at every
    step boundary; when None a :class:`GracefulStop` turns SIGTERM/SIGINT
    into a checkpoint-and-return."""
    _check_supported(cfg)
    exp = cfg.experiment
    work = pathlib.Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    logger = make_logger(str(work / exp.logging.jsonl_path),
                         exp.logging.tensorboard_dir, exp.logging.tracker)
    stop_ctx = GracefulStop() if stop is None else contextlib.nullcontext(stop)
    with stop_ctx as stopper:
        max_steps = max_steps if max_steps is not None else exp.max_steps
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

        train_step = make_train_step(model_cfg, optimizer)
        eval_step = make_eval_step(model_cfg)
        saver = AsyncCheckpointer() if exp.checkpoint.async_save else None

        def _save(step, metric):
            if saver is not None:
                saver.save(ckpt_dir, model, opt_state, step, metric=metric,
                           keep=exp.checkpoint.keep)
            else:
                save_checkpoint(ckpt_dir, model, opt_state, step,
                                metric=metric, keep=exp.checkpoint.keep)

        last_metrics: Dict[str, Any] = {}
        t_last = time.time()
        for step in range(step0, max_steps):
            batch = to_device(batcher.batch_at(step), device)
            metrics = train_step(model, opt_state, batch,
                                 step_generator(exp.seed, step, device), step)

            if (step + 1) % exp.logging.log_every_steps == 0 or step == step0:
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                metrics["steps_per_sec"] = (
                    exp.logging.log_every_steps / max(now - t_last, 1e-6))
                metrics["lr"] = lr_at_step(exp.optim, step)
                t_last = now
                logger.log(step + 1, metrics, prefix="train/")
                last_metrics = metrics

            saved = False
            if ((step + 1) % exp.logging.eval_every_steps == 0
                    or step + 1 == max_steps):
                val_metrics = _run_eval(cfg, model_cfg, eval_step, model,
                                        val_ds, device, work, step + 1)
                logger.log(step + 1, val_metrics, prefix="val/")
                _save(step + 1, metric=float(val_metrics.get("loss", 0.0)))
                saved = True
            elif (step + 1) % exp.checkpoint.save_every_steps == 0:
                _save(step + 1, metric=None)
                saved = True

            if getattr(stopper, "stop_requested", False):
                if not saved:
                    _save(step + 1, metric=None)
                last_metrics["interrupted_at_step"] = step + 1
                print(f"stop requested: checkpointed step {step + 1}, "
                      "exiting cleanly (resume to continue)")
                break
        if saver is not None:
            saver.wait()   # flush before anyone reads the directory back
        logger.close()
    return last_metrics


def _run_eval(cfg: Config, model_cfg, eval_step, model, val_ds, device,
              work, step: int) -> Dict[str, float]:
    """Mean eval metrics over the first ``eval_batches`` val batches; the
    alignment scalars ``attn_diagonality`` and ``attn_focus`` (means over
    the first batch's rows of its head-averaged last cross-attention
    layer, from the teacher-forced replay); the first prediction's mel
    against its target and its alignment as ``mel_step{step}.png`` and
    ``align_step{step}.png``; the first prediction rendered by Griffin-Lim
    (8 iterations, on ``device``) to ``audio_step{step}.wav``, with
    ``mr_stft_gl`` and ``spectral_convergence_gl`` against the shortest val
    clip's audio.  A failing scalar or artifact (a missing matplotlib
    included) is reported and never stops training."""
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
    return out
