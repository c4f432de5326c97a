"""Vocoder training: port of ``rtts/train/train_vocoder.py`` on one device.

The step is the reference's: SqueezeWave ``forward`` on (mel window, audio
crop) pairs, the flow NLL (``squeezewave_loss``), gradients by autograd
(every WN depth stage through K2's ``autograd.Function`` on the card, the
1x1 log-determinants by ``torch.linalg.slogdet`` on the card), the
unclipped gradients' global norm as ``grad_norm``, then global-norm clip,
Adam and the learning-rate schedule with optax's semantics
(``rtts_torch/train/optim.py``).  Parameters and optimizer state are
updated in place.

``train_vocoder`` runs the reference's loop: crops drawn from a generator
seeded (shuffle_seed, step), so a resumed run replays an uninterrupted one
bit for bit (on the card too: no op of the step picks a nondeterministic
algorithm, and ``chip_smoke.py`` phase 22 checks the replay);
logging with ``steps_per_sec`` and ``lr``; at each eval the held-out flow
NLL over ``eval_batches`` crops from a generator seeded 1234, the MR-STFT
distance of one vocoded val batch to its ground truth and a
``vocoder_step{N}.wav`` artifact; periodic and top-k checkpoints (async
when configured), resume, and a graceful stop on SIGTERM/SIGINT.  A mesh
of more than one device, TensorBoard and hosted trackers raise.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from rtts_torch.audio.wav import write_wav
from rtts_torch.config import Config, save_config
from rtts_torch.data import Manifest, MelAudioDataset, split_manifest
from rtts_torch.models import squeezewave as SW
from rtts_torch.train.checkpoint import (AsyncCheckpointer, latest_checkpoint,
                                         restore_checkpoint, save_checkpoint)
from rtts_torch.train.interrupt import GracefulStop
from rtts_torch.train.optim import global_norm, lr_at_step, make_optimizer
from rtts_torch.train.quality import multi_resolution_stft_distance
from rtts_torch.train.train_tts import check_single_device
from rtts_torch.train.vocoder_loss import squeezewave_loss
from rtts_torch.utils.metrics import make_logger


def make_train_step(voc_cfg, optimizer):
    """-> train_step(model, opt_state, batch, return_grads=False) -> metrics
    (0-dim tensors) [, grads].  ``batch`` holds ``mel`` (B, M, n_mels) and
    ``audio`` (B, M * hop) tensors on the model's device."""

    def train_step(model, opt_state, batch, return_grads=False):
        params = list(model.parameters())
        z, log_s, log_det = SW.forward(model, voc_cfg, batch["mel"],
                                       batch["audio"])
        loss, metrics = squeezewave_loss(z, log_s, log_det, voc_cfg.sigma)
        grads = torch.autograd.grad(loss, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        optimizer.step(params, grads, opt_state)
        return (metrics, grads) if return_grads else metrics

    return train_step


def make_eval_step(voc_cfg):
    """-> eval_step(model, batch) -> the loss metrics, without gradients."""

    @torch.no_grad()
    def eval_step(model, batch):
        z, log_s, log_det = SW.forward(model, voc_cfg, batch["mel"],
                                       batch["audio"])
        return squeezewave_loss(z, log_s, log_det, voc_cfg.sigma)[1]

    return eval_step


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _vocode(model, voc_cfg, mel: np.ndarray, device) -> np.ndarray:
    """mel (B, M, n_mels) -> audio (B, M * hop) on ``device``, with the noise
    drawn from a generator seeded 0 there."""
    gen = torch.Generator(device=device).manual_seed(0)
    return SW.infer(model, voc_cfg, torch.as_tensor(mel, device=device),
                    generator=gen).cpu().numpy()


def train_vocoder(cfg: Config, workdir: str, max_steps: Optional[int] = None,
                  manifest_path: Optional[str] = None,
                  stop: Optional[Any] = None, device="cuda") -> Dict[str, Any]:
    """Run vocoder training on ``device``; returns the last logged train
    metrics (with ``val_loss_vocoder`` after an eval).  Resumable from
    ``workdir``'s checkpoints.  ``stop`` as in
    :func:`rtts_torch.train.train_tts.train_tts`."""
    check_single_device(cfg)
    exp = cfg.experiment
    voc = cfg.vocoder
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
        train_ds = MelAudioDataset(train_man, voc.audio_segment_length)
        val_ds = MelAudioDataset(val_man, voc.audio_segment_length)

        model = SW.init(voc, torch.Generator().manual_seed(exp.seed), device)
        optimizer = make_optimizer(exp.optim)
        opt_state = optimizer.init(list(model.parameters()))
        step0 = 0
        ckpt_dir = work / exp.checkpoint.directory
        if exp.checkpoint.resume:
            latest = latest_checkpoint(ckpt_dir)
            if latest:
                step0 = restore_checkpoint(latest, model, opt_state)
                print(f"resumed from {latest} at step {step0}")

        train_step = make_train_step(voc, optimizer)
        eval_step = make_eval_step(voc)
        saver = AsyncCheckpointer() if exp.checkpoint.async_save else None

        def _save(step, metric):
            if saver is not None:
                saver.save(ckpt_dir, model, opt_state, step, metric=metric,
                           keep=exp.checkpoint.keep)
            else:
                save_checkpoint(ckpt_dir, model, opt_state, step,
                                metric=metric, keep=exp.checkpoint.keep)

        last: Dict[str, Any] = {}
        t_last = time.time()
        bsz = cfg.dataset.batch_size
        for step in range(step0, max_steps):
            # crops drawn from a per-step generator: the data stream is a
            # function of the step counter alone, so resume replays it
            crop_rng = np.random.default_rng((cfg.dataset.shuffle_seed, step))
            batch = _to_device(train_ds.sample(crop_rng, bsz), device)
            metrics = train_step(model, opt_state, batch)

            if (step + 1) % exp.logging.log_every_steps == 0 or step == step0:
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                metrics["steps_per_sec"] = (
                    exp.logging.log_every_steps / max(now - t_last, 1e-6))
                metrics["lr"] = lr_at_step(exp.optim, step)
                t_last = now
                logger.log(step + 1, metrics, prefix="train/")
                last = metrics

            saved = False
            if ((step + 1) % exp.logging.eval_every_steps == 0
                    or step + 1 == max_steps):
                val_metrics = _run_eval(cfg, eval_step, model, val_ds, device,
                                        work, step + 1)
                last["val_loss_vocoder"] = val_metrics.get("loss_vocoder")
                logger.log(step + 1, val_metrics, prefix="val/")
                _save(step + 1,
                      metric=float(val_metrics.get("loss_vocoder", 0.0)))
                saved = True
            elif (step + 1) % exp.checkpoint.save_every_steps == 0:
                _save(step + 1, metric=None)
                saved = True

            if getattr(stopper, "stop_requested", False):
                if not saved:
                    _save(step + 1, metric=None)
                last["interrupted_at_step"] = step + 1
                print(f"stop requested: checkpointed step {step + 1}, "
                      "exiting cleanly (resume to continue)")
                break
        if saver is not None:
            saver.wait()   # flush before anyone reads the directory back
        logger.close()
    return last


def _run_eval(cfg: Config, eval_step, model, val_ds, device, work,
              step: int) -> Dict[str, float]:
    """The held-out flow NLL averaged over ``eval_batches`` crops drawn
    from a generator seeded 1234 (comparable across evals); the MR-STFT
    distance of one vocoded val batch (crops seeded 1) to its ground truth;
    one val window (seeded 0) vocoded to ``vocoder_step{step}.wav``.  A
    failing waveform scalar or artifact is reported and never stops
    training."""
    voc, bsz = cfg.vocoder, cfg.dataset.batch_size
    val_rng = np.random.default_rng(1234)
    agg: Dict[str, float] = {}
    n_val = max(1, cfg.experiment.eval_batches)
    for _ in range(n_val):
        vm = eval_step(model, _to_device(val_ds.sample(val_rng, bsz), device))
        for k, v in vm.items():
            agg[k] = agg.get(k, 0.0) + float(v)
    out = {k: v / n_val for k, v in agg.items()}
    try:
        vb = val_ds.sample(np.random.default_rng(1), bsz)
        wavs = _vocode(model, voc, vb["mel"], device)
        dists = [multi_resolution_stft_distance(wavs[i], vb["audio"][i])
                 for i in range(wavs.shape[0])]
        for k in ("mr_stft", "spectral_convergence", "log_stft_l1"):
            out[k] = float(np.mean([d[k] for d in dists]))
    except Exception as e:  # scalars must never kill training
        print(f"waveform quality scalar failed: {e!r}")
    try:
        vb = val_ds.sample(np.random.default_rng(0), 1)
        wav = _vocode(model, voc, vb["mel"], device)[0]
        write_wav(pathlib.Path(work) / cfg.experiment.logging.artifacts_dir
                  / f"vocoder_step{step}.wav", np.clip(wav, -1, 1),
                  voc.sample_rate)
    except Exception as e:  # artifacts must never kill training
        print(f"vocoder eval artifact failed: {e!r}")
    return out
