"""Decode-mode fidelity evaluation on a trained checkpoint; a port of
``scripts/eval_decode_fidelity.py``.

For each decode mode (the faithful ``recompute``, which re-runs the whole
decoder every step, and the cached serving modes) this reports masked
mel L1 and MCD against the ground truth, the stop-length error, and mel L1
and the largest stop-length difference against the recompute trajectory;
``--kv-dtype`` re-runs the cached modes with that KV cache dtype (the f8
cache's fidelity cost).  ``--vocoder-ckpt`` adds waveform MR-STFT scores
of the vocoded prediction against the ground-truth audio; ``--waveform``
renders by Griffin-Lim instead.  The batch is the first ``--batch`` clips
of the training split.  Checkpoints are either package's ``step_N``
directories (``leaves.npz``), or the directory holding them (the newest
step is used).  Everything runs on ``--device`` (the card by default);
prints one row a mode and, last, one JSON line ``{"step", "max_frames",
"results": {mode: {...}}}``.

Usage:
  python -m rtts_torch.scripts.eval_decode_fidelity -c configs/base.yaml \\
      --ckpt runs/base/checkpoints [--batch 2] [--kv-dtype float8_e4m3fn] \\
      [--vocoder-ckpt runs/voc/checkpoints]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
from typing import List, Optional

import numpy as np
import torch


def _step_dir(path: str, what: str) -> pathlib.Path:
    from rtts_torch.train.checkpoint import latest_checkpoint

    ckpt = pathlib.Path(path)
    if not (ckpt / "leaves.npz").exists():
        latest = latest_checkpoint(ckpt)
        if latest is None:
            raise SystemExit(f"no {what}checkpoint under {ckpt}")
        ckpt = pathlib.Path(latest)
    return ckpt


@torch.no_grad()
def main(argv: Optional[List[str]] = None) -> dict:
    """Run the evaluation; returns the object of the final JSON line."""
    ap = argparse.ArgumentParser(
        prog="python -m rtts_torch.scripts.eval_decode_fidelity",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-o", "--override", action="append", default=[])
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint dir (latest step used) or step dir")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--modes", default="recompute,kv_full,kv_lsh,kv_lsh_chunk")
    ap.add_argument("--kv-dtype", default=None,
                    help="re-run cached modes with this kv_cache_dtype too")
    ap.add_argument("--stop-threshold", type=float, default=None)
    ap.add_argument("--window", default=None,
                    help="wb,wf — monotonic cross-attention window for the "
                         "cached modes (decode_greedy attn_window)")
    ap.add_argument("--vocoder-ckpt", default=None,
                    help="SqueezeWave checkpoint dir; adds waveform-domain "
                         "MR-STFT scalars per decode mode (vocoded "
                         "prediction vs ground-truth audio)")
    ap.add_argument("--waveform", action="store_true",
                    help="waveform scalars without a vocoder checkpoint "
                         "(Griffin-Lim render; absolute values carry the "
                         "phase-reconstruction floor)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the models run (the card by default)")
    args = ap.parse_args(argv)

    from rtts_torch.config import load_config
    from rtts_torch.data.dataset import (Manifest, TextMelDataset,
                                         split_manifest)
    from rtts_torch.infer.decode import (_precast_weights, decode_greedy,
                                         decode_greedy_recompute)
    from rtts_torch.models import reformer_tts as M
    from rtts_torch.train.checkpoint import restore_checkpoint
    from rtts_torch.train.quality import (mel_cepstral_distortion,
                                          multi_resolution_stft_distance)

    dev = torch.device(args.device)

    def seeded():
        return torch.Generator(device=dev).manual_seed(0)

    cfg = load_config(args.config, args.override)
    if cfg.model.vocab_size <= 0:
        from rtts_torch.text import frontend_vocab_size

        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model,
            vocab_size=frontend_vocab_size(cfg.dataset.text.level)))

    ckpt = _step_dir(args.ckpt, "")
    model = M.init(cfg.model, torch.Generator().manual_seed(0), dev)
    step = restore_checkpoint(ckpt, model)
    _precast_weights(model, M._dtype(cfg.model.compute_dtype))
    print(f"checkpoint: {ckpt} (step {step})")

    man = Manifest.load(
        pathlib.Path(cfg.dataset.data_dir) / cfg.dataset.manifest)
    train_man, _ = split_manifest(man, cfg.dataset.val_fraction,
                                  cfg.dataset.split_seed)
    ds = TextMelDataset(train_man, cfg.dataset)
    items = [ds[i] for i in range(min(args.batch, len(ds)))]
    batch = ds.collate(items)
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    tmask = torch.as_tensor(batch["token_mask"], device=dev)
    mel_gt = batch["mel"]
    gt_mask = batch["mel_mask"]
    max_frames = mel_gt.shape[1]
    print(f"batch {tokens.shape[0]} x {max_frames} frames "
          f"(gt lengths {gt_mask.sum(1).tolist()})")

    window = (tuple(int(x) for x in args.window.split(","))
              if args.window else None)

    def run_mode(mode, kv_dtype="compute"):
        mcfg = dataclasses.replace(cfg.model, kv_cache_dtype=kv_dtype)
        memory = M.encode(model, mcfg, tokens, tmask)
        if mode == "recompute":
            r = decode_greedy_recompute(model, mcfg, memory, tmask,
                                        max_frames=max_frames,
                                        stop_threshold=args.stop_threshold)
        else:
            r = decode_greedy(model, mcfg, memory, tmask,
                              max_frames=max_frames,
                              generator=seeded(),
                              stop_threshold=args.stop_threshold, mode=mode,
                              attn_window=window)
        return r.mel_post.float().cpu().numpy(), r.lengths.cpu().numpy()

    # the waveform renderer of the MR-STFT scalars: the vocoder when given,
    # else Griffin-Lim, both on the device
    render = None
    if args.vocoder_ckpt:
        from rtts_torch.models import squeezewave as SW

        vckpt = _step_dir(args.vocoder_ckpt, "vocoder ")
        vocoder = SW.init(cfg.vocoder, torch.Generator().manual_seed(0), dev)
        restore_checkpoint(vckpt, vocoder)
        vocoder = SW.ensure_folded(vocoder)

        def render(mel2d):
            mel_t = torch.as_tensor(mel2d, device=dev)[None]
            audio = SW.infer(vocoder, cfg.vocoder, mel_t,
                             generator=seeded())
            return audio[0].float().cpu().numpy()
    elif args.waveform:
        from rtts_torch.audio.griffin import mel_to_audio

        def render(mel2d):
            return mel_to_audio(torch.as_tensor(mel2d, device=dev),
                                cfg.dataset.audio, n_iter=8).cpu().numpy()

    gt_audio = None
    if render is not None:
        gt_audio = [ds.store.load(train_man.clips[i]["clip"])["audio"]
                    for i in range(len(items))]

    def waveform_row(mel, lens):
        """Per-item render of the predicted frames, scored vs GT audio."""
        scs, mrs = [], []
        for i in range(mel.shape[0]):
            wav = render(mel[i][:max(int(lens[i]), 1)])
            d = multi_resolution_stft_distance(wav, gt_audio[i])
            scs.append(d["spectral_convergence"])
            mrs.append(d["mr_stft"])
        return {"mr_stft_vs_gt": float(np.mean(mrs)),
                "spectral_convergence_vs_gt": float(np.mean(scs))}

    def l1(a, b, mask):
        m = mask[..., None]
        return float(np.abs((a - b) * m).sum() / (m.sum() * a.shape[-1]))

    def mcd(a, b, mask):
        return float(mel_cepstral_distortion(torch.as_tensor(a),
                                             torch.as_tensor(b),
                                             torch.as_tensor(mask)))

    gt_len = gt_mask.sum(1)
    modes = args.modes.split(",")
    results = {}
    ref_mel, ref_len = None, None
    for mode in modes:
        mel, lens = run_mode(mode)
        row = {"mel_l1_vs_gt": l1(mel, mel_gt, gt_mask),
               "mcd_vs_gt": mcd(mel, mel_gt, gt_mask),
               "stop_len_mae_vs_gt": float(np.abs(lens - gt_len).mean()),
               "lengths": lens.tolist()}
        if render is not None:
            row.update(waveform_row(mel, lens))
        if mode == "recompute":
            ref_mel, ref_len = mel, lens
        elif ref_mel is not None:
            rmask = (np.arange(max_frames)[None, :] < ref_len[:, None])
            row["mel_l1_vs_recompute"] = l1(mel, ref_mel, rmask)
            row["stop_delta_max"] = int(np.abs(lens - ref_len).max())
        results[mode] = row
        print(f"{mode:14s} L1_gt={row['mel_l1_vs_gt']:.4f} "
              f"MCD_gt={row['mcd_vs_gt']:.3f} "
              f"stopMAE_gt={row['stop_len_mae_vs_gt']:.1f} "
              + (f"MRSTFT_gt={row['mr_stft_vs_gt']:.3f} "
                 if "mr_stft_vs_gt" in row else "")
              + (f"L1_rec={row.get('mel_l1_vs_recompute'):.4f} "
                 f"stopD={row.get('stop_delta_max')}"
                 if "mel_l1_vs_recompute" in row else ""))

    if args.kv_dtype:
        print(f"\n-- kv_cache_dtype={args.kv_dtype} --")
        for mode in modes:
            if mode == "recompute":
                continue
            mel8, lens8 = run_mode(mode, kv_dtype=args.kv_dtype)
            base = results[mode]
            row = {"mel_l1_vs_gt": l1(mel8, mel_gt, gt_mask),
                   "lengths": lens8.tolist()}
            row["rel_cost_vs_gt_pct"] = (
                100.0 * (row["mel_l1_vs_gt"] - base["mel_l1_vs_gt"])
                / max(base["mel_l1_vs_gt"], 1e-9))
            row["stop_delta_vs_bf16"] = int(
                np.abs(lens8 - np.asarray(base["lengths"])).max())
            results[f"{mode}@{args.kv_dtype}"] = row
            print(f"{mode:14s} L1_gt={row['mel_l1_vs_gt']:.4f} "
                  f"rel_cost={row['rel_cost_vs_gt_pct']:+.3f}% "
                  f"stopD={row['stop_delta_vs_bf16']}")

    out = {"step": step, "max_frames": max_frames, "results": results}
    print("\n" + json.dumps(out))
    return out


if __name__ == "__main__":
    main()
