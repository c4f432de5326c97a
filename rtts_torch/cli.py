"""Command line of the port: ``rtts/cli.py``'s verbs on ``argparse``.

    python -m rtts_torch.cli [-c CONFIG.yaml] [-o key.path=value ...]
                             [--device cuda|cpu] VERB [options]

Verbs, options, defaults and choices are the JAX package's:
``download``, ``generate-corpus``, ``preprocess``, ``train-tts``,
``train-vocoder``, ``predict``, ``serve``, ``export`` and ``bench``.  The
one difference is ``--device`` (default ``cuda``), which takes the place of
``--platform``: every verb that computes runs on the card unless it says
``cpu``.  ``export`` writes ``torch.export`` artifacts on that device
(``rtts_torch/infer/export.py``) and ``predict --from-export`` serves from
them on the device they were made for; ``bench`` prints one JSON line per
cell of ``rtts_torch.bench`` (``--which``, or all ten).  A config needs no
PyYAML (``rtts_torch.config.load_yaml``), and the command line needs no
click.

Every verb first runs ``initialize_distributed(cfg.experiment.mesh)``, as
the reference's group does: a no-op in one process; over several
(``RTTS_MULTIHOST=1 python -m torch.distributed.run --nproc-per-node N -m
rtts_torch.cli ...``, or ``experiment.mesh.coordinator_address`` /
``num_processes`` / ``process_id``) each rank runs the verb on its card,
the trainers and ``predict``/``serve`` over ``experiment.mesh``'s layout,
and rank 0 alone writes what the verb writes.  ``main`` destroys the
process group it started when the verb returns or raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
from typing import List, Optional

from rtts_torch.config import Config, load_config

MODES = ["kv_full", "kv_lsh", "kv_lsh_chunk", "auto"]
BENCH_MODES = ["decode", "e2e", "vocoder", "train", "vocoder_train",
               "longform", "serving", "continuous", "latency", "kernels",
               "all"]


def _download(cfg: Config, args) -> None:
    from rtts_torch.data.download import download_corpus

    out = args.out_dir or cfg.dataset.data_dir
    path = download_corpus(args.index_url, out, fetch_media=args.fetch_media)
    print(f"wrote {path}")


def _generate_corpus(cfg: Config, args) -> None:
    from rtts_torch.data import corpus

    out = args.out_dir or cfg.dataset.data_dir
    if args.long_recording:
        tpath = corpus.generate_long_recording(out, args.num_utterances,
                                               cfg.dataset.audio.sample_rate)
        print(f"generated long recording + timed transcript {tpath}")
        return
    utts = corpus.generate_corpus(out, args.num_utterances,
                                  cfg.dataset.audio.sample_rate)
    print(f"generated {len(utts)} utterances under {out}")


def _preprocess(cfg: Config, args) -> None:
    from rtts_torch.data.preprocess import preprocess_corpus

    tpath = args.transcripts or str(pathlib.Path(cfg.dataset.data_dir)
                                    / "transcripts.txt")
    mpath = preprocess_corpus(cfg.dataset, tpath, device=args.device)
    print(f"wrote manifest {mpath}")


def _train_tts(cfg: Config, args) -> None:
    from rtts_torch.train.train_tts import train_tts

    metrics = train_tts(cfg, args.workdir, args.max_steps, device=args.device)
    print(f"done: {metrics}")


def _train_vocoder(cfg: Config, args) -> None:
    from rtts_torch.train.train_vocoder import train_vocoder

    metrics = train_vocoder(cfg, args.workdir, args.max_steps,
                            device=args.device)
    print(f"done: {metrics}")


def _load_synthesizer(cfg: Config, tts_ckpt, vocoder_ckpt, max_frames, mode,
                      device):
    """A Synthesizer on ``device`` from (optional) checkpoint directories,
    either package's (the step directory, or the newest step under it);
    without a checkpoint the weights are random from seed 0, and without a
    vocoder the Synthesizer renders by Griffin-Lim.  Shared by ``predict``
    and ``serve``."""
    import torch

    from rtts_torch.infer.synthesize import Synthesizer
    from rtts_torch.models import reformer_tts as M
    from rtts_torch.models import squeezewave as SW
    from rtts_torch.text import frontend_vocab_size
    from rtts_torch.train.checkpoint import (latest_checkpoint,
                                             restore_checkpoint)

    model_cfg = cfg.model
    if model_cfg.vocab_size <= 0:
        model_cfg = dataclasses.replace(
            model_cfg,
            vocab_size=frontend_vocab_size(cfg.dataset.text.level))
    from rtts_torch.parallel.mesh import make_mesh, rank_device

    from rtts_torch.parallel.sharding import whole_stacks

    mesh = make_mesh(cfg.experiment.mesh)
    if mesh.data_size * mesh.model_size == 1 and not whole_stacks(cfg.model):
        mesh = None   # (a stack split over the model group needs one)
    else:
        device = rank_device(device)
    tts = M.init(model_cfg, torch.Generator().manual_seed(0), device)
    if tts_ckpt:
        path = latest_checkpoint(tts_ckpt) or tts_ckpt
        step = restore_checkpoint(path, tts)
        print(f"loaded TTS step {step} from {path}")
    vocoder = None
    if vocoder_ckpt:
        vocoder = SW.init(cfg.vocoder, torch.Generator().manual_seed(0),
                          device)
        path = latest_checkpoint(vocoder_ckpt) or vocoder_ckpt
        step = restore_checkpoint(path, vocoder)
        vocoder = SW.fold_weightnorm(vocoder)
        print(f"loaded vocoder step {step} from {path}")
    return Synthesizer(dataclasses.replace(cfg, model=model_cfg), tts,
                       vocoder, max_frames=max_frames, mode=mode, mesh=mesh)


def _write_wavs(wavs, out_dir: str, sample_rate: int) -> None:
    from rtts_torch.audio.wav import write_wav
    from rtts_torch.parallel.mesh import global_rank

    if global_rank() != 0:   # every rank holds the batch; rank 0 writes
        return
    out = pathlib.Path(out_dir)
    for i, w in enumerate(wavs):
        p = out / f"sample_{i}.wav"
        write_wav(p, w, sample_rate)
        print(f"wrote {p} ({len(w)} samples)")


def _predict(cfg: Config, args) -> None:
    if args.export_dir:
        from rtts_torch.infer.export import ExportedSynthesizer

        syn = ExportedSynthesizer(args.export_dir)
        sample_rate = syn.manifest["audio"]["sample_rate"]
    else:
        syn = _load_synthesizer(cfg, args.tts_ckpt, args.vocoder_ckpt,
                                args.max_frames, args.mode, args.device)
        sample_rate = cfg.dataset.audio.sample_rate
    wavs = syn(list(args.text), seed=args.seed)
    _write_wavs(wavs, args.out_dir, sample_rate)


def _export(cfg: Config, args) -> None:
    from rtts_torch.infer.export import export_synthesizer

    syn = _load_synthesizer(cfg, args.tts_ckpt, args.vocoder_ckpt,
                            args.max_frames, args.mode, args.device)
    sizes = tuple(int(b) for b in str(args.batch_sizes).split(",") if b)
    manifest = export_synthesizer(syn, args.out_dir, batch_sizes=sizes,
                                  token_len=args.token_len)
    print(f"wrote {len(manifest['artifacts'])} artifacts + manifest to "
          f"{args.out_dir} (batch sizes {manifest['batch_sizes']}, "
          f"token_len {manifest['token_len']}, max_frames "
          f"{manifest['max_frames']}, device {manifest['device']})")


def _serve(cfg: Config, args) -> Optional[int]:
    texts = list(args.text)
    if args.texts_file:
        with open(args.texts_file) as f:
            texts += [line.strip() for line in f if line.strip()]
    if not texts:
        print("Error: no requests: pass --texts-file and/or --text",
              file=sys.stderr)
        return 2
    syn = _load_synthesizer(cfg, args.tts_ckpt, args.vocoder_ckpt,
                            args.max_frames, "auto", args.device)
    if args.strategy == "continuous":
        wavs = syn.serve_continuous(texts, seed=args.seed, slots=args.slots,
                                    frames_per_token=args.frames_per_token)
    else:
        wavs = syn.serve(texts, seed=args.seed,
                         frames_per_token=args.frames_per_token)
    _write_wavs(wavs, args.out_dir, cfg.dataset.audio.sample_rate)
    return None


def _bench(cfg: Config, args) -> None:
    from rtts_torch.bench import MODES, run_bench

    for mode in (MODES if args.which == "all" else [args.which]):
        print(run_bench(cfg, mode, device=args.device), flush=True)


def _checkpoint_options(p: argparse.ArgumentParser) -> None:
    p.add_argument("--tts-ckpt", default=None, help="TTS checkpoint dir")
    p.add_argument("--vocoder-ckpt", default=None,
                   help="vocoder checkpoint dir")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m rtts_torch.cli",
        description="rtts_torch — Reformer-TTS on PyTorch and CUDA.")
    parser.add_argument("-c", "--config", dest="config_path", default=None,
                        help="YAML config file")
    parser.add_argument("-o", "--override", dest="overrides",
                        action="append", default=[],
                        help="dot-path override, e.g. model.d_model=256")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the verbs compute (default: the card)")
    verbs = parser.add_subparsers(dest="verb", metavar="VERB", required=True)

    def verb(name, fn, doc):
        p = verbs.add_parser(name, help=doc, description=doc)
        p.set_defaults(run=fn)
        return p

    p = verb("download", _download,
             "Scrape transcripts + media (requires network).")
    p.add_argument("--index-url", required=True, help="transcript index URL")
    p.add_argument("--out", dest="out_dir", default=None)
    p.add_argument("--media", dest="fetch_media", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="also download the media files referenced by pages")

    p = verb("generate-corpus", _generate_corpus,
             "Generate the synthetic speech-like corpus.")
    p.add_argument("--out", dest="out_dir", default=None)
    p.add_argument("-n", "--num-utterances", type=int, default=24)
    p.add_argument("--long-recording", action="store_true",
                   help="one long wav + timed transcript (exercises the "
                        "cut-by-transcript-timing preprocessing stage)")

    p = verb("preprocess", _preprocess,
             "wav + transcripts -> per-clip token/mel arrays + manifest.")
    p.add_argument("--transcripts", default=None,
                   help="path to transcripts.txt (default: "
                        "<data_dir>/transcripts.txt)")

    for name, fn, work, doc in (
            ("train-tts", _train_tts, "runs/tts",
             "Train the ReformerTTS acoustic model."),
            ("train-vocoder", _train_vocoder, "runs/vocoder",
             "Train the SqueezeWave vocoder.")):
        p = verb(name, fn, doc)
        p.add_argument("--workdir", default=work)
        p.add_argument("--max-steps", type=int, default=None)

    p = verb("predict", _predict,
             "Text -> wav using trained checkpoints (Griffin-Lim if no "
             "vocoder).")
    p.add_argument("--text", required=True, action="append", default=[],
                   help="text to synthesize (repeatable)")
    _checkpoint_options(p)
    p.add_argument("--from-export", dest="export_dir", default=None,
                   help="serve from an `export` directory instead of "
                        "checkpoints (no model code / config needed)")
    p.add_argument("--out", dest="out_dir", default="synth_out")
    p.add_argument("--max-frames", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", default="auto", choices=MODES,
                   help="AR decode cache strategy")

    p = verb("export", _export,
             "Serialize the serving graphs to torch.export artifacts "
             "(.pt2, weights inside) on --device.")
    _checkpoint_options(p)
    p.add_argument("--out", dest="out_dir", default="export_out")
    p.add_argument("--max-frames", type=int, default=1024)
    p.add_argument("--batch-sizes", default="1",
                   help="comma-separated batch sizes to export, e.g. 1,8")
    p.add_argument("--token-len", type=int, default=None,
                   help="static token budget (default: dataset.text.max_len)")
    p.add_argument("--mode", default="auto", choices=MODES,
                   help="AR decode cache strategy baked into the artifact")

    p = verb("serve", _serve,
             "Batch-serve many texts -> wavs with variable-length batching.")
    p.add_argument("--texts-file", default=None,
                   help="file with one request per line")
    p.add_argument("--text", action="append", default=[],
                   help="inline request (repeatable)")
    _checkpoint_options(p)
    p.add_argument("--out", dest="out_dir", default="serve_out")
    p.add_argument("--max-frames", type=int, default=1024,
                   help="hard per-request frame cap (largest capacity class)")
    p.add_argument("--strategy", default="continuous",
                   choices=["continuous", "bucketed"],
                   help="continuous = slot-recycling capacity-classed pool "
                        "(serve_pool); bucketed = synchronous length buckets")
    p.add_argument("--slots", type=int, default=8,
                   help="concurrent decode slots per class")
    p.add_argument("--frames-per-token", type=float, default=8.0,
                   help="length-prediction heuristic (frames per text token)")
    p.add_argument("--seed", type=int, default=0)

    p = verb("bench", _bench,
             "Run the benchmark harness and print JSON line(s).")
    p.add_argument("--which", default="decode", choices=BENCH_MODES)
    return parser


# options that name a file that must exist (click.Path(exists=True))
_EXISTING_PATHS = ("config_path", "export_dir", "texts_file")


def main(argv: Optional[List[str]] = None) -> int:
    """Run one verb; returns the exit status (2 for a usage error)."""
    parser = build_parser()
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:   # --help, or a usage error
        return int(e.code or 0)
    for dest in _EXISTING_PATHS:
        path = getattr(args, dest, None)
        if path is not None and not pathlib.Path(path).exists():
            parser.print_usage(sys.stderr)
            print(f"Error: path {path!r} does not exist", file=sys.stderr)
            return 2
    cfg = load_config(args.config_path, args.overrides)
    import torch.distributed as dist

    from rtts_torch.parallel.mesh import (initialize_distributed,
                                          shutdown_distributed)

    # multi-process init precedes the first use of the card; a no-op in
    # one process.  The group this call starts is destroyed after the
    # verb, on success and on error, with no barrier (a rank that failed
    # would never reach it): a rank must not exit with the backend's
    # threads still running.
    started = not dist.is_initialized()
    initialize_distributed(cfg.experiment.mesh, getattr(args, "device",
                                                        "cpu"))
    try:
        return args.run(cfg, args) or 0
    finally:
        if started:
            shutdown_distributed()


if __name__ == "__main__":
    sys.exit(main())
