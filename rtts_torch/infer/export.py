"""Deployment artifacts: the serving graphs as ``torch.export`` programs.

Port of ``rtts/infer/export.py``.  ``export_synthesizer`` serializes a live
``Synthesizer`` into a directory of ``torch.export`` programs with the
weights inside (``torch.export.save``)::

    manifest.json       shapes, the text frontend's and the audio's
                        parameters, the decode's layout
    encoder_b{B}.pt2    tokens, mask -> the cross-attention K/V of every
                        decoder layer (``decode._init_mem_kv``) and a fresh
                        decode state
    step_b{B}.pt2       one decode step: (t, live, prenet uniforms,
                        rotations, mask, K/V, state) -> the state it
                        replaces; mel, stop logits and caches are written
                        in place
    finish_b{B}.pt2     mel, lengths -> mel + postnet residual, zero past
                        each length
    vocoder_b{B}.pt2    mel (B, max_frames, n_mels) -> audio, with the flow
                        noise z baked in (absent without a vocoder)

``ExportedSynthesizer`` serves text -> wav from such a directory with no
model code, config tree or checkpoint: it needs the text frontend,
``rtts_torch.infer.draws`` and the operators of ``rtts_torch.ops.registry``
(imported here: an artifact cannot load before its operators exist).

How it differs from the reference:

- The artifacts are ``.pt2`` programs, not StableHLO, each for one device:
  the ``Synthesizer``'s, which the manifest names.  A CUDA artifact where
  no card is present raises; it does not fall back to the CPU (the
  reference lowers for cpu and tpu at once).
- The decode loop is the runner's, over the exported step, as the port's
  decode is a host loop (``decode_greedy``); it checks for stop every
  ``unroll`` steps.  The reference exports a ``lax.while_loop``.  The step
  is ``decode._Decoder.step`` itself, with the step index a symbolic int.
- The caches are unstaged (staging changes no output, ``decode_greedy``).

Determinism: the runner draws the prenet's always-on dropout and the LSH
decode modes' rotations through ``draws``, from a generator seeded ``seed``
on the artifact's device, in the live decode's order, so the same seed
gives the live ``Synthesizer``'s mel.  The encoder's LSH rotations (a
generator seeded 0, or ``hash_seed``) are fixed and baked in
(``lsh.rotation_tape``), as are the vocoder's z (a generator seeded 0 on
the export device, what ``Synthesizer.mel_to_audio`` draws) and
``attn_window``.

Kernels: each launch is one ``torch.ops.rtts.*`` node, so on the card an
encoder artifact launches K1 (full attention), or K4 and K7 (LSH), and K6
(``use_pallas_ffn``), and a vocoder artifact K2, at every call.

A mesh-sharded ``Synthesizer`` exports by gathering its shards to whole
weights over the model group (``sharding.gather_param``): every rank calls
``export_synthesizer``, rank 0 writes the directory, every rank returns the
manifest.  A stack split over the sequence or the layers keeps its
parameters whole, so the artifact runs it whole.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rtts_torch.infer import draws
from rtts_torch.ops import registry  # noqa: F401  (defines rtts::*)

_MANIFEST = "manifest.json"
_FORMAT_VERSION = 1
_ARTIFACTS = ("encoder", "step", "finish")


# -- export -------------------------------------------------------------------


class _Parts(nn.Module):
    """Named submodules of the TTS model: an artifact's program carries
    the weights of the parts its wrapper holds, and no others."""

    def __init__(self, **parts):
        super().__init__()
        for name, part in parts.items():
            setattr(self, name, part)


def _encoder_parts(model) -> _Parts:
    """What the encoder artifact reads: the encoder's modules and, of the
    decoder, the cross-attention blocks (their K/V projections) and the
    first self-attention block (its head count)."""
    layers = model.decoder.layers
    keep = {0} | set(range(1, len(layers), 2))
    decoder = _Parts(layers=nn.ModuleList(
        _Parts(f=_Parts(attn=layer.f.attn)) if i in keep else _Parts()
        for i, layer in enumerate(layers)))
    return _Parts(embed=model.embed, enc_prenet=model.enc_prenet,
                  enc_pos=model.enc_pos, encoder=model.encoder,
                  decoder=decoder)


def _step_parts(model) -> _Parts:
    return _Parts(dec_prenet=model.dec_prenet, dec_pos=model.dec_pos,
                  decoder=model.decoder, mel_head=model.mel_head,
                  stop_head=model.stop_head)


class _Encoder(nn.Module):
    """tokens, mask -> (mem_k..., mem_v..., the fresh decoder's
    ``flat_state()``)."""

    def __init__(self, model, cfg, plan, stop_threshold, n_buckets):
        super().__init__()
        self.model, self.cfg, self.plan = model, cfg, plan
        self.stop_threshold, self.n_buckets = stop_threshold, n_buckets

    def forward(self, tokens, mask):
        from rtts_torch.infer.decode import _Decoder
        from rtts_torch.models.reformer_tts import encode

        p = self.plan
        memory = encode(self.model, self.cfg, tokens, mask)
        dec = _Decoder(self.model, self.cfg, memory, mask, p.n_groups,
                       p.n_groups, p.mode, None, self.stop_threshold, None,
                       self.n_buckets, p.local_spec, p.window)
        return (*dec.mem_k, *dec.mem_v, *dec.flat_state())


class _Step(nn.Module):
    """One ``_Decoder.step`` over given state -> the carried tensors."""

    def __init__(self, model, cfg, plan, stop_threshold):
        super().__init__()
        self.model, self.cfg, self.plan = model, cfg, plan
        self.stop_threshold = stop_threshold

    def forward(self, t, live, uniforms, rotations, memory_mask, mem_k, mem_v,
                state):
        from rtts_torch.infer.decode import _Decoder

        p = self.plan
        dec = _Decoder.restore(self.model, self.cfg, p.mode,
                               self.stop_threshold, memory_mask, mem_k, mem_v,
                               state, rotations or None, p.local_spec,
                               p.window)
        dec.step(t, live, uniforms)
        return tuple(dec.carried())


class _Finish(nn.Module):
    def __init__(self, model, cfg):
        super().__init__()
        self.model, self.cfg = model, cfg

    def forward(self, mel, lengths):
        from rtts_torch.infer.decode import finish_mel

        return finish_mel(self.model, self.cfg, mel, lengths)


class _Vocoder(nn.Module):
    """mel -> audio through ``squeezewave._infer_chunk`` with a baked z."""

    def __init__(self, vocoder, cfg, z):
        super().__init__()
        # each weight contiguous in a storage of its own: the archive
        # writes a strided or shared storage through one of its views
        self.vocoder, self.cfg = copy.deepcopy(vocoder), cfg
        for t in [*self.vocoder.parameters(), *self.vocoder.buffers()]:
            t.data = t.data.clone(memory_format=torch.contiguous_format)
        self.register_buffer("z", z)

    def forward(self, mel):
        from rtts_torch.models.squeezewave import _infer_chunk

        return _infer_chunk(self.vocoder, mel, self.z, cfg=self.cfg)


def _whole_stacks(model_cfg):
    """The config with neither stack split over ranks: an artifact runs
    one device's stacks (a split stack's parameters are whole already)."""
    return dataclasses.replace(model_cfg, **{
        name: dataclasses.replace(getattr(model_cfg, name),
                                  seq_parallel_axis=None, pipeline_axis=None)
        for name in ("encoder", "decoder")})


@torch.no_grad()
def _gather(tts, model_cfg, mesh, device):
    """A whole copy of a tensor-parallel TTS model: each parameter's shards
    gathered over the model group (every rank of it must call this)."""
    from rtts_torch.infer.decode import _precast_weights
    from rtts_torch.models import reformer_tts as M
    from rtts_torch.parallel.sharding import gather_param

    plan = getattr(tts, "tp_plan", None) or {}
    whole = M.init(model_cfg, torch.Generator().manual_seed(0), device)
    _precast_weights(whole, M._dtype(model_cfg.compute_dtype))
    for (name, p), w in zip(tts.named_parameters(), whole.parameters()):
        w.copy_(gather_param(p, plan.get(name), None, mesh))
    for b, w in zip(tts.buffers(), whole.buffers()):
        w.copy_(b)
    return whole


def _save(module: nn.Module, args: tuple, path: str, dynamic_shapes=None):
    with torch.no_grad():
        ep = torch.export.export(module, args, dynamic_shapes=dynamic_shapes)
    torch.export.save(ep, path)
    return ep


def export_synthesizer(synth, out_dir: str, batch_sizes: Sequence[int] = (1,),
                       token_len: Optional[int] = None,
                       gather_sharded: bool = True) -> Dict[str, Any]:
    """Serialize a live ``Synthesizer``'s serving graphs into ``out_dir``
    (module docstring), one set per batch size in ``batch_sizes``: tokens
    pad to ``token_len`` (default the text frontend's ``max_len``), the
    vocoder takes (B, max_frames, n_mels).  Returns the manifest dict
    (also written to ``manifest.json``).  A mesh-sharded Synthesizer
    gathers its weights first; ``gather_sharded=False`` refuses it."""
    from rtts_torch.attention import lsh as TL
    from rtts_torch.infer.decode import _decode_rotations, decode_plan
    from rtts_torch.parallel.mesh import global_rank

    cfg = synth.cfg
    tts = synth.tts
    writer = True
    if synth.mesh is not None:
        err = ("export_synthesizer cannot bake these sharded params into a "
               "portable artifact — rebuild the Synthesizer without mesh= "
               "for export, or export from a single-process mesh where "
               "gather-to-replicated applies")
        if not gather_sharded:
            raise ValueError(err + " (gather_sharded=False)")
        tts = _gather(tts, cfg.model, synth.mesh, synth.device)
        writer = global_rank() == 0
    model_cfg = _whole_stacks(cfg.model)
    tcfg = cfg.dataset.text
    token_len = int(token_len or tcfg.max_len)
    if tcfg.pad_to_multiple and token_len % tcfg.pad_to_multiple:
        raise ValueError(f"token_len={token_len} not a multiple of "
                         f"pad_to_multiple={tcfg.pad_to_multiple}")
    plan = decode_plan(model_cfg, synth.max_frames, synth.mode, synth.unroll,
                       False, attn_window=synth.attn_window)
    dev = torch.device(synth.device)
    a = model_cfg.decoder.attention
    rotations, nb = [], 0
    if plan.mode in ("kv_lsh", "kv_lsh_chunk"):
        rotations, nb = _decode_rotations(model_cfg, None, synth.max_frames,
                                          dev)
    audio = cfg.dataset.audio
    manifest: Dict[str, Any] = {
        "format_version": _FORMAT_VERSION,
        "torch_version": torch.__version__,
        "device": dev.type,
        "token_len": token_len,
        "max_frames": int(synth.max_frames),
        "n_mels": int(model_cfg.n_mels),
        "batch_sizes": sorted(int(b) for b in batch_sizes),
        "text": {
            "cleaner": tcfg.cleaner,
            "level": tcfg.level,
            "pad_to_multiple": int(tcfg.pad_to_multiple),
            "max_len": int(tcfg.max_len),
        },
        "audio": {
            "sample_rate": int(audio.sample_rate),
            "hop_length": int(cfg.vocoder.hop_length),
            # the Griffin-Lim fallback of a TTS-only export rebuilds its
            # mel basis from these
            "stft": {
                "sample_rate": int(audio.sample_rate),
                "n_fft": int(audio.n_fft),
                "hop_length": int(audio.hop_length),
                "win_length": int(audio.win_length),
                "n_mels": int(audio.n_mels),
                "fmin": float(audio.fmin),
                "fmax": None if audio.fmax is None else float(audio.fmax),
                "log_floor": float(audio.log_floor),
                "center": bool(audio.center),
            },
        },
        "decode": {
            "mode": plan.mode,
            "unroll": plan.unroll,
            "n_groups": plan.n_groups,
            "n_cross": model_cfg.decoder.num_layers,
            "carried": 3 + (plan.window is not None),
            "prenet_dropout": float(model_cfg.dec_prenet_dropout),
            "prenet_widths": [int(tts.dec_prenet.fc1.w.shape[1]),
                              int(tts.dec_prenet.fc2.w.shape[1])],
            "rotations": None if not rotations else {
                "layers": model_cfg.decoder.num_layers,
                "heads": a.num_heads, "head_dim": a.head_dim,
                "n_hashes": a.num_hashes, "n_buckets": nb,
                "hash_seed": a.hash_seed},
        },
        "artifacts": {},
    }
    for b in manifest["batch_sizes"]:
        for kind in _ARTIFACTS + (("vocoder",) if synth.vocoder is not None
                                  else ()):
            manifest["artifacts"][f"{kind}_b{b}"] = {"file": f"{kind}_b{b}.pt2"}
    if writer:
        os.makedirs(out_dir, exist_ok=True)
        stop = float(model_cfg.stop_threshold)
        for b in manifest["batch_sizes"]:
            path = lambda kind: os.path.join(out_dir, f"{kind}_b{b}.pt2")
            tokens = torch.ones((b, token_len), dtype=torch.long, device=dev)
            mask = torch.ones((b, token_len), dtype=torch.bool, device=dev)
            enc = _Encoder(_encoder_parts(tts), model_cfg, plan, stop, nb)
            with torch.no_grad(), TL.rotation_tape() as drawn:
                outs = enc(tokens, mask)
            with TL.rotation_tape(replay=drawn):
                _save(enc, (tokens, mask), path("encoder"))
            n = model_cfg.decoder.num_layers
            mem_k, mem_v, state = outs[:n], outs[n:2 * n], outs[2 * n:]
            uniforms = draws.prenet_uniforms(
                None, b, manifest["decode"]["prenet_widths"],
                model_cfg.dec_prenet_dropout, dev)
            live = torch.ones((), dtype=torch.bool, device=dev)
            args = (0, live, uniforms, list(rotations), mask, list(mem_k),
                    list(mem_v), list(state))
            # t symbolic (no shape depends on it), every tensor static
            static = torch.utils._pytree.tree_map(lambda _: None, args[1:])
            _save(_Step(_step_parts(tts), model_cfg, plan, stop), args,
                  path("step"),
                  dynamic_shapes=(torch.export.Dim.DYNAMIC, *static))
            _save(_Finish(_Parts(postnet=tts.postnet), model_cfg),
                  (state[manifest["decode"]["carried"]], state[2]),
                  path("finish"))
            if synth.vocoder is not None:
                voc_cfg = cfg.vocoder
                l = synth.max_frames * voc_cfg.hop_length // voc_cfg.n_group
                gen = torch.Generator(device=dev).manual_seed(0)
                z = torch.randn((b, l, voc_cfg.n_group), generator=gen,
                                device=dev) * voc_cfg.sigma
                mel = torch.zeros((b, synth.max_frames, model_cfg.n_mels),
                                  device=dev)
                _save(_Vocoder(synth.vocoder, voc_cfg, z), (mel,),
                      path("vocoder"))
        with open(os.path.join(out_dir, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
    if synth.mesh is not None and torch.distributed.is_initialized():
        torch.distributed.barrier()   # the directory is whole for every rank
    return manifest


# -- the runner -----------------------------------------------------------------


class _Program:
    """Calls an ``ExportedProgram``'s graph with its lifted weights,
    buffers and constants in their places: what ``ep.module()`` runs,
    without rebuilding the module tree (whose codegen cannot name the
    vocoder's ``in`` layers) and without its per-call input checks.  The
    graph's writes go to the caller's tensors: in place, or, where a
    functional graph returns a written input as an output
    (``USER_INPUT_MUTATION``), copied back as ``ep.module()`` does.  Any
    other kind of output raises."""

    def __init__(self, ep):
        from torch.export.graph_signature import InputKind, OutputKind

        self._gm = ep.graph_module
        self._call_spec = ep.call_spec
        self._inputs: List[Any] = []
        self._slots: List[int] = []
        user = {}                 # a user input's name -> its position
        for i, spec in enumerate(ep.graph_signature.input_specs):
            if spec.kind == InputKind.USER_INPUT:
                self._inputs.append(None)
                self._slots.append(i)
                user[spec.arg.name] = i
            elif spec.target in ep.state_dict:
                self._inputs.append(ep.state_dict[spec.target])
            else:
                self._inputs.append(ep.constants[spec.target])
        self._outputs: List[int] = []
        self._writes: List[Tuple[int, int]] = []    # (output, input)
        for i, spec in enumerate(ep.graph_signature.output_specs):
            if spec.kind == OutputKind.USER_OUTPUT:
                self._outputs.append(i)
            elif spec.kind == OutputKind.USER_INPUT_MUTATION:
                self._writes.append((i, user[spec.target]))
            else:
                raise ValueError(f"artifact output {i} is a {spec.kind}: "
                                 "only outputs and written inputs are served")

    def __call__(self, *args):
        flat, spec = torch.utils._pytree.tree_flatten((args, {}))
        if spec != self._call_spec.in_spec:
            raise ValueError(f"artifact called with {spec}, exported for "
                             f"{self._call_spec.in_spec}")
        inputs = list(self._inputs)
        for i, x in zip(self._slots, flat):
            inputs[i] = x
        outs = self._gm(*inputs)
        for i, j in self._writes:
            inputs[j].copy_(outs[i])
        return torch.utils._pytree.tree_unflatten(
            [outs[i] for i in self._outputs], self._call_spec.out_spec)


class ExportedSynthesizer:
    """Text -> wav from an export directory: no model code, no checkpoint.

    Loads the manifest and the ``.pt2`` programs written by
    ``export_synthesizer`` and mirrors the live ``Synthesizer``'s serving
    semantics: requests are chunked to the largest exported batch size
    (the last chunk padded by repeating its final request), tokens pad to
    the artifact's static ``token_len``, mels pad to ``max_frames`` for
    the vocoder and waveforms slice to ``length * hop``."""

    def __init__(self, path: str):
        with open(os.path.join(path, _MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format_version") != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported export format "
                f"{self.manifest.get('format_version')!r} at {path}")
        self.device = torch.device(self.manifest["device"])
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"the export at {path} was made on the card and runs there "
                "only: torch.cuda.is_available() is false")
        self._path = path
        self._loaded: Dict[str, Any] = {}

    def _artifact(self, key: str):
        if key not in self._loaded:
            meta = self.manifest["artifacts"].get(key)
            if meta is None:
                raise KeyError(
                    f"artifact {key!r} not in export (have: "
                    f"{sorted(self.manifest['artifacts'])})")
            self._loaded[key] = _Program(torch.export.load(
                os.path.join(self._path, meta["file"])))
        return self._loaded[key]

    @property
    def batch_sizes(self) -> List[int]:
        return list(self.manifest["batch_sizes"])

    def _encode(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        from rtts_torch.text import encode_batch

        t = self.manifest["text"]
        tl = self.manifest["token_len"]
        # encode_batch clamps/truncates at max_len=token_len — the same
        # static-budget contract the live Synthesizer serves under
        ids, mask = encode_batch(texts, cleaner=t["cleaner"],
                                 pad_to_multiple=t["pad_to_multiple"],
                                 max_len=tl, level=t["level"])
        pad = tl - ids.shape[1]
        if pad:
            ids = np.pad(ids, ((0, 0), (0, pad)))
            mask = np.pad(mask, ((0, 0), (0, pad)))
        return ids, mask

    @torch.no_grad()
    def _decode(self, b: int, ids: np.ndarray, mask: np.ndarray,
                seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One batch through encoder, the step loop and finish ->
        (mel_post (B, max_frames, n_mels), lengths (B,)) on the device."""
        d = self.manifest["decode"]
        dev = self.device
        tokens = torch.as_tensor(ids, device=dev).long()
        msk = torch.as_tensor(mask, device=dev).bool()
        outs = self._artifact(f"encoder_b{b}")(tokens, msk)
        n, c = d["n_cross"], d["carried"]
        mem_k, mem_v, state = list(outs[:n]), list(outs[n:2 * n]), \
            list(outs[2 * n:])
        gen = torch.Generator(device=dev).manual_seed(seed)
        rotations = []
        if d["rotations"] is not None:
            r = d["rotations"]
            rseed = (r["hash_seed"] if r["hash_seed"] is not None
                     else draws.rotation_seed(seed))
            rotations = draws.decode_rotations(
                rseed, r["layers"], r["heads"], r["head_dim"], r["n_hashes"],
                r["n_buckets"], dev)
        step = self._artifact(f"step_b{b}")
        unroll, n_groups = d["unroll"], d["n_groups"]
        first = torch.ones((), dtype=torch.bool, device=dev)
        t = 0
        while t < n_groups:
            live = first
            for _ in range(unroll):
                uniforms = draws.prenet_uniforms(gen, b, d["prenet_widths"],
                                                 d["prenet_dropout"], dev)
                state[:c] = step(t, live, uniforms, rotations, msk, mem_k,
                                 mem_v, state)
                t += 1
                if unroll > 1:
                    live = ~state[1].all()
            if bool(state[1].all()):
                break
        mel = self._artifact(f"finish_b{b}")(state[c], state[2])
        return mel, state[2]

    def text_to_mel(self, texts: Sequence[str], seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (mel (N, max_frames, n_mels) f32, lengths (N,) i32)."""
        ids, mask = self._encode(texts)
        b = self._pick_batch(len(texts))
        mels, lens = [], []
        for lo in range(0, len(texts), b):
            chunk_ids = ids[lo:lo + b]
            chunk_mask = mask[lo:lo + b]
            n = chunk_ids.shape[0]
            if n < b:  # repeat the last request up to the batch size
                chunk_ids = np.concatenate([chunk_ids]
                                           + [chunk_ids[-1:]] * (b - n))
                chunk_mask = np.concatenate([chunk_mask]
                                            + [chunk_mask[-1:]] * (b - n))
            mel, ln = self._decode(b, chunk_ids, chunk_mask, seed)
            mels.append(mel.cpu().numpy()[:n])
            lens.append(ln.cpu().numpy()[:n])
        return np.concatenate(mels), np.concatenate(lens)

    def _vocoder_batch(self) -> Optional[int]:
        """Smallest exported vocoder batch size (None when the export is
        TTS-only — vocode then falls back to Griffin-Lim)."""
        sizes = [b for b in self.batch_sizes
                 if f"vocoder_b{b}" in self.manifest["artifacts"]]
        return sizes[0] if sizes else None

    def _griffin_lim(self, mels, lengths) -> List[np.ndarray]:
        """TTS-only exports: invert mels with the manifest's STFT params
        (no model code: pinv(mel basis) + Griffin-Lim, on the artifact's
        device, as the live Synthesizer without a vocoder)."""
        from rtts_torch.audio.griffin import mel_to_audio as gl_mel_to_audio
        from rtts_torch.config import AudioConfig

        acfg = AudioConfig(**self.manifest["audio"]["stft"])
        out = []
        for m, ln in zip(mels, lengths):
            m = torch.as_tensor(np.asarray(m, np.float32)[: int(ln)],
                                device=self.device)
            out.append(gl_mel_to_audio(m, acfg).cpu().numpy())
        return out

    @torch.no_grad()
    def vocode(self, mels: Sequence[np.ndarray],
               lengths: Optional[Sequence[int]] = None) -> List[np.ndarray]:
        """Utterances [(T_i, n_mels)] -> waveforms [(length_i * hop,)].

        Batches through the smallest exported vocoder artifact: each row
        zero-pads to max_frames (the batched-vocode contract —
        conditioning differences confined to the receptive field of the
        stop boundary) and short final chunks pad with zero rows.  Flow
        noise z is the artifact's, baked from a generator seeded 0, so a
        given (artifact batch size, row position) is deterministic."""
        b = self._vocoder_batch()
        if lengths is None:
            lengths = [m.shape[0] for m in mels]
        if b is None:
            return self._griffin_lim(mels, lengths)
        frames = self.manifest["max_frames"]
        hop = self.manifest["audio"]["hop_length"]
        rows = []
        # clamp to the artifact's static frame budget: a longer mel
        # (external caller) truncates rather than crashing on a negative pad
        lengths = [min(int(ln), frames) for ln in lengths]
        for m, ln in zip(mels, lengths):
            m = np.asarray(m, np.float32)[:ln]
            rows.append(np.pad(m, ((0, frames - m.shape[0]), (0, 0))))
        wavs: List[np.ndarray] = []
        art = self._artifact(f"vocoder_b{b}")
        for lo in range(0, len(rows), b):
            chunk = rows[lo:lo + b]
            n = len(chunk)
            if n < b:
                chunk = chunk + [np.zeros_like(rows[0])] * (b - n)
            audio = art(torch.as_tensor(np.stack(chunk), device=self.device))
            audio = audio.cpu().numpy()
            wavs.extend(audio[j, : int(lengths[lo + j]) * hop]
                        for j in range(n))
        return wavs

    def mel_to_audio(self, mel: np.ndarray, length: Optional[int] = None
                     ) -> np.ndarray:
        """One utterance (T, n_mels) -> waveform (length * hop,)."""
        return self.vocode([mel], None if length is None else [length])[0]

    def _pick_batch(self, n: int) -> int:
        sizes = self.batch_sizes
        for b in sizes:
            if b >= n:
                return b
        return sizes[-1]

    def __call__(self, texts: Sequence[str], seed: int = 0
                 ) -> List[np.ndarray]:
        mel, lengths = self.text_to_mel(texts, seed)
        return self.vocode(list(mel), [int(x) for x in lengths])
