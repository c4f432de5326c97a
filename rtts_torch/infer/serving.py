"""Continuous-batching serving: ``ServingEngine``, ``serve_batch`` and
``serve_pool``.

Port of ``rtts/infer/serving.py``.  A fixed batch of ``slots`` decodes in
lock-step (one global step ``t``, a Python int, so every cache write is one
shared row), but each slot carries its own request: an admission offset
``o_i`` makes slot i attend only to the cache entries whose global step
lies in [o_i, t].  The self-attention caches are rings of ``capacity``
groups; the shared ``pos_buf`` records each ring row's global step, and
masking against it (not against the row index) makes the wraparound
invisible.  A slot stops at its budget (<= capacity), so a live slot's
window is never overwritten.  The positional encoding of slot i is the
table's row t - o_i.

Numerics: a slot admitted at t = 0 with capacity equal to the decode's
group count computes ``decode_greedy(mode="kv_full", staged=False)``'s
frames (the ring step reads the whole ring, whose unwritten rows get
probability exactly 0, where the prefix step reads the prefix: only the
f32 summation order differs); a recycled slot attends the same values at
rotated rows.  The postnet runs once over rows masked at each length
(``frame_mask``), which equals a run at the exact length.

The decoder prenet's always-on dropout draws one mask per global step for
all slots from one ``torch.Generator``, so ``ServingEngine`` and
``serve_batch`` decode the same frames, bit for bit, when they admit the
same requests at the same steps.

Three entry points:

- ``ServingEngine``: online arrivals.  The host admits at segment
  boundaries and harvests finished slots one segment late (the copy of a
  segment's done flags and lengths is read after the next segment has been
  launched).
- ``serve_batch``: a whole request list.  All requests are encoded in one
  batch up front; each boundary admits into the free slots by device
  arithmetic (the cumsum rank of the free slots) and runs ``segment``
  steps; the loop's condition is its one host synchronization a boundary.
- ``serve_pool``: ``serve_batch`` once per capacity class (the smallest
  class covering each request's budget): short requests attend short
  rings.  The reference's ``_hashable_cfg`` existed for jit's static
  arguments only and has no counterpart here.
"""

from __future__ import annotations

import collections
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from rtts_torch.attention.full import local_heads
from rtts_torch.config import Config, ReformerTTSConfig
from rtts_torch.infer.decode import (_cross_attn_step, _init_mem_kv,
                                     _kv_dtype, _precast_weights, _project,
                                     _stack_substep, _to_kv, _zeros)
from rtts_torch.models import reformer_tts as M
from rtts_torch.models import squeezewave
from rtts_torch.models.reformer_tts import _dtype, postnet_apply
from rtts_torch.nn.posenc import pos_table
from rtts_torch.ops.flash_attention import MASK_VALUE, SELF_MASK_VALUE


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: to the card from pinned memory without
    blocking the host (a pageable copy would synchronize)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.clone().to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` on the host: from the card into pinned memory without
    blocking (valid once the stream has passed this point)."""
    if x.device.type != "cuda":
        return x.clone()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return out.copy_(x, non_blocking=True)


def _check_sizes(r: int, slots: int, capacity_frames: int,
                 segment_frames: int) -> None:
    if slots < 1 or capacity_frames < r or segment_frames < r:
        raise ValueError(
            f"slots/capacity_frames/segment_frames must be positive "
            f"(>= reduction_factor {r}); got {slots}/{capacity_frames}/"
            f"{segment_frames} — a zero value would loop forever")
    if capacity_frames % r:
        raise ValueError(f"capacity_frames {capacity_frames} not a multiple "
                         f"of reduction_factor {r}")
    if segment_frames % r:
        raise ValueError(f"segment_frames {segment_frames} not a multiple "
                         f"of reduction_factor {r}")


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """e4m3 as its bytes (``where`` and indexing have no e4m3 kernel)."""
    return x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x


def _pick(take: torch.Tensor, new: torch.Tensor,
          old: torch.Tensor) -> torch.Tensor:
    """Rows of ``new`` where ``take`` (S,), else rows of ``old``."""
    sel = take.view((-1,) + (1,) * (old.ndim - 1))
    return torch.where(sel, _bytes(new), _bytes(old)).view(old.dtype)


def _rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return _bytes(x)[index].view(x.dtype)


def _self_attn_step_ring(p, h_t, k_cache, v_cache, pos_buf, offsets, t: int,
                         num_heads: int, cdt):
    """One-frame shared-QK self-attention over a ring cache (B, C, H, d)
    with per-slot admission offsets (B,).  Writes ring row t mod C and
    ``pos_buf`` (C,) there; slot i attends the rows whose recorded step p
    has offsets[i] <= p <= t (others replaced by -1e9), the current entry
    at -1e5.  It reads the whole ring: after wraparound there is no
    prefix.  A cache in another dtype than the compute one stores the
    keys unscaled, and 1/sqrt(d) goes to the query (``_project``)."""
    _, v_t, k_t, q_s = _project(p, h_t, num_heads, cdt, k_cache.dtype)
    w = t % k_cache.shape[1]
    k_cache[:, w] = _to_kv(k_t, k_cache.dtype)
    v_cache[:, w] = _to_kv(v_t, v_cache.dtype)
    # a fill of a one-row slice: a Python int assigned to a 0-dim view of
    # a CUDA tensor is copied from the host, which synchronizes
    pos_buf[w:w + 1].fill_(t)
    scores = torch.einsum("bhd,bthd->bht", q_s, k_cache.to(cdt)).float()
    pos = pos_buf[None, None, :]
    own = (pos >= offsets[:, None, None]) & (pos <= t)
    scores = torch.where(own, scores, MASK_VALUE)
    scores = torch.where(pos == t, SELF_MASK_VALUE, scores)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bht,bthd->bhd", probs.to(cdt), v_cache.to(cdt))
    return p.w_o(out.reshape(out.shape[0], -1), cdt)


class _Slots:
    """The slots' device state, shared by ``ServingEngine`` and
    ``serve_batch``: per self layer a ring cache (S, C, H, d) in the cache
    dtype, the shared ``pos_buf`` (C,) (-1 where unwritten), and per slot
    its done flag (empty slots are done), admission offset, budget in
    groups, previous frame, and its request's cross-attention K/V and
    token mask."""

    def __init__(self, cfg: ReformerTTSConfig, slots: int, capacity: int,
                 token_len: int, device, heads: Optional[int] = None):
        self.cdt = _dtype(cfg.compute_dtype)
        kdt = _kv_dtype(cfg, self.cdt)
        a = cfg.decoder.attention
        n = cfg.decoder.num_layers
        heads = a.num_heads if heads is None else heads   # a TP shard's
        ring = (slots, capacity, heads, a.head_dim)
        mem = (slots, token_len, heads, a.head_dim)
        self.done = torch.ones(slots, dtype=torch.bool, device=device)
        self.offsets = torch.zeros(slots, dtype=torch.int64, device=device)
        self.budgets = torch.ones(slots, dtype=torch.int64, device=device)
        self.prev = torch.zeros(slots, cfg.n_mels * cfg.reduction_factor,
                                device=device)
        self.pos_buf = torch.full((capacity,), -1, dtype=torch.int64,
                                  device=device)
        self.k_caches = [_zeros(ring, kdt, device) for _ in range(n)]
        self.v_caches = [_zeros(ring, kdt, device) for _ in range(n)]
        self.mem_k = [_zeros(mem, kdt, device) for _ in range(n)]
        self.mem_v = [_zeros(mem, kdt, device) for _ in range(n)]
        self.memory_mask = torch.ones(slots, token_len, dtype=torch.bool,
                                      device=device)

    def admit(self, take, t: int, budgets, mem_k, mem_v, memory_mask):
        """Install a request in every slot where ``take`` (S,): admitted at
        step t with ``budgets`` (S,) groups and the rows of ``mem_k``,
        ``mem_v`` (per cross layer) and ``memory_mask`` meant for it."""
        self.done = self.done & ~take
        self.offsets = torch.where(take, t, self.offsets)
        self.budgets = torch.where(take, budgets, self.budgets)
        self.prev = torch.where(take[:, None], 0.0, self.prev)
        self.mem_k = [_pick(take, n, o) for n, o in zip(mem_k, self.mem_k)]
        self.mem_v = [_pick(take, n, o) for n, o in zip(mem_v, self.mem_v)]
        self.memory_mask = _pick(take, memory_mask, self.memory_mask)

    def frame(self, model, cfg: ReformerTTSConfig, t: int,
              generator: Optional[torch.Generator], stop_threshold: float):
        """Decode global step t for every slot -> (group (S, r*n_mels),
        each slot's position t - offset, the slots that stop at it: the
        stop head or the budget).  Advances ``prev``; ``done`` is the
        caller's to update (its writes key on the pre-step flag)."""
        cdt = self.cdt
        num_heads = cfg.decoder.attention.num_heads
        h = model.dec_prenet(self.prev.to(cdt), cfg.dec_prenet_dropout,
                             generator, compute_dtype=cdt)
        p_rel = t - self.offsets
        table, alpha = pos_table(model.dec_pos)
        pe = table[p_rel.clamp(0, table.shape[0] - 1)]
        h = h + alpha.to(h.dtype) * pe.to(h.dtype)

        def self_attn(i, p, hh):
            return _self_attn_step_ring(p, hh, self.k_caches[i],
                                        self.v_caches[i], self.pos_buf,
                                        self.offsets, t, num_heads, cdt)

        def cross(i, p, hh):
            return _cross_attn_step(p, hh, self.mem_k[i], self.mem_v[i],
                                    self.memory_mask, num_heads, cdt)[0]

        y = _stack_substep(model, cfg, h, cdt, self_attn, cross)
        group = model.mel_head(y, cdt).float()
        stop_logit = model.stop_head(y, cdt)[..., 0].float()
        self.prev = group
        stops = ((torch.sigmoid(stop_logit) > stop_threshold)
                 | (p_rel + 1 >= self.budgets))
        return group, p_rel, stops


def _masked_postnet(model, mel: torch.Tensor, lengths: torch.Tensor,
                    cdt) -> torch.Tensor:
    """mel (B, T, n_mels) + the postnet's residual, both masked past each
    row's length: a recycled row still holds its previous occupant's
    frames there, and rows promise zeros beyond their length."""
    fmask = (torch.arange(mel.shape[1], device=mel.device)[None, :]
             < lengths[:, None])
    residual = postnet_apply(model.postnet, mel.to(cdt), cdt,
                             frame_mask=fmask).float()
    return (mel + residual) * fmask[..., None]


class ServingEngine:
    """Slot-recycling continuous-batching text -> mel (-> wav) server::

        eng = ServingEngine(cfg, tts_model, slots=8, capacity_frames=1024)
        ids = [eng.submit(text) for text in texts]
        results = eng.run_until_drained()   # {id: (mel_post, length)}

    or incrementally: ``submit`` at any time and call ``step()``, which
    advances one segment and returns the requests it finished.

    The cache is the full-attention KV cache (rings); LSH-trained models
    serve through it as they do in ``Synthesizer``.  A segment runs all of
    its steps (stopping early would take a host synchronization a step);
    done slots park their writes in a spare group.  So an admission that
    the reference makes after a segment in which every slot was done
    starts up to one segment later here."""

    def __init__(self, cfg: Config, tts_model: M.ReformerTTS, vocoder=None,
                 slots: int = 8, capacity_frames: int = 1024,
                 segment_frames: int = 64, token_len: Optional[int] = None,
                 stop_threshold: Optional[float] = None, seed: int = 0,
                 suppress_dispatch_warning: bool = False):
        """``tts_model`` and ``vocoder`` are modules on the device to serve
        from (the TTS weights cast to the compute dtype in place, the
        vocoder folded).  ``seed`` seeds the prenet dropout's generator."""
        mcfg = cfg.model
        _check_sizes(mcfg.reduction_factor, slots, capacity_frames,
                     segment_frames)
        if not suppress_dispatch_warning:
            warnings.warn(
                "ServingEngine synchronizes with the host at every segment "
                "boundary and runs a postnet per harvest. For request sets "
                "known up front use Synthesizer.serve_continuous / "
                "serve_pool (one synchronization a boundary, one postnet a "
                "capacity class). ServingEngine is the choice for ONLINE "
                "arrivals. Pass suppress_dispatch_warning=True to "
                "acknowledge.", UserWarning, stacklevel=2)
        self.cfg = cfg
        self.cdt = _dtype(mcfg.compute_dtype)
        _kv_dtype(mcfg, self.cdt)
        self.tts = _precast_weights(tts_model, self.cdt)
        self.vocoder = (squeezewave.ensure_folded(vocoder)
                        if vocoder is not None else None)
        self.device = _device(tts_model)
        self.slots = slots
        self.capacity = capacity_frames // mcfg.reduction_factor   # groups
        self.segment = segment_frames // mcfg.reduction_factor
        self.token_len = token_len or cfg.dataset.text.max_len or 128
        self.seed = seed
        self.stop_threshold = (mcfg.stop_threshold if stop_threshold is None
                               else stop_threshold)
        self.reset()

    def reset(self) -> None:
        """Drop all state, queue and results; the generator starts over."""
        mcfg = self.cfg.model
        r, dev = mcfg.reduction_factor, self.device
        self.generator = torch.Generator(device=dev).manual_seed(self.seed)
        heads = local_heads(self.tts.decoder.layers[0].f.attn)
        self.state = _Slots(mcfg, self.slots, self.capacity, self.token_len,
                            dev, heads)
        self.t = 0
        self.lengths = torch.zeros(self.slots, dtype=torch.int32, device=dev)
        # slot-local frames; group `capacity` is the spare that done slots
        # write to, so an unharvested utterance is never overwritten
        self.mel_out = torch.zeros(self.slots, (self.capacity + 1) * r,
                                   mcfg.n_mels, device=dev)
        self.queue: List[Tuple[int, np.ndarray, np.ndarray, int]] = []
        self.live: Dict[int, int] = {}             # slot -> request id
        self.results: Dict[int, Tuple[torch.Tensor, int]] = {}
        self._next_id = 0
        # per launched segment awaiting its harvest: (done, lengths on the
        # host, lengths on the device, its event, {slot: id} at launch)
        self._inflight: collections.deque = collections.deque()

    # -- API ------------------------------------------------------------------

    def submit(self, text: str, budget_frames: Optional[int] = None) -> int:
        """Queue a text request; returns its id.  ``budget_frames`` caps the
        utterance (default: the whole ring)."""
        from rtts_torch.text import encode_batch

        tcfg = self.cfg.dataset.text
        tokens, mask = encode_batch([text], cleaner=tcfg.cleaner,
                                    pad_to_multiple=1,
                                    max_len=self.token_len, level=tcfg.level)
        pad = self.token_len - tokens.shape[1]
        if pad > 0:
            tokens = np.pad(tokens, ((0, 0), (0, pad)))
            mask = np.pad(mask, ((0, 0), (0, pad)))
        return self.submit_tokens(tokens, mask, budget_frames)

    def submit_tokens(self, tokens: np.ndarray, token_mask: np.ndarray,
                      budget_frames: Optional[int] = None) -> int:
        """Queue a tokenized request ((1, token_len) ids and mask)."""
        r = self.cfg.model.reduction_factor
        tokens, token_mask = np.asarray(tokens), np.asarray(token_mask)
        if tokens.shape != (1, self.token_len):
            raise ValueError(f"tokens must be (1, {self.token_len}), "
                             f"got {tokens.shape}")
        budget = self.capacity if budget_frames is None else \
            min(self.capacity, -(-budget_frames // r))
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, tokens, token_mask, budget))
        return rid

    @property
    def idle(self) -> bool:
        return not self.queue and not self.live

    @torch.no_grad()
    def step(self) -> List[int]:
        """Admit queued requests, launch one segment, harvest the segment
        launched by the previous call; returns the ids it finished.

        The harvest reads segment k's done flags and lengths (copied to
        pinned host memory behind an event) only after segment k+1 has
        been launched, so the host's scheduling overlaps the card's work.
        A harvested slot's frames are safe: it is done, so it writes the
        spare group.  Completions surface one call late; drain loops key
        on the returned ids or ``idle``.  Finished utterances get one
        masked postnet over the slot rows, on the device, until
        ``fetch``."""
        self._fill_slots()
        if self.live:
            self._segment()
            done, lengths = self.state.done, self.lengths.clone()
            ev = None
            if self.device.type == "cuda":
                done_h, lengths_h = _to_host(done), _to_host(lengths)
                ev = torch.cuda.Event()
                ev.record()
            else:
                done_h, lengths_h = done.clone(), lengths
            self._inflight.append((done_h, lengths_h, lengths, ev,
                                   dict(self.live)))
        if not self._inflight:
            return []
        if self.live and len(self._inflight) < 2:
            return []          # filling the pipeline: one segment in flight
        done_h, lengths_h, lengths_d, ev, live_at = self._inflight.popleft()
        if ev is not None:
            ev.synchronize()
        done, lengths = done_h.numpy(), lengths_h.numpy()
        # only slots still held by the request they held at that launch (a
        # slot can be harvested and refilled while a later one is in flight)
        fin = [(slot, rid) for slot, rid in live_at.items()
               if done[slot] and self.live.get(slot) == rid]
        if not fin:
            return []
        t_max = self.capacity * self.cfg.model.reduction_factor
        post = _masked_postnet(self.tts, self.mel_out[:, :t_max], lengths_d,
                               self.cdt)
        for slot, rid in fin:
            self.results[rid] = (post[slot], int(lengths[slot]))
            del self.live[slot]
        return [rid for _, rid in fin]

    @staticmethod
    def fetch(result: Tuple[torch.Tensor, int]) -> np.ndarray:
        """(device row, length) -> the trimmed mel (length, n_mels)."""
        row, length = result
        return row[:length].cpu().numpy()

    def run_until_drained(self, fetch: bool = True
                          ) -> Dict[int, Tuple[Any, int]]:
        """Serve the queue to the end -> {id: (mel, length)}.  With
        ``fetch=False`` the mels stay device rows of the full capacity,
        zero beyond each length (for on-device consumers)."""
        while not self.idle:
            self.step()
        out, self.results = self.results, {}
        if fetch:
            out = {rid: (self.fetch(v), v[1]) for rid, v in out.items()}
        return out

    def mel_to_audio(self, mel: np.ndarray) -> np.ndarray:
        from rtts_torch.infer.synthesize import Synthesizer

        return Synthesizer.mel_to_audio(self, mel)   # shares the body

    # -- internals --------------------------------------------------------------

    def _fill_slots(self) -> None:
        """Encode one slot batch of queued requests and install them in the
        free slots: occupancy is the host's bookkeeping (``live``), never a
        read of the device."""
        free = [s for s in range(self.slots) if s not in self.live]
        n = min(len(free), len(self.queue))
        if n == 0:
            return
        tokens = np.zeros((self.slots, self.token_len), np.int64)
        # rows not installed keep an all-true mask (no fully masked row)
        masks = np.ones((self.slots, self.token_len), bool)
        budgets = np.zeros((self.slots,), np.int64)
        install = np.zeros((self.slots,), bool)
        for slot in free[:n]:
            rid, tok, msk, budget = self.queue.pop(0)
            tokens[slot], masks[slot] = tok[0], msk[0]
            budgets[slot], install[slot] = budget, True
            self.live[slot] = rid
        mcfg, dev = self.cfg.model, self.device
        tokens, masks = _to_device(tokens, dev), _to_device(masks, dev)
        budgets, install = _to_device(budgets, dev), _to_device(install, dev)
        memory = M.encode(self.tts, mcfg, tokens, masks)
        mem_k, mem_v = _init_mem_kv(self.tts, mcfg, memory.to(self.cdt),
                                    self.cdt, _kv_dtype(mcfg, self.cdt))
        self.state.admit(install, self.t, budgets, mem_k, mem_v, masks)
        self.lengths = torch.where(install, 0, self.lengths)

    def _segment(self) -> None:
        """``segment`` global steps, all of them, with no synchronization."""
        mcfg, st = self.cfg.model, self.state
        r, n_mels, cap = mcfg.reduction_factor, mcfg.n_mels, self.capacity
        mel = self.mel_out.view(self.slots, cap + 1, r, n_mels)
        rows = torch.arange(self.slots, device=self.device)
        for _ in range(self.segment):
            group, p_rel, stops = st.frame(self.tts, mcfg, self.t,
                                           self.generator,
                                           self.stop_threshold)
            g = torch.where(st.done, cap, p_rel.clamp(0, cap - 1))
            mel[rows, g] = group.view(self.slots, r, n_mels)
            self.lengths = torch.where(st.done, self.lengths,
                                       ((p_rel + 1) * r).to(torch.int32))
            st.done = st.done | stops
            self.t += 1


@torch.no_grad()
def _decode_queue(model, cfg: ReformerTTSConfig, tokens: torch.Tensor,
                  token_mask: torch.Tensor, budgets: torch.Tensor,
                  capacity_frames: int, slots: int, segment_frames: int,
                  stop_threshold: Optional[float],
                  generator: Optional[torch.Generator]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``serve_batch`` before the postnet -> (frames (N, capacity_frames,
    n_mels), lengths (N,) int32), on the model's device."""
    r, n_mels = cfg.reduction_factor, cfg.n_mels
    _check_sizes(r, slots, capacity_frames, segment_frames)
    dev = _device(model)
    thr = cfg.stop_threshold if stop_threshold is None else stop_threshold
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cap, n_slots, seg = capacity_frames // r, slots, segment_frames // r
    tokens, token_mask = tokens.to(dev).long(), token_mask.to(dev).bool()
    n, _ = tokens.shape
    cdt = _dtype(cfg.compute_dtype)
    # every request encoded in one batch; admission copies rows of these
    memory = M.encode(model, cfg, tokens, token_mask)
    mem_k, mem_v = _init_mem_kv(model, cfg, memory.to(cdt), cdt,
                                _kv_dtype(cfg, cdt))
    budgets_g = ((budgets.to(dev).long() + r - 1) // r).clamp(1, cap)
    st = _Slots(cfg, n_slots, cap, tokens.shape[1], dev,
                local_heads(model.decoder.layers[0].f.attn))
    # row n + s is slot s's spare: where a done slot writes
    spare = n + torch.arange(n_slots, device=dev)
    req = spare.clone()                       # the request each slot serves
    next_req = torch.zeros((), dtype=torch.int64, device=dev)
    out = torch.zeros(n + n_slots, cap * r, n_mels, device=dev)
    out_g = out.view(n + n_slots, cap, r, n_mels)
    lengths = torch.zeros(n + n_slots, dtype=torch.int32, device=dev)
    t = 0
    while n:
        serve_batch.boundaries += 1
        rank = torch.cumsum(st.done.long(), 0) - 1   # rank among free slots
        cand = next_req + rank
        take = st.done & (cand < n)
        src = torch.where(take, cand, 0)
        next_req = next_req + take.sum()
        req = torch.where(take, src, req)
        st.admit(take, t, budgets_g[src], [_rows(x, src) for x in mem_k],
                 [_rows(x, src) for x in mem_v], token_mask[src])
        for _ in range(seg):
            group, p_rel, stops = st.frame(model, cfg, t, generator, thr)
            # a slot whose stop fires now still writes its last frame (done
            # is the pre-step flag)
            wr = torch.where(st.done, spare, req)
            out_g[wr, p_rel.clamp(0, cap - 1)] = group.view(n_slots, r,
                                                            n_mels)
            fin = stops & ~st.done
            lengths[torch.where(fin, req, spare)] = torch.where(
                fin, (p_rel + 1) * r, 0).to(torch.int32)
            st.done = st.done | stops
            t += 1
        if not bool((next_req < n) | ~st.done.all()):   # the one sync
            break
    return out[:n], lengths[:n]


def serve_batch(model, cfg: ReformerTTSConfig, tokens: torch.Tensor,
                token_mask: torch.Tensor, budgets: torch.Tensor,
                capacity_frames: int, slots: int = 8,
                segment_frames: int = 64,
                stop_threshold: Optional[float] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Continuous-batching decode of a whole request list, the host loop
    counterpart of ``ServingEngine`` with one host synchronization a
    boundary (counted in ``serve_batch.boundaries``).

    tokens/token_mask (N, L); budgets (N,) frames (rounded up to the
    reduction factor, clamped to the capacity).  ``generator`` (on the
    model's device; default seeded 0) draws the prenet dropout, one mask a
    global step.  A request admitted at t = 0 with budget == capacity
    matches ``decode_greedy(kv_full, staged=False)``.
    -> (mel_post (N, capacity_frames, n_mels), zero beyond each length,
    lengths (N,) int32), on the model's device."""
    frames, lengths = _decode_queue(model, cfg, tokens, token_mask, budgets,
                                    capacity_frames, slots, segment_frames,
                                    stop_threshold, generator)
    with torch.no_grad():
        mel = _masked_postnet(model, frames, lengths,
                              _dtype(cfg.compute_dtype))
    return mel, lengths


serve_batch.boundaries = 0


def _class_seed(seed: int, cap: int) -> int:
    """The prenet generator's seed of capacity class ``cap`` (the
    reference folds the class into its key)."""
    return int(np.random.SeedSequence([seed, cap]).generate_state(
        1, np.uint64)[0])


def serve_pool(model, cfg: ReformerTTSConfig, tokens: np.ndarray,
               token_mask: np.ndarray, budgets,
               class_caps: Tuple[int, ...] = (128, 256, 512, 1024),
               slots: int = 8, segment_frames: int = 64,
               stop_threshold: Optional[float] = None, seed: int = 0
               ) -> Tuple[List[Any], np.ndarray]:
    """Capacity-classed continuous batching: each request goes to the
    smallest class covering its budget, and ``serve_batch`` runs once per
    class (its prenet generator seeded from ``seed`` and the class).
    -> ([per-request device mel (class capacity, n_mels), zero beyond
    its length], lengths np.int32)."""
    budgets = np.asarray(budgets, np.int64)
    caps = sorted(class_caps)
    if budgets.max(initial=0) > caps[-1]:
        raise ValueError(f"budget {int(budgets.max())} exceeds the largest "
                         f"class capacity {caps[-1]}")
    tokens, token_mask = np.asarray(tokens), np.asarray(token_mask)
    dev = _device(model)
    n = len(budgets)
    mels: List[Any] = [None] * n
    lengths = np.zeros((n,), np.int32)
    runs = []
    for ci, cap in enumerate(caps):
        lo = caps[ci - 1] if ci else 0
        idx = [i for i in range(n) if lo < budgets[i] <= cap]
        if not idx:
            continue
        gen = torch.Generator(device=dev).manual_seed(_class_seed(seed, cap))
        mel_c, len_c = serve_batch(
            model, cfg, _to_device(tokens[idx], dev),
            _to_device(token_mask[idx], dev), _to_device(budgets[idx], dev),
            capacity_frames=cap, slots=slots,
            segment_frames=min(segment_frames, cap),
            stop_threshold=stop_threshold, generator=gen)
        runs.append((idx, mel_c, len_c))
    if runs:     # every class's lengths in one read
        all_len = torch.cat([l for _, _, l in runs]).cpu().numpy()
        k = 0
        for idx, mel_c, _ in runs:
            for j, i in enumerate(idx):
                mels[i] = mel_c[j]
                lengths[i] = all_len[k]
                k += 1
    return mels, lengths
