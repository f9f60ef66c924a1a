"""Serving engine: prefill / decode step factories, ``generate`` and the
slot server, plus the admission-control primitives (the counterpart of
``repro.serve.engine``).

``make_prefill_step`` / ``make_decode_step`` build the steps;
``generate`` drives them for one batch; :class:`SlotServer` is a minimal
continuous-batching manager (fixed slot count, greedy refill) that serves
mixed-length traffic.  The slot server keeps one cache position per slot
(a ``[num_slots]`` ``pos``), so a request admitted while another slot is
mid-decode gets the tokens ``generate`` gives for its prompt alone.  The
reference keeps one shared position and does not (ROADMAP.md §3).  A
slot's row is every cache leaf's row: K/V (a sliding-window layer's ring
is shorter than a global layer's cache; MLA's is one packed compressed
tensor, ``v`` None), and the SSD's state and conv rows; an SSM model has
no KV cache and no position (the SSD needs none).

The encoder-decoder (``cfg.encdec``, ``models/encdec.py``) has its own
steps, as in the reference: prefill encodes ``batch["features"]`` and
fills the decoder's cache, decode reads the cross K/V from it;
``generate`` takes the ``features``.  The slot server does not serve it
(the reference's admits tokens only, and its launcher refuses it).

Serving builds no autograd graph: the steps, ``generate`` and the slot
server run under ``torch.no_grad()``, so a model the trainer has
unfrozen (``train/trainer.py``) serves as a frozen one does.  (Not
``inference_mode``: a cache made outside it and written in place inside
it, as a caller's ``init_cache``, must stay an ordinary tensor.)

The admission half is shared by every slot-batching server in the repo
(the LM ``SlotServer`` here and the graph ``QueryServer`` in
``serve/graph.py``): a bounded FIFO with per-item deadlines and an
injectable clock (:class:`AdmissionQueue`), the typed backpressure
rejection (:class:`QueueFullError`), and the typed deadline answer
(:class:`DeadlineExceeded`).  Under sustained load the contract is
graceful degradation: a full queue rejects at submit time (the caller
sees backpressure at once, nothing is silently dropped), and an admitted
request that outlives its deadline retires with a typed answer instead
of holding a slot.
"""
from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as transformer_mod
from repro_torch.models.transformer import LM, LayerCache


class QueueFullError(RuntimeError):
    """Typed submit-time rejection: the bounded admission queue is at
    capacity.  Carries the bound so callers can report backpressure."""

    def __init__(self, max_queue: int):
        super().__init__(f"admission queue full (max_queue={max_queue})")
        self.max_queue = max_queue


class DeadlineExceeded(NamedTuple):
    """Typed terminal answer for a request that outlived its deadline
    budget (queued too long, or admitted but not answered in time)."""
    rid: int
    kind: str
    waited_s: float


class AdmissionQueue:
    """Bounded FIFO with per-item absolute deadlines.

    ``max_queue=None`` keeps the unbounded legacy behavior.  ``clock``
    is injectable (tests drive deadlines with a fake clock; production
    uses ``time.monotonic``).  Counters: ``submitted`` (accepted
    pushes), ``rejected`` (queue-full pushes).  Expiry of queued items
    is the *caller's* retirement decision — :meth:`pop_ready` hands
    back ``(item, enqueued_at, deadline)`` and reports overdue items
    separately so the owner can answer them with a typed result."""

    def __init__(self, max_queue: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.clock = clock
        self._q: list[tuple[Any, float, Optional[float]]] = []
        self.submitted = 0
        self.rejected = 0

    def push(self, item, deadline_s: Optional[float] = None) -> None:
        """Enqueue ``item`` with a relative deadline budget (seconds;
        None = no deadline).  Raises :class:`QueueFullError` when the
        bound is hit — backpressure is surfaced at submit time."""
        if self.max_queue is not None and len(self._q) >= self.max_queue:
            self.rejected += 1
            raise QueueFullError(self.max_queue)
        now = self.clock()
        deadline = (now + deadline_s) if deadline_s is not None else None
        self._q.append((item, now, deadline))
        self.submitted += 1

    def pop_ready(self, limit: int
                  ) -> tuple[list[tuple[Any, float, Optional[float]]],
                             list[tuple[Any, float]]]:
        """Dequeue up to ``limit`` live items.  Returns ``(admitted,
        expired)``: admitted as ``(item, enqueued_at,
        absolute_deadline)``, expired as ``(item, waited_s)`` — every
        expired item found while scanning is drained regardless of
        ``limit`` (an overdue entry must never block a live one behind
        it)."""
        admitted: list[tuple[Any, float, Optional[float]]] = []
        expired: list[tuple[Any, float]] = []
        keep: list[tuple[Any, float, Optional[float]]] = []
        now = self.clock()
        for item, enq, deadline in self._q:
            if deadline is not None and now > deadline:
                expired.append((item, now - enq))
            elif len(admitted) < limit:
                admitted.append((item, enq, deadline))
            else:
                keep.append((item, enq, deadline))
        self._q = keep
        return admitted, expired

    def __len__(self) -> int:
        return len(self._q)


# ======================================================================
# LM serving
# ======================================================================
def make_prefill_step(cfg: ModelConfig) -> Callable:
    if cfg.encdec:
        @torch.no_grad()
        def prefill(params, batch: dict, caches):
            return encdec_mod.encdec_prefill(params, cfg, batch["features"],
                                             batch["tokens"], caches)
        return prefill

    @torch.no_grad()
    def prefill(params: LM, batch: dict, caches):
        logits, caches, _, _ = transformer_mod.forward(
            params, cfg, batch["tokens"], mode="prefill", caches=caches)
        return logits[:, -1:], caches
    return prefill


def make_decode_step(cfg: ModelConfig) -> Callable:
    if cfg.encdec:
        @torch.no_grad()
        def decode(params, token: torch.Tensor, caches):
            return encdec_mod.encdec_decode(params, cfg, token, caches)
        return decode

    @torch.no_grad()
    def decode(params: LM, token: torch.Tensor, caches):
        pos = _cache_pos(caches)
        B = token.shape[0]
        positions = pos.reshape(-1, 1).expand(B, 1)  # scalar or [B] pos
        logits, caches, _, _ = transformer_mod.forward(
            params, cfg, token, positions=positions, mode="decode",
            caches=caches)
        return logits, caches
    return decode


def _layer_caches(caches):
    """``(stacked, LayerCache)`` for every layer cache of the tree; a
    stacked cache's tensors carry a leading layer dim before the batch
    dim."""
    for stack in caches:
        if isinstance(stack, LayerCache):
            yield True, stack
        else:
            for lc in stack:
                yield False, lc


def _kv_caches(caches):
    """``(stacked, KVCache)`` for every KV cache of the tree."""
    for stacked, lc in _layer_caches(caches):
        if lc.kv is not None:
            yield stacked, lc.kv


def _cache_pos(caches) -> torch.Tensor:
    """Current length (scalar, or one a row): the first KV cache's, or 0
    when there is none (an SSM model's decode needs no position, as the
    reference's ``_cache_pos`` returns 0)."""
    for stacked, kv in _kv_caches(caches):
        return kv.pos[0] if stacked else kv.pos
    _, lc = next(_layer_caches(caches))
    return torch.zeros((), dtype=torch.int32, device=lc.ssm.state.device)


def init_caches(cfg: ModelConfig, batch: int, s_max: int, device=None):
    if cfg.encdec:
        return encdec_mod.init_dec_cache(cfg, batch, s_max, device)
    return transformer_mod.init_cache(cfg, batch, s_max, device)


# ======================================================================
@torch.no_grad()
def generate(params, cfg: ModelConfig, prompt, max_new: int,
             s_max: Optional[int] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             features=None) -> np.ndarray:
    """Greedy (or, with ``temperature > 0`` and a ``generator``, sampled)
    decoding of ``prompt`` [B, S]: returns [B, S + max_new] on the host.
    An encoder-decoder takes its encoder's input as ``features`` [B,
    enc_seq, D]."""
    dev = params.embed.device
    prompt = torch.as_tensor(prompt, device=dev)
    B, S = prompt.shape
    caches = init_caches(cfg, B, s_max or (S + max_new), dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    batch = {"tokens": prompt}
    if cfg.encdec:
        batch["features"] = torch.as_tensor(features, device=dev)
    logits, caches = prefill(params, batch, caches)
    tok = _sample(logits[:, -1], temperature, generator)[:, None]  # [B, 1]
    out = [tok]
    for _ in range(max_new - 1):
        logits, caches = decode(params, tok, caches)
        tok = _sample(logits[:, -1], temperature, generator)[:, None]
        out.append(tok)
    return torch.cat([prompt] + [o.to(prompt.dtype) for o in out],
                     dim=1).cpu().numpy()


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


# ======================================================================
class Request(NamedTuple):
    rid: int
    prompt: np.ndarray  # [S]
    max_new: int


class SlotServer:
    """Minimal continuous batching: fixed decode batch, greedy slot refill.

    A fixed-capacity slot buffer with backpressure (requests queue until
    a slot frees).  ``max_queue`` bounds the wait queue itself: submit
    past it raises :class:`QueueFullError` (None keeps it unbounded).
    Each slot keeps its own cache position, so prompts may differ in
    length and a slot may be refilled while the others are mid-decode;
    a free slot's position is held at 0."""

    def __init__(self, params: LM, cfg: ModelConfig, num_slots: int,
                 s_max: int, max_queue: Optional[int] = None):
        self.params, self.cfg = params, cfg
        self.device = params.embed.device
        self.num_slots, self.s_max = num_slots, s_max
        self.max_queue = max_queue
        self.caches = _slot_positions(
            init_caches(cfg, num_slots, s_max, self.device), num_slots)
        self.prefill = make_prefill_step(cfg)
        self.decode = make_decode_step(cfg)
        self.queue: list[Request] = []
        self.active: dict[int, dict] = {}  # slot -> {rid, remaining, tokens}
        self.cur = torch.zeros((num_slots, 1), dtype=torch.int64,
                               device=self.device)
        self.done: dict[int, np.ndarray] = {}
        self.rejected = 0

    def submit(self, req: Request):
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.rejected += 1
            raise QueueFullError(self.max_queue)
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.num_slots):
            while slot not in self.active and self.queue:
                req = self.queue.pop(0)
                # per-slot prefill (batch of 1), copied into the slot's rows
                prompt = torch.as_tensor(req.prompt, device=self.device)[None]
                caches1 = init_caches(self.cfg, 1, self.s_max, self.device)
                logits, caches1 = self.prefill(self.params,
                                               {"tokens": prompt}, caches1)
                _write_slot(self.caches, caches1, slot)
                tok = int(torch.argmax(logits[0, -1]))
                if req.max_new <= 1:  # done at its first token
                    self.done[req.rid] = np.array([tok])
                    continue
                self.cur[slot, 0] = tok
                self.active[slot] = {"rid": req.rid,
                                     "remaining": req.max_new - 1,
                                     "tokens": [tok]}

    @torch.no_grad()
    def step(self):
        self._admit()
        if not self.active:
            return
        logits, self.caches = self.decode(self.params, self.cur, self.caches)
        nxt = torch.argmax(logits[:, -1], dim=-1)
        host = nxt.cpu().numpy()
        for slot in list(self.active):
            st = self.active[slot]
            st["tokens"].append(int(host[slot]))
            st["remaining"] -= 1
            if st["remaining"] <= 0:
                self.done[st["rid"]] = np.array(st["tokens"])
                del self.active[slot]
        self.cur = nxt[:, None]
        free = [s for s in range(self.num_slots) if s not in self.active]
        if free:
            for _, kv in _kv_caches(self.caches):
                kv.pos[..., free] = 0

    def run(self):
        while self.queue or self.active:
            self.step()
        return self.done


def _write_slot(full_tree, one_tree, slot: int) -> None:
    """Copy a batch-of-1 cache into row ``slot`` of the slot server's
    caches, in place: every K/V tensor's row (MLA's packed one) and the
    slot's position, the
    SSD state's and conv's rows (the batch dim follows a stacked cache's
    layer dim)."""
    for (stacked, full), (_, one) in zip(_layer_caches(full_tree),
                                         _layer_caches(one_tree)):
        b = 1 if stacked else 0
        if full.kv is not None:
            for f, o in zip(full.kv[:2], one.kv[:2]):
                if f is not None:  # (MLA's v is None)
                    f.select(b, slot).copy_(o.select(b, 0))
            full.kv.pos.select(b, slot).copy_(one.kv.pos)
        if full.ssm is not None:
            for f, o in zip(full.ssm, one.ssm):
                f.select(b, slot).copy_(o.select(b, 0))


def _slot_positions(caches, num_slots: int):
    """The cache tree with one position a slot: a KV cache's ``pos``
    becomes ``[L, num_slots]`` in a stacked cache, ``[num_slots]`` in a
    layer's."""
    def per_slot(lc):
        if lc.kv is None:
            return lc
        return lc._replace(kv=lc.kv._replace(pos=torch.zeros(
            lc.kv.pos.shape + (num_slots,), dtype=torch.int32,
            device=lc.kv.pos.device)))
    return tuple(
        per_slot(stack) if isinstance(stack, LayerCache)
        else tuple(per_slot(lc) for lc in stack)
        for stack in caches)
