"""Continuous-batching GPT serving engine (iteration-level scheduling).

Counterpart of ``summer_clip_tpu/engine/serving.py``. Where the batched sampler
(``apps.gen_gpt.generate_device_batched``) admits a fixed prompt list and
drains it, here requests are admitted into free batch slots mid-decode:

- every iteration advances every slot by exactly one token ((B, 1) shapes);
- per-slot KV rings through the cache's per-row ``index``
  (``models/gpt2.py``): admitting a request resets only that slot's index --
  stale rows beyond it are causally masked, so slot reuse costs no zeroing;
- prompt prefill is chunked: an admitted prompt runs through one batched
  (B, bucket) forward (left-padded, per-row positions, a per-slot key-pad);
  decoding batch-mates stall for that call and their rings are rolled back on
  the host (the junk rows they wrote lie beyond the restored index).
  ``prefill_chunk=False`` falls back to token-per-step prefill;
- sampling (temperature, top-k, nucleus) happens on the device; a burst of
  ``burst`` iterations, and ``pipeline`` bursts chained, run without a
  read-back; wave dispatch folds a batched admission prefill and chains that
  run to the largest remaining budget (rows retire on the device through
  ``rem``) into one fetch; with no ``eot_id`` a drain fetches only once, at its
  end (:meth:`ContinuousBatcher.run`);
- ``megakernel=True``: each iteration runs the whole block stack for all slots
  in one launch of K8 (``ops/decode_block``) over int8 rings.

Where the JAX package dispatches a jitted ``lax.scan``, a burst here is a
Python loop of n steps that enqueues work and fetches nothing: ``feed``, the
ring index, ``rem``, ``active`` and ``key_pad`` stay device tensors across
chained bursts. One ``torch.Generator`` on the model's device is consumed once
a step, so a burst of n steps draws what n single steps draw.

Determinism: with ``top_k=1`` or ``greedy=True`` a request's output does not
depend on what shares the batch or how prefill is chunked, and equals
``gen_gpt.generate_device`` on the same model wherever a row's arithmetic does
not depend on its companions (the kernels' rows do not; see PERF.md for the
wide prefill on the card). The tensor-parallel arms are not ported: ``mesh``
raises ``NotImplementedError`` (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

from summer_clip_torch.engine.quant import quant_head_table, quantize_tree
from summer_clip_torch.models import gpt2 as gpt2_mod
from summer_clip_torch.ops import decode_block as DB
from summer_clip_torch.ops.gemv import qdot

__all__ = ["ContinuousBatcher", "Request"]

Pick = tp.Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class Request:
    uid: int
    prompt_ids: tp.List[int]
    max_new_tokens: int
    out_ids: tp.List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    req: tp.Optional[Request] = None
    fed: int = 0          # prompt tokens fed so far
    generated: int = 0    # sampled tokens kept so far

    @property
    def free(self) -> bool:
        return self.req is None


def _last_logits(out: tp.Mapping[str, tp.Any], head_table) -> torch.Tensor:
    """Last-position logits: in-model when ``head_table`` is None, else off the
    hoisted int8 table (decode-shaped reads stream it through K7)."""
    if head_table is None:
        return out["logits"][:, -1, :]
    return qdot(out["hidden"][:, -1, :], head_table, torch.float32)


def _forward(model, tokens, pos, cache, key_pad, head_table):
    return model(tokens, position_offset=pos[:, None], cache=cache, key_pad=key_pad,
                 compute_logits=head_table is None)


@torch.inference_mode()
def _engine_step(model, cache, tokens, pos, key_pad, head_table, pick: Pick):
    """One engine iteration: every slot advances one token. ``tokens`` (B,)
    this iteration's input per slot, ``pos`` (B,) its position."""
    out = _forward(model, tokens[:, None], pos, cache, key_pad, head_table)
    return out["cache"], pick(_last_logits(out, head_table))


@torch.inference_mode()
def _engine_burst(model, cache, feed0, pos0, active, rem, key_pad, n: int, head_table, pick: Pick):
    """``n`` decode iterations with no read-back (an admission-free window).

    ``active`` rows feed their previous sample while rows free at burst start
    keep feeding their token at a frozen position, and the KV index advances
    inside the cache. ``rem`` (B,) is each row's remaining budget at burst
    start: a row is live while ``i < rem[b]``; after that its feed token and
    position freeze and what it emits is junk the host discards, which lets a
    chain run to the largest remaining budget. While live, emitted ids are what
    ``n`` single steps emit. Returns (cache, tokens (n, B), feed), all on the
    device, so that a chained burst starts from ``feed`` unfetched."""
    feed, toks = feed0, []
    for i in range(n):
        live = active & (rem > i)
        pos = torch.where(active, pos0 + rem.clamp(max=i), pos0)
        out = _forward(model, feed[:, None], pos, cache, key_pad, head_table)
        cache = out["cache"]
        nxt = pick(_last_logits(out, head_table))
        feed = torch.where(live, nxt, feed)
        toks.append(nxt)
    return cache, torch.stack(toks), feed


@torch.inference_mode()
def _mega_prefill_step(model, mega_kv, tokens, offs, key_pad, admit_mask, head_table,
                       pick: Pick):
    """Batched admission prefill for megakernel serving: the standard wide
    forward runs into a fresh short cache, and only the admitted rows' K/V are
    quantised and merged into the engine's rings (in place, masked: the other
    rows' junk never touches the rings, so this prefill needs neither a ring
    rollback nor the clamp guard)."""
    batch, length = tokens.shape
    cache = model.init_cache(batch, length)
    index = torch.zeros(batch, dtype=torch.long, device=tokens.device)
    for layer in cache:
        layer["index"] = index
    out = _forward(model, tokens, offs, cache, key_pad, head_table)
    mask = admit_mask[None, :, None, None]
    for name in ("k", "v"):
        new = torch.stack([c[name] for c in out["cache"]]).to(torch.float32)   # (L, B, lb, D)
        q, s = DB._quant_rows(new, mega_kv[name].dtype)
        for key, val in ((name, q), (name + "s", s)):
            ring = mega_kv[key][:, :, :length]
            ring.copy_(torch.where(mask, val, ring))
    return mega_kv, pick(_last_logits(out, head_table))


@torch.inference_mode()
def _mega_burst(model, packed, kv, feed0, pos0, idx0, active, rem, key_pad, n: int, head_table,
                pick: Pick):
    """``n`` megakernel decode iterations with no read-back: each runs the
    whole block stack for all B slots in one launch of K8, so the int8 weight
    read is shared by the slots. Scheduling as in :func:`_engine_burst`; the KV
    state is the engine's per-stream rings, written in place, and the ring
    indices advance on the device. Every slot's ring advances, free or retired
    (junk writes clamp; admission resets the ring)."""
    lnf = model.core.ln_f
    t = kv["k"].shape[2]
    feed, idx, toks = feed0, idx0, []
    for i in range(n):
        live = active & (rem > i)
        pos = torch.where(active, pos0 + rem.clamp(max=i), pos0)
        x = gpt2_mod.decode_inputs(model, feed, pos)
        y, kq, vq, ksn, vsn = DB.decode_block(x, packed, kv, idx, nh=model.config.n_head,
                                              pad=key_pad)
        DB.mega_update_kv(kv, kq, vq, ksn, vsn, idx)
        h = DB._ln_rows(y, lnf.scale[None], lnf.bias[None])
        nxt = pick(qdot(h, head_table, torch.float32))
        feed = torch.where(live, nxt, feed)
        idx = (idx + 1).clamp(max=t)
        toks.append(nxt)
    return kv, torch.stack(toks), feed, idx


class ContinuousBatcher:
    """Iteration-level batched decode over ``batch_slots`` concurrent slots.

    Usage::

        eng = ContinuousBatcher(model, batch_slots=4, max_len=96)
        eng.submit([ids...], max_new_tokens=20)
        while eng.pending:
            for req in eng.step():
                ... req.out_ids ...

    ``quant_int8``: the engine quantises ``model``'s tree and reads logits off
    an int8 head table built once. ``generator``: a ``torch.Generator`` on the
    model's device (seed 0 if none)."""

    PREFILL_BUCKET = 16

    def __init__(self, model, *, batch_slots: int = 8, max_len: tp.Optional[int] = None,
                 temperature: float = 1.0, top_k: int = 50, greedy: bool = False,
                 top_p: float = 1.0, eot_id: tp.Optional[int] = None,
                 generator: tp.Optional[torch.Generator] = None, prefill_chunk: bool = True,
                 quant_int8: bool = False, burst: int = 8, pipeline: int = 4, wave: bool = True,
                 megakernel: bool = False, mesh=None):
        if mesh is not None:
            raise NotImplementedError("tensor-parallel serving (mesh) is not ported yet: "
                                      "ROADMAP Queue 1 item 11")
        self._head_table = None
        if quant_int8:
            model = model.with_tree(quantize_tree(model.tree())).eval()
            # hoisted once per engine: every step reads its logits off this
            # int8 table instead of running the model's head again
            self._head_table = quant_head_table(model)
        self.model = model
        self.device = model.core.ln_f.scale.device
        self.quant_int8 = bool(quant_int8)
        self.B = int(batch_slots)
        self.max_len = int(max_len or model.config.n_positions)
        if self.max_len > model.config.n_positions:
            raise ValueError(f"max_len {self.max_len} exceeds the model's "
                             f"{model.config.n_positions} positions")
        self.temperature = max(float(temperature), 1e-6)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.greedy = bool(greedy)
        self.eot_id = eot_id
        self.prefill_chunk = bool(prefill_chunk)
        # admission-free windows run up to `burst` iterations without a
        # read-back; 1 = a fetch every step
        self.burst = max(int(burst), 1)
        # up to `pipeline` bursts chain per host visit: the feed token stays on
        # the device between them and the whole token block is fetched once
        self.pipeline = max(int(pipeline), 1)
        # wave dispatch: per host visit one batched prefill admits every queued
        # request into the free slots, chained bursts carry per-row budgets,
        # and the prefill's first tokens and all chain tokens come back in one
        # fetch
        self.wave = bool(wave)
        from summer_clip_torch.apps.gen_gpt import _generator_for

        self._generator = _generator_for(generator, self.device)
        self._slots = [_Slot() for _ in range(self.B)]
        self._queue: tp.List[Request] = []
        self._next_uid = 0
        self.megakernel = bool(megakernel)
        self._cache = None
        if self.megakernel:
            mcfg = model.config
            if not self.quant_int8:
                raise ValueError("megakernel serving rides the stored-int8 tree "
                                 "(quant_int8=True); a bf16 store would demote the numerics")
            if not (self.wave and self.prefill_chunk and self.burst > 1):
                raise ValueError("megakernel serving is a wave-dispatch mode "
                                 "(wave=True, prefill_chunk=True, burst > 1)")
            if self.B > DB.MAX_STREAMS:
                raise ValueError(f"the megakernel carries at most {DB.MAX_STREAMS} streams; "
                                 f"batch_slots={self.B}")
            if not DB.mega_legal(mcfg.n_embd, 4 * mcfg.n_embd, mcfg.n_head):
                raise ValueError(f"the megakernel does not support {mcfg.name} geometry")
            self._packed = DB.pack_core_params(model.tree()["core"], mcfg.n_layer, store="int8")
            self._mega_kv = DB.init_mega_kv(mcfg.n_layer, mcfg.n_embd, self.max_len, torch.int8,
                                            batch=self.B, device=self.device)
        else:
            self._cache = model.init_cache(self.B, self.max_len)
        # host mirrors of per-slot device state (the ring index is
        # authoritative here and stamped into the cache before every dispatch:
        # that is what makes prefill rollback a host-side no-op)
        self._ring = np.zeros(self.B, np.int64)
        self._key_pad = np.zeros(self.B, np.int64)
        self._positions = np.zeros(self.B, np.int64)   # next position per slot
        self._last_sample = np.zeros(self.B, np.int64)
        # deferred-fetch drain state (run() with no eot_id): waves dispatch
        # back to back with the feed token carried on the device; token blocks
        # pile up unfetched and are fetched once at the end
        self._defer = False
        self._deferred: tp.List[dict] = []
        self._feed_dev: tp.Optional[torch.Tensor] = None

    # -- client API -----------------------------------------------------------

    def submit(self, prompt_ids: tp.Sequence[int], max_new_tokens: int = 20) -> Request:
        if len(prompt_ids) <= 0:
            raise ValueError("empty prompt")
        # capacity is the raw need; if the prefill bucket does not fit as well,
        # admission falls back to token-per-step prefill for that request
        if len(prompt_ids) + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {len(prompt_ids)} + max_new {max_new_tokens} exceeds "
                             f"engine max_len {self.max_len}")
        if self.megakernel:
            # no token-per-step fallback in megakernel mode: the bucketed
            # prefill itself must fit
            lb = -(-len(prompt_ids) // self.PREFILL_BUCKET) * self.PREFILL_BUCKET
            if lb + max_new_tokens > self.max_len:
                raise ValueError(f"megakernel serving admits via the {self.PREFILL_BUCKET}-"
                                 f"bucketed prefill: bucket {lb} + max_new {max_new_tokens} "
                                 f"exceeds engine max_len {self.max_len}")
        req = Request(self._next_uid, [int(i) for i in prompt_ids], int(max_new_tokens))
        self._next_uid += 1
        self._queue.append(req)
        return req

    @property
    def pending(self) -> bool:
        return bool(self._queue) or any(not s.free for s in self._slots)

    def run(self) -> tp.List[Request]:
        """Drain everything submitted; returns finished requests in completion
        order.

        With no ``eot_id`` the drain defers its fetches: token values cannot
        affect scheduling (only budgets retire rows), so waves dispatch back to
        back with the feed carried on the device and nothing is fetched until
        one flush at the end. With ``eot_id`` set, scheduling depends on the
        data and the engine keeps one fetch per wave."""
        done: tp.List[Request] = []
        self._defer = self.wave and self.eot_id is None
        try:
            while self.pending:
                done.extend(self.step())
        finally:
            if self._defer or self._deferred:
                self._exit_defer()
        return done

    # -- engine internals -----------------------------------------------------

    def _dev(self, array, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), dtype=dtype, device=self.device)

    def _pick(self, last: torch.Tensor) -> torch.Tensor:
        if self.greedy:
            return last.argmax(dim=-1)
        from summer_clip_torch.apps.gen_gpt import _sample_next

        return _sample_next(last / self.temperature, self._generator, self.top_k, self.top_p)

    def _stamped_cache(self):
        idx = self._dev(self._ring)
        for layer in self._cache:
            layer["index"] = idx
        return self._cache

    def _finish_token(self, b: int, tok: int) -> tp.Optional[Request]:
        """Record a sampled token for slot b; return the request if done."""
        slot = self._slots[b]
        req = slot.req
        self._last_sample[b] = tok
        req.out_ids.append(tok)
        slot.generated += 1
        if ((self.eot_id is not None and tok == self.eot_id)
                or slot.generated >= req.max_new_tokens):
            req.done = True
            self._slots[b] = _Slot()
            return req
        return None

    def _bucket(self, n: int) -> int:
        return -(-n // self.PREFILL_BUCKET) * self.PREFILL_BUCKET

    def _chunk_prefill(self, b: int, req: Request) -> tp.Union[None, str, Request]:
        """One-call prompt prefill for slot b (left-padded bucket)."""
        n_prompt = len(req.prompt_ids)
        lb = self._bucket(n_prompt)
        pad = lb - n_prompt
        if lb + req.max_new_tokens > self.max_len:
            return "fallback"   # the bucket does not fit
        # the batched junk write must not clamp into an active row's real
        # history near capacity
        for ob, s in enumerate(self._slots):
            if ob != b and not s.free and self._ring[ob] + lb > self.max_len:
                return "fallback"
        tokens = np.zeros((self.B, lb), np.int64)
        tokens[b, pad:] = req.prompt_ids
        offs = np.zeros(self.B, np.int64)
        offs[b] = -pad
        self._ring[b] = 0
        self._key_pad[b] = pad
        self._positions[b] = 0
        ring_before = self._ring.copy()
        with torch.inference_mode():
            out = _forward(self.model, self._dev(tokens), self._dev(offs), self._stamped_cache(),
                           self._dev(self._key_pad), self._head_table)
            self._cache, nxt = out["cache"], self._pick(_last_logits(out, self._head_table))
        # every other row's ring rolls back (their lb junk rows lie beyond the
        # restored index); slot b keeps its lb
        self._ring = ring_before
        self._ring[b] = lb
        self._positions[b] = n_prompt
        self._slots[b].fed = n_prompt
        return self._finish_token(b, int(nxt[b]))

    def _admit(self) -> tp.List[Request]:
        finished: tp.List[Request] = []
        for b, slot in enumerate(self._slots):
            if not slot.free or not self._queue:
                continue
            req = self._queue.pop(0)
            self._slots[b] = _Slot(req=req, fed=0, generated=0)
            self._ring[b] = 0
            self._key_pad[b] = 0
            self._positions[b] = 0
            if self.prefill_chunk and len(req.prompt_ids) > 1:
                out = self._chunk_prefill(b, req)
                if out == "fallback":
                    continue   # token-by-token prefill via step()
                if out is not None:
                    finished.append(out)
        return finished

    def _burst_len(self, safe: int) -> int:
        """Iterations to dispatch with no host visit: bounded by the burst knob
        and by ``safe`` (:meth:`_safe_iters`). A non-empty queue does not block
        a burst: ``_admit`` just ran, so a backlog means every slot is busy.
        Where bursts chain, a request that retires mid-chain through ``eot_id``
        delays the next admission, and decodes junk that is dropped, for up to
        ``burst * pipeline - 1`` iterations. Greedy outputs are the same per
        request regardless; sampled streams under a backlog depend on admission
        timing (the generator is consumed once an iteration)."""
        return 1 if self.burst <= 1 else min(self.burst, safe)

    def _safe_iters(self, active: tp.List[int]) -> int:
        """Iterations dispatchable with no host visit, uncapped by the burst
        knob: the least remaining budget and KV capacity over the active rows
        (1 while any row is still prefilling: prefill feeds are host data)."""
        n = 1 << 30
        for b in active:
            slot = self._slots[b]
            if slot.fed < len(slot.req.prompt_ids):
                return 1
            n = min(n, slot.req.max_new_tokens - slot.generated)
            n = min(n, self.max_len - int(self._ring[b]))
        return max(n, 1)

    def _dispatch_burst(self, active: tp.List[int], n: int, tokens, safe: int,
                        prefill_nxt: tp.Optional[torch.Tensor] = None,
                        admitted: tp.Sequence[int] = (),
                        chains: tp.Optional[int] = None) -> tp.List[Request]:
        """Dispatch ``chains`` back-to-back bursts of ``n`` iterations and
        fetch their tokens once. Between bursts the feed token and the ring
        index live on the device, so chaining only enqueues work; the emitted
        ids are what n * chains single steps emit.

        Wave mode (``prefill_nxt`` set): rows in ``admitted`` seed their feed
        from the first sampled token of the batched admission prefill, still on
        the device, and the prefill's fetch is folded into this dispatch's.
        Each row carries its remaining budget into the burst, so the chain
        length is bounded by the largest remaining budget (and capacity), not
        the least; rows out of budget freeze on the device and their tail is
        junk dropped here."""
        rem = np.zeros(self.B, np.int64)
        for b in active:
            slot = self._slots[b]
            rem[b] = slot.req.max_new_tokens - slot.generated
        for b in admitted:
            rem[b] -= 1   # the pending prefill token spends one unit of budget
        if chains is None:
            chains = 1
            if self.pipeline > 1 and n == self.burst:
                chains = max(1, min(self.pipeline, safe // n))
        mask = np.zeros(self.B, bool)
        mask[active] = True
        mask_dev = self._dev(mask, torch.bool)
        rem_dev = self._dev(rem)
        base_pos = self._dev(self._positions)
        key_pad = self._dev(self._key_pad)
        feed = tokens if isinstance(tokens, torch.Tensor) else self._dev(tokens)
        if prefill_nxt is not None:
            amask = np.zeros(self.B, bool)
            amask[list(admitted)] = True
            feed = torch.where(self._dev(amask, torch.bool), prefill_nxt, feed)
        if self.megakernel:
            kv, idx_dev = self._mega_kv, self._dev(self._ring)
        else:
            cache = self._stamped_cache()
        parts = []
        for k in range(chains):
            done_k = rem_dev.clamp(max=k * n)      # live iterations so far
            pos_k = torch.where(mask_dev, base_pos + done_k, base_pos)
            rem_k = torch.where(mask_dev, rem_dev - done_k, 0)
            if self.megakernel:
                kv, toks, feed, idx_dev = _mega_burst(
                    self.model, self._packed, kv, feed, pos_k, idx_dev, mask_dev, rem_k, key_pad,
                    n, self._head_table, self._pick)
            else:
                cache, toks, feed = _engine_burst(
                    self.model, cache, feed, pos_k, mask_dev, rem_k, key_pad, n,
                    self._head_table, self._pick)
            parts.append(toks)
        if not self.megakernel:
            self._cache = cache
        blocks = parts[0] if chains == 1 else torch.cat(parts, dim=0)
        if prefill_nxt is not None:   # one fetch for the prefill and all chains
            blocks = torch.cat([prefill_nxt[None], blocks], dim=0)
        total = n * chains
        self._ring += total
        if self._defer:
            # deferred-fetch drain: the block stays on the device, the feed
            # carries to the next wave there, and retirement is host arithmetic
            self._feed_dev = feed
            self._deferred.append({
                "blocks": blocks, "active": list(active), "admitted": list(admitted),
                "rem": rem.copy(), "total": total, "has_prefill": prefill_nxt is not None,
                "reqs": {b: self._slots[b].req for b in set(active) | set(admitted)}})
            return self._retire_budget(active, admitted, rem, total,
                                       prefill=prefill_nxt is not None)
        toks = blocks.cpu().numpy()
        finished: tp.List[Request] = []
        if prefill_nxt is not None:
            toks, pre = toks[1:], toks[0]
            for b in admitted:   # the prefill's sampled token precedes the chain
                done = self._finish_token(b, int(pre[b]))
                if done is not None:
                    finished.append(done)
        for b in active:
            self._positions[b] += min(total, int(rem[b]))
            if self._slots[b].free:   # retired by its own prefill token
                continue
            for i in range(total):
                done = self._finish_token(b, int(toks[i, b]))
                if done is not None:   # burst tokens after eot or the budget are junk
                    finished.append(done)
                    break
        return finished

    def _retire_budget(self, active, admitted, rem, total, *, prefill: bool) -> tp.List[Request]:
        """Deferred-mode retirement: with no ``eot_id`` a slot's life depends
        on budgets only, so requests retire on host arithmetic while their
        tokens are still in flight (``out_ids`` fill at the flush). Mirrors the
        arithmetic of :meth:`_finish_token`."""
        finished: tp.List[Request] = []
        if prefill:
            for b in admitted:
                slot = self._slots[b]
                slot.generated += 1
                if slot.generated >= slot.req.max_new_tokens:
                    slot.req.done = True
                    finished.append(slot.req)
                    self._slots[b] = _Slot()
        for b in active:
            self._positions[b] += min(total, int(rem[b]))
            slot = self._slots[b]
            if slot.free:   # retired by its own prefill token
                continue
            slot.generated += min(total, int(rem[b]))
            if slot.generated >= slot.req.max_new_tokens:
                slot.req.done = True
                finished.append(slot.req)
                self._slots[b] = _Slot()
        return finished

    def _flush_deferred(self) -> None:
        """Fetch every deferred wave's token block and fill ``out_ids`` in the
        order the fetching path would have (prefill token first, then each
        active row's kept chain tokens)."""
        for rec in self._deferred:
            toks = rec["blocks"].cpu().numpy()
            if rec["has_prefill"]:
                pre, toks = toks[0], toks[1:]
                for b in rec["admitted"]:
                    rec["reqs"][b].out_ids.append(int(pre[b]))
            for b in rec["active"]:
                req = rec["reqs"][b]
                for i in range(min(rec["total"], int(rec["rem"][b]))):
                    req.out_ids.append(int(toks[i, b]))
        self._deferred = []

    def _exit_defer(self) -> None:
        """Leave deferred mode mid-run (legacy fallback, or the end of
        :meth:`run`): flush the blocks and restore the host state that the
        fetching dispatch needs."""
        self._flush_deferred()
        self._defer = False
        self._feed_dev = None
        for b, slot in enumerate(self._slots):
            if not slot.free and slot.req.out_ids:
                self._last_sample[b] = slot.req.out_ids[-1]

    def _prefill_wave(self, admit: tp.Sequence[tp.Tuple[int, Request]], lb: int) -> torch.Tensor:
        """Batched multi-slot admission prefill: every (slot, request) pair
        rides one (B, lb) forward (per-row offsets and key-pads keep the rows
        independent), and the (B,) vector of first sampled tokens is returned on
        the device: the wave's burst chain seeds from it."""
        tokens = np.zeros((self.B, lb), np.int64)
        offs = np.zeros(self.B, np.int64)
        for b, req in admit:
            n_prompt = len(req.prompt_ids)
            pad = lb - n_prompt
            tokens[b, pad:] = req.prompt_ids
            offs[b] = -pad
            self._slots[b] = _Slot(req=req, fed=n_prompt, generated=0)
            self._ring[b] = 0
            self._key_pad[b] = pad
            self._positions[b] = 0
        ring_before = self._ring.copy()
        if self.megakernel:
            amask = np.zeros(self.B, bool)
            for b, _ in admit:
                amask[b] = True
            self._mega_kv, nxt = _mega_prefill_step(
                self.model, self._mega_kv, self._dev(tokens), self._dev(offs),
                self._dev(self._key_pad), self._dev(amask, torch.bool), self._head_table,
                self._pick)
        else:
            with torch.inference_mode():
                out = _forward(self.model, self._dev(tokens), self._dev(offs),
                               self._stamped_cache(), self._dev(self._key_pad), self._head_table)
                self._cache, nxt = out["cache"], self._pick(_last_logits(out, self._head_table))
        # the other rows' lb junk rows roll back (megakernel mode never wrote them)
        self._ring = ring_before
        for b, req in admit:
            self._ring[b] = lb
            self._positions[b] = len(req.prompt_ids)
        return nxt

    def _step_wave(self) -> tp.Optional[tp.List[Request]]:
        """Wave dispatch: batched admission prefill, rem-masked burst chains
        and one fetch for the whole window. Returns None when a precondition
        fails; :meth:`step` then takes the legacy per-slot path."""
        if not (self.prefill_chunk and self.burst > 1):
            return None
        for s in self._slots:
            if not s.free and s.fed < len(s.req.prompt_ids):
                return None   # mid token-wise prefill: the host feeds each token
        free = [b for b, s in enumerate(self._slots) if s.free]
        n_adm = min(len(free), len(self._queue))
        admit = list(zip(free, self._queue[:n_adm]))
        if admit and self.megakernel:
            # no legacy fallback in megakernel mode: defer the queue tail whose
            # batch-mates' shared bucket would not fit (each request's own
            # bucket fits by submit's check, so the head of the queue always
            # admits)
            kept: tp.List[tp.Tuple[int, Request]] = []
            for b, r in admit:
                trial = kept + [(b, r)]
                lb_t = max(self._bucket(len(x.prompt_ids)) for _, x in trial)
                if any(lb_t + x.max_new_tokens > self.max_len for _, x in trial):
                    break   # keep queue order; retry next wave
                kept.append((b, r))
            admit, n_adm = kept, len(kept)
        prefill_nxt = None
        admitted: tp.List[int] = []
        if admit:
            lb = max(self._bucket(len(r.prompt_ids)) for _, r in admit)
            if not self.megakernel:
                if any(lb + r.max_new_tokens > self.max_len for _, r in admit):
                    return None   # the shared bucket does not fit someone
                for ob, s in enumerate(self._slots):
                    if not s.free and self._ring[ob] + lb > self.max_len:
                        return None   # a junk write would clamp into real history
            del self._queue[:n_adm]
            admitted = [b for b, _ in admit]
            prefill_nxt = self._prefill_wave(admit, lb)
        active = [b for b, s in enumerate(self._slots) if not s.free]
        if not active:
            return []
        adm_set = set(admitted)
        rem_max = max(self._slots[b].req.max_new_tokens - self._slots[b].generated
                      - (b in adm_set) for b in active)
        if rem_max <= 0:   # every active row retires on its prefill token
            if self._defer:
                self._deferred.append({
                    "blocks": prefill_nxt[None], "active": [], "admitted": admitted,
                    "rem": np.zeros(self.B, np.int64), "total": 0, "has_prefill": True,
                    "reqs": {b: self._slots[b].req for b in admitted}})
                return self._retire_budget([], admitted, np.zeros(self.B, np.int64), 0,
                                           prefill=True)
            pre = prefill_nxt.cpu().numpy()
            finished = []
            for b in admitted:
                done = self._finish_token(b, int(pre[b]))
                if done is not None:
                    finished.append(done)
            return finished
        if self._defer and self._feed_dev is not None:
            # the feed never visits the host between waves: decode rows go on
            # from the token carried on the device, admitted rows are
            # overridden from prefill_nxt inside the dispatch
            tokens = self._feed_dev
        else:
            tokens = np.zeros(self.B, np.int64)
            for b in active:
                if b not in adm_set:
                    tokens[b] = self._last_sample[b]   # admitted rows seed on the device
        n = self.burst
        chains = max(1, min(self.pipeline, -(-rem_max // n)))
        return self._dispatch_burst(active, n, tokens, rem_max, prefill_nxt=prefill_nxt,
                                    admitted=admitted, chains=chains)

    def step(self) -> tp.List[Request]:
        """One iteration: every active slot advances one token (an
        admission-free all-decode window advances up to ``burst`` tokens in one
        dispatch; with ``wave=True`` the window also folds the batched
        admission prefill and runs to the largest remaining budget). Returns
        the requests that finished (an admission prefill may finish a request
        of one new token at once)."""
        if self.wave:
            out = self._step_wave()
            if out is not None:
                return out
            if self._defer:
                # the legacy fallback needs host-side feed state: flush the
                # blocks in flight and finish this run with fetches
                self._exit_defer()
        if self.megakernel:
            raise RuntimeError("megakernel serving has no per-slot path; wave dispatch declined")
        finished = self._admit()
        active = [b for b, s in enumerate(self._slots) if not s.free]
        if not active:
            return finished

        tokens = np.zeros(self.B, np.int64)
        for b, slot in enumerate(self._slots):
            if slot.free:
                continue   # idle rows advance harmlessly (their slots rewind on admit)
            req = slot.req
            if slot.fed < len(req.prompt_ids):
                tokens[b] = req.prompt_ids[slot.fed]     # prefill feed
            else:
                tokens[b] = self._last_sample[b]          # decode feed

        safe = self._safe_iters(active)
        n = self._burst_len(safe)
        if n > 1:
            return finished + self._dispatch_burst(active, n, tokens, safe)

        self._cache, nxt = _engine_step(
            self.model, self._stamped_cache(), self._dev(tokens), self._dev(self._positions),
            self._dev(self._key_pad), self._head_table, self._pick)
        nxt = nxt.cpu().numpy()
        self._ring += 1

        for b, slot in enumerate(self._slots):
            if slot.free:
                continue
            self._positions[b] += 1
            if slot.fed < len(slot.req.prompt_ids):
                slot.fed += 1
                if slot.fed < len(slot.req.prompt_ids):
                    continue   # still prefilling; the sampled token is unused
            done = self._finish_token(b, int(nxt[b]))
            if done is not None:
                finished.append(done)
        return finished
