"""Speculative decoding: a small draft model proposes, the target verifies.

Counterpart of ``summer_clip_tpu/engine/speculative.py``. Decode reads every
parameter of the large model once a token, so beyond int8 weights the lever is
to share the large model's reads among several tokens: a cheap draft model (a
smaller ClipGPT over the same CLIP vocabulary) greedily proposes ``k`` tokens,
then the target scores all ``k + 1`` positions in one forward and accepts the
longest agreeing prefix (Leviathan et al. 2023, greedy case). Every iteration
emits between 1 and ``k + 1`` tokens for one target forward, and acceptance
only ever keeps tokens that the target itself would have produced.

KV-cache rollback: after a verify forward the cache index sits at ``L + k + 1``
even when only ``a < k`` drafts were accepted. Setting the index back to
``L + a + 1`` is enough: stale rows beyond the index are never attended before
they are overwritten (the port's cache is written in place and masked from its
``index``, ``models/gpt2.py``).

On int8 trees the draft steps (one row) and the verify forward (``k + 1 <= 8``
rows) are decode-shaped and stream through K7; each model's logits come off an
int8 head table built once before the loop.

Where the JAX package runs the whole loop as one ``lax.while_loop`` and fetches
once at the end, this loop reads one pair back per verify iteration (the
emitted count and the done flag), because how far the loop runs depends on the
data; the draft scan and the verify forward between two read-backs only enqueue
work.
"""

from __future__ import annotations

import typing as tp

import torch

from summer_clip_torch.engine.quant import quant_head_table
from summer_clip_torch.ops.gemv import qdot

__all__ = ["generate_device_speculative"]


def _logits(out: tp.Mapping[str, tp.Any], table) -> torch.Tensor:
    """(positions, vocab) logits of batch row 0."""
    if table is None:
        return out["logits"][0]
    return qdot(out["hidden"][0], table, torch.float32)


def _rollback(cache, new_index):
    return [dict(c, index=new_index) for c in cache]


@torch.inference_mode()
def generate_device_speculative(
        model, draft_model, prompt_ids: tp.Sequence[int], *, max_new_tokens: int = 20, k: int = 4,
        eot_id: tp.Optional[int] = None, quant_int8: bool = False,
        draft_quant_int8: bool = False, return_stats: bool = False,
) -> tp.Union[tp.List[int], tp.Tuple[tp.List[int], tp.Dict[str, int]]]:
    """Greedy decode with draft-model speculation.

    Returns what ``generate_device(..., top_k=1)`` on the target alone returns
    wherever a row's logits do not depend on how many positions share a
    forward (the draft changes the speed, never the accepted tokens' source:
    every emitted token is an argmax of the target). ``quant_int8`` /
    ``draft_quant_int8``: that model holds an int8 tree.

    ``k``: draft tokens proposed per verify step. With ``return_stats`` also
    ``{"verify_iters", "emitted"}``: target forwards in the loop, and tokens
    emitted (the ratio is what speculation exists to raise)."""
    if k < 1:
        raise ValueError("speculation needs at least one draft token")
    n_prompt = len(prompt_ids)
    need = n_prompt + max_new_tokens + k + 1
    for name, m in (("target", model), ("draft", draft_model)):
        if need > m.config.n_positions:
            raise ValueError(f"prompt {n_prompt} + max_new {max_new_tokens} + speculation margin "
                             f"{k + 1} exceeds the {name}'s {m.config.n_positions} positions")
    device = model.core.ln_f.scale.device
    eot = -1 if eot_id is None else int(eot_id)
    t_table = quant_head_table(model) if quant_int8 else None
    d_table = quant_head_table(draft_model) if draft_quant_int8 else None
    prompt = torch.tensor([list(prompt_ids)], dtype=torch.long, device=device)
    # prefill both models on the prompt; the target's last-position argmax is
    # the first certain token ("pending": decided, not yet consumed by either
    # cache). The draft keeps its prefilled cache, its prompt logits are unused.
    out = model(prompt, position_offset=0, cache=model.init_cache(1, need))
    dout = draft_model(prompt, position_offset=0, cache=draft_model.init_cache(1, need),
                       compute_logits=False)
    cache, dcache = out["cache"], dout["cache"]
    pending = out["logits"][0, -1, :].argmax()
    buf = torch.zeros(max_new_tokens + k + 1, dtype=torch.long, device=device)
    steps = torch.arange(k + 1, device=device)
    n, length, iters, done = 0, n_prompt, 0, False
    while not done and n < max_new_tokens:
        # draft: k + 1 greedy single-token steps. Feeding pending, d_1 .. d_k
        # advances the draft cache through position length + k, so a window
        # that is accepted whole needs no catch-up; d_{k+1} is dropped.
        tok, window = pending, []
        for j in range(k + 1):
            window.append(tok)
            o = draft_model(tok[None, None], position_offset=length + j, cache=dcache,
                            compute_logits=d_table is None)
            dcache = o["cache"]
            tok = _logits(o, d_table)[-1].argmax()
        window = torch.stack(window)      # [pending, d_1 .. d_k]: what the target must score
        # target: all k + 1 positions in one forward; preds[i] is its token for
        # position length + i + 1
        o = model(window[None], position_offset=length, cache=cache,
                  compute_logits=t_table is None)
        preds = _logits(o, t_table).argmax(dim=-1)
        match = (preds[:k] == window[1:]).to(torch.long)
        accepted = match.cumprod(dim=0).sum()
        pending = preds[accepted]         # the correction (a < k) or the bonus token (a == k)
        # emit window[: a + 1]; the next write overwrites the invalid tail
        buf[n:n + k + 1] = window
        hit_eot = ((window == eot) & (steps <= accepted)).any()
        a, done = (int(v) for v in torch.stack([accepted, hit_eot.to(torch.long)]).tolist())
        done = bool(done)
        n, length, iters = n + a + 1, length + a + 1, iters + 1
        cache, dcache = _rollback(o["cache"], length), _rollback(dcache, length)
    out_ids = [int(i) for i in prompt_ids]
    for t in buf[:min(n, max_new_tokens)].tolist():
        out_ids.append(int(t))
        if eot_id is not None and int(t) == eot_id:
            break
    if return_stats:
        return out_ids, {"verify_iters": iters, "emitted": n}
    return out_ids
