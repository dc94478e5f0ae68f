"""Universal-trigger search over masked/causal LMs.

Counterpart of ``summer_clip_tpu/sandbox/mlm_trigger.py`` (the reference's
vendored ucinlp/autoprompt, ``summer_clip/clip_prompt/autoprompt/``): find a
universal trigger-token sequence that steers an LM's predictions toward label
tokens.

- :class:`TriggerTemplate` splices trigger ids into a templated input at fixed
  slots and tracks the predict position;
- :func:`label_logprob` scores (multi-token) label ids at the predict position
  (``AccuracyFn`` semantics);
- :func:`hotflip_candidates` + :func:`trigger_search_step` implement the
  averaged-gradient HotFlip update over a candidate set. The slot is drawn from
  a numpy generator, so a seed draws the JAX package's slots.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

__all__ = ["TriggerTemplate", "label_logprob", "hotflip_candidates", "trigger_search_step"]


class TriggerTemplate:
    """Fixed-shape template with trigger slots.

    ``template_ids``: (T,) ints with -1 marking trigger slots and -2 the
    predict slot (filled with ``mask_id``).
    """

    def __init__(self, template_ids: tp.Sequence[int], mask_id: int = 0):
        t = np.asarray(template_ids, np.int64)
        self.trigger_slots = np.flatnonzero(t == -1)
        predict = np.flatnonzero(t == -2)
        if len(predict) != 1:
            raise ValueError("exactly one predict slot (-2) required")
        self.predict_pos = int(predict[0])
        base = t.copy()
        base[self.trigger_slots] = 0
        base[self.predict_pos] = mask_id
        self.base_ids = base.astype(np.int32)

    @property
    def trigger_len(self) -> int:
        return len(self.trigger_slots)

    def fill(self, trigger_ids: tp.Union[torch.Tensor, tp.Sequence[int]],
             batch_ids: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """Insert trigger ids, (1, T); broadcast to (B, T) over a batch of contexts."""
        ids = torch.as_tensor(self.base_ids, dtype=torch.long).clone()
        ids[torch.as_tensor(self.trigger_slots)] = torch.as_tensor(trigger_ids, dtype=torch.long).cpu()
        if batch_ids is None:
            return ids[None]
        return ids[None].expand(batch_ids.shape[0], ids.shape[0])


def label_logprob(logits_at_predict: torch.Tensor, label_ids: tp.Sequence[int]) -> torch.Tensor:
    """Mean log-prob over the label's (possibly multiple) token ids, per row."""
    logp = torch.log_softmax(logits_at_predict.float(), dim=-1)
    lab = torch.as_tensor(np.asarray(label_ids, np.int64), device=logp.device)
    return logp[:, lab].mean(dim=-1)


def hotflip_candidates(avg_grad: torch.Tensor, embedding_table: torch.Tensor,
                       num_cands: int) -> np.ndarray:
    """Top replacement candidates for one slot from the averaged gradient."""
    scores = -(embedding_table @ avg_grad.to(embedding_table))
    return torch.topk(scores, num_cands).indices.cpu().numpy()


def trigger_search_step(trigger_ids: tp.List[int],
                        grad_fn: tp.Callable[[np.ndarray], torch.Tensor],
                        score_fn: tp.Callable[[np.ndarray], float],
                        embedding_table: torch.Tensor, *,
                        num_cands: int = 10,
                        rng: tp.Optional[np.random.Generator] = None) -> tp.Dict[str, tp.Any]:
    """One HotFlip move on the trigger (maximize ``score_fn``), in place.

    ``grad_fn(trigger_ids) -> (L, D)`` gradient of the score with respect to
    the trigger embeddings; ``score_fn(trigger_ids) -> float`` evaluation
    score.
    """
    rng = rng or np.random.default_rng()
    slot = int(rng.integers(0, len(trigger_ids)))
    grads = torch.as_tensor(grad_fn(np.asarray(trigger_ids)))
    # maximize: flip the sign of the loss-minimizing formulation
    cands = hotflip_candidates(-grads[slot], embedding_table, num_cands)
    base_score = score_fn(np.asarray(trigger_ids))
    best = (base_score, trigger_ids[slot])
    for cand in cands:
        trial = list(trigger_ids)
        trial[slot] = int(cand)
        s = score_fn(np.asarray(trial))
        if s > best[0]:
            best = (s, int(cand))
    accepted = best[1] != trigger_ids[slot]
    if accepted:
        trigger_ids[slot] = best[1]
    return {"slot": slot, "accepted": accepted, "score": best[0], "base_score": base_score}
