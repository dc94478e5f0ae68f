"""AutoPrompt: discrete prompt search by HotFlip.

Counterpart of ``summer_clip_tpu/methods/autoprompt.py``:

- :func:`hotflip_attack` -- first-order candidate scoring, the top k of
  ``-(E @ grad)``;
- :class:`AutoPromptState` -- the discrete prompt (ids and their embeddings);
- :class:`TopPrompter` -- a bounded min-heap of the best-loss prompts;
- :func:`hotflip_step` -- one search move: pick a position, score candidates
  from the prompt-embedding gradient, evaluate them on fresh batches, accept
  the best greedily.

The gradient and the candidates' losses are closures that the trainer
supplies (one backward and many forwards through the frozen text tower); the
accept loop runs on the host, as in the JAX package.
"""

from __future__ import annotations

import heapq
import typing as tp

import numpy as np
import torch

__all__ = ["hotflip_attack", "AutoPromptState", "TopPrompter", "hotflip_step"]


def hotflip_attack(position_grad: torch.Tensor, embedding_matrix: torch.Tensor,
                   num_cands: int) -> np.ndarray:
    """Top candidate token ids replacing one position (grad with respect to
    its embedding), best first.

    Ties follow ``jax.lax.top_k``: among equal scores the lower index comes
    first, also at the k-th place. ``torch.topk`` promises no order among
    equal values, so the scores go through a stable descending sort instead
    and the first ``num_cands`` are kept."""
    scores = -(embedding_matrix @ position_grad)
    order = torch.sort(scores, descending=True, stable=True).indices[:num_cands]
    return order.cpu().numpy()


class AutoPromptState:
    """Discrete prompt: global ids + their (restricted-table) embeddings."""

    def __init__(self, clip_embs: np.ndarray, init_ids: tp.Sequence[int]):
        self.clip_embs = np.asarray(clip_embs, np.float32)
        self.prompt_ids = list(int(i) for i in init_ids)

    @property
    def prompt_embs(self) -> np.ndarray:
        return self.clip_embs[np.asarray(self.prompt_ids)]

    def with_candidate(self, position: int, cand: int) -> tp.Tuple[np.ndarray, tp.List[int]]:
        ids = list(self.prompt_ids)
        ids[position] = int(cand)
        return self.clip_embs[np.asarray(ids)], ids

    def accept(self, position: int, cand: int) -> None:
        self.prompt_ids[position] = int(cand)


class TopPrompter:
    """Keeps the ``max_size`` lowest-loss prompts (train_autoprompt.py:47-62)."""

    def __init__(self, max_size: int):
        self.max_size = max_size
        self.heap: tp.List[tp.Tuple[float, tp.Tuple[int, ...]]] = []

    def push(self, prompt_ids: tp.Sequence[int], prompt_loss: float) -> None:
        item = (-float(prompt_loss), tuple(int(i) for i in prompt_ids))
        if len(self.heap) < self.max_size:
            heapq.heappush(self.heap, item)
        else:
            heapq.heappushpop(self.heap, item)

    def clear(self) -> None:
        self.heap.clear()

    def items(self) -> tp.List[tp.Tuple[tp.List[int], float]]:
        return [(list(ids), -neg) for neg, ids in sorted(self.heap, reverse=True)]


def hotflip_step(state: AutoPromptState,
                 grad_fn: tp.Callable[[np.ndarray, tp.Any], tp.Tuple[float, torch.Tensor]],
                 loss_fn: tp.Callable[[np.ndarray, np.ndarray, tp.Any], float],
                 batches: tp.Sequence[tp.Any], *, num_cands: int = 10,
                 rng: tp.Optional[np.random.Generator] = None) -> dict:
    """One AutoPrompt move.

    ``grad_fn(prompt_embs, batch) -> (loss, grad_embs (P, D))`` and
    ``loss_fn(prompt_embs, prompt_ids, batch) -> loss`` are closures over the
    frozen towers. ``batches``: the fresh evaluation batches (``search_steps``
    of them). The position comes from ``rng`` (numpy), so a seed picks the
    same positions as the JAX package."""
    rng = rng or np.random.default_rng()
    p = len(state.prompt_ids)
    position = int(rng.integers(0, p))

    _, grads = grad_fn(state.prompt_embs, batches[0])
    table = torch.from_numpy(state.clip_embs).to(grads.device)
    candidates = hotflip_attack(grads[position].float(), table, num_cands)

    curr_loss = 0.0
    cand_losses = np.zeros(len(candidates))
    for batch in batches:
        curr_loss += float(loss_fn(state.prompt_embs, np.asarray(state.prompt_ids), batch))
        for ci, cand in enumerate(candidates):
            cand_embs, cand_ids = state.with_candidate(position, int(cand))
            cand_losses[ci] += float(loss_fn(cand_embs, np.asarray(cand_ids), batch))

    best = int(np.argmin(cand_losses))
    accepted = bool(cand_losses[best] < curr_loss)
    if accepted:
        state.accept(position, int(candidates[best]))
    return {
        "position": position, "accepted": accepted,
        "curr_loss": curr_loss / len(batches),
        "best_cand_loss": float(cand_losses[best]) / len(batches),
        "best_cand": int(candidates[best]),
    }
