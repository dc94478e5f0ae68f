"""FluentPrompt: Langevin-dynamics discrete prompt tuning.

Counterpart of ``summer_clip_tpu/methods/fluentprompt.py``: SGD steps with
``sqrt(2 lr beta_t)`` Gaussian noise (SGLD, ``engine.optim.langevin``, the
noise drawn from an explicit ``torch.Generator``), a geometric beta annealing
schedule, and a projection of the continuous prompt onto the nearest
vocabulary embedding after every step.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from summer_clip_torch.core.device import resolve_device
from summer_clip_torch.engine.optim import Optimizer, langevin
from summer_clip_torch.methods.prompt_models import find_nearest

__all__ = ["geometric_beta_schedule", "make_langevin_optimizer", "FluentPromptState"]


def geometric_beta_schedule(beta_start: float, beta_end: float, num_steps: int
                            ) -> tp.Callable[[int], float]:
    """beta_t = beta_start * (beta_end / beta_start)^(t / T)
    (fluentprompt_learner.py:44-66), in the JAX function's f32 arithmetic."""
    ratio = np.float32((beta_end / beta_start) ** (1.0 / max(num_steps, 1)))

    def schedule(step: int) -> float:
        return float(np.float32(beta_start) * np.power(ratio, np.float32(step)))

    return schedule


def make_langevin_optimizer(params, lr: tp.Union[float, tp.Callable[[int], float]],
                            beta_start: float, beta_end: float, num_steps: int, seed: int = 0,
                            generator: tp.Optional[torch.Generator] = None) -> Optimizer:
    """SGLD over the named ``params`` on the geometric beta schedule; the noise
    comes from ``generator`` (a CPU generator seeded with ``seed`` when None)."""
    return langevin(params, lr, geometric_beta_schedule(beta_start, beta_end, num_steps),
                    generator=generator, seed=seed)


class FluentPromptState:
    """Continuous prompt + its current discrete projection, on ``device`` (the
    card when None). ``params["prompt_embs"]`` is one leaf for the whole run:
    :meth:`project` writes into it, so an optimizer built on it keeps it."""

    def __init__(self, clip_embs: np.ndarray, init_ids: tp.Sequence[int], dist_p: float = 2.0,
                 device: tp.Union[None, str, torch.device] = None):
        device = resolve_device(device)
        self.clip_embs = torch.from_numpy(np.array(clip_embs, np.float32)).to(device)
        self.prompt_ids = [int(i) for i in init_ids]
        self.dist_p = dist_p
        ids = torch.as_tensor(self.prompt_ids, device=device)
        self.params = {"prompt_embs": self.clip_embs[ids].clone().requires_grad_()}

    def project(self) -> tp.List[int]:
        """Snap the embeddings to the nearest vocabulary entries; update the ids.

        As the reference's post-step projection (fluentprompt_learner.py:82-89):
        the ids come from the current embeddings, and the embeddings are reset
        to the ids' vocabulary rows."""
        embs = self.params["prompt_embs"]
        with torch.no_grad():
            ids = find_nearest(embs, self.clip_embs, self.dist_p)
            embs.copy_(self.clip_embs[ids])
        self.prompt_ids = [int(i) for i in ids.cpu().numpy()]
        return self.prompt_ids
