"""Optimizers and schedules for the port's trainers: optax's pieces on torch.optim.

Counterpart of ``summer_clip_tpu/engine/optim.py``. Parameters are named
tensors (a dict, or ``module.named_parameters()``), and every builder returns
an :class:`Optimizer`: a ``torch.optim`` optimizer plus what an optax chain
adds around it, with optax's semantics:

- a learning rate that may be a schedule of the update count, read before
  each update (the first update uses ``schedule(0)``);
- ``clip_by_global_norm`` of the gradients before the update
  (:func:`clip_by_global_norm`, optax's rule: scale by ``max_norm / norm``
  when the norm reaches ``max_norm``);
- :func:`decay_mask` / :func:`adamw_grouped`: no weight decay on biases and
  norm scales (``torch.optim.AdamW`` applies ``lr * wd * p`` from the old
  parameter, as optax's ``add_decayed_weights`` does);
- :func:`with_grad_accum`: optax ``MultiSteps``: gradients are averaged over
  ``every`` calls and the inner optimizer, its schedule included, advances only
  on the calls that update;
- :func:`trainable_only`: the named subset a predicate keeps; the rest is
  frozen (``requires_grad_(False)``), optax's ``multi_transform`` with
  ``set_to_zero``;
- ``frozen=`` (:func:`adamw`, :class:`Optimizer`): leaves that are
  differentiated, accumulated and clipped with the rest but never updated,
  optax's ``chain(clip_by_global_norm, multi_transform({..., "freeze":
  set_to_zero()}))`` over gradients of every leaf (``train_gpt``);
- ``state_dict`` / ``load_state_dict`` on :class:`Optimizer` and
  :class:`GradAccum`: the update count, the ``torch.optim`` state and
  ``MultiSteps``' call count and running mean, so a run resumes exactly;
- :func:`langevin`: SGLD, an SGD step plus ``sqrt(2 lr beta_t)`` Gaussian
  noise drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

__all__ = ["Optimizer", "GradAccum", "Langevin", "decay_mask", "adamw_grouped", "adamw", "adam",
           "sgd", "langevin", "warmup_cosine", "warmup_linear", "cosine_decay_schedule",
           "with_grad_accum",
           "trainable_only", "clip_by_global_norm"]

Schedule = tp.Callable[[int], float]
Named = tp.Union[tp.Mapping[str, torch.Tensor], tp.Iterable[tp.Tuple[str, torch.Tensor]]]


def _named(params: Named) -> tp.Dict[str, torch.Tensor]:
    return dict(params.items() if isinstance(params, tp.Mapping) else params)


def clip_by_global_norm(tensors: tp.Sequence[torch.Tensor], max_norm: float) -> float:
    """Scale the gradients of ``tensors`` in place by ``max_norm / norm`` when
    their global L2 norm reaches ``max_norm`` (optax's rule); return the norm."""
    grads = [t.grad for t in tensors if t.grad is not None]
    norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads))) if grads else 0.0
    if norm >= max_norm > 0:
        for g in grads:
            g.mul_(max_norm / norm)
    return norm


class Optimizer:
    """A ``torch.optim`` optimizer with a learning-rate schedule read at the
    update count and optional global-norm clipping; ``step()`` consumes the
    ``.grad`` of its parameters. ``frozen`` leaves count in the clipping norm
    (and in :class:`GradAccum`'s mean) but are never updated."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 learning_rate: tp.Union[float, Schedule],
                 grad_clip_norm: tp.Optional[float] = None,
                 frozen: tp.Sequence[torch.Tensor] = ()):
        self.optimizer = optimizer
        self.learning_rate = learning_rate
        self.grad_clip_norm = grad_clip_norm
        self.frozen = list(frozen)
        self.count = 0
        self.last_grad_norm: tp.Optional[float] = None   # the norm the last clipping read

    @property
    def params(self) -> tp.List[torch.Tensor]:
        """The leaves the optimizer updates."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    @property
    def grad_params(self) -> tp.List[torch.Tensor]:
        """Every differentiated leaf: the updated ones, then the frozen ones."""
        return self.params + self.frozen

    def current_lr(self) -> float:
        lr = self.learning_rate
        return float(lr(self.count)) if callable(lr) else float(lr)

    def step(self) -> None:
        if self.grad_clip_norm is not None:
            self.last_grad_norm = clip_by_global_norm(self.grad_params, self.grad_clip_norm)
        lr = self.current_lr()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        for p in self.frozen:
            p.grad = None

    def state_dict(self) -> dict:
        return {"count": self.count, "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: tp.Mapping[str, tp.Any]) -> None:
        self.count = int(state["count"])
        self.optimizer.load_state_dict(state["optimizer"])


class GradAccum:
    """optax ``MultiSteps``: ``step()`` adds the gradients to a running mean;
    every ``every``-th call hands the mean to the inner optimizer, whose count
    and schedule advance only then. Other calls leave the parameters alone."""

    def __init__(self, inner: Optimizer, every: int):
        self.inner = inner
        self.every = int(every)
        self.calls = 0
        self._acc: tp.Optional[tp.List[torch.Tensor]] = None

    @property
    def params(self) -> tp.List[torch.Tensor]:
        return self.inner.params

    @property
    def count(self) -> int:
        return self.inner.count

    def current_lr(self) -> float:
        return self.inner.current_lr()

    def step(self) -> None:
        params = self.inner.grad_params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        k = self.calls % self.every
        if self._acc is None:
            self._acc = [torch.zeros_like(g) for g in grads]
        for a, g in zip(self._acc, grads):
            a.add_((g - a) / (k + 1))                     # optax's running mean
        self.calls += 1
        if self.calls % self.every == 0:
            for p, a in zip(params, self._acc):
                p.grad = a.clone()
            self.inner.step()
            self._acc = None

    def zero_grad(self) -> None:
        self.inner.zero_grad()

    def state_dict(self) -> dict:
        return {"calls": self.calls, "acc": self._acc, "inner": self.inner.state_dict()}

    def load_state_dict(self, state: tp.Mapping[str, tp.Any]) -> None:
        self.calls = int(state["calls"])
        acc = state.get("acc")
        self._acc = None if acc is None else [
            a.to(device=p.device, dtype=p.dtype).clone()
            for a, p in zip(acc, self.inner.grad_params)]
        self.inner.load_state_dict(state["inner"])


def decay_mask(params: Named, no_decay_keywords: tp.Sequence[str] = ("bias", "scale")
               ) -> tp.Dict[str, bool]:
    """True = apply weight decay: every parameter whose last name component
    holds none of ``no_decay_keywords`` (biases and norm scales excluded)."""
    return {name: not any(kw in name.split(".")[-1] for kw in no_decay_keywords)
            for name in _named(params)}


def adamw(params: Named, learning_rate: tp.Union[float, Schedule], *, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
          mask: tp.Optional[tp.Mapping[str, bool]] = None,
          grad_clip_norm: tp.Optional[float] = None,
          frozen: tp.Sequence[torch.Tensor] = ()) -> Optimizer:
    """optax ``adamw`` (with ``mask``: decay only where it is True; ``frozen``:
    see :class:`Optimizer`)."""
    named = _named(params)
    if mask is None:
        groups = [{"params": list(named.values()), "weight_decay": weight_decay}]
    else:
        groups = [{"params": [p for n, p in named.items() if mask[n]],
                   "weight_decay": weight_decay},
                  {"params": [p for n, p in named.items() if not mask[n]], "weight_decay": 0.0}]
        groups = [g for g in groups if g["params"]]
    opt = torch.optim.AdamW(groups, lr=0.0, betas=(b1, b2), eps=eps)
    return Optimizer(opt, learning_rate, grad_clip_norm, frozen)


def adamw_grouped(params: Named, learning_rate: tp.Union[float, Schedule],
                  weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8, no_decay_keywords: tp.Sequence[str] = ("bias", "scale"),
                  grad_clip_norm: tp.Optional[float] = None) -> Optimizer:
    """AdamW with the :func:`decay_mask` grouping (grouped-params semantics)."""
    named = _named(params)
    return adamw(named, learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 mask=decay_mask(named, no_decay_keywords), grad_clip_norm=grad_clip_norm)


def adam(params: Named, learning_rate: tp.Union[float, Schedule], b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    opt = torch.optim.Adam(list(_named(params).values()), lr=0.0, betas=(b1, b2), eps=eps)
    return Optimizer(opt, learning_rate)


def sgd(params: Named, learning_rate: tp.Union[float, Schedule],
        momentum: tp.Optional[float] = None) -> Optimizer:
    opt = torch.optim.SGD(list(_named(params).values()), lr=0.0, momentum=momentum or 0.0)
    return Optimizer(opt, learning_rate)


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax ``linear_schedule``, in its f32 arithmetic."""
    f32 = np.float32

    def schedule(count: int) -> float:
        frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
        return float(f32(init - end) * frac + f32(end))
    return schedule


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  end_value: float = 0.0) -> Schedule:
    """optax ``warmup_cosine_decay_schedule`` from 0: linear to ``base_lr``
    over ``warmup_steps``, then a cosine to ``end_value`` at ``total_steps``;
    optax's f32 arithmetic, so the rates agree to an f32 rounding."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1) - warmup
    alpha = 0.0 if base_lr == 0.0 else end_value / base_lr
    rise = _linear(0.0, base_lr, warmup)
    fall = cosine_decay_schedule(base_lr, decay, alpha)

    def schedule(count: int) -> float:
        return rise(count) if count < warmup else fall(count - warmup)
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax ``cosine_decay_schedule``: ``init_value`` at count 0, a cosine
    down to ``alpha * init_value`` at ``decay_steps``, flat after; optax's f32
    arithmetic."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(count, decay_steps))
        angle = f32(math.pi) * c / f32(decay_steps)
        cosine = f32(0.5) * (f32(1) + f32(np.cos(np.float64(angle))))
        return float(f32(init_value) * (f32(1 - alpha) * cosine + f32(alpha)))
    return schedule


def warmup_linear(base_lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """Linear 0 -> ``base_lr`` over ``warmup_steps``, then linear to 0 over the
    rest (optax ``join_schedules`` of two ``linear_schedule``s)."""
    warmup = max(warmup_steps, 1)
    rise, fall = _linear(0.0, base_lr, warmup), _linear(base_lr, 0.0, max(total_steps - warmup_steps, 1))

    def schedule(count: int) -> float:
        return rise(count) if count < warmup else fall(count - warmup)
    return schedule


class Langevin(torch.optim.Optimizer):
    """SGLD: ``p <- p - lr g + sqrt(2 lr beta_t) N(0, 1)``, the noise drawn
    from ``generator`` (FluentPrompt's optimizer)."""

    def __init__(self, params, beta_schedule: Schedule, generator: torch.Generator):
        super().__init__(list(params), {"lr": 0.0})
        self.beta_schedule = beta_schedule
        self.generator = generator
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        beta = float(self.beta_schedule(self.count))
        for group in self.param_groups:
            lr = group["lr"]
            scale = math.sqrt(2.0 * lr * beta)
            for p in group["params"]:
                if p.grad is None:
                    continue
                p.add_(-lr * p.grad + scale * self.noise(p))
        self.count += 1

    def noise(self, p: torch.Tensor) -> torch.Tensor:
        """N(0, 1) of ``p``'s shape from the generator, on ``p``'s device."""
        return torch.randn(p.shape, generator=self.generator, device=self.generator.device,
                           dtype=p.dtype).to(p.device)


def langevin(params: Named, learning_rate: tp.Union[float, Schedule], beta_schedule: Schedule,
             generator: tp.Optional[torch.Generator] = None, seed: int = 0) -> Optimizer:
    """SGLD with the schedules read at the update count (see :class:`Langevin`)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
    return Optimizer(Langevin(_named(params).values(), beta_schedule, gen), learning_rate)


def with_grad_accum(tx: Optimizer, every: int) -> tp.Union[Optimizer, GradAccum]:
    return tx if every <= 1 else GradAccum(tx, every)


def trainable_only(params: Named, is_trainable: tp.Callable[[str, torch.Tensor], bool]
                   ) -> tp.Dict[str, torch.Tensor]:
    """The named subset ``is_trainable(name, tensor)`` keeps, for an optimizer;
    the rest is frozen in place (``requires_grad_(False)``)."""
    kept = {}
    for name, p in _named(params).items():
        if is_trainable(name, p):
            kept[name] = p
        else:
            p.requires_grad_(False)
    return kept
