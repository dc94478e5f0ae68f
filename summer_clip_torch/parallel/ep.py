"""Expert parallelism: a switch-routed MoE MLP with its experts over an
``expert`` axis.

Counterpart of ``summer_clip_tpu/parallel/ep.py``, which no app uses, here or
there:

- top-1 switch routing (:func:`_route`): a linear router picks one expert a
  token, and the expert's output is scaled by the router probability (the
  gate, differentiable through the probability);
- :func:`moe_forward_dense` (:class:`MoEMLP`'s forward) computes every expert
  on every token and masks: the one-device reference;
- :func:`moe_apply_ep`: a rank holds its experts (:func:`shard_experts_ep`),
  routes every token (the router is replicated), runs its experts on the
  tokens routed to them (masked) and one sum over the axis combines them
  (``parallel.mesh.axis_sum``: every rank then holds the output, so its
  backward is the identity). The tokens enter the experts through
  ``axis_copy``: each rank's experts see only their tokens' part of the
  input's gradient, which the copy's backward sums. No all-to-all and no
  capacity: every token is served by its expert exactly once.

The expert MLP is plain PyTorch, as it is plain ``jnp`` in the JAX package:
no TPU kernel computes it.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from summer_clip_torch.parallel.mesh import axis_copy, axis_sum

__all__ = ["MoEMLP", "moe_forward_dense", "moe_apply_ep", "shard_experts_ep",
           "check_ep_divisibility"]


def check_ep_divisibility(num_experts: int, n_shards: int) -> None:
    if num_experts % n_shards != 0:
        raise ValueError(f"num_experts {num_experts} not divisible by {n_shards} expert shards")


def _expert_ffn(w1, b1, w2, b2, x):
    """Experts' tanh-GELU MLPs on (N, D) tokens: (E, N, D)."""
    h = F.gelu(torch.einsum("nd,edh->enh", x, w1) + b1[:, None], approximate="tanh")
    return torch.einsum("enh,ehd->end", h, w2) + b2[:, None]


def _route(params: tp.Mapping[str, torch.Tensor], x2: torch.Tensor, dtype):
    """(N, D) tokens -> (one-hot (N, E) f32, gate probability (N, 1) in
    ``dtype``) for top-1 routing."""
    logits = x2.to(torch.float32) @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(logits.argmax(-1), logits.shape[-1]).to(torch.float32)
    gate = (probs * onehot).sum(-1, keepdim=True)
    return onehot, gate.to(dtype)


def _experts(params, x2, dtype):
    return _expert_ffn(*(params[k].to(dtype) for k in ("w1", "b1", "w2", "b2")), x2)


def moe_forward_dense(params: tp.Mapping[str, torch.Tensor], x: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """Every expert on every token, outputs masked by the routing."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).to(dtype)
    onehot, gate = _route(params, x2, dtype)
    combined = torch.einsum("end,ne->nd", _experts(params, x2, dtype).to(torch.float32),
                            onehot).to(dtype)
    return (combined * gate).reshape(shape)


def moe_apply_ep(params: tp.Mapping[str, torch.Tensor], x: torch.Tensor, mesh,
                 axis: str = "expert", dtype=torch.float32) -> torch.Tensor:
    """The EP forward: ``params`` holds this rank's experts (leading axis
    ``E / n``, :func:`shard_experts_ep`) and the whole router; ``x`` is the
    same on every rank, and so is the result."""
    n = mesh.size(axis)
    e_local = params["w1"].shape[0]
    check_ep_divisibility(params["router"].shape[1], n)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).to(dtype)
    onehot, gate = _route(params, x2, dtype)
    i = mesh.coords.get(axis, 0)
    local = onehot[:, i * e_local:(i + 1) * e_local]
    outs = _experts(params, axis_copy(x2, mesh, axis), dtype)
    part = axis_sum(torch.einsum("end,ne->nd", outs.to(torch.float32), local), mesh, axis)
    return (part.to(dtype) * gate).reshape(shape)


def shard_experts_ep(params: tp.Mapping[str, torch.Tensor], mesh,
                     axis: str = "expert") -> tp.Dict[str, torch.Tensor]:
    """This rank's experts (the leading axis cut over ``axis``) and the whole
    router."""
    n, i = mesh.size(axis), mesh.coords.get(axis, 0)
    check_ep_divisibility(params["w1"].shape[0], n)
    per = params["w1"].shape[0] // n
    return {"router": params["router"],
            **{k: params[k][i * per:(i + 1) * per] for k in ("w1", "b1", "w2", "b2")}}


class MoEMLP(nn.Module):
    """Top-1 switch MoE feed-forward, (..., D) -> (..., D), computed densely
    (:func:`moe_forward_dense`). Parameters: ``router`` (D, E) and stacked
    experts with a leading (E, ...) axis, the axis :func:`shard_experts_ep`
    cuts; initialised as Flax's ``lecun_normal`` (without its truncation)
    and zeros."""

    def __init__(self, d: int, num_experts: int, hidden_mult: int = 4,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.num_experts, self.hidden_mult, self.dtype = num_experts, hidden_mult, dtype
        h = hidden_mult * d
        g = generator or torch.Generator().manual_seed(0)

        def lecun(*shape):   # fan_in: every dim but the last (Flax's in_axis=-2 with E batched in)
            fan_in = 1
            for s in shape[:-1]:
                fan_in *= s
            return nn.Parameter((torch.randn(shape, generator=g) * fan_in ** -0.5).to(device))

        self.router = lecun(d, num_experts)
        self.w1 = lecun(num_experts, d, h)
        self.b1 = nn.Parameter(torch.zeros(num_experts, h, device=device))
        self.w2 = lecun(num_experts, h, d)
        self.b2 = nn.Parameter(torch.zeros(num_experts, d, device=device))

    def tree(self) -> tp.Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in ("router", "w1", "b1", "w2", "b2")}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return moe_forward_dense(self.tree(), x, dtype=self.dtype)
