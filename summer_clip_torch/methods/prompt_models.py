"""Prompt models: CoOp (continuous), VQ (straight-through), Gumbel family.

Counterpart of ``summer_clip_tpu/methods/prompt_models.py``. Each model holds
static config and the frozen CLIP token table; its parameters are a dict of
leaf tensors (the JAX package's pytree, same keys), which the trainer hands
to the optimizer:

- ``init(generator) -> params`` (leaves that require grad);
- ``apply(params, temperature, training) -> {"clip_embs", "gpt_embs", "ids", ...}``;
- ``decode_ids(params)`` nearest-token decode for logging, in global ids;
- ``allowed_tokens`` restricts the searchable vocabulary, with global-id
  remapping.

The straight-through estimator is ``(hard - soft).detach() + soft``; Gumbel
models feed the soft mixture to CLIP and the hard straight-through embedding
to the GPT fluency branch; ``Gumbelv3a1`` rolls its distribution out of an
autoregressive proposer (``methods/gpt_heads``).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from summer_clip_torch.core.device import resolve_device

__all__ = [
    "find_nearest", "straight_through", "BasePromptModel", "CoOp",
    "VQVAE1", "VQVAE2", "Gumbelv0a1", "Gumbelv1a1", "Gumbelv3a1", "prompt_grads_info",
]


def find_nearest(prompt_embs: torch.Tensor, clip_embs: torch.Tensor, p: float = 2.0
                 ) -> torch.Tensor:
    """Ids of the nearest vocabulary embedding under the Minkowski-p metric."""
    if p == 2.0:
        # ||a - b||^2 = |a|^2 - 2ab + |b|^2, without the (P, V, D) difference
        d = ((prompt_embs ** 2).sum(-1, keepdim=True) - 2.0 * prompt_embs @ clip_embs.t()
             + (clip_embs ** 2).sum(-1)[None, :])
        return d.argmin(dim=1)
    diffs = (prompt_embs[:, None, :] - clip_embs[None, :, :]).abs() ** p
    return diffs.sum(-1).argmin(dim=1)


def straight_through(hard: torch.Tensor, soft: torch.Tensor) -> torch.Tensor:
    return (hard - soft).detach() + soft


def prompt_grads_info(grads: tp.Any, name: str = "prompt_embs",
                      log_dir_name: str = "prompt_grad_norm") -> tp.Dict[str, float]:
    g = grads.get(name) if isinstance(grads, dict) else None
    if g is None:
        return {}
    norms = g.detach().float().norm(dim=-1).cpu().numpy()
    return {f"{log_dir_name}/{i + 1}": float(norms[i]) for i in range(len(norms))}


class BasePromptModel:
    def __init__(self, clip_embs: np.ndarray, prompt_len: int,
                 allowed_tokens: tp.Optional[tp.Sequence[int]] = None,
                 device: tp.Union[None, str, torch.device] = None, **kwargs):
        del kwargs
        self.prompt_len = prompt_len
        self.device = resolve_device(device)
        self.allowed_tokens = (np.asarray(allowed_tokens, np.int32)
                               if allowed_tokens is not None else None)
        table = np.asarray(clip_embs, np.float32)
        if self.allowed_tokens is not None:
            table = table[self.allowed_tokens]
        self.clip_embs = torch.from_numpy(np.ascontiguousarray(table)).to(self.device)
        self.vocab_size, self.emb_dim = table.shape

    def _normal(self, generator: torch.Generator, shape) -> torch.Tensor:
        return (0.02 * torch.randn(shape, generator=generator)).to(self.device).requires_grad_()

    def init(self, generator: torch.Generator) -> dict:
        raise NotImplementedError

    def apply(self, params: dict, temperature: float = 1.0, training: bool = True) -> dict:
        raise NotImplementedError

    def to_global_ids(self, ids) -> torch.Tensor:
        ids = torch.as_tensor(ids)
        if self.allowed_tokens is None:
            return ids
        return torch.from_numpy(self.allowed_tokens).long().to(ids.device)[ids.long()]

    def decode_ids(self, params: dict) -> np.ndarray:
        with torch.no_grad():
            out = self.apply(params, training=False)
            return self.to_global_ids(out["ids"]).cpu().numpy()

    def step_info(self, grads: dict) -> tp.Dict[str, float]:
        return prompt_grads_info(grads)


class CoOp(BasePromptModel):
    """Free continuous prompt embeddings; nearest-token decode at eval."""

    def __init__(self, dist_p: float = 2.0, **kwargs):
        super().__init__(**kwargs)
        self.dist_p = dist_p

    def init(self, generator: torch.Generator) -> dict:
        return {"prompt_embs": self._normal(generator, (self.prompt_len, self.emb_dim))}

    def apply(self, params, temperature: float = 1.0, training: bool = True) -> dict:
        embs = params["prompt_embs"]
        if training:
            ids = torch.zeros((self.prompt_len,), dtype=torch.long, device=embs.device)
        else:
            ids = find_nearest(embs, self.clip_embs, self.dist_p)
        return {"clip_embs": embs, "gpt_embs": embs, "ids": ids}


class VQVAE1(BasePromptModel):
    """Nearest-vocab quantization with straight-through; hard embs both ways."""

    def __init__(self, dist_p: float = 2.0, **kwargs):
        super().__init__(**kwargs)
        self.dist_p = dist_p

    def init(self, generator: torch.Generator) -> dict:
        return {"prompt_embs": self._normal(generator, (self.prompt_len, self.emb_dim))}

    def apply(self, params, temperature: float = 1.0, training: bool = True) -> dict:
        embs = params["prompt_embs"]
        ids = find_nearest(embs.detach(), self.clip_embs, self.dist_p)
        st = straight_through(self.clip_embs[ids], embs)
        return {"clip_embs": st, "gpt_embs": st, "ids": ids}


class VQVAE2(VQVAE1):
    """Like VQVAE1, but CLIP sees the continuous embeddings."""

    def apply(self, params, temperature: float = 1.0, training: bool = True) -> dict:
        out = super().apply(params, temperature, training)
        out["clip_embs"] = params["prompt_embs"]
        return out


def _weights_stats(weights: torch.Tensor, suffix: str) -> tp.Dict[str, torch.Tensor]:
    w = weights.detach().float().flatten()
    q25, median, q75 = torch.quantile(w, torch.tensor([0.25, 0.5, 0.75], device=w.device))
    return {
        f"weights{suffix}/min": w.min(), f"weights{suffix}/max": w.max(),
        f"weights{suffix}/mean": w.mean(), f"weights{suffix}/median": median,
        f"weights{suffix}/quant_75": q75, f"weights{suffix}/quant_25": q25,
    }


class GumbelBase(BasePromptModel):
    """Softmax relaxation over the vocab: soft mixture to CLIP, hard ST to GPT."""

    logits_temperature: float = 1.0 / 100.0

    def get_prompt_logits(self, params: dict) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, params, temperature: float = 1.0, training: bool = True) -> dict:
        y_soft = torch.softmax(self.get_prompt_logits(params) / self.logits_temperature, dim=-1)
        y_inds = y_soft.argmax(dim=-1)
        prompts_soft = y_soft @ self.clip_embs
        prompts_hard = straight_through(self.clip_embs[y_inds], prompts_soft)
        info = _weights_stats(y_soft, "")
        for ind in (0, -1):
            info.update(_weights_stats(y_soft[ind], f"_{ind}"))
        return {"clip_embs": prompts_soft, "gpt_embs": prompts_hard, "ids": y_inds,
                "temperature": temperature, "logits_temperature": self.logits_temperature,
                **info}


class Gumbelv0a1(GumbelBase):
    """Raw per-position vocab logits as parameters."""

    def init(self, generator: torch.Generator) -> dict:
        del generator
        return {"prompt_logits": torch.ones((self.prompt_len, self.vocab_size),
                                            device=self.device, requires_grad=True)}

    def get_prompt_logits(self, params):
        return params["prompt_logits"]

    def step_info(self, grads):
        return prompt_grads_info(grads, "prompt_logits")


class Gumbelv1a1(GumbelBase):
    """Logits = prompt embeddings @ vocab table^T."""

    def init(self, generator: torch.Generator) -> dict:
        return {"prompt_embs": self._normal(generator, (self.prompt_len, self.emb_dim))}

    def get_prompt_logits(self, params):
        return params["prompt_embs"] @ self.clip_embs.t()


class Gumbelv3a1(GumbelBase):
    """Autoregressive proposal: a ClipGPT head rolls out the next-token
    distribution position by position through a KV cache.

    ``proposer`` (:class:`~summer_clip_torch.methods.gpt_heads.AdapterGPT` or
    ``LoRAGPT``) supplies ``init(generator) -> params``, ``init_cache(batch,
    max_len)`` and ``__call__(params, clip_space_embeds, cache) -> (logits over
    the GLOBAL CLIP vocabulary, new cache)``. The parameters are the
    proposer's, flat under ``proposer.`` (``proposer.fc1.kernel``, ...), so
    the trainer's optimizer takes them as it takes any prompt model's. The
    chain stays in the graph: the gradient flows back through every step
    (the proposer's cache is rebuilt out of place on this path).
    """

    def __init__(self, proposer: tp.Any, bos_token_id: int, clip_embs: np.ndarray, **kwargs):
        super().__init__(clip_embs=clip_embs, **kwargs)
        self.proposer = proposer
        # the BOS embedding comes from the GLOBAL table, the feedback from the
        # (possibly restricted) one
        self.bos_emb = torch.from_numpy(
            np.array(np.asarray(clip_embs, np.float32)[bos_token_id])).to(self.device)
        self._allowed_t = (torch.from_numpy(self.allowed_tokens).long().to(self.device)
                           if self.allowed_tokens is not None else None)

    def init(self, generator: torch.Generator) -> dict:
        return {f"proposer.{k}": v for k, v in self.proposer.init(generator).items()}

    def proposer_params(self, params: dict) -> dict:
        return {k[len("proposer."):]: v for k, v in params.items() if k.startswith("proposer.")}

    def get_prompt_logits(self, params):
        """(prompt_len, V) next-token probabilities of the rollout (already a
        softmax: ``apply`` takes no second one)."""
        pparams = self.proposer_params(params)
        cache = self.proposer.init_cache(1, self.prompt_len + 1)
        x = self.bos_emb[None, None, :]
        probs_list = []
        for _ in range(self.prompt_len):
            logits, cache = self.proposer(pparams, x, cache)
            logits = logits[:, -1, :]
            if self._allowed_t is not None:
                logits = logits[:, self._allowed_t]
            probs = torch.softmax(logits, dim=-1)
            x = (probs @ self.clip_embs)[:, None, :]
            probs_list.append(probs[0])
        return torch.stack(probs_list, dim=0)

    def apply(self, params, temperature: float = 1.0, training: bool = True) -> dict:
        y_soft = self.get_prompt_logits(params)
        y_inds = y_soft.argmax(dim=-1)
        prompts_soft = y_soft @ self.clip_embs
        prompts_hard = straight_through(self.clip_embs[y_inds], prompts_soft)
        return {"clip_embs": prompts_soft, "gpt_embs": prompts_hard, "ids": y_inds,
                "temperature": temperature}
