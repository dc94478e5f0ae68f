"""Fixed-means Gaussian-mixture EM in PyTorch.

Counterpart of ``summer_clip_tpu/methods/em.py`` (the reference's
``summer_clip/clip_em/fixed_em.py`` + ``train_em.py``): a GMM over image
features whose component means are FIXED to the class text features; the
M-step updates only the mixture weights and the covariances (full or
diagonal). Each EM step is a few batched tensor operations on ``device``; the
loop stops when the mean log-likelihood moves by less than ``tol``, read back
once a step as the JAX package does.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

from summer_clip_torch.core.device import resolve_device

__all__ = ["FixedMeansGMM"]


def _f32(x, device) -> torch.Tensor:
    """An array or tensor as an f32 tensor on ``device``."""
    return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x),
                           dtype=torch.float32).to(device)


def _log_gauss_full(x: torch.Tensor, means: torch.Tensor, chol: torch.Tensor) -> torch.Tensor:
    """log N(x | mu_k, Sigma_k) for all k. x (N, D), means (K, D), chol (K, D, D) -> (N, K)."""
    d = x.shape[1]
    diff = (x[None] - means[:, None]).transpose(1, 2)                    # (K, D, N)
    sol = torch.linalg.solve_triangular(chol, diff, upper=False)         # (K, D, N)
    maha = (sol ** 2).sum(dim=1)                                          # (K, N)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=1, dim2=2)).sum(dim=1)
    return (-0.5 * (d * math.log(2 * math.pi) + logdet[:, None] + maha)).t()


def _log_gauss_diag(x: torch.Tensor, means: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    d = x.shape[1]
    diff2 = (x[:, None, :] - means[None]) ** 2
    maha = (diff2 / var[None]).sum(dim=-1)
    logdet = torch.log(var).sum(dim=-1)
    return -0.5 * (d * math.log(2 * math.pi) + logdet[None] + maha)


class FixedMeansGMM:
    """EM with component means pinned to provided vectors.

    ``covariance_type``: 'full' (the reference's default) or 'diag'. ``fit``
    runs up to ``max_iter`` EM steps; ``predict_proba`` returns
    responsibilities, ``predict_log_proba`` the joint log-densities (used as
    logits, as the reference's ``predict_proba``), both as numpy arrays.
    ``device``: the card when None.
    """

    def __init__(self, means_init, covariance_type: str = "full", reg_covar: float = 1e-6,
                 max_iter: int = 100, tol: float = 1e-3, n_components: tp.Optional[int] = None,
                 device: tp.Union[None, str, torch.device] = None):
        device = resolve_device(device)
        self.means = _f32(means_init, device)
        if n_components is not None:
            assert n_components == self.means.shape[0], "n_components must match means_init"
        self.k, self.d = self.means.shape
        self.covariance_type = covariance_type
        self.reg_covar = reg_covar
        self.max_iter = max_iter
        self.tol = tol
        self.device = device
        self.weights_: tp.Optional[torch.Tensor] = None
        self.covariances_: tp.Optional[torch.Tensor] = None
        self.lower_bound_: float = -np.inf

    def _x(self, x) -> torch.Tensor:
        return _f32(x, self.device)

    def _log_prob(self, x: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
        if self.covariance_type == "full":
            return _log_gauss_full(x, self.means, torch.linalg.cholesky(cov))
        return _log_gauss_diag(x, self.means, cov)

    def _e_step(self, x, weights, cov):
        weighted = self._log_prob(x, cov) + torch.log(weights)[None]
        norm = torch.logsumexp(weighted, dim=1, keepdim=True)
        return weighted - norm, norm.mean()

    def _m_step(self, x, log_resp):
        resp = torch.exp(log_resp)
        nk = resp.sum(dim=0) + 10 * torch.finfo(resp.dtype).eps
        weights = nk / nk.sum()
        diff = x[:, None, :] - self.means[None]  # (N, K, D)
        if self.covariance_type == "full":
            cov = torch.einsum("nk,nkd,nke->kde", resp, diff, diff) / nk[:, None, None]
            cov = cov + self.reg_covar * torch.eye(self.d, device=x.device)[None]
        else:
            cov = torch.einsum("nk,nkd->kd", resp, diff ** 2) / nk[:, None] + self.reg_covar
        return weights, cov

    def fit(self, x) -> "FixedMeansGMM":
        x = self._x(x)
        weights = torch.full((self.k,), 1.0 / self.k, device=x.device)
        if self.covariance_type == "full":
            cov = torch.eye(self.d, device=x.device)[None].expand(self.k, self.d, self.d)
        else:
            cov = torch.ones(self.k, self.d, device=x.device)
        prev = -math.inf
        for _ in range(self.max_iter):
            log_resp, lb = self._e_step(x, weights, cov)
            weights, cov = self._m_step(x, log_resp)
            lb = float(lb)
            converged = abs(lb - prev) < self.tol
            prev = lb
            if converged:
                break
        self.weights_, self.covariances_, self.lower_bound_ = weights, cov, prev
        return self

    def score_samples_per_component(self, x) -> torch.Tensor:
        assert self.weights_ is not None, "fit first"
        return self._log_prob(self._x(x), self.covariances_) + torch.log(self.weights_)[None]

    def predict_proba(self, x) -> np.ndarray:
        return torch.softmax(self.score_samples_per_component(x), dim=1).cpu().numpy()

    def predict_log_proba(self, x) -> np.ndarray:
        return self.score_samples_per_component(x).cpu().numpy()
