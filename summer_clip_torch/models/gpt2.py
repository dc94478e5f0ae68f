"""GPT-2 and ClipGPT (GPT-2 re-based onto CLIP's vocabulary) as PyTorch modules.

Counterpart of ``summer_clip_tpu/models/gpt2.py``:

- :class:`GPT2` -- GPT-2 decoder (tanh-GELU, fused qkv, tied head) taking token
  ids or ``inputs_embeds``, with a KV cache for incremental decoding;
- :class:`ClipGPT` -- input and output embeddings replaced by the frozen CLIP
  token table bridged through trainable ReLU adapters; only the adapters train
  (:func:`clip_gpt_trainable_mask`), or everything but the embedding tables
  (:func:`clip_gpt_full_trainable_mask`);
- :func:`convert_hf_gpt2` -- HF ``GPT2LMHeadModel`` state dict -> parameter tree;
- :func:`from_flax_variables` -- the JAX package's variables (as numpy, plain or
  int8-quantised) -> parameter tree.

**Parameter trees.** Modules and parameters carry the JAX package's names
(``core.h_0.attn.c_attn.kernel``, ``core.h_0.ln_1.scale``, ``wte.embedding``,
``clip_emb`` ...), so a tree -- a nested dict of tensors, read with
:meth:`tree` and installed with :meth:`load_tree` -- has the JAX package's
paths, and ``engine/checkpoint`` and ``engine/quant`` work on it as they do
there. Dense kernels are stored (in, out), row-major, as HF's ``Conv1D`` and
Flax store them: the streaming kernel K7 reads them as stored. A quantised
leaf is a :class:`~summer_clip_torch.ops.gemv.QLeaf` in the kernel's place.

**The KV cache** is preallocated and written in place (the counterpart of
``dynamic_update_slice``): a list of ``{"k", "v", "index"}`` per layer, where
``index`` is a Python int (every row appends at the same slot) or a (B,)
tensor (per-row slots). The returned cache holds the same buffers with the
index advanced. On a gradient path (new keys or values that require grad, at a
Python-int index) the buffers are rebuilt out of place instead, the
counterpart of the JAX cache being functional: the returned cache then holds
new buffers and the one passed in is left as it was. ``key_pad`` (B,) masks the first ``key_pad[b]`` slots of row b
(left-padded batches).

**The heads** return f32 logits: the product of the compute-dtype operands
accumulated and returned in f32 (:func:`logits_f32`, the JAX package's
``preferred_element_type=jnp.float32``), never rounded to bf16 first.

**Remat.** ``remat=True`` runs each block of the training path (no cache,
grad enabled) under ``torch.utils.checkpoint`` (non-reentrant), the JAX
package's ``nn.remat(GPT2Block)``: its activations are recomputed in the
backward, so a kernel of the block launches once more there.
``remat_policy="dots"`` keeps the dense products (``aten.mm`` / ``aten.addmm``
outputs) and recomputes the rest, the batched attention products included:
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import os
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from summer_clip_torch.ops.attention import multi_head_attention
from summer_clip_torch.ops.block_kernels import ln_f32
from summer_clip_torch.ops.gemv import QLeaf, gather_rows, is_qleaf, qdot, qmlp

__all__ = [
    "GPT2Config", "GPT2", "GPT2_CONFIGS", "build_gpt2", "convert_hf_gpt2", "from_flax_variables",
    "ClipGPT", "clip_gpt_trainable_mask", "clip_gpt_full_trainable_mask",
    "Adapter", "QDense", "LayerNormF32", "GPT2Attention", "GPT2Block", "GPT2Core", "decode_inputs",
    "logits_f32", "REMAT_POLICIES",
]

Tree = tp.Dict[str, tp.Any]
Cache = tp.List[tp.Dict[str, tp.Any]]
MASKED = -1e30   # additive mask value, f32: masks add, and a bf16 mask would overflow to -inf
REMAT_POLICIES = (None, "dots")


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    name: str = "gpt2"
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12


GPT2_CONFIGS = {c.name: c for c in [
    GPT2Config("gpt2"),
    GPT2Config("gpt2-medium", n_embd=1024, n_layer=24, n_head=16),
    GPT2Config("gpt2-large", n_embd=1280, n_layer=36, n_head=20),
    GPT2Config("gpt2-xl", n_embd=1600, n_layer=48, n_head=25),
    GPT2Config("test-gpt", vocab_size=512, n_positions=96, n_embd=32, n_layer=2, n_head=2),
    # tiny config whose widths the decode kernels take (multiples of 128)
    GPT2Config("test-gpt-mega", vocab_size=512, n_positions=512, n_embd=256,
               n_layer=2, n_head=4),
]}


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------
def _set_leaf(module: nn.Module, name: str, value: tp.Any) -> None:
    if hasattr(module, name):
        delattr(module, name)
    if is_qleaf(value):
        setattr(module, name, value)
    else:
        setattr(module, name, nn.Parameter(torch.as_tensor(value), requires_grad=False))


def _module_tree(module: nn.Module) -> Tree:
    out: Tree = {name: p.data for name, p in module._parameters.items() if p is not None}
    for name, child in module._modules.items():
        out[name] = child if is_qleaf(child) else _module_tree(child)
    return out


def _load_module_tree(module: nn.Module, tree: tp.Mapping[str, tp.Any]) -> None:
    for name, value in tree.items():
        if isinstance(value, tp.Mapping):
            _load_module_tree(getattr(module, name), value)
        else:
            old = getattr(module, name)
            if tuple(old.shape) != tuple(value.shape):
                raise ValueError(f"{name}: expected shape {tuple(old.shape)}, got {tuple(value.shape)}")
            _set_leaf(module, name, value)


class _TreeModule(nn.Module):
    """Parameters in and out as a nested dict with the JAX package's paths."""

    def tree(self) -> Tree:
        """The parameters as a nested dict; tensors are shared, not copied."""
        return _module_tree(self)

    def load_tree(self, tree: tp.Mapping[str, tp.Any], device=None) -> "_TreeModule":
        """Install the leaves of ``tree`` (tensors or int8 ``QLeaf``s) in
        place, shared and not copied unless ``device`` moves them; leaves that
        ``tree`` lacks stay."""
        def moved(node):
            if isinstance(node, tp.Mapping):
                return {k: moved(v) for k, v in node.items()}
            return node.to(device)

        _load_module_tree(self, tree if device is None else moved(tree))
        return self

    def with_tree(self, tree: tp.Mapping[str, tp.Any]) -> "_TreeModule":
        """A second module of the same architecture whose leaves are those of
        ``tree``, which must be complete (say, ``quantize_tree(self.tree())``)."""
        clone = type(self)(**self._ctor, device="meta")
        clone.load_tree(tree)
        left = [n for n, p in clone.named_parameters() if p.is_meta]
        if left:
            raise ValueError(f"with_tree: the tree lacks {left[:4]} ...")
        return clone

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "_TreeModule":
        """Flax's initialisers from an explicit CPU generator: dense kernels
        LeCun-normal, biases zero, LayerNorm one/zero, ``wpe`` N(0, 0.01),
        token tables N(0, 0.02). Every number is drawn on the CPU and copied to
        the parameter's device, so a seed gives the same weights on a card and
        without one (a CUDA generator's stream is not promised equal across
        cards or versions). ``generator`` gives each drawn leaf a seed of its
        own, in the order of :meth:`named_parameters`; the leaves are then
        drawn side by side, which a single stream would not allow."""
        if generator.device.type != "cpu":
            raise ValueError(f"init_weights takes a CPU generator, got one on {generator.device}")
        drawn = []
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel":
                drawn.append((p, p.shape[0] ** -0.5))
            elif leaf in ("embedding", "clip_emb"):
                drawn.append((p, 0.02))
            elif leaf == "wpe":
                drawn.append((p, 0.01))
            else:
                p.fill_(1.0 if leaf == "scale" else 0.0)
        seeds = torch.randint(0, 2 ** 62, (len(drawn),), generator=generator).tolist()

        def draw(job):
            (p, std), seed = job
            return torch.randn(p.shape, generator=torch.Generator().manual_seed(seed)) * std

        with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            for (p, _), value in zip(drawn, pool.map(draw, zip(drawn, seeds))):
                p.copy_(value)
        return self


def from_flax_variables(variables: tp.Mapping[str, tp.Any]) -> Tree:
    """The JAX package's ``{"params": ...}`` (or the bare params) with numpy
    leaves -> a tree for :meth:`load_tree`. ``{"q", "scale"}`` leaves of a
    ``quantize_tree`` result become :class:`QLeaf`s, value for value."""
    params = variables["params"] if "params" in variables else variables

    def tensor(a):
        return torch.from_numpy(np.array(a, copy=True))

    def walk(node):
        if isinstance(node, tp.Mapping):
            if set(node) == {"q", "scale"}:
                return QLeaf(tensor(node["q"]), tensor(node["scale"]))
            return {str(k): walk(v) for k, v in node.items()}
        return tensor(node)

    return walk(params)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
class LayerNormF32(nn.Module):
    """LayerNorm in f32 (eps 1e-5) with Flax's parameter names."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d, device=device), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ln_f32(x, self.scale, self.bias, 1e-5)


def _dense_apply(inputs: torch.Tensor, kernel, bias: tp.Optional[torch.Tensor],
                 dtype: torch.dtype) -> torch.Tensor:
    """The QDense math on raw leaves (shared with GPT2Block's MLP pair)."""
    if is_qleaf(kernel):
        y = qdot(inputs, kernel, dtype)
        return y if bias is None else y + bias.to(y.dtype)
    y = torch.matmul(inputs.to(dtype), kernel.to(dtype))
    return y if bias is None else y + bias.to(dtype)


class QDense(nn.Module):
    """Dense layer whose ``kernel`` is (in, out) and may be an int8 ``QLeaf``.

    A plain kernel is one ``torch.matmul`` in ``dtype``. An int8 kernel goes
    through :func:`~summer_clip_torch.ops.gemv.qdot`: decode-shaped calls
    stream the stored int8 through K7, wide calls (prefill) run the same math
    as one product."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features, device=device),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(features, device=device), requires_grad=False)
                     if use_bias else None)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return _dense_apply(inputs, self.kernel, self.bias, self.dtype)


def cache_mask(index: tp.Union[int, torch.Tensor], s_new: int, t: int,
               key_pad: tp.Optional[torch.Tensor], device) -> torch.Tensor:
    """Additive f32 mask of ``s_new`` new queries at cache slot ``index``
    against ``t`` cache slots: causal from the index (scalar: (s_new, t);
    per-row: (B, 1, s_new, t)), plus the pad mask of ``key_pad``."""
    k_pos = torch.arange(t, device=device)[None, :]
    rows = torch.arange(s_new, device=device)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    if isinstance(index, torch.Tensor) and index.dim() == 1:
        q_pos = index[:, None, None] + rows[None]
        mask = torch.where(k_pos[None] <= q_pos, zero, MASKED)[:, None]
    else:
        mask = torch.where(k_pos <= index + rows, zero, MASKED)
    if key_pad is not None:
        pad_mask = torch.where(k_pos < key_pad[:, None], MASKED, zero)
        if mask.dim() == 2:
            mask = mask[None, None]
        mask = mask + pad_mask[:, None, None, :]
    return mask


def logits_f32(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``h @ table.T`` of the compute-dtype operands (``table`` is cast to
    ``h``'s dtype), accumulated and returned in f32: the JAX package's
    ``jnp.dot(..., preferred_element_type=jnp.float32)``. The product of two
    bf16 values is exact in f32, so this is the f32 product of the widened
    operands, on the CPU and on the card alike (``torch.mm`` with
    ``out_dtype=torch.float32`` computes the same forward, but the card's torch
    has no backward for it)."""
    table = table.to(h.dtype)
    if h.dtype == torch.float32:
        return torch.matmul(h, table.t())
    return torch.matmul(h.float(), table.float().t())


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the dense products, recompute everything else (the batched
    attention products, and any buffer a kernel writes into)."""
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kwargs(policy: tp.Optional[str]) -> dict:
    if policy == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        return {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                                _dots_policy)}
    return {}


class GPT2Attention(nn.Module):
    def __init__(self, d: int, num_heads: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.c_attn = QDense(d, 3 * d, dtype=dtype, device=device)
        self.c_proj = QDense(d, d, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, cache: tp.Optional[dict] = None,
                mask: tp.Optional[torch.Tensor] = None
                ) -> tp.Tuple[torch.Tensor, tp.Optional[dict]]:
        d = x.shape[-1]
        q, k, v = self.c_attn(x).split(d, dim=-1)
        if cache is None:
            o = multi_head_attention(q, k, v, num_heads=self.num_heads, causal=True)
            return self.c_proj(o), None
        # incremental decode: x is (B, S_new, D), the cache holds (B, T, D) and
        # is written in place; ``mask`` (from cache_mask) hides the slots past
        # each row's index, so a reused slot needs no zeroing
        idx = cache["index"]
        s_new = q.shape[1]
        kc, vc = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
        if isinstance(idx, torch.Tensor) and idx.dim() == 1:
            rows = torch.arange(q.shape[0], device=q.device)[:, None]
            # a row past the cache's end writes its last slots (the serving
            # engine advances free and retired rows too; their rows are junk)
            start = idx.clamp(max=cache["k"].shape[1] - s_new)
            slots = start[:, None] + torch.arange(s_new, device=q.device)[None, :]
            cache["k"][rows, slots] = kc
            cache["v"][rows, slots] = vc
        elif kc.requires_grad or vc.requires_grad:
            # on a gradient path (a proposer rolled out through the cache) the
            # buffers are rebuilt out of place: autograd keeps every step's,
            # where an in-place write would overwrite what it saved
            return self._attend(q, *(torch.cat([buf[:, :idx], new, buf[:, idx + s_new:]], dim=1)
                                     for buf, new in ((cache["k"], kc), (cache["v"], vc))),
                                mask, idx + s_new)
        else:
            cache["k"][:, idx:idx + s_new] = kc
            cache["v"][:, idx:idx + s_new] = vc
        return self._attend(q, cache["k"], cache["v"], mask, idx + s_new)

    def _attend(self, q, k, v, mask, index) -> tp.Tuple[torch.Tensor, dict]:
        o = multi_head_attention(q, k, v, num_heads=self.num_heads, mask=mask, use_flash=False)
        return self.c_proj(o), {"k": k, "v": v, "index": index}


class _QParams(nn.Module):
    """Kernel and bias of a dense layer, held for a caller that computes on the
    raw leaves (GPT2Block's MLP pair, which may take one fused kernel)."""

    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features, device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features, device=device), requires_grad=False)


class GPT2Block(nn.Module):
    def __init__(self, d: int, num_heads: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = LayerNormF32(d, device)
        self.attn = GPT2Attention(d, num_heads, dtype, device)
        self.ln_2 = LayerNormF32(d, device)
        self.mlp_c_fc = _QParams(d, 4 * d, device)
        self.mlp_c_proj = _QParams(4 * d, d, device)

    def forward(self, x, cache=None, mask=None):
        h, new_cache = self.attn(self.ln_1(x), cache, mask)
        x = x + h
        fc, proj = self.mlp_c_fc, self.mlp_c_proj
        u = self.ln_2(x)
        # decode-shaped int8 pair: fc + gelu + proj in one kernel (K10) when
        # opted in; None -> the unfused pair
        m = qmlp(u, fc.kernel, fc.bias, proj.kernel, proj.bias, self.dtype)
        if m is None:
            hidden = F.gelu(_dense_apply(u, fc.kernel, fc.bias, self.dtype), approximate="tanh")
            m = _dense_apply(hidden, proj.kernel, proj.bias, self.dtype)
        return x + m, new_cache


class GPT2Core(nn.Module):
    """Positional embedding + blocks + final LN (no token embedding).
    ``remat`` / ``remat_policy``: see the module docstring."""

    def __init__(self, config: GPT2Config, dtype: torch.dtype = torch.float32, device=None,
                 remat: bool = False, remat_policy: tp.Optional[str] = None):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy takes one of {REMAT_POLICIES}, got {remat_policy!r}")
        self.config = config
        self.dtype = dtype
        self.remat = bool(remat)
        self.remat_policy = remat_policy
        self.wpe = nn.Parameter(torch.empty(config.n_positions, config.n_embd, device=device),
                                requires_grad=False)
        for i in range(config.n_layer):
            setattr(self, f"h_{i}", GPT2Block(config.n_embd, config.n_head, dtype, device))
        self.ln_f = LayerNormF32(config.n_embd, device)

    def forward(self, inputs_embeds: torch.Tensor,
                position_offset: tp.Union[int, torch.Tensor] = 0,
                cache: tp.Optional[Cache] = None, key_pad: tp.Optional[torch.Tensor] = None
                ) -> tp.Tuple[torch.Tensor, tp.Optional[Cache]]:
        cfg = self.config
        t = inputs_embeds.shape[1]
        # position_offset may be a (B, 1) tensor (left-padded batches: per-row
        # offsets, negative at pad slots). Clamp: pad slots get position 0
        # (their K/V are masked by key_pad anyway) and over-length decodes
        # stay at the last position.
        positions = (position_offset + torch.arange(t, device=inputs_embeds.device)
                     ).clamp(0, cfg.n_positions - 1)
        x = inputs_embeds.to(self.dtype) + gather_rows(self.wpe, positions).to(self.dtype)
        mask = None
        if cache is not None:
            # every layer's cache has the same index: one mask for all
            mask = cache_mask(cache[0]["index"], t, cache[0]["k"].shape[1], key_pad, x.device)
        new_caches: tp.Optional[Cache] = [] if cache is not None else None
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i in range(cfg.n_layer):
            block = getattr(self, f"h_{i}")
            if remat:
                x, nc = torch.utils.checkpoint.checkpoint(block, x, None, mask, use_reentrant=False,
                                                          **_remat_kwargs(self.remat_policy))
            else:
                x, nc = block(x, cache[i] if cache is not None else None, mask)
            if new_caches is not None:
                new_caches.append(nc)
        return self.ln_f(x), new_caches


class _Embed(nn.Module):
    def __init__(self, n: int, d: int, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(n, d, device=device), requires_grad=False)


def _init_cache(config: GPT2Config, dtype, device, batch: int, max_len: int) -> Cache:
    return [{"k": torch.zeros(batch, max_len, config.n_embd, dtype=dtype, device=device),
             "v": torch.zeros(batch, max_len, config.n_embd, dtype=dtype, device=device),
             "index": 0} for _ in range(config.n_layer)]


class GPT2(_TreeModule):
    """GPT-2 LM with tied input/output embeddings."""

    def __init__(self, config: GPT2Config, dtype: torch.dtype = torch.float32, device=None,
                 remat: bool = False, remat_policy: tp.Optional[str] = None):
        super().__init__()
        self._ctor = dict(config=config, dtype=dtype, remat=remat, remat_policy=remat_policy)
        self.config = config
        self.dtype = dtype
        self.wte = _Embed(config.vocab_size, config.n_embd, device)
        self.core = GPT2Core(config, dtype, device, remat, remat_policy)

    def init_cache(self, batch: int, max_len: int) -> Cache:
        return _init_cache(self.config, self.dtype, self.core.ln_f.scale.device, batch, max_len)

    def head_logits(self, h: torch.Tensor) -> torch.Tensor:
        table = self.wte.embedding
        if is_qleaf(table):   # tied head off a quantised wte: scale per vocab row
            return qdot(h, QLeaf(table.q.t(), table.scale.t()), torch.float32)
        return logits_f32(h, table)

    def forward(self, input_ids: tp.Optional[torch.Tensor] = None,
                inputs_embeds: tp.Optional[torch.Tensor] = None,
                position_offset: tp.Union[int, torch.Tensor] = 0,
                cache: tp.Optional[Cache] = None, key_pad: tp.Optional[torch.Tensor] = None,
                compute_logits: bool = True) -> tp.Dict[str, tp.Any]:
        """``compute_logits=False`` leaves ``logits`` out: a decode loop that
        reads its logits off a hoisted head table says so, because eager
        PyTorch would otherwise compute the in-model head every token."""
        if inputs_embeds is None:
            inputs_embeds = gather_rows(self.wte.embedding, input_ids)
        h, new_cache = self.core(inputs_embeds, position_offset, cache, key_pad)
        logits = self.head_logits(h) if compute_logits else None
        return {"logits": logits, "hidden": h, "cache": new_cache}


def build_gpt2(name: str, dtype: torch.dtype = torch.float32, device=None
               ) -> tp.Tuple[GPT2, GPT2Config]:
    cfg = GPT2_CONFIGS[name]
    return GPT2(cfg, dtype=dtype, device=device), cfg


# ---------------------------------------------------------------------------
# ClipGPT
# ---------------------------------------------------------------------------
class Adapter(nn.Module):
    """ReLU bottleneck bridge: Dense-ReLU-Dense-ReLU, no biases."""

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.fc1 = QDense(in_dim, hid_dim, use_bias=False, dtype=dtype, device=device)
        self.fc2 = QDense(hid_dim, out_dim, use_bias=False, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.fc2(F.relu(self.fc1(x))))


class ClipGPT(_TreeModule):
    """GPT-2 whose token space is CLIP's 49,408-token vocabulary.

    input path:  clip_emb[ids] -> emb adapter -> gpt core
    output path: hidden @ (head adapter(clip_emb)).T
    ``head_hid_dim=None`` shares the emb adapter as the head adapter.
    """

    def __init__(self, config: GPT2Config, clip_vocab_size: int = 49408, clip_emb_dim: int = 512,
                 emb_hid_dim: int = 1024, head_hid_dim: tp.Optional[int] = 1024,
                 dtype: torch.dtype = torch.float32, device=None, remat: bool = False,
                 remat_policy: tp.Optional[str] = None):
        super().__init__()
        self._ctor = dict(config=config, clip_vocab_size=clip_vocab_size, clip_emb_dim=clip_emb_dim,
                          emb_hid_dim=emb_hid_dim, head_hid_dim=head_hid_dim, dtype=dtype,
                          remat=remat, remat_policy=remat_policy)
        self.config = config
        self.dtype = dtype
        self.clip_emb = nn.Parameter(torch.empty(clip_vocab_size, clip_emb_dim, device=device),
                                     requires_grad=False)
        self.adapter_emb = Adapter(clip_emb_dim, emb_hid_dim, config.n_embd, dtype, device)
        if head_hid_dim is not None:
            self.adapter_head = Adapter(clip_emb_dim, head_hid_dim, config.n_embd, dtype, device)
        self.core = GPT2Core(config, dtype, device, remat, remat_policy)

    def _head_adapter(self) -> Adapter:
        return getattr(self, "adapter_head", self.adapter_emb)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """CLIP-space token embeddings (before the adapter); ``clip_emb`` may
        be an int8 leaf with per-row scales, gathered as stored."""
        return gather_rows(self.clip_emb, input_ids)

    def adapt_embeds(self, clip_space_embeds: torch.Tensor) -> torch.Tensor:
        """CLIP-space -> GPT-space."""
        return self.adapter_emb(clip_space_embeds.to(self.dtype))

    def lm_head_table(self) -> torch.Tensor:
        emb = self.clip_emb
        if is_qleaf(emb):
            emb = emb.dequantize()
        return self._head_adapter()(emb.to(self.dtype))

    def forward(self, input_ids: tp.Optional[torch.Tensor] = None,
                inputs_embeds: tp.Optional[torch.Tensor] = None,
                position_offset: tp.Union[int, torch.Tensor] = 0,
                cache: tp.Optional[Cache] = None, key_pad: tp.Optional[torch.Tensor] = None,
                compute_logits: bool = True) -> tp.Dict[str, tp.Any]:
        """``inputs_embeds`` are CLIP-space embeddings (the adapter is applied
        here). ``compute_logits=False`` skips the 49k-row head adapter, for a
        decode loop that reads its logits off a hoisted head table."""
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids)
        x = self.adapt_embeds(inputs_embeds)
        h, new_cache = self.core(x, position_offset, cache, key_pad)
        logits = None
        if compute_logits:
            logits = logits_f32(h, self.lm_head_table())
        return {"logits": logits, "hidden": h, "cache": new_cache}

    def init_cache(self, batch: int, max_len: int) -> Cache:
        return _init_cache(self.config, self.dtype, self.core.ln_f.scale.device, batch, max_len)


def decode_inputs(model: tp.Union[GPT2, ClipGPT], tokens: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """The block stack's input for one token a row: token embedding (through
    the emb adapter for a ClipGPT) plus position embedding, (B, D) f32.
    ``tokens`` and ``positions`` are (B,); positions clamp to the table."""
    if isinstance(model, ClipGPT):
        x = model.adapt_embeds(model.embed(tokens[:, None]))[:, 0]
    else:
        x = gather_rows(model.wte.embedding, tokens)
    pos = positions.clamp(0, model.config.n_positions - 1)
    return x.to(torch.float32) + gather_rows(model.core.wpe, pos).to(torch.float32)


def clip_gpt_trainable_mask(path: tp.Sequence[str], leaf=None) -> bool:
    """Adapters-only training."""
    return any(str(n).startswith("adapter_") for n in path)


def clip_gpt_full_trainable_mask(path: tp.Sequence[str], leaf=None) -> bool:
    """Everything except the token-embedding tables (positional embeddings do train)."""
    return not any(str(n) in ("clip_emb", "wte") for n in path)


# ---------------------------------------------------------------------------
# HF conversion
# ---------------------------------------------------------------------------
def convert_hf_gpt2(sd: tp.Mapping[str, tp.Any], n_layer: int) -> Tree:
    """HF transformers ``GPT2LMHeadModel`` state dict -> a tree for
    :meth:`GPT2.load_tree`. HF's ``Conv1D`` stores weights (in, out), as
    ``QDense`` does: no transpose. LayerNorm weight/bias map to scale/bias."""
    def A(key):
        t = sd[key]
        if hasattr(t, "detach"):
            t = t.detach().cpu().float().numpy()
        return torch.from_numpy(np.array(t, np.float32, copy=True))   # a copy: no aliasing

    def pfx(key):   # both `transformer.*` and bare layouts appear
        return key if key in sd else f"transformer.{key}"

    core: Tree = {
        "wpe": A(pfx("wpe.weight")),
        "ln_f": {"scale": A(pfx("ln_f.weight")), "bias": A(pfx("ln_f.bias"))},
    }
    for i in range(n_layer):
        p = pfx(f"h.{i}.ln_1.weight").rsplit(".ln_1", 1)[0]
        core[f"h_{i}"] = {
            "ln_1": {"scale": A(f"{p}.ln_1.weight"), "bias": A(f"{p}.ln_1.bias")},
            "ln_2": {"scale": A(f"{p}.ln_2.weight"), "bias": A(f"{p}.ln_2.bias")},
            "attn": {
                "c_attn": {"kernel": A(f"{p}.attn.c_attn.weight"), "bias": A(f"{p}.attn.c_attn.bias")},
                "c_proj": {"kernel": A(f"{p}.attn.c_proj.weight"), "bias": A(f"{p}.attn.c_proj.bias")},
            },
            "mlp_c_fc": {"kernel": A(f"{p}.mlp.c_fc.weight"), "bias": A(f"{p}.mlp.c_fc.bias")},
            "mlp_c_proj": {"kernel": A(f"{p}.mlp.c_proj.weight"), "bias": A(f"{p}.mlp.c_proj.bias")},
        }
    return {"wte": {"embedding": A(pfx("wte.weight"))}, "core": core}
