"""Shared app plumbing: CLIP sessions + feature extraction.

Counterpart of ``summer_clip_tpu/apps/common.py``. A :class:`ClipSession`
holds a frozen CLIP on an explicit device in the compute dtype. Its image and
token encoders run under ``torch.inference_mode()``; uint8 image batches are
normalized on the device, float32 batches (PIL without ``device_normalize``,
the native JPEG path) arrive normalized and go to the tower as they are.
:meth:`ClipSession.encode_text_embeds` runs with autograd, so prompt learning
differentiates through the frozen text tower with respect to the embeddings.

With a mesh (``parallel.create_mesh``) :func:`extract_image_features` splits
every batch over its ``data`` axis: each rank decodes and encodes only its own
rows of every batch (the batcher's ``shard``), and rank 0 gathers every
rank's features once, at the end, in the one-device run's row order; the
other ranks get none (only rank 0 writes the store and goes on). Encoders
otherwise run on every rank alike. :func:`data_parallel_mesh` is the apps'
rule for that mesh.
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np
import torch

from summer_clip_torch.core import profiling
from summer_clip_torch.core.device import resolve_device
from summer_clip_torch.data.loader import Batch
from summer_clip_torch.data.transforms import CLIP_MEAN, CLIP_STD
from summer_clip_torch.data.prefetch import prefetch_to_device
from summer_clip_torch.models.clip.modeling import CLIP, build_clip
from summer_clip_torch.models.clip.convert import load_clip

__all__ = ["ClipSession", "create_clip_session", "extract_image_features", "resolve_dtype",
           "resolve_prompting", "data_parallel_mesh", "data_parallel_world"]


def resolve_dtype(name: tp.Optional[str], device: torch.device) -> torch.dtype:
    """``None``/``"auto"``: bf16 on CUDA (the kernels' dtype), f32 on CPU."""
    if name in (None, "auto"):
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    return {"float32": torch.float32, "fp32": torch.float32, "bfloat16": torch.bfloat16,
            "bf16": torch.bfloat16}[str(name)]


class ClipSession:
    """Frozen CLIP on one device (per rank) with encode entry points."""

    def __init__(self, model: CLIP, cfg, device: torch.device, mesh=None):
        self.model = model
        self.cfg = cfg
        self.device = device
        self.mesh = mesh if mesh is not None and mesh.groups.get("data") is not None else None
        self._mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=device)
        self._std = torch.tensor(CLIP_STD, dtype=torch.float32, device=device)

    def _prep(self, images) -> torch.Tensor:
        images = torch.as_tensor(images).to(self.device)
        if images.dtype == torch.uint8:
            images = (images.float() / 255.0 - self._mean) / self._std
        return images

    @torch.inference_mode()
    def encode_image(self, images) -> torch.Tensor:
        return self.model.encode_image(self._prep(images))

    @torch.inference_mode()
    def encode_image_preproj(self, images) -> torch.Tensor:
        """Image features before the final vision projection (ProLIP's input)."""
        return self.model.encode_image_preproj(self._prep(images))

    def vision_projection(self) -> np.ndarray:
        """(width, embed_dim) final vision projection W0 in f32 (ViT towers)."""
        return self.model.visual.proj.detach().float().cpu().numpy()

    @torch.inference_mode()
    def encode_text(self, tokens) -> torch.Tensor:
        return self.model.encode_text(torch.as_tensor(tokens).to(self.device).long())

    def encode_text_embeds(self, embeds: torch.Tensor, lens) -> torch.Tensor:
        """Text features of (B, T, width) token embeddings pooled at
        ``lens - 1``; differentiable with respect to ``embeds`` (not under
        ``inference_mode``: the tower's parameters stay frozen)."""
        return self.model.encode_text_embeds(embeds.to(self.device),
                                             torch.as_tensor(lens).to(self.device))

    def token_embedding_table(self) -> np.ndarray:
        """(vocab, width) CLIP token embeddings in f32 (the prompt-learning
        substrate)."""
        return self.model.token_embedding.weight.detach().float().cpu().numpy()

    @property
    def logit_scale(self) -> float:
        return float(self.model.logit_scale.detach().float().exp())

    @property
    def embed_dim(self) -> int:
        return self.cfg.embed_dim

    @property
    def input_size(self) -> int:
        return self.cfg.image_resolution


def create_clip_session(model_name: str, checkpoint_path: tp.Optional[str] = None,
                        dtype: tp.Optional[str] = None,
                        device: tp.Optional[tp.Union[str, torch.device]] = None,
                        logger: tp.Optional[tp.Any] = None,
                        proj_path: tp.Optional[str] = None,
                        quant: tp.Optional[str] = None, seed: int = 0,
                        remat: tp.Optional[bool] = None, mesh=None) -> ClipSession:
    """A session from a converted checkpoint when ``checkpoint_path`` exists,
    otherwise random towers drawn from ``torch.Generator().manual_seed(seed)``.
    ``proj_path``: optional ``.npy`` (width, embed_dim) vision projection.
    ``remat``: checkpoint every residual block's activations when a gradient
    flows through the towers (config ``clip.remat``). ``quant="int8"``: the
    int8 towers (config ``clip.quant``, ``models.clip.modeling``). ``mesh``:
    extraction batches split over its ``data`` axis (every rank builds the
    same towers from the same seed or checkpoint)."""
    device = resolve_device(device)
    tdtype = resolve_dtype(dtype, device)
    if checkpoint_path and Path(checkpoint_path).exists():
        model, cfg = load_clip(checkpoint_path, dtype=tdtype, device=device, quant=quant)
        if logger:
            logger.log_info(f"Loaded CLIP weights from {checkpoint_path} ({cfg.name})")
    else:
        if checkpoint_path and logger:
            logger.log_info(f"WARNING: checkpoint {checkpoint_path} not found - random init")
        model, cfg = build_clip(model_name, torch.Generator().manual_seed(seed),
                                dtype=tdtype, device=device, quant=quant)
    if proj_path:
        w = torch.from_numpy(np.load(proj_path))
        old = model.visual.proj
        if tuple(w.shape) != tuple(old.shape):
            raise ValueError(f"projection shape {tuple(w.shape)} != tower {tuple(old.shape)}")
        with torch.no_grad():
            old.copy_(w.to(old.dtype))
        if logger:
            logger.log_info(f"Swapped vision projection from {proj_path}")
    return ClipSession(model.set_remat(bool(remat)), cfg, device, mesh=mesh)


def data_parallel_world(cfg, batch_size: int) -> int:
    """The ranks of a data-parallel extraction: every visible card
    (``meta.world_size`` when set) when the batch divides over them, else one,
    the JAX package's rule."""
    from summer_clip_torch.engine.trainer import visible_world

    n = visible_world(cfg)
    return n if n > 1 and batch_size % n == 0 else 1


def data_parallel_mesh(batch_size: int):
    """The mesh of a data-parallel extraction: every rank of the process group
    on the ``data`` axis when the batch divides over them, else None (one
    device). Joins the group the environment names first (``distributed_init``)."""
    import torch.distributed as dist

    from summer_clip_torch.parallel import create_mesh, distributed_init

    if not distributed_init():
        return None
    n = dist.get_world_size()
    return create_mesh(data=n, model=1) if batch_size % n == 0 else None


def resolve_prompting(cfg, view) -> tp.Tuple[tp.Sequence[str], tp.Sequence[str]]:
    """(classes, templates): config overrides win, else the dataset's own."""
    prompting = cfg.get("prompting")
    templates = (prompting.get("templates") if prompting else None) or view.template
    classes = (prompting.get("classes") if prompting else None) or view.classes
    return classes, templates


def extract_image_features(session: ClipSession, batcher: tp.Iterable[Batch],
                           preproj: bool = False
                           ) -> tp.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stream batches through the image tower -> (features (N, D) f32, labels,
    indices), padded tail rows dropped by the batch mask, rows in a stable
    sort on dataset index. Features stay on the device until the end, so the
    host never waits for the device inside the loop. ``preproj=True``: the
    features before the final projection (ProLIP's input).

    With the session's mesh each rank decodes and encodes only its rows of
    every batch (``batcher.shard``), and the axis's first rank gathers every
    rank's rows at the end; the other ranks return no rows.

    Spans (``core/profiling``): ``extract`` around the call, ``extract.load``
    and ``extract.stage`` (``data/prefetch``), ``extract.encode`` a batch,
    ``extract.gather`` after the last batch with ``extract.fetch`` around its
    blocking copies; counters ``extract.batches`` and ``extract.images``
    (rows the masks keep)."""
    from summer_clip_torch.parallel import gather_rows

    with profiling.span("extract"):
        mesh = session.mesh
        if mesh is not None:
            batcher = batcher.shard(mesh.coords["data"], mesh.shape["data"])
        encode = session.encode_image_preproj if preproj else session.encode_image
        feats_parts: tp.List[torch.Tensor] = []
        labels_parts, index_parts, masks = [], [], []
        for batch in prefetch_to_device(batcher, session.device, size=2):
            with profiling.span("extract.encode"):
                feats_parts.append(encode(batch.images))
            profiling.count("extract.batches")
            labels_parts.append(batch.labels)
            index_parts.append(batch.indices)
            masks.append(batch.mask)
        with profiling.span("extract.gather"):
            local = torch.cat(feats_parts)
            feats = gather_rows(local, mesh, "data")
            meta = np.stack([np.concatenate(labels_parts), np.concatenate(index_parts),
                             np.concatenate(masks)], 1).astype(np.int64)
            profiling.count("extract.images", int(meta[:, 2].sum()))
            with profiling.span("extract.fetch"):
                # blocking copies: the metadata's upload waits for the card's queue
                meta = gather_rows(torch.from_numpy(meta).to(session.device), mesh, "data")
                if feats is None:   # not the axis's first rank
                    return (np.zeros((0, local.shape[1]), np.float32), np.zeros(0, np.int32),
                            np.zeros(0, np.int32))
                feats, meta = feats.float().cpu().numpy(), meta.cpu().numpy()
            labels, indices = meta[:, 0].astype(np.int32), meta[:, 1].astype(np.int32)
            mask = meta[:, 2] > 0
            feats, labels, indices = feats[mask], labels[mask], indices[mask]
            order = np.argsort(indices, kind="stable")
            return feats[order], labels[order], indices[order]
