"""Process groups over the cards: the port's counterpart of the JAX mesh.

Counterpart of ``summer_clip_tpu/parallel/mesh.py``. The JAX package runs one
controller over a ``jax.sharding.Mesh`` of devices; here every rank is a
process of its own, on one card (or the CPU), joined by ``torch.distributed``:

- :func:`create_mesh` lays the group's ranks out on named axes, row-major as
  ``np.reshape`` lays out the JAX mesh's devices: ``('data', 'model')`` by
  default, or any axes given by name and size (the training layouts use
  ``('stage',)``, ``('data', 'stage')`` and ``('expert',)``), and gives each
  axis a process group (the whole group where the axis spans it, a
  ``new_group`` where it does not); :class:`Mesh` holds the axis sizes, this
  rank's coordinates and device, and those groups;
- :func:`distributed_init` joins the group that the environment names
  (``torchrun``'s ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``) and does nothing
  otherwise, as JAX's does for ``JAX_COORDINATOR_ADDRESS``;
- :func:`replicate` is the identity up to the device, since every rank holds
  its own copy; :func:`shard_batch` gives the rank its rows;
- :func:`launch` starts one process per rank (``torch.multiprocessing.spawn``)
  and joins them in a group, so that one command drives every card: the CUDA
  kernels are built in the caller first (ranks must not race to compile into
  ``build/``), the ranks get the ``PYTHONHASHSEED`` the caller started with
  (``0`` when it had none: the synthetic datasets draw each image from
  ``hash(path)``, so ranks must agree on it, and with the caller where it can),
  and each rank's return value and kernel launch counts come back to the
  caller.

Backends (:func:`backend_for`): NCCL where each rank has a card of its own,
gloo on the CPU and where ranks share a card (gloo all-reduces, broadcasts,
gathers and all-gathers CUDA tensors through the host; NCCL refuses two ranks
on one device). The caller's choice is kept: a group is never switched to
another backend after a failure.

Collectives on a mesh axis go through :func:`all_reduce` and
:func:`gather_rows`, which do nothing on an axis without a group (one
process, no ``torch.distributed``). The collectives GSPMD and ``shard_map``
insert in the JAX package's training step are explicit here, each an autograd
function whose backward is its transpose, built on all-reduce and all-gather
alone (the two collectives both backends take on a card):

- :func:`axis_copy` (Megatron's *f*): the identity, its backward sums the
  gradient over the axis (a replicated input that every rank feeds into its
  own part of a sum);
- :func:`axis_sum` (Megatron's *g*, a ``psum`` whose result every rank then
  holds): the sum over the axis, its backward the identity (every rank
  computes the same loss from it; a second sum would scale the gradient by
  the axis size);
- :func:`axis_all_gather`: a rank's shard gathered along a dim, its backward
  the gradient summed over the axis and cut back to the rank's shard (a
  reduce-scatter, as an all-reduce and a slice);
- :func:`axis_shift`: ``lax.ppermute`` from each coordinate i to i + 1
  (cyclic), its backward the reverse shift (an all-gather from which each
  rank takes its neighbour's part).

Sums run in f32 whatever the input's type (bf16 partial sums widened, summed
and rounded once); gathers move bytes and keep the type.
"""

from __future__ import annotations

import dataclasses
import math
import os
import pickle
import shutil
import socket
import tempfile
import typing as tp

import torch
import torch.distributed as dist

__all__ = ["Mesh", "create_mesh", "distributed_init", "replicate", "shard_batch", "launch",
           "backend_for", "rank_devices", "all_reduce", "gather_rows", "RankResult",
           "leads", "model_mesh", "kernel_counters", "axis_copy", "axis_sum", "axis_all_gather",
           "axis_shift", "all_gather"]

Device = tp.Union[str, torch.device]


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on the mesh's named axes (``shape`` in axis order).
    ``groups`` maps an axis to its process group, None where the axis has no
    collective to run (one process without ``torch.distributed``)."""
    shape: tp.Dict[str, int]
    coords: tp.Dict[str, int]
    rank: int
    device: torch.device
    groups: tp.Dict[str, tp.Any]

    @property
    def leads(self) -> bool:
        """Rank 0 writes what a one-device run writes (records, stores)."""
        return self.rank == 0

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def stride(self, axis: str) -> int:
        """How far apart two neighbours of ``axis`` are in rank order."""
        names = list(self.shape)
        out = 1
        for a in names[names.index(axis) + 1:]:
            out *= self.shape[a]
        return out


def backend_for(devices: tp.Sequence[Device]) -> str:
    """``nccl`` where every rank has a card of its own, else ``gloo``."""
    devs = [torch.device(d) for d in devices]
    cards = [d for d in devs if d.type == "cuda"]
    if cards and len(cards) == len(devs) and len({_card_index(d) for d in cards}) == len(cards):
        return "nccl"
    return "gloo"


def _card_index(dev: torch.device) -> int:
    return 0 if dev.index is None else int(dev.index)


def rank_devices(device: Device, world_size: int) -> tp.List[torch.device]:
    """The device of each of ``world_size`` ranks: on CUDA rank r takes card
    ``r % device_count()`` (more ranks than cards share them, as ``chip_smoke.py``
    runs two ranks on one card); on the CPU every rank takes the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * world_size
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device; pass device=\"cpu\" (meta.device=cpu) for the CPU")
    return [torch.device("cuda", r % n) for r in range(world_size)]


def distributed_init() -> bool:
    """Join the process group the environment names; a no-op without one or
    when a group exists. Returns whether a group exists.

    The environment is ``torchrun``'s: ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR`` (``MASTER_PORT`` too), with ``LOCAL_RANK`` picking the card:
    NCCL when each local rank has a card, else gloo."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return False
    world, me = int(env["WORLD_SIZE"]), int(env["RANK"])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if n and int(env.get("LOCAL_WORLD_SIZE", world)) <= n else "gloo"
    if n:
        torch.cuda.set_device(int(env.get("LOCAL_RANK", me)) % n)
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=me)
    return True


def leads() -> bool:
    """Whether this process writes what a one-device run writes: rank 0 of the
    process group, or a process without one."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _default_device() -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def create_mesh(data: tp.Optional[int] = None, model: int = 1,
                axes: tp.Optional[tp.Mapping[str, int]] = None) -> Mesh:
    """A mesh over the ranks of the process group (one rank without a group),
    this rank on its current card, or the CPU (the devices are named where the
    ranks start: :func:`launch`). By default a ``data x model`` mesh,
    ``data=None`` putting every rank on the data axis as in the JAX package;
    ``axes`` names the axes and their sizes instead, in order (``{"data": 2,
    "stage": 2}``). Ranks are laid out row-major. Every rank calls this with
    the same arguments (``new_group`` is collective)."""
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    if axes is None:
        if data is None:
            data = world // model
        axes = {"data": data, "model": model}
    shape = {str(k): int(v) for k, v in axes.items()}
    if math.prod(shape.values()) != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape.values()))} != {world} ranks")
    names = list(shape)
    strides = {a: math.prod(shape[b] for b in names[i + 1:]) for i, a in enumerate(names)}
    coords = {a: rank // strides[a] % shape[a] for a in names}
    groups: tp.Dict[str, tp.Any] = {a: None for a in names}
    if grouped:
        for a in names:
            if shape[a] == world:
                groups[a] = dist.group.WORLD
                continue
            # every rank creates every group of the axis, in the same order
            for base in range(world):
                if base // strides[a] % shape[a]:
                    continue            # not the first rank of its line along the axis
                members = [base + i * strides[a] for i in range(shape[a])]
                group = dist.new_group(members)
                if rank in members:
                    groups[a] = group
    return Mesh(shape, coords, rank, _default_device(), groups)


def model_mesh() -> tp.Optional[Mesh]:
    """Every rank of the process group on the ``model`` axis (the sharded
    cache's and tensor-parallel decode's mesh); None without a group. Joins
    the group the environment names first (``distributed_init``)."""
    if not distributed_init():
        return None
    return create_mesh(data=1, model=dist.get_world_size())


def replicate(tree: tp.Any, mesh: Mesh) -> tp.Any:
    """Every rank holds its own copy: the tree's tensors on the rank's device."""
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return torch.as_tensor(tree).to(mesh.device)


def _rows_of(n: int, mesh: Mesh, axis: str) -> slice:
    size = mesh.shape[axis]
    if n % size:
        raise ValueError(f"{n} rows do not split over {size} ranks of axis {axis!r}")
    share = n // size
    i = mesh.coords[axis]
    return slice(i * share, (i + 1) * share)


def shard_batch(tree: tp.Any, mesh: Mesh, axis: str = "data") -> tp.Any:
    """This rank's rows of every array (dim 0 split evenly over ``axis``, in
    the axis order); numpy arrays stay numpy, tensors stay where they are."""
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(v, mesh, axis) for v in tree)
    return tree[_rows_of(tree.shape[0], mesh, axis)]


def all_reduce(x: torch.Tensor, mesh: tp.Optional[Mesh], axis: str = "model") -> torch.Tensor:
    """Sum ``x`` over the ranks of ``axis`` in place (the JAX ``psum``); the
    identity where the axis has no group."""
    group = None if mesh is None else mesh.groups.get(axis)
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def gather_rows(x: torch.Tensor, mesh: tp.Optional[Mesh],
                axis: str = "data") -> tp.Optional[torch.Tensor]:
    """The rows of every rank of ``axis`` concatenated in the axis order, on
    the axis's first rank; None on the others (each rank holds the same number
    of rows). ``x`` itself where the axis has no group."""
    group = None if mesh is None else mesh.groups.get(axis)
    if group is None:
        return x
    i = mesh.coords[axis]
    first = mesh.rank - i * mesh.stride(axis)
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])] if i == 0 else None
    dist.gather(x.contiguous(), parts, dst=first, group=group)
    return torch.cat(parts) if i == 0 else None


def _group(mesh: tp.Optional[Mesh], axis: str):
    return None if mesh is None else mesh.groups.get(axis)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, out of place, added in f32."""
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def all_gather(x: torch.Tensor, mesh: tp.Optional[Mesh], axis: str) -> tp.List[torch.Tensor]:
    """Every rank's ``x`` along ``axis``, in the axis order (the bytes moved as
    they are: a bf16 tensor travels as uint8, a type both backends take).
    ``[x]`` without a group."""
    group = _group(mesh, axis)
    if group is None:
        return [x]
    x = x.contiguous()
    wire = x.view(torch.uint8) if x.dtype == torch.bfloat16 else x
    parts = [torch.empty_like(wire) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, wire, group=group)
    return [p.view(x.dtype) for p in parts]


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        return torch.cat(all_gather(x, mesh, axis), dim)

    @staticmethod
    def backward(ctx, grad):
        i = ctx.mesh.coords[ctx.axis]
        whole = _sum(grad, _group(ctx.mesh, ctx.axis))
        return whole.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, step):
        ctx.mesh, ctx.axis, ctx.step = mesh, axis, step
        parts = all_gather(x, mesh, axis)
        return parts[(mesh.coords[axis] - step) % len(parts)]

    @staticmethod
    def backward(ctx, grad):
        parts = all_gather(grad, ctx.mesh, ctx.axis)
        return parts[(ctx.mesh.coords[ctx.axis] + ctx.step) % len(parts)], None, None, None


def axis_copy(x: torch.Tensor, mesh: tp.Optional[Mesh], axis: str) -> torch.Tensor:
    """Megatron's *f*: ``x`` as it is, with its gradient summed over ``axis``."""
    group = _group(mesh, axis)
    return x if group is None else _Copy.apply(x, group)


def axis_sum(x: torch.Tensor, mesh: tp.Optional[Mesh], axis: str) -> torch.Tensor:
    """Megatron's *g*: the sum of ``x`` over ``axis`` (in f32, rounded to
    ``x``'s type once), its gradient passed through unchanged."""
    group = _group(mesh, axis)
    return x if group is None else _Sum.apply(x, group)


def axis_all_gather(x: torch.Tensor, mesh: tp.Optional[Mesh], axis: str,
                    dim: int = 0) -> torch.Tensor:
    """Every rank's shard of ``axis`` concatenated along ``dim``; the
    gradient is summed over the axis and cut back to this rank's shard."""
    if _group(mesh, axis) is None:
        return x
    return _AllGather.apply(x, mesh, axis, dim)


def axis_shift(x: torch.Tensor, mesh: tp.Optional[Mesh], axis: str, step: int = 1) -> torch.Tensor:
    """``lax.ppermute`` with ``perm = [(i, (i + step) % n)]``: this rank gets
    the ``x`` of coordinate ``i - step``; the gradient goes the other way."""
    if _group(mesh, axis) is None:
        return x
    return _Shift.apply(x, mesh, axis, step)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
class RankResult(tp.NamedTuple):
    """What one rank returned, and the launches of every kernel it made."""
    value: tp.Any
    launches: tp.Dict[str, int]


def kernel_counters() -> tp.Dict[str, tp.Any]:
    """Every kernel wrapper of the port, by name; each counts its own launches."""
    from summer_clip_torch.ops import attention as at
    from summer_clip_torch.ops import block_kernels as bk
    from summer_clip_torch.ops import cache_kernels as ck
    from summer_clip_torch.ops import decode_block as DB
    from summer_clip_torch.ops import gemv

    return {"K1 cache_dense": ck.cache_attention, "K2 labels_dense": ck.cache_attention_labels,
            "K3 onehot_grouped": ck.cache_attention_onehot,
            "K4 short_attention_packed": at.short_attention_packed,
            "K5 fused_ln_attn": bk.fused_ln_attn, "K6 fused_ln_mlp": bk.fused_ln_mlp,
            "K7 streamed_qmatmul": gemv.streamed_qmatmul, "K8 decode_block": DB.decode_block,
            "K9 fused_ln_mlp_chunked": bk.fused_ln_mlp_chunked,
            "K10 fused_qmlp": gemv.fused_qmlp, "K11 flash_attention": at.flash_attention,
            "K12 short_attention": at.short_attention, "K13 onehot_variant": ck.onehot_variant,
            "K14 blend_argmax_hits": ck.blend_argmax_hits}


def _start_hash_seed() -> tp.Optional[str]:
    """``PYTHONHASHSEED`` as this interpreter started with it, which set its
    string hashes: ``os.environ`` may have changed since (``set_random_state``
    writes it), ``/proc/self/environ`` has not."""
    try:
        with open("/proc/self/environ", "rb") as fh:
            for item in fh.read().split(b"\0"):
                if item.startswith(b"PYTHONHASHSEED="):
                    return item.split(b"=", 1)[1].decode()
        return None
    except OSError:
        return os.environ.get("PYTHONHASHSEED")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _build_kernels() -> None:
    """Every CUDA source, one nvcc each, all started together (a no-op for a
    source already built)."""
    import concurrent.futures

    from summer_clip_torch.ops import _lib

    names = sorted(p.stem for p in _lib.CSRC_DIR.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(_lib.build, n) for n in names]:
            f.result()


def _rank_main(rank: int, fn, devices, backend: str, init_method: str, out_dir: str,
               threads: int, args) -> None:
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=init_method, world_size=len(devices), rank=rank)
    try:
        counters = kernel_counters()
        for f in counters.values():
            f.launches = 0
        value = fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        result = RankResult(value, {k: int(f.launches) for k, f in counters.items()})
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: tp.Callable, devices: tp.Sequence[Device], *args,
           backend: tp.Optional[str] = None) -> tp.List[RankResult]:
    """Run ``fn(*args)`` once in each of ``len(devices)`` new processes, rank r
    on ``devices[r]``, all joined in one process group on ``localhost`` with
    ``backend`` (:func:`backend_for` by default). ``fn`` and ``args`` must
    pickle (``fn`` a module-level function). Returns each rank's
    :class:`RankResult` in rank order; a rank that raises makes this raise
    (``torch.multiprocessing.ProcessRaisedException``, with its traceback)."""
    import torch.multiprocessing as mp

    devs = [torch.device(d) for d in devices]
    backend = backend or backend_for(devs)
    if any(d.type == "cuda" for d in devs):
        _build_kernels()
    out_dir = tempfile.mkdtemp(prefix="summer_clip_ranks_")
    threads = max(1, (os.cpu_count() or 1) // len(devs))
    init_method = f"tcp://localhost:{_free_port()}"
    old_seed = os.environ.get("PYTHONHASHSEED")
    started = _start_hash_seed()
    os.environ["PYTHONHASHSEED"] = started if started not in (None, "random") else "0"
    try:
        mp.spawn(_rank_main, args=(fn, devs, backend, init_method, out_dir, threads, args),
                 nprocs=len(devs), join=True)
        results = []
        for r in range(len(devs)):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        return results
    finally:
        if old_seed is None:
            os.environ.pop("PYTHONHASHSEED", None)
        else:
            os.environ["PYTHONHASHSEED"] = old_seed
        shutil.rmtree(out_dir, ignore_errors=True)
