"""Trainer lifecycle: the template-method harness the port's apps run under.

Counterpart of ``summer_clip_tpu/engine/trainer.py`` with the same hooks:
``setup()`` chains the setup hooks, ``train_loop()`` iterates epochs with
timed train/val phases, metric logging and per-epoch checkpoints; one-shot
evaluators override ``train_loop``. :func:`run_trainer` guards the whole run
with a SIGTERM preemption guard (``engine/preemption.py``): after the first
signal the epoch in flight finishes, its checkpoint is written, and the loop
stops. The device comes from the config (``meta.device``) or is CUDA when
present; seeding covers python, numpy and torch, and ``self.generator`` is the
run's explicit ``torch.Generator``.

Several devices: an app's :meth:`BaseTrainer.world_size` is its rule for the
number of ranks (one by default; ``meta.world_size`` overrides the visible
cards where an app has a rule). :func:`run_trainer` starts that many
processes when it is not in a process group already (``parallel.launch``; a
group that ``torchrun`` or a caller made is joined by ``setup_mesh``), each
rank runs the app with ``self.mesh`` set, and rank 0 alone writes records and
files (:attr:`BaseTrainer.leads`). A SIGTERM may reach one rank only: a
training loop over a mesh calls :meth:`BaseTrainer.agree` once a step (one
small all-reduce of its values and the guard's flag), and from then on
:meth:`BaseTrainer.preempted` answers the flag the ranks agreed on, so every
rank stops at the same step and none waits alone in a collective.
"""

from __future__ import annotations

import contextlib
import logging
import os
import random
import time
import typing as tp

import numpy as np
import torch

from summer_clip_torch.core import log_utils
from summer_clip_torch.core.config import ConfigNode, to_container, to_yaml
from summer_clip_torch.core.device import resolve_device

__all__ = ["BaseTrainer", "run_trainer", "make_logger", "set_random_state", "resolve_device",
           "timed", "visible_world"]


def make_logger(project: str = "summer_clip_torch", name: tp.Optional[str] = None,
                config: tp.Optional[dict] = None) -> log_utils.LoggingManager:
    """Console + ``records.jsonl`` in the run dir. Unlike the JAX package's
    ``make_logger`` this never picks wandb, so a run opens no network
    connection whatever is installed. A rank other than 0 of a process group
    logs nothing: rank 0 writes the run's records."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        quiet = logging.getLogger("summer_clip_torch.quiet_rank")
        quiet.propagate = False
        if not quiet.handlers:
            quiet.addHandler(logging.NullHandler())
        return log_utils.LoggingManager(log_utils.NullExpLogger(),
                                        log_utils.ConsoleLogger(name or project, quiet))
    return log_utils.LoggingManager(log_utils.JsonlLogger("records.jsonl", config=config),
                                    log_utils.ConsoleLogger(name or project))


def set_random_state(seed: int) -> torch.Generator:
    """Seed python, numpy and torch globals; return a generator seeded alike."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def visible_world(cfg) -> int:
    """The ranks an app with a multi-device rule may take: ``meta.world_size``
    when set, else every visible card (one on the CPU)."""
    meta = cfg.get("meta", {}) or {}
    if meta.get("world_size") is not None:
        return int(meta.get("world_size"))
    device = resolve_device(meta.get("device"))
    return torch.cuda.device_count() if device.type == "cuda" else 1


@contextlib.contextmanager
def timed(info: log_utils.StreamingMeans, event: str, device: torch.device):
    """Write ``duration/<event>`` into ``info``; the device is drained at both
    ends, so queued CUDA work is counted."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    info.update_value(f"duration/{event}", time.perf_counter() - t0)


class BaseTrainer:
    _agreed_stop: tp.Optional[bool] = None     # set by agree()

    def __init__(self, cfg: ConfigNode):
        self.cfg = cfg
        self.generator: tp.Optional[torch.Generator] = None
        self.mesh = None

    @classmethod
    def world_size(cls, cfg: ConfigNode) -> int:
        """The app's rule for its number of ranks: one device unless an app
        says otherwise."""
        return 1

    @property
    def leads(self) -> bool:
        """Whether this rank writes what a one-device run writes: rank 0 of
        the mesh, or the only process."""
        return self.mesh is None or self.mesh.leads

    # -- setup hooks (overridden by apps) -----------------------------------
    def setup_logger(self):
        config_for_logger = to_container(self.cfg)
        config_for_logger["PID"] = os.getpid()
        exp = self.cfg.get("exp", {}) or {}
        project = exp.get("project", "summer_clip_torch") if hasattr(exp, "get") else "summer_clip_torch"
        name = exp.get("name", None) if hasattr(exp, "get") else None
        self.logger = make_logger(project, name, config_for_logger)

    def setup_rng(self):
        seed = int(self.cfg.get("meta", {}).get("random_state", 42))
        self.generator = set_random_state(seed)

    def setup_device(self):
        self.device = resolve_device(self.cfg.get("meta", {}).get("device"))

    def setup_mesh(self):
        """Hook for multi-device apps; one device (no mesh) by default. Joins
        the process group the environment names first (``distributed_init``
        is a no-op without one), as the JAX package's hook does."""
        from summer_clip_torch.parallel import distributed_init

        distributed_init()
        self.mesh = None

    def setup_dataset(self):
        pass

    def setup_loaders(self):
        pass

    def setup_model(self):
        pass

    def setup_optimizer(self):
        pass

    def setup_scheduler(self):
        pass

    def setup_loss(self):
        pass

    def setup(self):
        self.setup_rng()
        self.setup_logger()
        self.setup_device()
        self.setup_mesh()
        self.setup_dataset()
        self.setup_loaders()
        self.setup_model()
        self.setup_optimizer()
        self.setup_scheduler()
        self.setup_loss()

    # -- epoch hooks ---------------------------------------------------------
    def compute_metrics(self, epoch_num: int, epoch_info: log_utils.StreamingMeans):
        pass

    def train_epoch(self, epoch_num: int, epoch_info: log_utils.StreamingMeans):
        return epoch_info

    def validation_epoch(self, epoch_num: int, epoch_info: log_utils.StreamingMeans):
        return epoch_info

    def save_epoch_model(self, epoch_num: int):
        pass

    def _install_preemption_guard(self):
        """SIGTERM -> graceful stop (engine/preemption.py). SIGTERM only:
        trapping SIGINT would swallow the first Ctrl-C in apps whose own
        train_loop never polls the flag. Signal handlers are main-thread-only;
        a trainer driven from another thread runs unguarded."""
        import signal

        from summer_clip_torch.engine.preemption import PreemptionGuard

        try:
            self.preempt = PreemptionGuard(signals=(signal.SIGTERM,)).install()
        except ValueError:  # not the main thread
            self.preempt = None
        return self.preempt

    def preempted(self) -> bool:
        """Whether to stop: this process's SIGTERM guard, or over a mesh the
        flag the ranks agreed on at the last :meth:`agree`."""
        if self._agreed_stop is not None:
            return self._agreed_stop
        return self._signalled()

    def _signalled(self) -> bool:
        guard = getattr(self, "preempt", None)
        return guard is not None and guard.triggered

    def agree(self, *values: float) -> tp.List[float]:
        """One all-reduce over the process group (f64): the sums of
        ``values`` over the ranks, and whether any rank's guard was triggered,
        which :meth:`preempted` then answers on every rank. Without a mesh,
        the values as they are."""
        if self.mesh is None:
            return list(values)
        import torch.distributed as dist

        both = torch.tensor([*values, float(self._signalled())], dtype=torch.float64,
                            device=self.mesh.device)
        dist.all_reduce(both)
        self._agreed_stop = bool(both[-1] > 0)
        return both[:-1].tolist()

    def train_loop(self):
        epochs_num = int(self.cfg.training.epochs_num)
        calculate_every = int(self.cfg.get("log", {}).get("calculate_every", 1))
        time_log = log_utils.TimeLog(self.logger, epochs_num + 1, event="training")
        for epoch_num in range(1, epochs_num + 1):
            epoch_info = log_utils.StreamingMeans()
            with timed(epoch_info, "epoch_train", self.device):
                epoch_info = self.train_epoch(epoch_num, epoch_info)
            with timed(epoch_info, "epoch_val", self.device):
                epoch_info = self.validation_epoch(epoch_num, epoch_info)
            if epoch_num % calculate_every == 0:
                self.compute_metrics(epoch_num, epoch_info)
            self.logger.log_epoch(epoch_num, epoch_info)
            self.save_epoch_model(epoch_num)
            time_log.now(epoch_num)
            if self.preempted():
                self.logger.log_info({"type": "preempted", "epoch": epoch_num})
                break
        time_log.end()


def _rank_trainer(trainer_cls: tp.Type[BaseTrainer], cfg: ConfigNode) -> None:
    _run_here(trainer_cls, cfg)


def run_trainer(trainer_cls: tp.Type[BaseTrainer], cfg: ConfigNode):
    """Run the app: here when its world is one device or a process group
    exists (returns the trainer), else in ``trainer_cls.world_size(cfg)`` new
    processes (returns each rank's ``parallel.mesh.RankResult``)."""
    from summer_clip_torch.parallel import mesh as M

    print(to_yaml(cfg))
    if not M.distributed_init():
        world = trainer_cls.world_size(cfg)
        if world > 1:
            devices = M.rank_devices(resolve_device(cfg.get("meta", {}).get("device")), world)
            return M.launch(_rank_trainer, devices, trainer_cls, cfg)
    return _run_here(trainer_cls, cfg)


def _run_here(trainer_cls: tp.Type[BaseTrainer], cfg: ConfigNode) -> BaseTrainer:
    trainer = trainer_cls(cfg)
    # guard the whole run, setup included: an eviction does not wait for the
    # first epoch
    guard = trainer._install_preemption_guard()
    try:
        trainer.setup()
        trainer.train_loop()
    finally:
        if guard is not None:
            guard.restore()
    return trainer
