"""Logging, metrics, and timing.

Copy of ``summer_clip_tpu/core/log_utils.py``. Covers the observability
surface of the reference (``summer_clip/utils/log_utils.py``): a fan-out
``LoggingManager`` over an experiment logger (a JSONL file) and a console
logger with grouped metric tables; ``StreamingMeans`` accumulation; and epoch
timers, wall-clock with the CUDA device drained at both ends.

Two differences from the JAX package's module: there is no wandb sink and no
``make_logger`` here (``summer_clip_torch.engine.trainer.make_logger`` builds
the only logger of the port, JSONL + console, so a run never opens a network
connection), and the timers drain CUDA, not XLA.
"""

from __future__ import annotations

import json
import logging
import time
import typing as tp
from collections import defaultdict
from pathlib import Path

__all__ = [
    "LoggingManager", "ConsoleLogger", "JsonlLogger",
    "NullExpLogger", "StreamingMeans", "Timer", "TimeLog",
    "setup_json_logging",
]


class _JsonLogFormatter(logging.Formatter):
    """JSON log records (reference uses pythonjsonlogger, conf/hydra_setup.yaml:4-11)."""

    def format(self, record: logging.LogRecord) -> str:
        payload: tp.Dict[str, tp.Any] = {
            "asctime": self.formatTime(record),
            "name": record.name,
            "levelname": record.levelname,
        }
        if isinstance(record.msg, dict):
            payload["message"] = None
            payload.update(_jsonable(record.msg))
        else:
            payload["message"] = record.getMessage()
        return json.dumps(payload, default=str)


def _jsonable(obj: tp.Any) -> tp.Any:
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item") and callable(obj.item):
        try:
            return obj.item()
        except Exception:
            return str(obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def setup_json_logging(log_file: tp.Union[str, Path], name: tp.Optional[str] = None,
                       level: int = logging.INFO
                       ) -> tp.Tuple[logging.Logger, logging.FileHandler]:
    """Attach a JSON-formatted file handler + plain stdout handler.

    Returns the logger AND the file handler it created, so callers can
    detach exactly that handler later (path comparison is unreliable —
    ``FileHandler.baseFilename`` and ``Path.resolve()`` canonicalize
    symlinks differently)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    fh = logging.FileHandler(log_file)
    fh.setFormatter(_JsonLogFormatter())
    logger.addHandler(fh)
    if not any(isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] %(message)s"))
        logger.addHandler(sh)
    return logger, fh


class NullExpLogger:
    """Experiment logger that drops everything ."""

    run_dir = "."

    def log(self, info: tp.Dict[str, tp.Any], step: tp.Optional[int] = None) -> None:
        pass

    def log_table(self, name: str, columns: tp.List[str], rows: tp.List[tp.List[tp.Any]]) -> None:
        pass

    def log_code(self, root: tp.Union[str, Path] = ".",
                 include: str = "**/*.py") -> tp.List[str]:
        """Snapshot the source tree for reproducibility (reference WandbLogger
        uploads every ``**/*.py`` as a wandb code artifact, log_utils.py:56-65).
        Returns the list of captured relative paths."""
        if type(self)._log_code_impl is NullExpLogger._log_code_impl:
            return []  # no sink — skip the tree walk entirely
        root = Path(root)
        files = sorted(
            str(p.relative_to(root)) for p in root.glob(include)
            if p.is_file() and "outputs" not in p.parts and ".git" not in p.parts
        )
        self._log_code_impl(root, files)
        return files

    def _log_code_impl(self, root: Path, files: tp.List[str]) -> None:
        pass

    def finish(self) -> None:
        pass


class JsonlLogger(NullExpLogger):
    """File-backed experiment logger: one JSON record per ``log`` call.

    This is the default machine-readable sink replacing wandb; analysis
    code filters records by their ``type`` field exactly like the reference
    notebooks do (``image_attention.py:98-120``).
    """

    def __init__(self, path: tp.Union[str, Path] = "records.jsonl",
                 config: tp.Optional[dict] = None):
        self.path = Path(path)
        self.run_dir = str(self.path.parent)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if config is not None:
            with open(self.path, "a") as f:
                f.write(json.dumps({"type": "config", "config": _jsonable(config)}) + "\n")

    def log(self, info: tp.Dict[str, tp.Any], step: tp.Optional[int] = None) -> None:
        rec = _jsonable(info)
        if step is not None:
            rec["step"] = step
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_table(self, name: str, columns: tp.List[str], rows: tp.List[tp.List[tp.Any]]) -> None:
        self.log({"type": "table", "name": name, "columns": columns, "rows": rows})

    def _log_code_impl(self, path_root: Path, files: tp.List[str]) -> None:
        import hashlib

        manifest = {
            f: hashlib.sha256((path_root / f).read_bytes()).hexdigest()[:16]
            for f in files
        }
        self.log({"type": "code_artifact", "root": str(path_root), "files": manifest})


class ConsoleLogger:
    """stdlib-logging console sink with grouped prefix/suffix metric tables.

    Metric keys are ``group/name``; ``format_info`` renders one line per
    group (reference ``log_utils.py:78-104``).
    """

    def __init__(self, name: str = "summer_clip_torch", logger: tp.Optional[logging.Logger] = None):
        self.logger = logger or logging.getLogger(name)
        if not self.logger.handlers and not logging.getLogger().handlers:
            logging.basicConfig(
                level=logging.INFO,
                format="[%(asctime)s][%(name)s][%(levelname)s] %(message)s",
            )

    @staticmethod
    def format_info(info: tp.Dict[str, tp.Any]) -> str:
        groups: tp.Dict[str, tp.List[str]] = defaultdict(list)
        for key, value in info.items():
            prefix, _, suffix = str(key).rpartition("/")
            sval = f"{value:.5f}" if isinstance(value, float) else str(value)
            groups[prefix].append(f"{suffix}: {sval}")
        lines = []
        for prefix, entries in groups.items():
            head = f"{prefix} | " if prefix else ""
            lines.append(head + ", ".join(entries))
        return "\n".join(lines)

    def log_info(self, msg: tp.Any) -> None:
        self.logger.info(msg)

    def log_epoch(self, epoch_num: int, info: tp.Dict[str, tp.Any]) -> None:
        self.logger.info("epoch %d\n%s", epoch_num, self.format_info(info))


class LoggingManager:
    """Fan-out to experiment logger + console (reference log_utils.py:27-49)."""

    def __init__(self, exp_logger: NullExpLogger, console_logger: ConsoleLogger):
        self.exp_logger = exp_logger
        self.console_logger = console_logger

    def log_info(self, info: tp.Any) -> None:
        self.console_logger.log_info(info)
        if isinstance(info, dict):
            self.exp_logger.log(info)

    def log_info_wandb(self, info: tp.Dict[str, tp.Any]) -> None:
        """Record-only log (skips console spam for dense sweep output)."""
        self.exp_logger.log(info)
        self.console_logger.logger.debug(info)

    def log_epoch(self, epoch_num: int, epoch_info: "StreamingMeans") -> None:
        info = epoch_info.to_dict() if isinstance(epoch_info, StreamingMeans) else dict(epoch_info)
        self.console_logger.log_epoch(epoch_num, info)
        self.exp_logger.log({"epoch": epoch_num, **info})

    def finish(self) -> None:
        self.exp_logger.finish()


class _StreamingMean:
    def __init__(self) -> None:
        self._sum = 0.0
        self._count = 0

    def update(self, value: tp.Any, weight: int = 1) -> None:
        if hasattr(value, "item"):
            value = float(value.item() if callable(value.item) else value)
        self._sum += float(value) * weight
        self._count += weight

    @property
    def mean(self) -> float:
        return self._sum / max(self._count, 1)


class StreamingMeans(dict):
    """Streaming means keyed by ``group/name`` (reference log_utils.py:171-228)."""

    def update_value(self, key: str, value: tp.Any, weight: int = 1) -> None:
        if key not in self:
            self[key] = _StreamingMean()
        self[key].update(value, weight)

    def update_values(self, values: tp.Dict[str, tp.Any], weight: int = 1) -> None:
        for k, v in values.items():
            self.update_value(k, v, weight)

    def to_dict(self, prefix: str = "") -> tp.Dict[str, float]:
        return {f"{prefix}{k}": v.mean for k, v in self.items()}


def _block_all() -> None:
    """Drain all queued CUDA work so wall-clock timings are honest."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Timer:
    """Context timer writing ``duration/<event>`` into a StreamingMeans.

    Wall-clock counterpart of the reference's CUDA-event timer
    (``log_utils.py:121-142``): the device is drained at both ends, so
    queued work is included.
    """

    def __init__(self, info: StreamingMeans, event: str, sync: bool = True):
        self.info = info
        self.event = event
        self.sync = sync

    def __enter__(self) -> "Timer":
        if self.sync:
            _block_all()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.sync:
            _block_all()
        self.info.update_value(f"duration/{self.event}", time.perf_counter() - self._t0)


class TimeLog:
    """ETA logger over a known number of steps (reference log_utils.py:145-168)."""

    def __init__(self, logger: LoggingManager, total_steps: int, event: str = "run"):
        self.logger = logger
        self.total_steps = total_steps
        self.event = event
        self.start = time.perf_counter()

    def now(self, step: int) -> None:
        elapsed = time.perf_counter() - self.start
        rate = elapsed / max(step, 1)
        eta = rate * (self.total_steps - step)
        self.logger.log_info(
            f"[{self.event}] step {step}/{self.total_steps} "
            f"elapsed {elapsed:.1f}s eta {eta:.1f}s"
        )

    def end(self) -> None:
        self.logger.log_info(
            f"[{self.event}] finished in {time.perf_counter() - self.start:.1f}s"
        )
