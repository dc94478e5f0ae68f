"""Compatibility alias package: the reference's ``utils`` layer.

Counterpart of ``summer_clip_tpu/utils/__init__.py``. The runtime utilities
live in :mod:`summer_clip_torch.core` (config, logging, profiling) and
:mod:`summer_clip_torch.engine` (optimizers, trainer, seeding); this package
re-exports them under the reference's module names, so that
``summer_clip_torch.utils.*`` imports work for users migrating configs.
"""

from summer_clip_torch.core import config as hydra_utils  # noqa: F401
from summer_clip_torch.core import log_utils  # noqa: F401
from summer_clip_torch.core import profiling  # noqa: F401
from summer_clip_torch.engine.trainer import set_random_state  # noqa: F401
from summer_clip_torch.engine import optim as train_utils  # noqa: F401
from summer_clip_torch.engine.trainer import BaseTrainer, run_trainer  # noqa: F401
from summer_clip_torch.data import views as datasets  # noqa: F401
