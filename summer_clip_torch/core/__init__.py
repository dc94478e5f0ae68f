"""Core runtime: config composition, logging/metrics/timing."""

from summer_clip_torch.core.config import (  # noqa: F401
    ConfigNode, ConfigList, compose, load_config, instantiate, instantiate_all,
    load_obj, type_full_name, to_container, to_yaml, main, open_dict, merge,
)
from summer_clip_torch.core.log_utils import (  # noqa: F401
    LoggingManager, ConsoleLogger, JsonlLogger, NullExpLogger, StreamingMeans,
    Timer, TimeLog, setup_json_logging,
)
