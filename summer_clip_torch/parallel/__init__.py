"""Multi-device serving: process-group meshes, the row-sharded cache and
tensor-parallel decode (``summer_clip_tpu/parallel``'s serving side)."""

from summer_clip_torch.parallel.mesh import (  # noqa: F401
    Mesh, all_reduce, create_mesh, distributed_init, gather_rows, launch, model_mesh,
    rank_devices, replicate, shard_batch,
)
from summer_clip_torch.parallel.sharded_cache import (  # noqa: F401
    ShardedResidentCache, pad_cache_for_mesh, sharded_cache_logits,
)
from summer_clip_torch.parallel.tp import (  # noqa: F401
    check_tp_divisibility, gpt2_tp_spec, shard_decode_tp,
)
from summer_clip_torch.parallel.tp_int8 import (  # noqa: F401
    TPInt8Decoder, permute_qkv_columns, shard_decode_tp_int8, tp_int8_decoder,
)
