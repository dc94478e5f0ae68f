"""Multi-device: process-group meshes and their autograd collectives, the
row-sharded cache, tensor-parallel decode and training, fully-sharded
parameters, the GPipe pipeline and the stacked block layout, and expert
parallelism (``summer_clip_tpu/parallel``)."""

from summer_clip_torch.parallel.mesh import (  # noqa: F401
    Mesh, all_reduce, axis_all_gather, axis_copy, axis_shift, axis_sum, create_mesh,
    distributed_init, gather_rows, launch, model_mesh, rank_devices, replicate, shard_batch,
)
from summer_clip_torch.parallel.sharded_cache import (  # noqa: F401
    ShardedResidentCache, pad_cache_for_mesh, sharded_cache_logits,
)
from summer_clip_torch.parallel.tp import (  # noqa: F401
    check_tp_divisibility, gpt2_tp_spec, shard_decode_tp, shard_params_tp,
)
from summer_clip_torch.parallel.tp_int8 import (  # noqa: F401
    TPInt8Decoder, permute_qkv_columns, shard_decode_tp_int8, tp_int8_decoder,
)
from summer_clip_torch.parallel.fsdp import (  # noqa: F401
    FSDP_MIN_ELEMS, fsdp_spec, shard_params_fsdp,
)
from summer_clip_torch.parallel.pp import (  # noqa: F401
    check_pp_divisibility, pipeline_blocks, pp_clip_gpt_forward, pp_gpt2_forward,
    scan_clip_gpt_forward, scan_gpt2_forward, shard_stacked_pp, stack_block_params,
    unstack_block_params,
)
from summer_clip_torch.parallel.ep import (  # noqa: F401
    MoEMLP, check_ep_divisibility, moe_apply_ep, moe_forward_dense, shard_experts_ep,
)
