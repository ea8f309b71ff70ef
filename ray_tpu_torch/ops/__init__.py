"""Operator library of the port (counterpart of ``ray_tpu.ops``): norms,
rotary embeddings, attention with the Hopper flash kernels, and the
mixture-of-experts FFN."""

from .norms import layernorm, rmsnorm  # noqa: F401
from .rotary import apply_rotary, rotary_angles  # noqa: F401
from .attention import (  # noqa: F401
    multi_head_attention,
    reference_attention,
    repeat_kv,
)
from .moe import (  # noqa: F401
    expert_capacity,
    moe_ffn,
    moe_ffn_reference,
    route,
)
from .flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_bwd,
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
    flash_fwd,
    planted_fwd_faults,
    tile_rel_err,
)
