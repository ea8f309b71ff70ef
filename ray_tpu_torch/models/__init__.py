"""Model zoo of the port (counterpart of ``ray_tpu.models``): the
decoder-only transformer family (dense or a mixture of experts), its
whole-prompt generation path, the continuous-batching engine's slot
functions, its loss and its training step; and the ViT family."""

from .generate import (  # noqa: F401
    cache_gather_slot,
    cache_insert_slot,
    decode_step,
    decode_step_slots,
    draft_propose_slots,
    generate,
    init_kv_cache,
    init_slot_cache,
    prefill,
    prefill_chunk,
    prefill_chunked,
    resume_prefill,
    verify_step_slots,
)
from .transformer import (  # noqa: F401
    TransformerConfig,
    count_params,
    decode_flops_per_token,
    engine_flops_table,
    flops_per_token,
    forward,
    forward_with_aux,
    init_params,
    lm_loss,
    local_leaves,
    make_train_step,
    param_leaves,
    param_shapes,
    params_axes,
    remat_policy,
    whole_params,
)
from .vit import (  # noqa: F401
    ViTConfig,
    init_vit_params,
    make_vit_train_step,
    vit_forward,
    vit_loss,
    vit_param_shapes,
    vit_params_axes,
)
