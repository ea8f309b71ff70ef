"""Model zoo of the port (counterpart of ``ray_tpu.models``): the
decoder-only transformer family, its whole-prompt generation path, its loss
and its training step."""

from .generate import (  # noqa: F401
    decode_step,
    generate,
    init_kv_cache,
    prefill,
)
from .transformer import (  # noqa: F401
    TransformerConfig,
    count_params,
    decode_flops_per_token,
    flops_per_token,
    forward,
    forward_with_aux,
    init_params,
    lm_loss,
    make_train_step,
    param_leaves,
    param_shapes,
    remat_policy,
)
