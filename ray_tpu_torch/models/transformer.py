"""Decoder-only transformer (GPT-2 and Llama families) in PyTorch.

Counterpart of ``ray_tpu/models/transformer.py``: the forward, the loss
and the training step.  Parameters are a plain nested dict of tensors in the
JAX package's stacked layout (``wq`` [L, d, h, hd], ``wo`` [L, h, hd, d],
...), so weights carry across with a pure copy (`ray_tpu_torch.convert`).
The layer stack is a Python loop over the leading "layers" axis, each layer
under `torch.utils.checkpoint` as ``cfg.remat`` says.  Attention goes
through `ray_tpu_torch.ops.multi_head_attention`, which on the card is the
Hopper flash kernels, forward and backward.  With ``n_experts > 0`` every
layer's FFN is a mixture of experts (`ray_tpu_torch.ops.moe_ffn`), and the
loss adds the router's load-balancing term.

Under a mesh (`parallel.use_mesh`) the same functions run SPMD, one rank a
device, as the JAX package's run under ``jax.set_mesh``: each rank takes
its rows of the batch (split over ``dp`` × ``fsdp``); with
``attention_impl="ring"`` and an ``sp`` axis wider than 1 each rank runs
its block of the sequence (positions and rotary angles offset to its
place, attention by `ops.ring_attention`); with ``pp_stages > 1`` the layer
stack runs as a GPipe pipeline over ``pp`` (`parallel.pipeline`).  The
loss is the global batch's on every rank.  `params_axes` gives the logical
axes `parallel.shard_pytree` places the weights by; `make_train_step`
gathers placed weights (DTensors) for the products and hands each gradient
back in its weight's placement; the serving entry points gather them whole
once a call (`whole_params`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..device import DeviceLike, resolve_device
from ..ops.attention import multi_head_attention
from ..ops.moe import moe_ffn
from ..ops.norms import layernorm, rmsnorm
from ..ops.rotary import apply_rotary, rotary_angles
from ..parallel.collectives import (all_gather, all_gather_invariant,
                                    axis_index, psum)
from ..parallel.mesh import axis_size, current_mesh
from ..parallel.pipeline import microbatch, pipeline_apply, unmicrobatch
from ..parallel.sharding import batch_rows, gather_for_compute

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50304          # GPT-2 vocab padded to a 128 multiple
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    n_kv_heads: Optional[int] = None  # None → MHA
    d_ff: Optional[int] = None        # None → 4*d_model (gelu) / 8/3 (swiglu)
    max_seq_len: int = 1024
    pos_emb: str = "learned"          # "learned" | "rope"
    activation: str = "gelu"          # "gelu" | "swiglu"
    norm: str = "layernorm"           # "layernorm" | "rmsnorm"
    tie_embeddings: bool = True
    rope_base: float = 10000.0
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "auto"      # "auto"|"flash"|"reference"|"ring"
    causal: bool = True               # False → bidirectional (encoders)
    remat: Any = True                 # False | True (full) | "dots": save
    #   the outputs of products without batch dimensions, recompute the rest
    embed_impl: str = "gather"        # "gather" | "one_hot" (matmul)
    norm_remat: bool = False          # recompute the norms in the backward
    loss_chunk: int = 0               # >0 → cross entropy [b, chunk, vocab]
    #   logits at a time, each chunk recomputed in the backward
    # -- pipeline parallelism (parallel/pipeline.py) -------------------------
    pp_stages: int = 1                # >1 → GPipe schedule over mesh "pp"
    pp_microbatches: Optional[int] = None  # None → pp_stages
    # -- mixture of experts (ops/moe.py) ------------------------------------
    n_experts: int = 0                # 0 → dense FFN
    expert_top_k: int = 2
    capacity_factor: float = 2.0
    router_aux_weight: float = 0.01   # Switch load-balancing loss weight

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def ff_dim(self) -> int:
        if self.d_ff is not None:
            return self.d_ff
        if self.activation == "swiglu":
            # Llama convention: 8/3 * d, rounded up to a 256 multiple
            return ((int(8 * self.d_model / 3) + 255) // 256) * 256
        return 4 * self.d_model

    # -- presets (sizes follow the public GPT-2/Llama papers) ---------------
    @staticmethod
    def gpt2(size: str = "small", **kw) -> "TransformerConfig":
        d, l, h = {"small": (768, 12, 12), "medium": (1024, 24, 16),
                   "large": (1280, 36, 20), "xl": (1600, 48, 25)}[size]
        return TransformerConfig(
            vocab_size=50304, d_model=d, n_layers=l, n_heads=h,
            max_seq_len=kw.pop("max_seq_len", 1024), pos_emb="learned",
            activation="gelu", norm="layernorm", tie_embeddings=True, **kw)

    @staticmethod
    def llama(size: str = "1b", **kw) -> "TransformerConfig":
        dims = {  # d_model, layers, heads, kv_heads, d_ff, vocab
            "tiny": (512, 4, 8, 4, 1408, 32000),
            "1b": (2048, 16, 32, 8, 8192, 128256),
            "3b": (3072, 28, 24, 8, 8192, 128256),
            "8b": (4096, 32, 32, 8, 14336, 128256),
        }[size]
        d, l, h, hk, ff, v = dims
        return TransformerConfig(
            vocab_size=v, d_model=d, n_layers=l, n_heads=h, n_kv_heads=hk,
            d_ff=ff, max_seq_len=kw.pop("max_seq_len", 4096),
            pos_emb="rope", activation="swiglu", norm="rmsnorm",
            tie_embeddings=False, **kw)

    @staticmethod
    def tiny(**kw) -> "TransformerConfig":
        """Test-sized model that still exercises every code path."""
        defaults = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, max_seq_len=128, pos_emb="rope",
                        activation="swiglu", norm="rmsnorm",
                        tie_embeddings=False, remat=False)
        defaults.update(kw)
        return TransformerConfig(**defaults)


def _per_layer_matmul_params(cfg: TransformerConfig, active: bool) -> int:
    """Matmul parameters per layer; for MoE, ``active`` counts only the
    top-k experts a token visits (the FLOP count), ``active=False`` every
    expert (the memory count)."""
    d, ff, hd = cfg.d_model, cfg.ff_dim, cfg.head_dim
    attn = d * cfg.n_heads * hd + 2 * d * cfg.kv_heads * hd \
        + cfg.n_heads * hd * d
    mlp = d * ff * (3 if cfg.activation == "swiglu" else 2)
    if cfg.n_experts:
        mult = cfg.expert_top_k if active else cfg.n_experts
        mlp = mult * mlp + d * cfg.n_experts       # + router
    return attn + mlp


def count_params(cfg: TransformerConfig) -> int:
    d = cfg.d_model
    norms = 2 * d * (2 if cfg.norm == "layernorm" else 1)
    per_layer = _per_layer_matmul_params(cfg, active=False) + norms
    emb = cfg.vocab_size * d
    if cfg.pos_emb == "learned":
        emb += cfg.max_seq_len * d
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    final = d * (2 if cfg.norm == "layernorm" else 1)
    return cfg.n_layers * per_layer + emb + head + final


def flops_per_token(cfg: TransformerConfig, seq_len: int) -> float:
    """Training FLOPs/token: 6*N_active_matmul + the attention term (causal
    or bidirectional)."""
    n_matmul = cfg.n_layers * _per_layer_matmul_params(cfg, active=True) \
        + cfg.vocab_size * cfg.d_model
    attn_factor = 6 if cfg.causal else 12
    attn = attn_factor * cfg.n_layers * cfg.n_heads * cfg.head_dim * seq_len
    return 6 * n_matmul + attn


def decode_flops_per_token(cfg: TransformerConfig,
                           context_len: int) -> float:
    """Inference forward FLOPs for ONE token at cache position
    ``context_len``: 2*N_active_matmul plus the attention reads of the
    cache."""
    n_matmul = cfg.n_layers * _per_layer_matmul_params(cfg, active=True) \
        + cfg.vocab_size * cfg.d_model
    attn = 4 * cfg.n_layers * cfg.n_heads * cfg.head_dim * context_len
    return 2 * n_matmul + attn


def engine_flops_table(cfg: TransformerConfig, max_len: int,
                       draft_cfg: Optional[TransformerConfig] = None
                       ) -> Dict[str, float]:
    """Analytic FLOPs per token of each program of the serve engine (the
    dispatch profiler's MFU numerators), at the mid-stream cache position
    ``max_len // 2``, the average context a token attends over a full
    stream.  The copy programs (cache insert/gather) are 0: they move
    bytes, not FLOPs."""
    mid = max(1, max_len // 2)
    target = decode_flops_per_token(cfg, mid)
    table = {
        "decode_step": target,
        "prefill_chunk": target,   # per prompt token, the same forward
        "verify": target,          # spec_k-wide target forward per token
        "cache_insert": 0.0,
        "prefix_gather": 0.0,
    }
    if draft_cfg is not None:
        draft = decode_flops_per_token(draft_cfg, mid)
        table["draft_propose"] = draft
        table["draft_prefill_chunk"] = draft
    return table


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def param_shapes(cfg: TransformerConfig) -> Params:
    """The parameter tree's shapes: the JAX package's stacked layout."""
    d, hd, h, hk, ff, L = (cfg.d_model, cfg.head_dim, cfg.n_heads,
                           cfg.kv_heads, cfg.ff_dim, cfg.n_layers)
    layers = {"attn_norm": (L, d), "wq": (L, d, h, hd),
              "wk": (L, d, hk, hd), "wv": (L, d, hk, hd),
              "wo": (L, h, hd, d), "mlp_norm": (L, d)}
    # experts stack on an axis after the layers': w_in [L, E, d, ff]
    experts = (cfg.n_experts,) if cfg.n_experts else ()
    if cfg.n_experts:
        layers["router"] = (L, d, cfg.n_experts)
    layers["w_in"] = (L, *experts, d, ff)
    layers["w_out"] = (L, *experts, ff, d)
    if cfg.activation == "swiglu":
        layers["w_gate"] = (L, *experts, d, ff)
    tree: Params = {"embed": {"tok": (cfg.vocab_size, d)}, "layers": layers,
                    "final_norm": (d,)}
    if cfg.norm == "layernorm":
        layers["attn_norm_b"] = (L, d)
        layers["mlp_norm_b"] = (L, d)
        tree["final_norm_b"] = (d,)
    if cfg.pos_emb == "learned":
        tree["embed"]["pos"] = (cfg.max_seq_len, d)
    if not cfg.tie_embeddings:
        tree["lm_head"] = (d, cfg.vocab_size)
    return tree


def params_axes(cfg: TransformerConfig) -> Params:
    """The logical axes of every parameter (the JAX `init_params`' second
    tree, leaf for leaf): what `parallel.shard_pytree` places them by.
    Stacked layer weights lead with "layers"."""
    layers = {"attn_norm": ("layers", "embed"),
              "wq": ("layers", "embed", "heads", "kv"),
              "wk": ("layers", "embed", "heads", "kv"),
              "wv": ("layers", "embed", "heads", "kv"),
              "wo": ("layers", "heads", "kv", "embed"),
              "mlp_norm": ("layers", "embed")}
    experts = ("expert",) if cfg.n_experts else ()
    if cfg.n_experts:
        layers["router"] = ("layers", "embed", "expert")
    layers["w_in"] = ("layers", *experts, "embed", "mlp")
    layers["w_out"] = ("layers", *experts, "mlp", "embed")
    if cfg.activation == "swiglu":
        layers["w_gate"] = ("layers", *experts, "embed", "mlp")
    tree: Params = {"embed": {"tok": ("vocab", "embed")}, "layers": layers,
                    "final_norm": ("embed",)}
    if cfg.norm == "layernorm":
        layers["attn_norm_b"] = ("layers", "embed")
        layers["mlp_norm_b"] = ("layers", "embed")
        tree["final_norm_b"] = ("embed",)
    if cfg.pos_emb == "learned":
        tree["embed"]["pos"] = (None, "embed")
    if not cfg.tie_embeddings:
        tree["lm_head"] = ("embed", "vocab")
    return tree


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random weights drawn from ``generator`` on ``device``, with the JAX
    package's scales: matmul weights N(0, 1/fan_in), token embedding
    N(0, 0.02²), learned positions N(0, 0.01²), norms 1 and biases 0."""
    device = resolve_device(device)
    pt = cfg.param_dtype
    fan_in = {"wq": cfg.d_model, "wk": cfg.d_model, "wv": cfg.d_model,
              "wo": cfg.n_heads * cfg.head_dim, "w_in": cfg.d_model,
              "w_gate": cfg.d_model, "w_out": cfg.ff_dim,
              "router": cfg.d_model, "lm_head": cfg.d_model}

    def make(name, shape):
        if "norm" in name:
            fill = 0.0 if name.endswith("_b") else 1.0
            return torch.full(shape, fill, dtype=pt, device=device)
        x = torch.randn(shape, generator=generator, dtype=pt, device=device)
        if name == "tok":
            return x * 0.02
        if name == "pos":
            return x * 0.01
        return x / math.sqrt(fan_in[name])

    def walk(tree):
        return {name: walk(v) if isinstance(v, dict) else make(name, v)
                for name, v in tree.items()}

    return walk(param_shapes(cfg))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

# the mesh axes a batch splits over (every rule table's "batch")
BATCH_AXES = ("dp", "fsdp")


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where this rank sits in the mesh, as the model sees it.  Each entry
    point (`forward_with_aux`, `lm_loss`) reads the ambient mesh once and
    hands its layout down to every layer: a layer recomputed in the
    backward (remat) then runs as in the forward, wherever the backward
    is taken."""
    mesh: Optional[DeviceMesh] = None
    sp: int = 1              # ranks the sequence is split over
    sp_index: int = 0
    batch_axes: Tuple[str, ...] = ()   # live axes the batch is split over

    @property
    def summed_axes(self) -> Tuple[str, ...]:
        """The axes whose ranks compute on different data: their gradients
        of a weight add up."""
        return self.batch_axes + (("sp",) if self.sp > 1 else ())

    def seq_block(self, s: int) -> Tuple[int, int]:
        """This rank's positions [lo, hi) of a sequence of s."""
        if s % self.sp:
            raise ValueError(f"sequence of {s} does not split over "
                             f"sp={self.sp} ranks")
        c = s // self.sp
        return self.sp_index * c, (self.sp_index + 1) * c


def _layout(cfg: TransformerConfig) -> _Layout:
    """The ambient mesh's layout for ``cfg``: the sequence splits over sp
    only under ring attention (other attention needs the whole sequence,
    so sp ranks then compute the same)."""
    mesh = current_mesh()
    if mesh is None:
        return _NO_MESH
    sp = axis_size("sp", mesh) if cfg.attention_impl == "ring" else 1
    return _Layout(mesh=mesh, sp=sp,
                   sp_index=axis_index("sp", mesh) if sp > 1 else 0,
                   batch_axes=tuple(a for a in BATCH_AXES
                                    if axis_size(a, mesh) > 1))


_NO_MESH = _Layout()


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_ONE_HOT_CHUNK = 1024   # tokens per one-hot block: [1024, vocab] at a time


def _save_dots(ctx, op, *args, **kwargs):
    """Policy of ``remat="dots"``: keep the outputs of products with no
    batch dimensions (``aten.mm`` / ``addmm``: the projections and the
    FFN), as JAX's `dots_with_no_batch_dims_saveable` does, and recompute
    everything else, the attention kernel included."""
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(remat) -> Optional[Callable]:
    """A config's ``remat`` → the ``context_fn`` that `torch.utils.checkpoint`
    runs each layer under, or None when remat is off."""
    if not remat:
        return None
    if remat == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
    if remat is True:
        return noop_context_fn
    # an unrecognized string must not silently mean full remat
    raise ValueError(f"remat={remat!r}: expected False, True, or 'dots'")


def _norm(cfg, x, scale, bias):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, scale)
    return layernorm(x, scale, bias)


def _heads(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    return (y @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _project_kv(cfg, y, lp, cos, sin):
    dt = cfg.dtype
    k = _heads(y, lp["wk"].to(dt))
    v = _heads(y, lp["wv"].to(dt))
    if cfg.pos_emb == "rope":
        k = apply_rotary(k, cos, sin)
    return k, v


def _layer_params(params: Params, i: int) -> Params:
    return {name: w[i] for name, w in params["layers"].items()}


def _layer_kv(cfg: TransformerConfig, x: torch.Tensor, lp: Params, cos, sin,
              lay: _Layout = _NO_MESH):
    """One transformer block → (x, router aux, k, v); prefill keeps k and v
    for the cache instead of projecting them a second time."""
    dt = cfg.dtype
    norm = _norm
    if cfg.norm_remat and torch.is_grad_enabled():
        # nothing of the norm kept for the backward but its inputs
        norm = functools.partial(checkpoint, _norm, use_reentrant=False)
    y = norm(cfg, x, lp["attn_norm"], lp.get("attn_norm_b"))
    q = _heads(y, lp["wq"].to(dt))
    k, v = _project_kv(cfg, y, lp, cos, sin)
    if cfg.pos_emb == "rope":
        q = apply_rotary(q, cos, sin)
    impl = cfg.attention_impl
    if impl == "ring" and lay.sp == 1:
        impl = "reference"          # the whole sequence is on this rank
    attn = multi_head_attention(q, k, v, causal=cfg.causal, impl=impl,
                                mesh=lay.mesh)
    x = x + attn.flatten(2) @ lp["wo"].to(dt).flatten(0, 1)
    y = norm(cfg, x, lp["mlp_norm"], lp.get("mlp_norm_b"))
    z, aux = _ffn(cfg, y, lp, lay)
    return x + z, aux, k, v


def _layer(cfg: TransformerConfig, x: torch.Tensor, lp: Params,
           cos, sin, lay: _Layout) -> Tuple[torch.Tensor, torch.Tensor]:
    """One transformer block; returns (x, router_aux_loss)."""
    x, aux, _, _ = _layer_kv(cfg, x, lp, cos, sin, lay)
    return x, aux


def _ffn(cfg: TransformerConfig, y: torch.Tensor, lp: Params,
         lay: _Layout = _NO_MESH) -> Tuple[torch.Tensor, torch.Tensor]:
    """Post-attention FFN on a normed input, dense or a mixture of experts;
    ONE implementation shared by training, prefill and every decode path
    (`models/generate.py`).  → (residual delta, router aux loss; 0 for a
    dense FFN)."""
    dt = cfg.dtype
    if cfg.n_experts:
        return _moe(cfg, y, lp, lay)
    aux = torch.zeros((), dtype=torch.float32, device=y.device)
    if cfg.activation == "swiglu":
        up = y @ lp["w_in"].to(dt)
        gate = y @ lp["w_gate"].to(dt)
        z = F.silu(gate) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        z = F.gelu(y @ lp["w_in"].to(dt), approximate="tanh")
    return z @ lp["w_out"].to(dt), aux


def _moe(cfg: TransformerConfig, y: torch.Tensor, lp: Params, lay: _Layout
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mixture-of-experts FFN.  Under a mesh its router statistics
    average over every rank's rows; where the sequence splits over sp, the
    experts run on the whole sequence (each batch row's capacity counts
    over all its tokens, as in JAX) and each rank keeps its block, and the
    aux loss, the same on every sp rank, is taken once over them."""
    mean = None
    if lay.sp > 1:
        y = all_gather(y, "sp", 1, lay.mesh)
    if lay.batch_axes:
        count = y.shape[0] * y.shape[1] * math.prod(
            axis_size(a, lay.mesh) for a in lay.batch_axes)

        def mean(x):
            return psum(x.sum(dim=(0, 1)), lay.batch_axes, lay.mesh) / count

    z, aux = moe_ffn(y, lp["router"], lp["w_in"], lp["w_out"],
                     lp.get("w_gate"), top_k=cfg.expert_top_k,
                     capacity_factor=cfg.capacity_factor, batch_mean=mean)
    if lay.sp > 1:
        lo, hi = lay.seq_block(y.shape[1])
        z, aux = z[:, lo:hi], psum(aux / lay.sp, "sp", lay.mesh)
    return z, aux


def _embed(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
           positions: slice, impl: str = "gather") -> torch.Tensor:
    if impl == "one_hot":
        # the embedding as a product with one-hot rows, _ONE_HOT_CHUNK
        # tokens at a time, as the JAX package's MXU formulation
        emb = params["embed"]["tok"].to(cfg.dtype)
        x = torch.cat([F.one_hot(t, cfg.vocab_size).to(cfg.dtype) @ emb
                       for t in tokens.reshape(-1).long().split(
                           _ONE_HOT_CHUNK)])
        x = x.reshape(*tokens.shape, cfg.d_model)
    elif impl == "gather":
        x = params["embed"]["tok"][tokens].to(cfg.dtype)
    else:   # a typo must not silently mean the gather path
        raise ValueError(f"embed_impl={impl!r}: expected 'gather' or "
                         f"'one_hot'")
    if cfg.pos_emb == "learned":
        x = x + params["embed"]["pos"][positions].to(cfg.dtype)
    return x


def _trunk(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
           lay: _Layout) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [b, s] → (hidden [b, s, d] after the final norm, in
    cfg.dtype, on this rank's positions of ``lay``; mean router aux).
    While grad is enabled, each layer runs under `torch.utils.checkpoint`
    as ``cfg.remat`` says and each norm under its own when
    ``cfg.norm_remat``; without grad it runs plainly."""
    s = tokens.shape[1]
    lo, hi = lay.seq_block(s)
    x = _embed(params, tokens[:, lo:hi], cfg, slice(lo, hi), cfg.embed_impl)
    cos, sin = (rotary_angles(s, cfg.head_dim, cfg.rope_base,
                              device=x.device)
                if cfg.pos_emb == "rope" else (None, None))
    if cos is not None:
        cos, sin = cos[lo:hi], sin[lo:hi]
    if cfg.pp_stages > 1:
        x, aux = _pipelined_layers(cfg, x, params["layers"], cos, sin, lay)
    else:
        x, aux = _layers(cfg, x, params["layers"], cos, sin, lay)
        aux = aux / cfg.n_layers
    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_b"))
    return x, aux


def _pipelined_layers(cfg: TransformerConfig, x: torch.Tensor,
                      stacked: Params, cos, sin, lay: _Layout
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer stack as a GPipe pipeline over the mesh's pp axis
    (`parallel.pipeline_apply`) → (x, mean router aux).  A stacked weight
    is the whole stack, or a DTensor placed on pp whose local block is
    this stage's slab (`make_train_step`)."""
    pp = axis_size("pp", lay.mesh)
    if cfg.n_layers % cfg.pp_stages:
        raise ValueError(f"{cfg.n_layers} layers not divisible by "
                         f"{cfg.pp_stages} pipeline stages")
    if pp != cfg.pp_stages:
        raise ValueError(f"pp_stages={cfg.pp_stages} needs an ambient mesh "
                         f"whose pp axis has that size (it has {pp}); "
                         f"enter parallel.use_mesh(mesh)")
    n_micro = cfg.pp_microbatches or cfg.pp_stages

    def stage_fn(slab, state):
        h, aux = state
        h, aux_l = _layers(cfg, h, slab, cos, sin, lay)
        return h, aux + aux_l

    zeros = torch.zeros((n_micro,), dtype=torch.float32, device=x.device)
    h_mb, aux_mb = pipeline_apply(stage_fn, stacked,
                                  (microbatch(x, n_micro), zeros),
                                  n_stages=cfg.pp_stages, n_micro=n_micro,
                                  mesh=lay.mesh)
    return unmicrobatch(h_mb), aux_mb.sum() / (n_micro * cfg.n_layers)


def _layers(cfg: TransformerConfig, x: torch.Tensor, stacked: Params,
            cos, sin, lay: _Layout = _NO_MESH
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer stack over stacked weights [L, ...] → (x, the layers'
    summed router aux), each layer under `torch.utils.checkpoint` as
    ``cfg.remat`` says while grad is enabled; shared by every model family
    (the transformer, ViT)."""
    context_fn = remat_policy(cfg.remat)
    training = torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # one unbind per stacked weight: its backward stacks the layers'
    # gradients in one write, as the JAX scan does, where a select per
    # layer would add a full-size zero-padded gradient once per layer
    layers = {name: w.unbind(0) for name, w in stacked.items()}
    for i in range(len(next(iter(layers.values())))):
        lp = {name: ws[i] for name, ws in layers.items()}
        if context_fn is not None and training:
            x, aux_l = checkpoint(_layer, cfg, x, lp, cos, sin, lay,
                                  use_reentrant=False, context_fn=context_fn)
        else:
            x, aux_l = _layer(cfg, x, lp, cos, sin, lay)
        aux = aux + aux_l
    return x, aux


def _unembed(params: Params, cfg: TransformerConfig) -> torch.Tensor:
    w = (params["embed"]["tok"].T if cfg.tie_embeddings
         else params["lm_head"])
    return w.to(cfg.dtype)


def whole_params(params: Params) -> Params:
    """``params`` with every placed weight (a DTensor, as
    `parallel.shard_pytree` leaves it) gathered whole by
    `gather_for_compute`, the rule the sharded train step uses; a tree of
    plain tensors comes back as it is.  The serving entry points
    (`forward_with_aux`, `models.prefill`, `prefill_chunk`, `decode_step`,
    `generate`) call it once a call, so a model placed over a gang's mesh
    serves as GSPMD serves the JAX package's placed weights: each rank runs
    the whole arithmetic on the gathered weights, and its results are the
    plain weights' bitwise at world size 1."""
    leaves = param_leaves(params)
    if not any(isinstance(p, DTensor) for p in leaves):
        return params
    return _with_leaves(params, [
        gather_for_compute(p, p.device_mesh, ())
        if isinstance(p, DTensor) else p for p in leaves])


def forward_with_aux(params: Params, tokens: torch.Tensor,
                     cfg: TransformerConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [batch, seq] → (logits [batch, seq, vocab] fp32, mean router
    aux loss).  Under a mesh ``tokens`` are this rank's rows, and the
    logits come back over the whole sequence on every rank.  Placed
    weights are gathered whole first (`whole_params`)."""
    params = whole_params(params)
    lay = _layout(cfg)
    x, aux = _trunk(params, tokens, cfg, lay)
    # fp32 accumulation of cfg.dtype operands, as the JAX package's
    # preferred_element_type=float32: upcasting both operands is exact
    logits = x.float() @ _unembed(params, cfg).float()
    if lay.sp > 1:
        logits = all_gather_invariant(logits, "sp", 1, lay.mesh)
    return logits, aux


def forward(params: Params, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """tokens [batch, seq] → logits [batch, seq, vocab] fp32."""
    return forward_with_aux(params, tokens, cfg)[0]


def _chunk_loss_sum(x: torch.Tensor, w32: torch.Tensor,
                    targets: torch.Tensor, valid: torch.Tensor
                    ) -> torch.Tensor:
    """Σ valid · cross entropy of one [b, chunk] block of positions."""
    logits = x.float() @ w32
    losses = F.cross_entropy(logits.flatten(0, 1), targets.flatten(),
                             reduction="none")
    return (losses * valid.flatten()).sum()


def lm_loss(params: Params, batch: Dict[str, torch.Tensor],
            cfg: TransformerConfig) -> torch.Tensor:
    """Next-token cross entropy, fp32.  ``batch`` has "tokens" [b, s] and
    optionally "mask" [b, s]; the loss is on positions 0..s-2 predicting
    1..s-1, averaged over the positions whose target the mask keeps.

    With ``cfg.loss_chunk`` set (it must divide s), the unembedding and the
    softmax run chunk by chunk, each chunk under `torch.utils.checkpoint`,
    so one [b, chunk, vocab] block of logits exists at a time instead of
    the full [b, s, vocab] fp32 tensor.  A mixture-of-experts model adds
    ``cfg.router_aux_weight`` times the layers' mean router aux loss.
    Under a mesh ``batch`` holds this rank's rows, and every rank returns
    the global batch's loss (`_summed_loss`).
    """
    # the model runs on the FULL sequence and the logits shift, as in JAX
    tokens = batch["tokens"]
    b, s = tokens.shape
    mask = batch.get("mask")
    aux_weight = cfg.router_aux_weight if cfg.n_experts else 0.0
    if cfg.loss_chunk and s % cfg.loss_chunk:
        # falling back silently would materialize the full logits — the
        # memory cliff loss_chunk exists to avoid
        raise ValueError(f"seq length {s} is not divisible by "
                         f"loss_chunk={cfg.loss_chunk}")
    lay = _layout(cfg)
    if cfg.loss_chunk or lay.mesh is not None:
        loss, aux = _summed_loss(params, tokens, mask, cfg, lay)
        return loss + aux_weight * aux

    logits, aux = forward_with_aux(params, tokens, cfg)
    losses = F.cross_entropy(logits[:, :-1].flatten(0, 1),
                             tokens[:, 1:].flatten().long(),
                             reduction="none").view(b, s - 1)
    if mask is not None:
        m = mask[:, 1:].float()
        return (losses * m).sum() / m.sum().clamp_min(1.0) + aux_weight * aux
    return losses.mean() + aux_weight * aux


def _summed_loss(params: Params, tokens: torch.Tensor,
                 mask: Optional[torch.Tensor], cfg: TransformerConfig,
                 lay: _Layout) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lm_loss`'s cross entropy as a sum over positions → (loss, mean
    router aux).  Each rank sums over its block of positions of ``lay``
    (targets from the whole rows), ``cfg.loss_chunk`` positions at a time
    (all at once when 0); under a mesh the sums and the count of valid
    targets add up over the ranks that hold different data, so every rank
    returns the global batch's loss."""
    b, s = tokens.shape
    lo, hi = lay.seq_block(s)
    x, aux = _trunk(params, tokens, cfg, lay)
    # fp32 accumulation of cfg.dtype operands, as forward_with_aux
    w32 = _unembed(params, cfg).float()
    # the LAST position's target is a dummy 0 with weight 0
    zero = torch.zeros((b, 1), dtype=tokens.dtype, device=tokens.device)
    targets = torch.cat([tokens[:, 1:], zero], dim=1)[:, lo:hi].long()
    valid = torch.ones((b, s), dtype=torch.float32, device=x.device)
    valid[:, -1] = 0.0
    if mask is not None:
        valid[:, :-1] *= mask[:, 1:].float()
    valid = valid[:, lo:hi]
    chunk = cfg.loss_chunk or (hi - lo)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, hi - lo, chunk):
        part = (x[:, i:i + chunk], w32, targets[:, i:i + chunk],
                valid[:, i:i + chunk])
        if cfg.loss_chunk and torch.is_grad_enabled():
            total = total + checkpoint(_chunk_loss_sum, *part,
                                       use_reentrant=False)
        else:
            total = total + _chunk_loss_sum(*part)
    count = valid.sum()
    if lay.summed_axes:
        total = psum(total, lay.summed_axes, lay.mesh)
        count = psum(count, lay.summed_axes, lay.mesh)
    return total / count.clamp_min(1.0), aux


def param_leaves(params: Params) -> List[torch.Tensor]:
    """The parameter tensors in the order ``jax.tree_util.tree_leaves``
    gives for the same tree (keys sorted at every level): the tensors to
    build the optimizer of `make_train_step` over."""
    leaves = []
    for key in sorted(params):
        node = params[key]
        leaves.extend(param_leaves(node) if isinstance(node, dict)
                      else [node])
    return leaves


def _with_leaves(params: Params, leaves: List[torch.Tensor]) -> Params:
    """``params``' tree with its tensors replaced by ``leaves``, given in
    `param_leaves` order."""
    it = iter(leaves)

    def walk(node):
        return {key: walk(node[key]) if isinstance(node[key], dict)
                else next(it) for key in sorted(node)}

    return walk(params)


def make_train_step(cfg: TransformerConfig, optimizer: torch.optim.Optimizer,
                    accum_steps: int = 1):
    """→ ``step(params, batch) -> {"loss", "grad_norm"}``, the JAX package's
    train step.  Unlike the JAX step, which is pure, it updates ``params``
    and the optimizer's state IN PLACE: ``optimizer`` is a
    `torch.optim.Optimizer` built over ``param_leaves(params)``; the step
    hands it the gradients as each tensor's ``.grad``, calls its ``step()``
    and clears the ``.grad`` again.  Both metrics are 0-d fp32 tensors on
    the parameters' device; ``grad_norm`` is the L2 norm of the gradients
    before the update.

    ``accum_steps > 1`` splits every batch leaf into that many
    microbatches and weights each microbatch's gradient by its count of
    valid target tokens, so the step equals the full-batch one even when a
    mask is uneven across microbatches; the weighted sum is taken in fp32
    and cast back to each parameter's dtype.

    Under a mesh (`parallel.use_mesh`) every rank calls the step with the
    whole batch (or a DTensor placed by `parallel.batch_sharding`) and
    takes its rows (``dp`` × ``fsdp``).  Parameters may be DTensors
    (`parallel.shard_pytree`): each is gathered for the products and its
    gradient comes back in its own placement, summed over the ranks that
    hold different data; a plain parameter's gradient is summed the same
    way.  With ``pp_stages > 1`` a layer weight placed on ``pp`` (the
    rules' ``layers="pp"``) is gathered over the other axes only: each
    stage holds and updates its own slab of the stack.  The optimizer is
    built over `local_leaves(params)` (the same as `param_leaves` where no
    parameter is a DTensor) and steps on the local shards; no DTensor
    arithmetic runs.  The metrics are the global batch's, on every rank.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps={accum_steps}: must be >= 1")

    def grads_of(params, leaves, batch):
        lay = _layout(cfg)
        # under a mesh each weight is gathered for the products, and its
        # gradient lands in its placement; a weight placed on pp stays so
        # where the model pipelines: each stage computes with its own slab
        use = None if lay.mesh is None else functools.partial(
            gather_for_compute, mesh=lay.mesh, summed_axes=lay.summed_axes,
            keep=("pp",) if cfg.pp_stages > 1 else ())
        loss, _, grads = _loss_and_grads(
            lambda p: (lm_loss(p, batch, cfg), {}), params, leaves, use)
        return loss, grads

    def step(params: Params, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        targets = _owned_leaves(optimizer, params)
        leaves = param_leaves(params)
        mesh = current_mesh()
        if mesh is not None:
            batch = {key: batch_rows(val, mesh, BATCH_AXES)
                     for key, val in batch.items()}
        if accum_steps > 1:
            full = batch["tokens"].shape[0]
            if full % accum_steps:
                raise ValueError(f"batch {full} not divisible by "
                                 f"accum_steps {accum_steps}")
            micro = full // accum_steps
            f32 = dict(dtype=torch.float32, device=leaves[0].device)
            gsum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in targets]
            lsum = torch.zeros((), **f32)
            csum = torch.zeros((), **f32)
            for i in range(accum_steps):
                # every batch leaf (tokens, mask, ...) splits on the batch
                # axis, so each microbatch loss sees the same keys
                mb = {key: val[i * micro:(i + 1) * micro]
                      for key, val in batch.items()}
                loss, grads = grads_of(params, leaves, mb)
                grads = [_local(g) for g in grads]
                if "mask" in mb:
                    count = mb["mask"][:, 1:].float().sum()
                else:
                    count = torch.tensor(
                        float(micro * (mb["tokens"].shape[1] - 1)), **f32)
                if mesh is not None:
                    count = psum(count, _layout(cfg).batch_axes, mesh)
                for acc, g in zip(gsum, grads):
                    acc.add_(g.float() * count)
                lsum = lsum + loss * count
                csum = csum + count
            csum = csum.clamp_min(1.0)
            grads = [(acc / csum).to(p.dtype)
                     for acc, p in zip(gsum, targets)]
            loss = lsum / csum
        else:
            loss, grads = grads_of(params, leaves, batch)
            grads = [_local(g) for g in grads]
        grad_norm = torch.sqrt(_square_sum(grads, leaves))
        _apply_grads(optimizer, targets, grads)
        return {"loss": loss, "grad_norm": grad_norm}

    return step


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself, not a copy); a plain
    tensor as it is."""
    if isinstance(x, DTensor):
        with torch.no_grad():
            return x.to_local()
    return x


def local_leaves(params: Params) -> List[torch.Tensor]:
    """`param_leaves` with each DTensor replaced by its local shard: the
    tensors to build `make_train_step`'s optimizer over."""
    return [_local(p) for p in param_leaves(params)]


def _square_sum(grads: List[torch.Tensor],
                leaves: List[torch.Tensor]) -> torch.Tensor:
    """Σ g² over every gradient, fp32, from the local shards ``grads`` of
    ``leaves``: where a leaf is placed on a mesh, each shard's sum counts
    once however many ranks replicate it (one all-reduce for them all)."""
    sums = [g.float().square().sum() for g in grads]
    mesh = next((p.device_mesh for p in leaves if isinstance(p, DTensor)),
                None)
    if mesh is None:
        return sum(sums)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    world = math.prod(sizes.values())
    total = sum(s / (math.prod(n for n, pl in zip(sizes.values(),
                                                  p.placements)
                               if pl.is_replicate())
                     if isinstance(p, DTensor) else world)
                for s, p in zip(sums, leaves))
    if world > 1:
        torch.distributed.all_reduce(total)      # the mesh spans the group
    return total


def _owned_leaves(optimizer: torch.optim.Optimizer,
                 params: Params) -> List[torch.Tensor]:
    """`local_leaves(params)` (``param_leaves`` where no parameter is a
    DTensor), after checking that ``optimizer`` was built over exactly
    those tensors."""
    leaves = local_leaves(params)
    owned = {id(p) for group in optimizer.param_groups
             for p in group["params"]}
    if owned != {id(p) for p in leaves}:
        raise ValueError("the optimizer must be built over "
                         "local_leaves(params) (param_leaves(params) where "
                         "no parameter is a DTensor)")
    return leaves


def _loss_and_grads(loss_fn: Callable, params: Params,
                    leaves: List[torch.Tensor],
                    use: Optional[Callable] = None):
    """``loss_fn(params) -> (loss, {name: metric})`` and the loss's
    gradients with respect to ``leaves`` (``param_leaves(params)``), taken
    through aliases of the parameters so the caller's tensors keep
    ``requires_grad`` as they were; ``use`` maps each alias to what the
    loss computes with.  → (loss, metrics, grads), the loss and metrics
    detached."""
    alias = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        used = alias if use is None else [use(a) for a in alias]
        loss, metrics = loss_fn(_with_leaves(params, used))
        grads = torch.autograd.grad(loss, alias)
    return (loss.detach(), {key: val.detach() for key, val in metrics.items()},
            grads)


def _apply_grads(optimizer: torch.optim.Optimizer,
                leaves: List[torch.Tensor], grads) -> None:
    """One optimizer step with ``grads`` as the leaves' ``.grad``, which
    are cleared again after it: the parameters and the optimizer's state
    change in place."""
    for p, g in zip(leaves, grads):
        p.grad = g
    optimizer.step()
    for p in leaves:
        p.grad = None
