"""ViT: the vision-transformer classification family (counterpart of
``ray_tpu/models/vit.py``).

Patchify is a reshape and one matmul; the encoder runs the transformer's
own layer stack (`transformer._layers`, the same blocks, remat and
attention dispatch) with bidirectional attention, so on the card its
attention is the Hopper flash kernels with ``causal=False``.  The head
runs in fp32.  Parameters are a nested dict in the JAX package's layout,
so weights carry across with `ray_tpu_torch.convert.params_from_numpy`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .transformer import (Params, TransformerConfig, _apply_grads, _layers,
                          _loss_and_grads, _norm, _owned_leaves, init_params,
                          param_shapes, params_axes)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    channels: int = 3
    num_classes: int = 10
    d_model: int = 192
    n_layers: int = 6
    n_heads: int = 4
    d_ff: Optional[int] = None
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: Any = False
    attention_impl: str = "auto"

    @property
    def n_patches(self) -> int:
        side = self.image_size // self.patch_size
        return side * side

    @property
    def seq_len(self) -> int:
        return self.n_patches + 1          # +1 for the CLS token

    def block_cfg(self) -> TransformerConfig:
        """The encoder blocks: plain transformer layers with bidirectional
        attention."""
        return TransformerConfig(
            vocab_size=8,                   # unused (embed is replaced)
            d_model=self.d_model, n_layers=self.n_layers,
            n_heads=self.n_heads, d_ff=self.d_ff,
            max_seq_len=self.seq_len, pos_emb="learned",
            activation="gelu", norm="layernorm", causal=False,
            dtype=self.dtype, param_dtype=self.param_dtype,
            remat=self.remat, attention_impl=self.attention_impl)

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        defaults = dict(image_size=16, patch_size=4, channels=1,
                        num_classes=4, d_model=64, n_layers=2,
                        n_heads=4)
        defaults.update(kw)
        return ViTConfig(**defaults)

    @staticmethod
    def base(**kw) -> "ViTConfig":
        """ViT-B/16 dimensions (public paper sizes)."""
        defaults = dict(image_size=224, patch_size=16, channels=3,
                        num_classes=1000, d_model=768, n_layers=12,
                        n_heads=12)
        defaults.update(kw)
        return ViTConfig(**defaults)


def vit_param_shapes(cfg: ViTConfig) -> Params:
    """The parameter tree's shapes, in the JAX package's layout."""
    d = cfg.d_model
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.channels
    return {"layers": param_shapes(cfg.block_cfg())["layers"],
            "final_norm": (d,), "final_norm_b": (d,),
            "patch": {"w": (patch_dim, d), "b": (d,)},
            "cls": (1, 1, d), "pos": (cfg.seq_len, d),
            "head": {"w": (d, cfg.num_classes), "b": (cfg.num_classes,)}}


def vit_params_axes(cfg: ViTConfig) -> Params:
    """The logical axes of every parameter (the JAX `init_vit_params`'
    second tree): what `parallel.shard_pytree` places them by."""
    base = params_axes(cfg.block_cfg())
    return {"layers": base["layers"], "final_norm": base["final_norm"],
            "final_norm_b": base["final_norm_b"],
            "patch": {"w": (None, "embed"), "b": ("embed",)},
            "cls": (None, None, "embed"), "pos": (None, "embed"),
            "head": {"w": ("embed", "vocab"), "b": ("vocab",)}}


def init_vit_params(cfg: ViTConfig, generator: torch.Generator,
                    device: DeviceLike = None) -> Params:
    """Random weights drawn from ``generator`` on ``device``, with the JAX
    package's scales: the encoder layers as the transformer's
    `init_params`, patch and head weights N(0, 1/fan_in), CLS token and
    positions N(0, 0.02²), biases 0."""
    device = resolve_device(device)
    base = init_params(cfg.block_cfg(), generator, device)
    pt, d = cfg.param_dtype, cfg.d_model
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.channels

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=pt,
                           device=device) * scale

    def zeros(n):
        return torch.zeros(n, dtype=pt, device=device)

    return {"layers": base["layers"], "final_norm": base["final_norm"],
            "final_norm_b": base["final_norm_b"],
            "patch": {"w": normal((patch_dim, d), 1 / math.sqrt(patch_dim)),
                      "b": zeros(d)},
            "cls": normal((1, 1, d), 0.02),
            "pos": normal((cfg.seq_len, d), 0.02),
            "head": {"w": normal((d, cfg.num_classes), 1 / math.sqrt(d)),
                     "b": zeros(cfg.num_classes)}}


def patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[b, H, W, C] → [b, n_patches, P*P*C] by reshape and permute."""
    expect = (cfg.image_size, cfg.image_size, cfg.channels)
    if tuple(images.shape[1:]) != expect:
        # a same-element-count layout mismatch (e.g. NCHW) would reshape
        # into scrambled patches and silently fail to learn
        raise ValueError(f"expected NHWC images [b, {expect[0]}, "
                         f"{expect[1]}, {expect[2]}], got "
                         f"{tuple(images.shape)}")
    b = images.shape[0]
    p, side = cfg.patch_size, cfg.image_size // cfg.patch_size
    x = images.reshape(b, side, p, side, p, cfg.channels)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, side * side, p * p * cfg.channels)


def vit_forward(params: Params, images: torch.Tensor,
                cfg: ViTConfig) -> torch.Tensor:
    """[b, H, W, C] float images → [b, num_classes] fp32 logits."""
    bc = cfg.block_cfg()
    dt = cfg.dtype
    x = patchify(images.to(dt), cfg)
    x = x @ params["patch"]["w"].to(dt) + params["patch"]["b"].to(dt)
    cls = params["cls"].to(dt).expand(x.shape[0], 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos"].to(dt)
    x, _ = _layers(bc, x, params["layers"], None, None)
    x = _norm(bc, x, params["final_norm"], params.get("final_norm_b"))
    cls_out = x[:, 0].float()
    return cls_out @ params["head"]["w"].float() + params["head"]["b"].float()


def vit_loss(params: Params, batch: Dict[str, torch.Tensor],
             cfg: ViTConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross entropy of ``batch["image"]`` against ``batch["label"]`` →
    (loss, {"loss", "accuracy"}), fp32 scalars."""
    logits = vit_forward(params, batch["image"], cfg)
    labels = batch["label"].long()
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def make_vit_train_step(cfg: ViTConfig, optimizer: torch.optim.Optimizer):
    """→ ``step(params, batch) -> {"loss", "accuracy"}``, the JAX package's
    ViT train step.  As `make_train_step`, it updates ``params`` and the
    optimizer's state IN PLACE; ``optimizer`` is built over
    ``param_leaves(params)``."""

    def step(params: Params, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        leaves = _owned_leaves(optimizer, params)
        _, metrics, grads = _loss_and_grads(
            lambda p: vit_loss(p, batch, cfg), params, leaves)
        _apply_grads(optimizer, leaves, grads)
        return metrics

    return step
