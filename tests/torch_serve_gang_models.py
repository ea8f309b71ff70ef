"""Deployment callables for the port's serve gang, built in its spawned
member processes (`tests/test_torch_serve_gang.py` on the CPU over gloo,
`tests/cuda_rank_checks.py` on four cards over NCCL, `chip_smoke.py`'s
``serve_gang`` phase on one card).

They mirror tests/test_serve_gang.py's ``ShardedModel`` and ``Generator``:
each reads its gang context, places its weights over the gang's mesh under
FSDP_TP_RULES and serves through the model's entry points, which gather the
placed weights once a call.  They live here, not in a test module, because
a member unpickles its callable by reference: this module imports torch and
the port only, never JAX.  Weights are a numpy tree in the JAX init's
layout, or an int seed for `init_params` on the member's device.  Every
request counts the flash kernels' launches in the member (each counter set
to 0 just before it, read just after) and returns them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ray_tpu_torch import ops, parallel
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import (TransformerConfig, forward, generate,
                                  init_params, params_axes)
from ray_tpu_torch.serve import get_gang_context

KERNELS = (ops.flash_fwd, ops.flash_bwd_dq, ops.flash_bwd_dkv)


def model_config(preset: str, cfg_kw: dict) -> TransformerConfig:
    """``"llama-1b"`` (TransformerConfig.llama("1b")) or ``"tiny"``, with
    ``cfg_kw`` on top."""
    if preset == "llama-1b":
        return TransformerConfig.llama("1b", **cfg_kw)
    return TransformerConfig.tiny(**cfg_kw)


def plain_params(cfg: TransformerConfig, weights, device):
    """The model's weights as plain tensors on ``device``: from a numpy
    tree, or from ``init_params`` with a generator seeded ``weights``."""
    if isinstance(weights, int):
        return init_params(
            cfg, torch.Generator(device=device).manual_seed(weights), device)
    return params_from_numpy(weights, cfg, device)


def forward_summary(logits: torch.Tensor) -> dict:
    """What a forward request answers instead of the logits (1 x 2048 x
    128,256 fp32 would be about 1 GB through the pipe): the shape, the mean,
    a checksum (the sum of the fp32 bit patterns, equal for equal logits)
    and the last position's argmax per row."""
    return {"shape": list(logits.shape), "mean": float(logits.mean()),
            "checksum": int(logits.contiguous().view(torch.int32).sum(
                dtype=torch.int64)),
            "argmax_last": logits[:, -1].argmax(-1).tolist()}


def _counted(fn):
    """``fn()`` with the flash launches it made and its wall ms (synced)."""
    for kernel in KERNELS:
        kernel.launches = 0
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, {k.__name__: k.launches for k in KERNELS}, ms


def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                           device=device)


def forward_request(params, cfg: TransformerConfig, tokens, device) -> dict:
    """One forward request on ``params`` (placed or plain): the logits'
    summary, the flash launches and the wall ms.  A gang member and the
    same call in one process run exactly this."""
    with torch.no_grad():
        logits, launches, ms = _counted(
            lambda: forward(params, _tokens(tokens, device), cfg))
        return {**forward_summary(logits), "launches": launches,
                "member_ms": ms}


def generate_request(params, cfg: TransformerConfig, payload: dict,
                     device) -> dict:
    """One greedy KV-cache generation ``{"prompt": [B, S] ints, "n": new
    tokens}`` on ``params``: the tokens, the flash launches, the wall ms."""
    with torch.no_grad():
        toks, launches, ms = _counted(lambda: generate(
            params, _tokens(payload["prompt"], device), cfg=cfg,
            max_new_tokens=int(payload["n"]), temperature=0.0))
        return {"tokens": toks.tolist(), "launches": launches,
                "member_ms": ms}


class _Served:
    """The gang context and the weights placed over its mesh."""

    def __init__(self, preset: str, cfg_kw: dict, weights):
        ctx = get_gang_context()
        assert ctx is not None, "built outside a gang replica"
        self.ctx = ctx
        self.cfg = model_config(preset, cfg_kw)
        self.params = parallel.shard_pytree(
            plain_params(self.cfg, weights, ctx.device),
            params_axes(self.cfg), ctx.mesh, parallel.FSDP_TP_RULES)

    def forward(self, tokens) -> dict:
        """A forward pass: its summary, never the logits."""
        return {"rank": self.ctx.rank, **forward_request(
            self.params, self.cfg, tokens, self.ctx.device)}

    def logits(self, tokens) -> np.ndarray:
        """The whole logits as numpy (small models only)."""
        with torch.no_grad():
            return forward(self.params, _tokens(tokens, self.ctx.device),
                           self.cfg).cpu().numpy()

    def generate(self, payload: dict) -> dict:
        """A greedy KV-cache generation (`generate_request`)."""
        return {"rank": self.ctx.rank, **generate_request(
            self.params, self.cfg, payload, self.ctx.device)}

    def stats(self) -> dict:
        return {"rank": self.ctx.rank, "world": self.ctx.world_size}

    def placements(self) -> dict:
        """Each layer weight's placements: the proof that the weights are
        placed over the gang."""
        return {name: [repr(p) for p in w.placements]
                for name, w in self.params["layers"].items()}

    def peak_memory_gib(self) -> float:
        return (torch.cuda.max_memory_allocated(self.ctx.device) / 2**30
                if self.ctx.device.type == "cuda" else 0.0)


class ShardedModel(_Served):
    """A transformer whose weights are placed over the gang; a request is
    a forward pass."""

    def __call__(self, tokens) -> dict:
        return self.forward(tokens)


class Generator(_Served):
    """A transformer whose weights are placed over the gang; a request is a
    greedy KV-cache generation."""

    def __call__(self, payload: dict) -> dict:
        return self.generate(payload)


class ChaosProbe:
    """An actor that reports whether its process armed a chaos plan, and
    what a ``once`` rule does there."""

    def state(self) -> dict:
        from ray_tpu_torch.util import fault_injection as fi
        if fi.ACTIVE is None:
            return {"armed": False}
        return {"armed": True, "plan": fi.ACTIVE.raw,
                "fires": [fi.ACTIVE.point("serve.spec_verify", "k")
                          for _ in range(3)],
                "claims": [fi.local_claim("x"), fi.local_claim("x")]}
