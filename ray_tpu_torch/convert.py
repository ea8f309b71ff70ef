"""Carry the JAX package's model weights into the port.

`params_from_numpy` takes the nested dict that ``ray_tpu.models.init_params``
(or ``init_vit_params``) returns, with every leaf converted to a numpy array
(``np.asarray``), and copies it into tensors in the same stacked layout.  It
changes no value and no dtype.  `policy_params_from_numpy` does the same for
an RL policy's params (``ray_tpu.rl`` policies' ``init``), permuting the
conv kernels from HWIO to OIHW.  Needs no JAX: the caller does the
``np.asarray``.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.transformer import Params, TransformerConfig, param_shapes
from .models.vit import ViTConfig, vit_param_shapes


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")   # own, writable memory
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy rejects: move the
        # bits as int16 and reinterpret them
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_numpy(tree: Any, cfg: Union[TransformerConfig, ViTConfig],
                      device: DeviceLike = None) -> Params:
    """JAX parameters as numpy arrays → the port's parameters on
    ``device``, for a transformer (dense or a mixture of experts) or a ViT.
    Raises if the tree's keys or shapes are not those ``cfg`` defines."""
    device = resolve_device(device)

    def walk(node, shapes, path):
        if set(node) != set(shapes):
            raise ValueError(f"parameters at {path or '/'} have keys "
                             f"{sorted(node)}, config expects "
                             f"{sorted(shapes)}")
        out = {}
        for name, want in shapes.items():
            if isinstance(want, dict):
                out[name] = walk(node[name], want, f"{path}/{name}")
                continue
            arr = np.asarray(node[name])
            if arr.shape != tuple(want):
                raise ValueError(f"{path}/{name}: shape {arr.shape}, "
                                 f"config expects {tuple(want)}")
            out[name] = _tensor(arr, device)
        return out

    shapes = (vit_param_shapes(cfg) if isinstance(cfg, ViTConfig)
              else param_shapes(cfg))
    return walk(tree, shapes, "")


def policy_params_from_numpy(policy: Any, tree: Any) -> Any:
    """A JAX RL network's params as numpy arrays → the port's params for
    ``policy`` on its device: an `rl.MLPPolicy`, `LSTMPolicy` or
    `ConvPolicy`, a `QNetwork` (plain, dueling ``{"torso", "v", "a"}``,
    C51), a `RecurrentQNetwork` (``{"torso", "lstm", "q"}``), a `TD3` or
    `SAC` algorithm (its actor / critic tree; SAC's ``log_alpha`` 0-d), an
    `IndependentPPO` or `MADDPG` algorithm (per-agent trees stacked on a
    leading agent axis), `QMIX` (``{"q", "mix"}``, the mixer's
    hypernetworks), `MARWIL` (``{"pi", "v"}``), `CRR` (``{"pi", "q"}``),
    `ES` / `ARS` (the flat vector), `MAML` (its policy's tree), `Dreamer`
    (``{"model", "actor", "critic"}``), `DT` (the trunk's stacked
    ``layers`` and ``ln_f``, the embeddings and the head), `AlphaZero`
    (``{"torso", "pi", "v"}``) or `SlateQ` (its item Q-network) — anything
    with ``param_shapes()`` and ``device``.  Conv kernels go from
    the JAX package's HWIO to OIHW; nothing else changes.  Raises if the
    tree's structure or shapes are not those ``policy`` defines, naming
    the path."""

    def walk(node, shapes, path, conv=False):
        if isinstance(shapes, dict):
            if not isinstance(node, dict) or set(node) != set(shapes):
                raise ValueError(f"policy parameters at {path or '/'} do not "
                                 f"have the keys {sorted(shapes)}")
            return {k: walk(node[k], shapes[k], f"{path}/{k}",
                            conv or k == "convs") for k in shapes}
        if isinstance(shapes, list):
            if not isinstance(node, (list, tuple)) or \
                    len(node) != len(shapes):
                raise ValueError(f"policy parameters at {path}: expected "
                                 f"{len(shapes)} layers")
            return [walk(n, s, f"{path}/{i}", conv)
                    for i, (n, s) in enumerate(zip(node, shapes))]
        arr = np.asarray(node)
        if conv and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
        if arr.shape != tuple(shapes):
            raise ValueError(f"{path}: shape {arr.shape}, policy expects "
                             f"{tuple(shapes)}")
        return _tensor(arr, policy.device)

    return walk(tree, policy.param_shapes(), "")
