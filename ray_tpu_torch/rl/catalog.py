"""Model catalog: build a policy from an env's spaces and a model config
(counterpart of ``ray_tpu/rl/catalog.py``), with the JAX package's choices
and guards and its custom-model registry."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ..device import DeviceLike
from .env import TorchEnv
from .policy import ConvPolicy, LSTMPolicy, MLPPolicy

_CUSTOM_MODELS: Dict[str, Callable[..., Any]] = {}

DEFAULT_MODEL: Dict[str, Any] = {
    "hidden": (64, 64),
    "conv_filters": None,     # None -> catalog default for image spaces
    "use_lstm": False,        # recurrent wrapper
    "lstm_cell_size": 64,
    "custom_model": None,
    "custom_model_config": {},
}


def register_custom_model(name: str, factory: Callable[..., Any]) -> None:
    """factory(obs_size, action_size, discrete=..., device=...,
    **custom_config) -> policy object with the MLPPolicy interface
    (init / forward / sample_action / log_prob)."""
    _CUSTOM_MODELS[name] = factory


def build_policy(env: TorchEnv, model: Optional[Dict[str, Any]] = None,
                 obs_size_override: Optional[int] = None,
                 device: DeviceLike = None):
    """Policy for an env's spaces.  ``obs_size_override`` is the
    observation size after the obs connector pipeline (FrameStack
    multiplies it): pass ``pipeline.out_size(env.observation_size)``."""
    cfg = dict(DEFAULT_MODEL)
    cfg.update(model or {})
    obs_size = obs_size_override or env.observation_size
    custom = cfg.get("custom_model")
    if custom and cfg.get("use_lstm"):
        raise ValueError(
            "custom_model + use_lstm is not supported: recurrence must "
            "live inside the custom policy (give it is_recurrent=True "
            "and the LSTMPolicy interface)")
    if custom:
        if custom not in _CUSTOM_MODELS:
            raise ValueError(
                f"custom model {custom!r} not registered "
                f"(known: {sorted(_CUSTOM_MODELS)})")
        return _CUSTOM_MODELS[custom](
            obs_size, env.action_size, discrete=env.discrete, device=device,
            **cfg.get("custom_model_config", {}))
    # an image observation space gets the conv torso; connectors that
    # resize flat obs keep the MLP path, the image geometry being gone
    obs_shape = getattr(env, "observation_shape", None)
    is_image = obs_shape is not None and len(obs_shape) == 3 and \
        obs_size == env.observation_size
    if cfg.get("use_lstm"):
        if is_image:
            raise ValueError(
                "use_lstm on an image-observation env would silently "
                "drop the conv torso (the LSTMPolicy is MLP-bodied); "
                "flatten the observations with a connector, or register "
                "a custom Conv+LSTM policy (is_recurrent=True with the "
                "LSTMPolicy interface)")
        return LSTMPolicy(obs_size, env.action_size,
                          discrete=env.discrete,
                          hidden=tuple(cfg["hidden"]),
                          lstm_size=cfg.get("lstm_cell_size", 64),
                          device=device)
    if is_image:
        return ConvPolicy(obs_shape, env.action_size,
                          discrete=env.discrete,
                          conv_filters=cfg.get("conv_filters")
                          or ((16, 3, 1), (32, 3, 1)),
                          hidden=tuple(cfg["hidden"]), device=device)
    return MLPPolicy(obs_size, env.action_size, discrete=env.discrete,
                     hidden=tuple(cfg["hidden"]), device=device)
