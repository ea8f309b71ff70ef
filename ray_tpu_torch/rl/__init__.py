"""Reinforcement learning of the port (counterpart of ``ray_tpu.rl``): the
batched envs, the MLP / LSTM / conv actor-critic policies, connectors, the
model catalog and the PPO family (PPO, A2C).  Envs, policies and the update
run on the card unless given ``device="cpu"``."""

from .algorithm import Algorithm, track_episode_returns  # noqa: F401
from .catalog import build_policy, register_custom_model  # noqa: F401
from .connectors import (  # noqa: F401
    ClipActions,
    ClipReward,
    Connector,
    ConnectorPipeline,
    FrameStack,
    ObsNormalizer,
    UnsquashActions,
)
from .env import (  # noqa: F401
    CartPole,
    GridTarget,
    MemoryCue,
    Pendulum,
    PixelPong,
    TorchEnv,
)
from .policy import (  # noqa: F401
    ConvPolicy,
    LSTMPolicy,
    MLPPolicy,
    mlp_apply,
    mlp_init,
)
from .ppo import (  # noqa: F401
    PPO,
    A2CConfig,
    ClippedAdam,
    PPOConfig,
    compute_gae,
    make_recurrent_rollout_fn,
    make_recurrent_update_fn,
    make_rollout_fn,
    make_update_fn,
)
