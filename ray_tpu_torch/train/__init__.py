"""Training entry points of the port (counterpart of ``ray_tpu.train``): so
far the RL trainer."""

from .rl import RLTrainer  # noqa: F401
