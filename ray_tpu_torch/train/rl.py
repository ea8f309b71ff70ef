"""RLTrainer: the Train-API face of the RL algorithms (counterpart of
``ray_tpu/train/rl.py``): ``fit()`` runs the iteration loop and returns a
`Result` with the last iteration's metrics and a checkpoint."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ..air import Result, RunConfig


class RLTrainer:
    """``RLTrainer(PPOConfig(env=...), iterations=20).fit()``.

    ``algo_config`` is an RL config object with ``.build()``.  ``stop`` may
    name metric thresholds (e.g. ``{"episode_reward_mean": 450}``) that end
    training early.  The Result's checkpoint restores with
    ``algo_config.build().restore(ckpt)``.
    """

    def __init__(self, algo_config: Any, *, iterations: int = 10,
                 stop: Optional[Dict[str, float]] = None,
                 run_config: Optional[RunConfig] = None,
                 on_result: Optional[Callable[[Dict[str, Any]], None]]
                 = None):
        self.algo_config = algo_config
        self.iterations = iterations
        self.stop = stop or {}
        self.run_config = run_config or RunConfig()
        self.on_result = on_result

    def fit(self) -> Result:
        algo = self.algo_config.build()
        res: Dict[str, Any] = {}
        for _ in range(self.iterations):
            res = algo.train()
            if self.on_result is not None:
                self.on_result(res)
            if any(res.get(k, float("-inf")) >= v
                   for k, v in self.stop.items()):
                break
        return Result(metrics=res, checkpoint=algo.save())
