"""Reinforcement learning of the port (counterpart of ``ray_tpu.rl``): the
batched envs, the MLP / LSTM / conv actor-critic policies, connectors, the
model catalog, the PPO family (PPO, A2C, PG; DD-PPO over a process
group's ranks), exploration, the replay
buffer on the card (`replay`, `learner`), the off-policy algorithms
(DQN, SimpleQ, Rainbow, R2D2, TD3, DDPG, SAC), IMPALA and APPO (inline),
multi-agent RL (IndependentPPO, QMIX, MADDPG), offline RL (BC, MARWIL,
CQL, CRR, importance-sampling estimation), contextual bandits (LinUCB,
LinTS), evolution strategies (ES, ARS), meta-learning (MAML), model-based
RL (Dreamer), the Decision Transformer (DT), AlphaZero and SlateQ.  Envs,
policies, buffers and updates run on the card unless given
``device="cpu"``."""

from .algorithm import Algorithm, track_episode_returns  # noqa: F401
from .bandit import (  # noqa: F401
    ContextBandit,
    LinearContextBandit,
    LinTS,
    LinTSConfig,
    LinUCB,
    LinUCBConfig,
)
from .alpha_zero import (  # noqa: F401
    AlphaZero,
    AlphaZeroConfig,
    TicTacToe,
    make_mcts,
)
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
from .ddppo import DDPPO, DDPPOConfig  # noqa: F401
from .dqn import (  # noqa: F401
    DQN,
    DQNConfig,
    QNetwork,
    Rainbow,
    RainbowConfig,
    SimpleQ,
    SimpleQConfig,
)
from .dreamer import Dreamer, DreamerConfig  # noqa: F401
from .dt import DT, DTConfig, episodes_from_columns  # noqa: F401
from .env import (  # noqa: F401
    CartPole,
    GridTarget,
    MemoryCue,
    Pendulum,
    PixelPong,
    TorchEnv,
)
from .es import ARS, ARSConfig, ES, ESConfig, make_eval_fn  # noqa: F401
from .exploration import (  # noqa: F401
    EpsilonGreedy,
    GaussianActionNoise,
    OrnsteinUhlenbeckNoise,
    StochasticSampling,
)
from .impala import APPOConfig, Impala, ImpalaConfig, vtrace  # noqa: F401
from .maddpg import MADDPG, MADDPGConfig, SpreadLineContinuous  # noqa: F401
from .maml import GoalDirection, MAML, MAMLConfig, MetaTaskEnv  # noqa: F401
from .multi_agent import (  # noqa: F401
    IndependentPPO,
    IndependentPPOConfig,
    MultiAgentTorchEnv,
    SpreadLine,
)
from .offline import (  # noqa: F401
    BC,
    BCConfig,
    CQL,
    CQLConfig,
    CRR,
    CRRConfig,
    MARWIL,
    MARWILConfig,
    collect_dataset,
    importance_sampling_estimate,
    load_dataset,
    save_dataset,
)
from .pg import PG, PGConfig  # noqa: F401
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
    Adam,
    AdamW,
    ClippedAdam,
    PPOConfig,
    compute_gae,
    make_recurrent_rollout_fn,
    make_recurrent_update_fn,
    make_rollout_fn,
    make_update_fn,
)
from .qmix import QMIX, QMIXConfig, mixer_apply, mixer_init  # noqa: F401
from .r2d2 import R2D2, R2D2Config, RecurrentQNetwork  # noqa: F401
from .sac import SAC, SACConfig  # noqa: F401
from .slateq import RecSlateEnv, SlateQ, SlateQConfig  # noqa: F401
from .td3 import DDPG, DDPGConfig, TD3, TD3Config  # noqa: F401
