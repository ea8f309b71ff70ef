"""Train functions for the port's Train gang, run in its spawned rank
processes (`tests/test_torch_train_gang.py` on the CPU over gloo,
`tests/cuda_rank_checks.py` on four cards over NCCL).

They live here, not in the test module, because a rank unpickles its train
function by reference: this module imports torch and the port only, never
JAX, so a rank does not import the test module or JAX.  Each reads the
device from the session.
"""

from __future__ import annotations

import os

from ray_tpu_torch.air import Checkpoint, session

# AdamW, pinned on both sides as in test_torch_train.py
LR, B1, B2, EPS, WD = 1e-2, 0.9, 0.95, 1e-3, 0.1
# the tiny model of tests/test_train.py:47
TINY = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, max_seq_len=32)


def tiny_steps(config):
    """``config["steps"]`` AdamW steps of the tiny fp32 model from
    ``config["params"]`` (a numpy tree, the JAX init's layout) on the global
    batch ``config["tokens"]``, the weights placed on the gang's mesh by
    ``config["rules"]`` (FSDP_TP_RULES by default); reports each step's loss
    and grad norm with a checkpoint of the step."""
    import torch

    from ray_tpu_torch import parallel
    from ray_tpu_torch.convert import params_from_numpy
    from ray_tpu_torch.models import (TransformerConfig, local_leaves,
                                      make_train_step, params_axes)
    torch.set_num_threads(1)
    device = session.get_device()
    cfg = TransformerConfig.tiny(dtype=torch.float32, **TINY)
    mesh = session.get_mesh()
    params = parallel.shard_pytree(
        params_from_numpy(config["params"], cfg, device), params_axes(cfg),
        mesh, getattr(parallel, config.get("rules", "FSDP_TP_RULES")))
    opt = torch.optim.AdamW(local_leaves(params), lr=LR, betas=(B1, B2),
                            eps=EPS, weight_decay=WD)
    batch = {"tokens": torch.from_numpy(config["tokens"]).to(device)}
    with parallel.use_mesh(mesh):
        step = make_train_step(cfg, opt)
        for i in range(config["steps"]):
            m = step(params, batch)
            session.report({"loss": float(m["loss"]),
                            "grad_norm": float(m["grad_norm"]), "step": i,
                            "world": session.get_world_size()},
                           checkpoint=Checkpoint.from_dict({"step": i}))


def restart_once(config):
    """tests/test_train.py:100's loop: steps 0-3, resuming after the step
    of the checkpoint it is given; raises once at step 2 (a marker file
    remembers that it did)."""
    ck = session.get_checkpoint()
    start = ck.to_dict()["step"] + 1 if ck else 0
    for i in range(start, 4):
        if i == 2 and not os.path.exists(config["marker"]):
            open(config["marker"], "w").write("x")
            raise RuntimeError("injected worker failure")
        session.report({"step": i},
                       checkpoint=Checkpoint.from_dict({"step": i}))


def always_fails():
    raise RuntimeError("always fails")


def rank_allreduce():
    """tests/test_train.py:260 over torch.distributed: two elements a rank
    of value rank, summed over the gang (12.0 at world size 4)."""
    import torch
    import torch.distributed as dist
    mesh = session.get_mesh()
    rank = session.get_world_rank()
    total = torch.full((2,), float(rank),
                       device=session.get_device()).sum()
    dist.all_reduce(total)
    session.report({"rank": rank, "total": float(total),
                    "world": dist.get_world_size(),
                    "dp": mesh.size(mesh.mesh_dim_names.index("dp"))})


def exits_after_a_report(config):
    """Every rank reports once; then rank ``config["rank"]``'s process ends
    with ``config["code"]`` (no exception, no clean-up), as a crashed rank
    does, while the others wait for it in a barrier that never completes."""
    import torch.distributed as dist
    session.report({"step": 0})
    if session.get_world_rank() == config["rank"]:
        os._exit(config["code"])
    dist.barrier()


class Echo:
    """A plain actor for the actor layer's own tests."""

    def __init__(self, x):
        self.x = x

    def add(self, y):
        return self.x + y

    def env(self, key):
        return os.environ.get(key)

    def fail(self):
        raise ValueError("failed in the actor")

    def sleep(self, seconds):
        import time
        time.sleep(seconds)
        return seconds
