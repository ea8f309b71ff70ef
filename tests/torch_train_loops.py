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


def _fail_once(config, step, i):
    """Raise at ``step`` the first time each rank gets there (a marker file
    a rank remembers it by), so every rank of the gang fails together."""
    marker = f"{config['marker']}.{session.get_world_rank()}"
    if i == step and not os.path.exists(marker):
        open(marker, "w").close()
        raise RuntimeError(f"injected failure at step {i}")


def host_array_steps(config):
    """A `HostArrayConfig` gang: each step allreduces a scalar (rank + 1 +
    step), gathers the ranks and passes a barrier through the trainer's
    store, reporting the store's key prefix; every rank fails once at step 1
    and the next attempt resumes after the checkpoint's step."""
    import numpy as np

    from ray_tpu_torch.train import host_collective as hc
    ck = session.get_checkpoint()
    rank = session.get_world_rank()
    for i in range(ck.to_dict()["step"] + 1 if ck else 0, config["steps"]):
        _fail_once(config, 1, i)
        total = hc.allreduce(np.float32(rank + 1 + i), "sum")
        gathered = hc.allgather(np.int64(rank))
        hc.barrier()
        session.report({"step": i, "total": float(total),
                        "gathered": [int(g) for g in gathered],
                        "prefix": hc._STORE[1], "world": hc._STORE[2]},
                       checkpoint=Checkpoint.from_dict({"step": i}))


def pytree_steps(config):
    """A dp gang: each step saves {"w": a DTensor sharded over dp, "step"}
    to the shared ``config["path"]`` with `Checkpoint.from_pytree` and
    reports it; every rank fails once at step 1, and the next attempt
    restores the registered save with ``to_pytree(device="cpu")``."""
    import torch

    from ray_tpu_torch.parallel.sharding import (NamedSharding,
                                                 PartitionSpec, device_put)
    mesh = session.get_mesh()
    ck = session.get_checkpoint()
    start, restored = 0, None
    if ck is not None:
        tree = ck.to_pytree(device="cpu")
        start, restored = tree["step"] + 1, tree["w"].numpy().tolist()
    for i in range(start, config["steps"]):
        _fail_once(config, 1, i)
        w = device_put(torch.arange(16.0).reshape(4, 4) + i,
                       NamedSharding(mesh, PartitionSpec("dp", None)))
        ck = Checkpoint.from_pytree({"w": w, "step": i}, path=config["path"])
        session.report({"step": i, "restored": restored,
                        "local": w.to_local().numpy().tolist()},
                       checkpoint=ck)


def host_ops(config):
    """A rank of a `HostArrayConfig` gang: `host_collective`'s allreduce
    with every op and allgather of this rank's array, `allreduce_pytree` of
    gradient-like tensors on the rank's device, then a `util.collective`
    group on the same store (broadcast from the last rank, a send / recv
    around the ring, a reducescatter of 7 rows); writes what each returned
    to ``config["out"]/host_ops<rank>.json``."""
    import json

    import numpy as np
    import torch

    from ray_tpu_torch.train import host_collective as hc
    from ray_tpu_torch.util import collective as col
    rank, world = session.get_world_rank(), session.get_world_size()
    device = session.get_device()
    x = host_ops_input(rank)
    out = {op: hc.allreduce(x, op).tolist()
           for op in ("sum", "mean", "max", "min")}
    out["gather"] = [g.tolist() for g in hc.allgather(x)]
    grads = {"w": torch.from_numpy(x).to(device),
             "b": torch.from_numpy(x[0]).to(device, torch.bfloat16)}
    red = hc.allreduce_pytree(grads, "mean")
    out["tree"] = {"w": red["w"].cpu().tolist(),
                   "b": red["b"].float().cpu().tolist(),
                   "devices": [str(red["w"].device), str(red["b"].device)],
                   "b_dtype": str(red["b"].dtype)}
    col.init_collective_group(world, rank, store=hc._STORE[0],
                              group_name="ranks")
    out["broadcast"] = col.broadcast(x * (rank + 1), src_rank=world - 1,
                                     group_name="ranks").tolist()
    col.send(x + rank, (rank + 1) % world, group_name="ranks")
    out["recv"] = col.recv((rank - 1) % world, group_name="ranks").tolist()
    out["scatter"] = col.reducescatter(host_ops_rows(rank),
                                       group_name="ranks").tolist()
    col.barrier(group_name="ranks")
    col.destroy_collective_group("ranks")
    with open(os.path.join(config["out"], f"host_ops{rank}.json"), "w") as f:
        json.dump(out, f)
    session.report({"rank": rank, "world": world})


def host_ops_input(rank):
    import numpy as np
    return np.random.default_rng(100 + rank).standard_normal(
        (3, 5)).astype(np.float32)


def host_ops_rows(rank):
    import numpy as np
    return np.arange(14, dtype=np.float32).reshape(7, 2) * (rank + 1)


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
