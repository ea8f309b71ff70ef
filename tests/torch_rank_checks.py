"""Rank-side checks of the port's parallel layer, for the multi-rank CPU
tests (`test_torch_parallel.py`, `test_torch_ring_attention.py`,
`test_torch_pipeline.py`).

`run_ranks` starts one process per rank (``python torch_rank_checks.py
JOB RANK_DIR``), which join one gloo group through
`parallel.join_mesh_gang` on a `FileStore`, run the job's checks in order
and write their results (numpy trees) to ``RANK_DIR/rank<r>.pkl``.  The
ranks import torch and the port only, never JAX: the test module holds the
results against the JAX package in its own process.  With
``RANKS_DEBUG=<seconds>`` in the environment a rank still running after
that long prints its stack and exits.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path


REPO = Path(__file__).resolve().parents[1]
# AdamW, pinned on both sides as in test_torch_train.py
LR, B1, B2, EPS, WD = 1e-2, 0.9, 0.95, 1e-3, 0.1


def run_ranks(tmp: Path, world: int, checks, timeout: float = 180.0,
              device: str = "cpu"):
    """Run ``checks`` ([(name, kwargs)]; a name "train:moe" runs
    `check_train` and keeps its result as "train:moe") on ``world`` ranks,
    over gloo with CPU tensors, or with ``device="cuda"`` over NCCL with
    each rank's tensors on its own card; → the results, a list indexed by
    rank of {name: result}."""
    tmp.mkdir(parents=True, exist_ok=True)
    for old in [tmp / "store", *tmp.glob("rank*.pkl")]:   # an earlier run's
        old.unlink(missing_ok=True)
    job = tmp / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump({"world": world, "store": str(tmp / "store"),
                     "checks": checks, "device": device}, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(job), str(tmp)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _ in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError("a rank failed:\n" + "\n".join(
            f"--- process {i} (exit {p.returncode}) ---\n{log[-4000:]}"
            for i, (p, log) in enumerate(zip(procs, logs))))
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# -- rank side -----------------------------------------------------------------

_DEV = "cpu"        # this rank's device: "cpu", or its card "cuda:<i>"


def _t(a):
    import torch
    return torch.from_numpy(a).to(_DEV)


def _np(x):
    from torch.distributed.tensor import DTensor
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


def _mesh(spec):
    from ray_tpu_torch.parallel import MeshSpec, create_mesh
    return create_mesh(MeshSpec(**spec),
                       device="cpu" if _DEV == "cpu" else "cuda")


def _rules(name, overrides=None):
    from ray_tpu_torch import parallel
    rules = getattr(parallel, name)
    return rules.with_overrides(**overrides) if overrides else rules


def _cfg(kw):
    import torch
    from ray_tpu_torch.models import TransformerConfig
    return TransformerConfig.tiny(dtype=torch.float32, **kw)


def _params(tree, cfg):
    from ray_tpu_torch.convert import params_from_numpy
    return params_from_numpy(tree, cfg, _DEV)


def _leaf_paths(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaf_paths(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def check_gang(rank):
    import torch.distributed as dist
    return {"rank": rank, "world": dist.get_world_size()}


def check_shards(rank, params, cfg_kw, meshes):
    """Each mesh's placement of the tiny model's weights by FSDP_TP_RULES:
    this rank's local shard of every leaf."""
    from ray_tpu_torch.models import params_axes
    from ray_tpu_torch.parallel import shard_pytree
    cfg = _cfg(cfg_kw)
    tparams = _params(params, cfg)
    out = []
    for spec in meshes:
        placed = shard_pytree(tparams, params_axes(cfg), _mesh(spec),
                              _rules("FSDP_TP_RULES"))
        out.append({path: _np(leaf.to_local())
                    for path, leaf in _leaf_paths(placed)})
    return out


def check_matmul(rank, x, w):
    """The FSDP matmul as the port's train step runs it: this rank's rows
    of the batch times the weight gathered for compute, the product's rows
    gathered whole."""
    import torch
    from ray_tpu_torch.parallel import (FSDP_RULES, device_put,
                                        named_sharding)
    from ray_tpu_torch.parallel.collectives import all_gather_invariant
    from ray_tpu_torch.parallel.sharding import (batch_rows,
                                                 gather_for_compute)
    mesh = _mesh({"fsdp": 4})
    xs = device_put(_t(x),
                    named_sharding(mesh, ("batch", None), FSDP_RULES))
    ws = device_put(_t(w),
                    named_sharding(mesh, ("embed", None), FSDP_RULES))
    rows = batch_rows(xs, mesh)
    local = rows @ gather_for_compute(ws, mesh, ("fsdp",))
    return {"local_x": _np(xs.to_local()), "local_w": _np(ws.to_local()),
            "rows": _np(rows),
            "out": _np(all_gather_invariant(local, "fsdp", 0, mesh))}


def check_constrain(rank, w):
    """`constrain` moves a DTensor between specs; a plain tensor and no mesh
    leave it as it is."""
    import torch
    from ray_tpu_torch.parallel import (FSDP_TP_RULES, constrain,
                                        device_put, named_sharding,
                                        use_mesh)
    mesh = _mesh({"fsdp": 2, "tp": 2})
    t = _t(w)
    d = device_put(t, named_sharding(mesh, ("embed", "mlp"), FSDP_TP_RULES))
    with use_mesh(mesh):
        moved = constrain(d, (None, "mlp"), FSDP_TP_RULES)
        plain = constrain(t, (None, "mlp"), FSDP_TP_RULES)
    outside = constrain(d, (None, "mlp"), FSDP_TP_RULES)
    return {"before": _np(d.to_local()), "after": _np(moved.to_local()),
            "placements": [str(p) for p in moved.placements],
            "plain_same": plain is t, "outside_same": outside is d}


def check_attention(rank, spec, cases):
    """Whole-tensor ring and Ulysses attention and, where asked, the
    gradients of sum(out²) with respect to q, k and v."""
    import torch
    from ray_tpu_torch.ops.ring_attention import (make_ring_attention,
                                                  make_ulysses_attention)
    mesh = _mesh(spec)
    out = {}
    for name, kind, causal, grads, q, k, v in cases:
        make = make_ring_attention if kind == "ring" else \
            make_ulysses_attention
        fn = make(mesh, causal=causal)
        qkv = [_t(a).requires_grad_(grads) for a in (q, k, v)]
        o = fn(*qkv)
        res = {"out": _np(o)}
        if grads:
            res["grads"] = _np(torch.autograd.grad((o ** 2).sum(), qkv))
        out[name] = res
    return out


class _Record:
    """An optimizer stand-in for `make_train_step` that keeps each step's
    gradients (whole: a DTensor parameter's local gradient joined with its
    placements) and leaves the params as they are."""

    def __init__(self, params):
        import torch
        from ray_tpu_torch.models import local_leaves, param_leaves
        self.leaves = param_leaves(params)
        self.opt = torch.optim.SGD(local_leaves(params), lr=0.0)
        self.param_groups = self.opt.param_groups
        self.grads = None

    def step(self):
        from torch.distributed.tensor import DTensor
        local = [p.grad for g in self.param_groups for p in g["params"]]
        self.grads = [
            DTensor.from_local(g, p.device_mesh, p.placements,
                               run_check=False).full_tensor().cpu().numpy()
            if isinstance(p, DTensor) else g.cpu().numpy()
            for g, p in zip(local, self.leaves)]


def _adamw(leaves):
    import torch
    return torch.optim.AdamW(leaves, lr=LR, betas=(B1, B2), eps=EPS,
                             weight_decay=WD)


def _train(cfg, params, tokens, steps, mesh=None, rules=None):
    """One recorded step (the gradients of the first loss), then ``steps``
    AdamW steps; under ``mesh`` the weights are placed by ``rules`` as
    DTensors.  → (first loss, first grad norm, first grads (whole, in
    param_leaves order), [loss], [grad_norm], final params (whole))."""
    import contextlib

    import torch
    from ray_tpu_torch.models import (local_leaves, make_train_step,
                                      param_leaves, params_axes)
    from ray_tpu_torch.parallel import shard_pytree, use_mesh
    if mesh is not None:
        params = shard_pytree(params, params_axes(cfg), mesh, rules)
    batch = {"tokens": _t(tokens)}
    ctx = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with ctx:
        rec = _Record(params)
        first = make_train_step(cfg, rec)(params, batch)
        step = make_train_step(cfg, _adamw(local_leaves(params)))
        losses, norms = [], []
        for _ in range(steps):
            m = step(params, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return {"loss": float(first["loss"]),
            "grad_norm": float(first["grad_norm"]), "grads": rec.grads,
            "losses": losses, "norms": norms,
            "params": [_np(p) for p in param_leaves(params)]}


def check_train(rank, cfg_kw, params, tokens, spec, rules, steps,
                overrides=None, plain=False):
    """The train step under ``spec``'s mesh with the weights placed by
    ``rules``; with ``plain`` also the same steps with no mesh and no
    pipeline."""
    cfg = _cfg(cfg_kw)
    out = {"mesh": _train(cfg, _params(params, cfg), tokens, steps,
                          _mesh(spec), _rules(rules, overrides))}
    if plain:
        flat = _cfg({**cfg_kw, "pp_stages": 1})
        out["plain"] = _train(flat, _params(params, flat), tokens, steps)
    return out


def check_forward(rank, cfg_kw, params, tokens, spec):
    """The forward under ``spec``'s mesh on this rank's rows (plain
    weights) and the plain forward of the whole batch."""
    import torch
    from ray_tpu_torch.models import forward_with_aux
    from ray_tpu_torch.parallel import use_mesh
    from ray_tpu_torch.parallel.sharding import batch_rows
    cfg = _cfg(cfg_kw)
    tparams = _params(params, cfg)
    tok = _t(tokens)
    mesh = _mesh(spec)
    with torch.no_grad(), use_mesh(mesh):
        logits, aux = forward_with_aux(tparams, batch_rows(tok, mesh), cfg)
    with torch.no_grad():
        whole, _ = forward_with_aux(tparams, tok,
                                    _cfg({**cfg_kw, "pp_stages": 1}))
    return {"logits": _np(logits), "aux": float(aux), "plain": _np(whole)}


def check_backward_outside(rank, cfg_kw, params, tokens, spec):
    """`lm_loss` on this rank's rows under ``spec``'s mesh with full remat,
    its gradients taken once inside the `use_mesh` block and once after
    leaving it: the layers recomputed in the backward must run as the
    forward did either way."""
    import torch
    from ray_tpu_torch.models import lm_loss, param_leaves
    from ray_tpu_torch.parallel import use_mesh
    from ray_tpu_torch.parallel.sharding import batch_rows
    cfg = _cfg({**cfg_kw, "remat": True})
    mesh = _mesh(spec)
    tok = batch_rows(_t(tokens), mesh)
    out = {}
    for where in ("inside", "outside"):
        tparams = _params(params, cfg)
        leaves = [p.requires_grad_(True) for p in param_leaves(tparams)]
        with use_mesh(mesh):
            loss = lm_loss(tparams, {"tokens": tok}, cfg)
            if where == "inside":
                grads = torch.autograd.grad(loss, leaves)
        if where == "outside":
            grads = torch.autograd.grad(loss, leaves)
        out[where] = {"loss": float(loss), "grads": _np(grads)}
    return out


def check_slab(rank, spec, w, x):
    """`pipeline_apply` over a stack of matrices [L, d, d] (each layer
    h -> tanh(h @ w_l)), given once placed with layers="pp" and
    embed="fsdp" and gathered with pp kept, once as the whole stack: the
    tensor each rank holds for the compute, the slab a stage runs, the
    outputs and the stack's gradient of sum(out²)."""
    import torch
    from torch.distributed.tensor import DTensor
    from ray_tpu_torch.parallel import (FSDP_TP_RULES, device_put,
                                        named_sharding, pipeline_apply)
    from ray_tpu_torch.parallel.sharding import gather_for_compute
    mesh = _mesh(spec)
    rules = FSDP_TP_RULES.with_overrides(layers="pp")
    seen = []

    def stage_fn(slab, state):
        seen.append(tuple(slab["w"].shape))
        h = state[0]
        for wl in slab["w"].unbind(0):
            h = torch.tanh(h @ wl)
        return (h,)

    out = {}
    for how in ("placed", "whole"):
        wt = _t(w)
        if how == "placed":
            wt = device_put(wt, named_sharding(
                mesh, ("layers", "embed", None), rules))
        wt = wt.detach().requires_grad_(True)
        use = gather_for_compute(wt, mesh, (), keep=("pp",))
        held = use.to_local() if isinstance(use, DTensor) else use
        seen.clear()
        (y,) = pipeline_apply(stage_fn, {"w": use}, (_t(x),),
                              n_stages=spec["pp"], n_micro=x.shape[0],
                              mesh=mesh)
        (g,) = torch.autograd.grad((y ** 2).sum(), [wt])
        out[how] = {"held": tuple(held.shape), "slab": seen[0],
                    "y": y.detach().cpu().numpy(), "grad": _np(g)}
    return out


def check_ddppo(rank, spec, cfg_kw, params, resets, draws, perms):
    """One DD-PPO iteration, the learner given its JAX draws: learner i is
    the mesh's dp coordinate i."""
    import torch
    from ray_tpu_torch import rl
    from ray_tpu_torch.convert import policy_params_from_numpy
    mesh = _mesh(spec)
    algo = rl.DDPPO(rl.DDPPOConfig(env=rl.CartPole, device=_DEV,
                                   **cfg_kw), mesh=mesh)
    i = algo.rank
    algo.params = policy_params_from_numpy(algo.policy, params)
    algo.opt_state = algo.optimizer.init(algo.params)
    algo.env_states, algo.obs = algo.env.reset_given(
        {k: _t(v) for k, v in resets[i].items()})
    mine = [{"noise": _t(d["noise"]),
             "reset": {k: _t(v)
                       for k, v in d["reset"].items()}} for d in draws[i]]
    res = algo.training_step(draws=mine,
                             perms=_t(perms[i]).long())
    return {"learner": i, "metrics": res,
            "params": _np(algo.params), "obs": algo.obs.cpu().numpy(),
            "done_returns": list(algo._ep_done_returns),
            "state": algo.get_state()}


def check_ddppo_sync(rank, spec, cfg_kw):
    """One DD-PPO iteration with the learners' own draws: the weights
    before and after it (every learner must end with the same) and the
    reward sum (summed over the learners, the same on every rank)."""
    import copy

    from ray_tpu_torch import rl
    algo = rl.DDPPO(rl.DDPPOConfig(env=rl.CartPole, device=_DEV,
                                   **cfg_kw), mesh=_mesh(spec))
    before = copy.deepcopy(_np(algo.params))    # numpy views of CPU tensors
    res = algo.train()
    return {"learner": algo.rank, "before": before,
            "params": _np(algo.params), "reward_sum": res["reward_sum"]}


def check_pytree(rank, path, w, b):
    """`Checkpoint.from_pytree` of {"w": w under fsdp=2,tp=2 as
    P("fsdp", "tp"), "b", "step"} at 4 ranks, restored onto the swapped
    placements P("tp", "fsdp") and onto whole tensors, then a second
    (numbered) save of 2w and its restore: this rank's shards, the files
    each rank wrote and the save directories."""
    import numpy as np
    import torch

    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.parallel.sharding import (NamedSharding,
                                                 PartitionSpec, device_put)
    mesh = _mesh({"fsdp": 2, "tp": 2})

    def put(x, *spec):
        return device_put(_t(x), NamedSharding(mesh, PartitionSpec(*spec)))

    tree = {"w": put(w, "fsdp", "tp"), "b": _t(b),
            "step": torch.tensor(3, device=_DEV)}
    ck = Checkpoint.from_pytree(tree, path=path)
    first = sorted(os.listdir(path))
    save = os.path.join(path, first[-1])
    swapped = ck.to_pytree({"w": put(np.zeros_like(w), "tp", "fsdp"),
                            "b": _t(np.zeros_like(b)),
                            "step": torch.tensor(0, device=_DEV)})
    whole = ck.to_pytree(device=_DEV)
    ck2 = Checkpoint.from_pytree({"w": put(w * 2, "fsdp", "tp"),
                                  "b": _t(b), "step": 4}, path=path)
    again = ck2.to_pytree(device=_DEV)
    return {"saved_local": _np(tree["w"].to_local()),
            "swapped_local": _np(swapped["w"].to_local()),
            "swapped_placements": [repr(p) for p in
                                   swapped["w"].placements],
            "whole": {k: _np(v) for k, v in whole.items()},
            "again": {k: _np(v) for k, v in again.items()},
            "files": {n: os.path.getsize(os.path.join(save, n))
                      for n in os.listdir(save)},
            "saves": [first, sorted(os.listdir(path))]}


def check_pytree_cross(rank, path, cfg_kw, params):
    """The tiny model placed by FSDP_RULES on an fsdp=4 mesh and saved
    with `Checkpoint.from_pytree`, then restored onto FSDP_TP_RULES
    placements on an fsdp=2,tp=2 mesh (the cross-topology resume): each
    restored leaf whole, and its placements."""
    import torch

    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.models import params_axes
    from ray_tpu_torch.parallel import shard_pytree
    cfg = _cfg(cfg_kw)
    tparams = _params(params, cfg)
    Checkpoint.from_pytree(
        shard_pytree(tparams, params_axes(cfg), _mesh({"fsdp": 4}),
                     _rules("FSDP_RULES")), path=path)
    zeros = {k: ({n: torch.zeros_like(v) for n, v in t.items()}
                 if isinstance(t, dict) else torch.zeros_like(t))
             for k, t in tparams.items()}
    target = shard_pytree(zeros, params_axes(cfg),
                          _mesh({"fsdp": 2, "tp": 2}),
                          _rules("FSDP_TP_RULES"))
    restored = Checkpoint.from_directory(path).to_pytree(target)
    return {"restored": {p: _np(leaf) for p, leaf in _leaf_paths(restored)},
            "placements": {p: [repr(x) for x in leaf.placements]
                           for p, leaf in _leaf_paths(restored)}}


def check_launches(rank):
    """The flash kernels' launch counts in this rank so far (0 on the
    CPU, where the wrappers run their plain versions)."""
    from ray_tpu_torch.ops.flash_attention import (flash_bwd_dkv,
                                                   flash_bwd_dq, flash_fwd)
    return {fn.__name__: fn.launches
            for fn in (flash_fwd, flash_bwd_dq, flash_bwd_dkv)}


CHECKS = {name[len("check_"):]: fn for name, fn in globals().items()
          if name.startswith("check_")}


def main(job_path: str, out_dir: str) -> None:
    global _DEV
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.parallel import join_mesh_gang, leave_mesh_gang
    torch.set_num_threads(1)
    if os.environ.get("RANKS_DEBUG"):
        import faulthandler
        faulthandler.dump_traceback_later(int(os.environ["RANKS_DEBUG"]),
                                          exit=True)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    store = dist.FileStore(job["store"], job["world"])
    device = job.get("device", "cpu")
    join_mesh_gang("checks", job["world"], store=store, device=device)
    if device == "cuda":        # the gang put this rank on its card
        _DEV = f"cuda:{torch.cuda.current_device()}"
    rank = dist.get_rank()
    results = {}
    for name, kwargs in job["checks"]:
        # "check:label" runs check_<check> and keeps it under its label
        results[name] = CHECKS[name.split(":")[0]](rank, **kwargs)
    dist.barrier()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    leave_mesh_gang("checks")


if __name__ == "__main__":
    assert "jax" not in sys.modules
    main(*sys.argv[1:3])
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
