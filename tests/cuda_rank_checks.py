"""The multi-rank checks of `torch_rank_checks.py` with each rank's tensors
on its own card and the collectives over NCCL, held without JAX: each
sharded run against the same computation unsharded.

    python tests/cuda_rank_checks.py [--device cuda|cpu] [--out DIR]

needs four cards (``--device cpu`` runs the same four ranks on gloo with
CPU tensors, to rehearse where there is no card).  The meshes: sp=4
(ring and Ulysses attention against reference attention on the whole
tensors; Ulysses runs the flash kernels on the cards), sp=2 x fsdp=2 (the
ring model's train step with FSDP_TP_RULES DTensors, and its remat
backward outside the mesh block), pp=2 x fsdp=2 (the pipelined step with
layers="pp", and a placed stack's slabs), fsdp=2 x ep=2 (the MoE step) and
dp=4 (DD-PPO, whose learners must end an iteration with the same
weights), and the tiny model saved with `Checkpoint.from_pytree` under
fsdp=4 DTensors, restored onto fsdp=2,tp=2 placements and whole in this
process, bitwise.  A train step is held against the plain step on one rank, at
the CPU tests' bounds.  Then the Train gang (`TorchTrainer` on the port's
actor layer, four spawned ranks): the all-reduce of the ranks (12.0), and
the tiny fp32 model's steps at dp=4 and fsdp=4 against the same loop on
one rank; a `HostArrayConfig` gang of four (`host_collective`'s
allreduce with every op, allgather, `allreduce_pytree` of card leaves, and
a `util.collective` group: broadcast, send / recv, an uneven
reducescatter) against the JAX reducer's arithmetic written out in numpy;
no process left after.  Last the serve gang (`serve.gang`, the
`torch_serve_gang_models.Generator` callable): tp=2 and tp=4 gang replicas
of a small fp32 model at head dim 64 (so the forward kernel runs on the
cards), weights placed under FSDP_TP_RULES: the last position's logits
within OUT_TOL of the plain one-rank forward in this process, the greedy
tokens equal, one forward launch a layer a request; a follower killed in
the tp=2 gang fails the next request with ActorDiedError and a later one
with ReplicaUnavailableError; no process left.  Prints a line a check, then
one JSON object; exits 1 where a check fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from torch_rank_checks import REPO, run_ranks

sys.path.insert(0, str(REPO))           # the port, run from any directory

WORLD = 4
OUT_TOL = dict(atol=2e-5, rtol=2e-4)     # tests/test_ring_attention.py's
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
TOL = 1e-5                               # the CPU tests' step bound
MODEL = dict(attention_impl="ring", max_seq_len=64)
MOE_MODEL = dict(MODEL, n_experts=4, expert_top_k=2)
DENSE = dict(max_seq_len=32, attention_impl="reference")
PIPE = dict(DENSE, pp_stages=2, pp_microbatches=2)
MOE = dict(DENSE, n_experts=4, expert_top_k=2)
# the serve gang's model: head dim 64 (d 256, 4/2 heads), fp32, flash
SERVE_GANG = dict(d_model=256, n_heads=4, n_kv_heads=2, max_seq_len=128,
                  attention_impl="flash")
DDPPO = dict(num_envs=8, rollout_length=8, num_sgd_epochs=2,
             num_minibatches=2, lr=3e-3, seed=0, hidden=(8,))
# name, kind, causal, gradients, (b, s, h, hkv, d); Ulysses at head dim
# 64 so its local attention is the flash kernels' on a card
CASES = [("ring_causal", "ring", True, True, (2, 64, 4, 2, 16)),
         ("ring_noncausal", "ring", False, True, (2, 64, 4, 4, 16)),
         ("ulysses", "ulysses", True, True, (1, 128, 8, 8, 64))]


def _weights(kw):
    """The tiny fp32 model's weights from a seed, as numpy."""
    from ray_tpu_torch.models import TransformerConfig, init_params
    cfg = TransformerConfig.tiny(dtype=torch.float32, **kw)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else v.numpy()
                for k, v in node.items()}
    return walk(params)


def _qkv(seed, b, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))


def _norm_err(got, want):
    return max(float(np.linalg.norm(np.asarray(g) - np.asarray(w))
                     / max(np.linalg.norm(np.asarray(w)), 1e-30))
               for g, w in zip(got, want))


def _close(got, want, atol, rtol):
    """max |got - want| and whether it is within atol + rtol |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    return float(diff.max()), bool((diff <= atol + rtol * np.abs(want)).all())


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _leaf_items(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaf_items(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def checks(out_dir):
    tokens64 = np.random.default_rng(1).integers(0, 256, (2, 64),
                                                 dtype=np.int32)
    tokens32 = np.random.default_rng(1).integers(0, 256, (4, 32),
                                                 dtype=np.int32)
    cases = [(name, kind, causal, grads, *_qkv(i, *shape))
             for i, (name, kind, causal, grads, shape) in enumerate(CASES)]
    sp2 = dict(sp=2, fsdp=2)
    step = dict(rules="FSDP_TP_RULES", steps=2, plain=True)
    slab_w = (np.random.default_rng(2).normal(size=(4, 8, 8)) * 0.4
              ).astype(np.float32)
    slab_x = np.random.default_rng(3).normal(size=(2, 3, 8)).astype(
        np.float32)
    return [
        ("attention", dict(spec=dict(sp=WORLD, fsdp=1), cases=cases)),
        ("launches", {}),
        ("train:ring", dict(step, cfg_kw=MODEL, params=_weights(MODEL),
                            tokens=tokens64, spec=sp2)),
        ("backward_outside", dict(cfg_kw=MOE_MODEL,
                                  params=_weights(MOE_MODEL),
                                  tokens=tokens64, spec=sp2)),
        ("train:pipe", dict(step, cfg_kw=PIPE, params=_weights(PIPE),
                            tokens=tokens32, spec=dict(fsdp=2, pp=2),
                            overrides={"layers": "pp"})),
        ("slab", dict(spec=dict(fsdp=2, pp=2), w=slab_w, x=slab_x)),
        ("train:moe", dict(step, cfg_kw=MOE, params=_weights(MOE),
                           tokens=tokens32, spec=dict(fsdp=2, ep=2))),
        ("ddppo_sync", dict(spec=dict(dp=WORLD, fsdp=1), cfg_kw=DDPPO)),
        ("pytree_cross", dict(path=str(out_dir / "pytree"), cfg_kw=DENSE,
                              params=_weights(DENSE))),
    ]


def judge(jobs, results, device):
    """→ {check: {numbers..., "ok": bool}}."""
    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.ops.attention import reference_attention
    out = {}
    for name, kind, causal, grads, q, k, v in jobs["attention"]["cases"]:
        qkv = [torch.from_numpy(a).double().requires_grad_(True)
               for a in (q, k, v)]
        o = reference_attention(*qkv, causal=causal)
        want = [o.detach().numpy(), *[g.numpy() for g in torch.autograd.grad(
            (o ** 2).sum(), qkv)]]
        err, ok = 0.0, True
        for r in range(WORLD):
            got = results[r]["attention"][name]
            e, good = _close(got["out"], want[0], **OUT_TOL)
            err, ok = max(err, e), ok and good
            for g, w in zip(got.get("grads", []), want[1:]):
                e, good = _close(g, w, **GRAD_TOL)
                err, ok = max(err, e), ok and good
        out[f"attention:{name}"] = {"max_abs_err": err, "ok": ok}
    launches = [results[r]["launches"] for r in range(WORLD)]
    out["ulysses_flash_launches"] = {
        "per_rank": launches,
        "ok": all(set(n.values()) == ({0} if device == "cpu" else {1})
                  for n in launches)}
    for which in ("train:ring", "train:pipe", "train:moe"):
        worst = {"loss": 0.0, "grads": 0.0, "losses": 0.0}
        for r in range(WORLD):
            mesh, plain = (results[r][which][side]
                           for side in ("mesh", "plain"))
            worst["loss"] = max(worst["loss"], abs(
                mesh["loss"] - plain["loss"]) / abs(plain["loss"]))
            worst["grads"] = max(worst["grads"],
                                 _norm_err(mesh["grads"], plain["grads"]))
            worst["losses"] = max(worst["losses"], float(np.max(
                np.abs(np.subtract(mesh["losses"], plain["losses"]))
                / np.abs(plain["losses"]))))
        out[which] = {**worst, "ok": all(x <= TOL for x in worst.values())}
    same = all(
        np.array_equal(g, w)
        for r in range(WORLD)
        for g, w in zip(results[r]["backward_outside"]["outside"]["grads"],
                        results[r]["backward_outside"]["inside"]["grads"]))
    out["backward_outside"] = {"bitwise": same, "ok": same}
    w, y = jobs["slab"]["w"], jobs["slab"]["x"]
    for wl in w:
        y = np.tanh(y @ wl)
    per = (w.shape[0] // 2,) + w.shape[1:]
    err, ok = 0.0, True
    for r in range(WORLD):
        got = results[r]["slab"]
        ok = ok and tuple(got["placed"]["held"]) == per and tuple(
            got["whole"]["held"]) == w.shape
        for how in ("placed", "whole"):
            e, good = _close(got[how]["y"], y, TOL, TOL)
            err, ok = max(err, e), ok and good
        e, good = _close(got["placed"]["grad"], got["whole"]["grad"], TOL,
                         TOL)
        err, ok = max(err, e), ok and good
    out["slab"] = {"held": per, "max_abs_err": err, "ok": ok}
    runs = [results[r]["ddppo_sync"] for r in range(WORLD)]
    first = _leaves(runs[0]["params"])
    same = all(all(np.array_equal(a, b) for a, b in zip(
        _leaves(run["params"]), first)) for run in runs)
    moved = not all(np.array_equal(a, b) for a, b in zip(
        _leaves(runs[0]["before"]), first))
    learners = sorted(run["learner"] for run in runs)
    sums = {float(run["reward_sum"]) for run in runs}
    want = dict(_leaf_items(jobs["pytree_cross"]["params"]))
    same = all(np.array_equal(results[r]["pytree_cross"]["restored"][k], w)
               for r in range(WORLD) for k, w in want.items())
    on_tp = any("Shard" in results[0]["pytree_cross"]["placements"][k][4]
                for k in want)
    # the same save restored whole in this one process, with no group
    whole = Checkpoint.from_directory(jobs["pytree_cross"]["path"]).to_pytree(
        device="cuda:0" if device == "cuda" else "cpu")
    one = all(np.array_equal(leaf.cpu().numpy(), want[k])
              for k, leaf in _leaf_items(whole))
    out["pytree_cross"] = {"fsdp4_to_fsdp2_tp2_bitwise": same,
                           "tp_sharded": on_tp, "whole_here_bitwise": one,
                           "ok": same and on_tp and one}
    out["ddppo_sync"] = {
        "learners": learners, "weights_equal": same, "moved": moved,
        "reward_sum": sorted(sums),
        "ok": same and moved and learners == list(range(WORLD))
        and len(sums) == 1 and all(np.isfinite(a).all() for a in first)}
    return out


def trainer_checks(device, out_dir):
    """→ {check: {numbers..., "ok": bool}} of the Train gang at WORLD
    ranks: each rank on its card (``device`` "cuda") or gloo on the CPU."""
    import multiprocessing

    import torch_train_loops as loops
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.train import HostArrayConfig, SpmdConfig, TorchTrainer

    def fit(name, fn, workers, mesh, config=None, backend=None):
        result = TorchTrainer(
            fn, train_loop_config=config,
            scaling_config=ScalingConfig(
                num_workers=workers,
                device=None if device == "cuda" else "cpu"),
            backend_config=backend or SpmdConfig(mesh=mesh),
            run_config=RunConfig(name=name, storage_path=out_dir)).fit()
        if result.error is not None:
            raise RuntimeError(f"trainer {name} failed") from result.error
        return result

    out = {}
    res = fit("allreduce", loops.rank_allreduce, WORLD, f"dp={WORLD}")
    out["trainer:allreduce"] = {
        "total": res.metrics["total"], "world": res.metrics["world"],
        "ok": res.metrics["total"] == 12.0 and res.metrics["world"] == WORLD}
    job = {"params": _weights(loops.TINY), "steps": 2,
           "tokens": np.random.default_rng(1).integers(
               0, 256, (WORLD, 32), dtype=np.int32)}
    one = fit("one", loops.tiny_steps, 1, None, job).metrics_history
    for mesh in (f"dp={WORLD}", f"fsdp={WORLD}"):
        got = fit(mesh, loops.tiny_steps, WORLD, mesh, job).metrics_history
        rel = max(abs(g[key] - w[key]) / abs(w[key])
                  for g, w in zip(got, one) for key in ("loss", "grad_norm"))
        out[f"trainer:{mesh}"] = {
            "losses": [g["loss"] for g in got], "max_rel": rel,
            "ok": len(got) == len(one) and rel <= TOL
            and all(g["world"] == WORLD for g in got)}
    out.update(host_checks(fit, out_dir, device))
    left = multiprocessing.active_children()
    out["trainer:no_process_left"] = {"left": [p.pid for p in left],
                                      "ok": not left}
    return out


def host_checks(fit, out_dir, device):
    """A `HostArrayConfig` gang of WORLD ranks (`torch_train_loops.
    host_ops`): each result against the JAX reducer's and group actor's
    arithmetic on the same arrays (rank-ordered numpy sums, ``/ world`` for
    the mean, the float32 round trip of allreduce_pytree), written out here
    because JAX does not run on the cards; bitwise."""
    import json

    import torch_train_loops as loops
    from ray_tpu_torch.train import HostArrayConfig
    res = fit("host_ops", loops.host_ops, WORLD, None, {"out": out_dir},
              backend=HostArrayConfig())
    got = []
    for r in range(WORLD):
        with open(Path(out_dir) / f"host_ops{r}.json") as f:
            got.append(json.load(f))
    xs = [loops.host_ops_input(r) for r in range(WORLD)]
    want = {"sum": np.sum(xs, axis=0), "mean": np.sum(xs, axis=0) / WORLD,
            "max": np.max(xs, axis=0), "min": np.min(xs, axis=0)}
    ops_ok = all(np.array_equal(np.float32(g[op]), w)
                 for g in got for op, w in want.items())
    gather_ok = all(np.array_equal(np.float32(g["gather"]), np.stack(xs))
                    for g in got)
    # the tree's flat vector, keys sorted: b (bf16 of row 0), then w
    flat = [np.concatenate([torch.from_numpy(x[0]).to(torch.bfloat16)
                            .float().numpy(), x.ravel()]) for x in xs]
    mean = np.sum(flat, axis=0) / WORLD
    tree_b = torch.from_numpy(mean[:5]).to(torch.bfloat16).float().numpy()
    tree_ok = all(
        np.array_equal(np.float32(g["tree"]["w"]), mean[5:].reshape(3, 5))
        and np.array_equal(np.float32(g["tree"]["b"]), tree_b)
        and g["tree"]["b_dtype"] == "torch.bfloat16"
        and all(d.startswith(device) for d in g["tree"]["devices"])
        for g in got)
    rows = np.sum([loops.host_ops_rows(r) for r in range(WORLD)], axis=0)
    parts = np.array_split(rows, WORLD, axis=0)
    group_ok = all(
        np.array_equal(np.float32(g["broadcast"]), xs[-1] * WORLD)
        and np.array_equal(np.float32(g["recv"]),
                           xs[(r - 1) % WORLD] + (r - 1) % WORLD)
        and np.array_equal(np.float32(g["scatter"]), parts[r])
        for r, g in enumerate(got))
    return {"host:allreduce_allgather": {
                "ok": ops_ok and gather_ok and res.metrics["world"] == WORLD},
            "host:allreduce_pytree_card_leaves": {"ok": tree_ok},
            "host:collective_group": {
                "scatter_rows": [p.shape[0] for p in parts],
                "ok": group_ok}}


def serve_gang_checks(device):
    """→ {check: {numbers..., "ok": bool}} of tp=2 and tp=4 gang replicas
    (members on their cards, or gloo with ``device`` "cpu") against the
    plain one-rank model in this process."""
    import multiprocessing
    import os
    import signal

    import torch_serve_gang_models as models
    from ray_tpu_torch.core import actors
    from ray_tpu_torch.exceptions import (ActorDiedError,
                                          ReplicaUnavailableError)
    from ray_tpu_torch.models import forward, generate
    from ray_tpu_torch.serve import gang

    cfg_kw = dict(SERVE_GANG, dtype=torch.float32)
    cfg = models.model_config("tiny", cfg_kw)
    weights = _weights(SERVE_GANG)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (2, 64))
    payload = {"prompt": rng.integers(0, cfg.vocab_size, (2, 16)), "n": 8}
    here = "cuda:0" if device == "cuda" else "cpu"
    plain = models.plain_params(cfg, weights, here)
    with torch.no_grad():
        want = forward(plain, torch.from_numpy(tokens).to(here),
                       cfg)[:, -1].cpu().numpy()
        want_toks = generate(plain, payload["prompt"], cfg=cfg,
                             max_new_tokens=payload["n"]).tolist()
    fwd = {"flash_fwd": cfg.n_layers if device == "cuda" else 0,
           "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    entry = {"callable_blob": actors.dumps_function(models.Generator),
             "init_args": ("tiny", cfg_kw, weights), "init_kwargs": {}}
    out = {}
    for size in (2, 4):
        rep = gang.start_gang_replica(
            "gang_check", f"tp{size}", entry,
            {"gang_size": size, "gang_mesh": f"tp={size}"},
            device=None if device == "cuda" else "cpu")
        try:
            def ask(*args, method=None, timeout=300.0):
                return actors.get(rep["handle"].handle_request.remote(
                    args, {}, method), timeout)
            logits = ask(tokens, method="logits")[:, -1]
            err, close = _close(logits, want, **OUT_TOL)
            got = ask(payload)
            placed = any("Shard" in p for p in ask(
                method="placements")["wq"])
            check = {"max_abs_err": err, "tokens_equal":
                     got["tokens"] == want_toks, "launches": got["launches"],
                     "placed_on_tp": placed}
            check["ok"] = (close and check["tokens_equal"] and placed
                           and got["rank"] == 0 and got["launches"] == fwd)
            if size == 2:
                follower = rep["gang"][1]
                os.kill(follower.pid, signal.SIGKILL)
                t0 = time.monotonic()
                try:
                    ask(payload, timeout=60)
                    died = None
                except ActorDiedError as e:
                    died = e
                check["noticed_after_s"] = time.monotonic() - t0
                try:
                    ask(payload, timeout=30)
                    later = None
                except ReplicaUnavailableError as e:
                    later = e
                check["killed_follower"] = repr(died)
                check["ok"] = (check["ok"] and died is not None
                               and died.pid == follower.pid
                               and later is not None)
        finally:
            gang.stop_gang_replica(rep)
        out[f"serve_gang:tp={size}"] = check
    left = multiprocessing.active_children()
    out["serve_gang:no_process_left"] = {"left": [p.pid for p in left],
                                         "ok": not left}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=str(REPO / "build" / "rank_checks"),
                    help="the ranks' store and results (scratch)")
    args = ap.parse_args()
    if args.device == "cuda":
        if torch.cuda.device_count() < WORLD:
            print(f"needs {WORLD} cards, found {torch.cuda.device_count()}",
                  file=sys.stderr)
            sys.exit(1)
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
        from ray_tpu_torch.kernels import build
        for built in build.build_all():      # once, before the ranks load
            print(f"built {built.name} in {built.seconds:.1f} s", flush=True)
    t0 = time.perf_counter()
    jobs = checks(Path(args.out))
    results = run_ranks(Path(args.out), WORLD, jobs, timeout=600.0,
                        device=args.device)
    verdict = judge(dict(jobs), results, args.device)
    verdict.update(trainer_checks(args.device, args.out))
    verdict.update(serve_gang_checks(args.device))
    seconds = time.perf_counter() - t0
    for name, res in verdict.items():
        print(f"{'ok  ' if res['ok'] else 'FAIL'} {name}: {res}", flush=True)
    ok = all(res["ok"] for res in verdict.values())
    print(json.dumps({"cuda_rank_checks": verdict, "device": args.device,
                      "world": WORLD, "seconds": seconds, "ok": ok},
                     default=str))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
