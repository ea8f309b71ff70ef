"""Rank side of `test_torch_host_collective.py`: ``python
torch_collective_ranks.py HOST PORT WORLD RANK OUT_DIR`` joins the test's
`TCPStore` (no process group), runs the port's host collectives
(`train.host_collective` and a `util.collective` group) on the inputs of
`inputs` and pickles what each returned to ``OUT_DIR/rank<r>.pkl``.  Imports
no JAX: the test holds the results against the JAX package's reducer and
group actor in its own process."""

from __future__ import annotations

import pickle
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np

OPS = ("sum", "mean", "max", "min")
GROUP_OPS = OPS + ("prod",)
SCATTER_ROWS = 7          # split unevenly over 4 ranks: 2, 2, 2, 1
BROADCAST_SRC = 2
# (src, dst, messages): a ring of two each, and three more from 0 to 2
# that rank 2 reads interleaved with its ring messages
P2P = [(r, (r + 1) % 4, 2) for r in range(4)] + [(0, 2, 3)]


def inputs(rank: int) -> dict:
    """This rank's arrays, the same in the test's process."""
    rng = np.random.default_rng(100 + rank)
    return {
        "x": rng.standard_normal((3, 5)).astype(np.float32),
        "pos": (rng.random((3, 5)) + 0.5).astype(np.float32),
        "ints": rng.integers(-5, 5, (4,)).astype(np.int64),
        "rows": rng.standard_normal((SCATTER_ROWS, 3)).astype(np.float32),
        "tree": {"b": rng.standard_normal((2, 3)).astype(np.float32),
                 "a": [rng.standard_normal((4,)).astype(np.float32),
                       rng.integers(0, 9, (2,)).astype(np.int32)],
                 "t": rng.standard_normal((3,)).astype(np.float32)},
        "message": [rng.standard_normal((2,)).astype(np.float32)
                    for _ in range(3)],
    }


def _tree_in(tree):
    """The rank's tree with torch leaves where the JAX side has arrays:
    float32 ``b`` and ``t`` as tensors (``t`` in bfloat16), the rest numpy."""
    import torch
    return {"b": torch.from_numpy(tree["b"]), "a": tree["a"],
            "t": torch.from_numpy(tree["t"]).to(torch.bfloat16)}


def run(store, world: int, rank: int) -> dict:
    import torch

    from ray_tpu_torch.train import host_collective as hc
    from ray_tpu_torch.util import collective as col
    x = inputs(rank)
    out: dict = {}
    hc._set_store(store, "hc", world, rank)
    for op in OPS:
        out[f"hc_{op}"] = hc.allreduce(x["x"], op)
    out["hc_ints"] = hc.allreduce(x["ints"], "sum")
    out["hc_gather"] = hc.allgather(x["x"])
    hc.barrier()
    tree = hc.allreduce_pytree(_tree_in(x["tree"]), "mean")
    out["hc_tree"] = {"b": tree["b"].numpy(), "a": tree["a"],
                      "t": tree["t"].float().numpy(),
                      "kinds": [type(tree["b"]).__name__,
                                str(tree["t"].dtype),
                                type(tree["a"][1]).__name__,
                                str(tree["a"][1].dtype)]}
    out["hc_held"] = hc.peak_held_bytes()
    hc._set_store(None, "", 1, 0)

    col.init_collective_group(world, rank, store=store, group_name="g")
    for op in GROUP_OPS:
        out[f"g_{op}"] = col.allreduce(x["pos"], op=op, group_name="g")
    out["g_gather"] = col.allgather(torch.from_numpy(x["x"]),
                                    group_name="g")
    out["g_scatter"] = col.reducescatter(x["rows"], group_name="g")
    out["g_broadcast"] = col.broadcast(x["x"] * (rank + 1),
                                       src_rank=BROADCAST_SRC,
                                       group_name="g")
    sends = [(dst, i) for src, dst, n in P2P if src == rank
             for i in range(n)]
    for dst, i in sends:
        col.send(x["message"][i] + 10 * dst, dst, group_name="g")
    got = {}
    # read the pairs in an order unlike the sends: the last source first
    for src, dst, n in sorted(P2P, key=lambda p: -p[0]):
        if dst == rank:
            got[src] = [col.recv(src, group_name="g") for _ in range(n)]
    out["g_recv"] = got
    col.barrier(group_name="g")
    col.destroy_collective_group("g")
    return out


def main(host: str, port: str, world: str, rank: str, out_dir: str):
    import torch.distributed as dist
    store = dist.TCPStore(host, int(port), is_master=False,
                          timeout=timedelta(seconds=60))
    out = run(store, int(world), int(rank))
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:6])
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
