"""The port's parallel layer (`ray_tpu_torch.parallel`) against the JAX
package's on the CPU.

In this process: the mesh specs, the rule tables and their specs (the
missing-axis and non-dividing drops), and the logical-axes trees of the
models.  On four gloo ranks (`torch_rank_checks.run_ranks`, started once
for the module and joined through `join_mesh_gang` on a `FileStore`): the
placement of a tiny model's weights, where every rank's local shard must
equal the shard JAX's device r holds on the same mesh shape over
``jax.devices()[:4]``; the FSDP matmul; `constrain`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from ray_tpu.models import init_params as jinit
from ray_tpu.models import transformer as jtr
from ray_tpu.models import vit as jvit
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsh
from ray_tpu_torch.models import TransformerConfig, ViTConfig, params_axes
from ray_tpu_torch.models import vit_params_axes
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsh
from torch_rank_checks import run_ranks

WORLD = 4
# the tiny llama with GQA: 4 heads, 2 kv heads (tp=4 cannot split those)
CFG = dict(n_kv_heads=2)
MESHES = [dict(fsdp=4), dict(fsdp=2, tp=2), dict(fsdp=1, tp=4)]


def _raises_like(fn_t, fn_j):
    """Both calls give the same value, or both raise ValueError."""
    try:
        want = fn_j()
    except ValueError:
        with pytest.raises(ValueError):
            fn_t()
        return
    assert fn_t() == want


# -- in this process ----------------------------------------------------------

SPECS = [(dict(tp=4), 8), (dict(dp=2, fsdp=4), 8), (dict(tp=3), 8),
         (dict(dp=2, fsdp=2, tp=4), 8), (dict(sp=2, fsdp=-1, tp=-1), 8),
         (dict(pp=2, ep=2), 4), (dict(), 1), (dict(fsdp=1), 1)]


@pytest.mark.parametrize("kw,n", SPECS)
def test_mesh_spec_resolve_and_shape_match_jax(kw, n):
    _raises_like(lambda: tmesh.MeshSpec(**kw).resolve(n),
                 lambda: jmesh.MeshSpec(**kw).resolve(n))
    _raises_like(lambda: tmesh.mesh_shape_for(tmesh.MeshSpec(**kw), n),
                 lambda: jmesh.mesh_shape_for(jmesh.MeshSpec(**kw), n))


@pytest.mark.parametrize("text", ["dp=2, tp=4", "sp=4,fsdp=2", "", "pp=2,",
                                  "bogus=2"])
def test_mesh_spec_parse_matches_jax(text):
    _raises_like(lambda: tmesh.MeshSpec.parse(text).sizes(),
                 lambda: jmesh.MeshSpec.parse(text).sizes())


def test_auto_shape_and_divisors_match_jax():
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    for n, mp in [(8, 1), (8, 2), (8, 8), (6, 3), (8, 3)]:
        _raises_like(lambda: tmesh.auto_mesh_shape(n, mp).sizes(),
                     lambda: jmesh.auto_mesh_shape(n, mp).sizes())
    for n in range(1, 33):
        for ndim in (1, 2, 3):
            assert tmesh.pick_divisor_shape(n, ndim) == \
                jmesh.pick_divisor_shape(n, ndim)


def _norm(spec):
    """A spec as a tuple, a one-axis tuple entry as its axis (JAX's
    NamedSharding writes ("fsdp",) as "fsdp"; both split alike)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


class _FakeMesh:
    """The port's view of a mesh's names and sizes, with no process
    group: what the spec functions read."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.mesh = names, torch.empty(shape)


def _fake_mesh(spec, drop):
    sizes = tmesh.MeshSpec(**spec).resolve(8)
    names = tuple(a for a in tmesh.MESH_AXES if sizes[a] > 1 or not drop)
    return _FakeMesh(names or ("dp",), [sizes[a] for a in names] or [1])


LOGICAL = [("embed", "mlp"), ("vocab", "embed"), ("layers", "embed", "heads",
                                                  "kv"),
           ("batch", None), ("layers", "expert", "embed", "mlp"), None, ()]
SHAPES = {("layers", "embed", "heads", "kv"): (2, 64, 2, 16),
          ("embed", "mlp"): (64, 6), ("vocab", "embed"): (250, 64),
          ("batch", None): (6, 3), ("layers", "expert", "embed", "mlp"):
          (2, 3, 64, 128)}


@pytest.mark.parametrize("rules", ["DP_RULES", "FSDP_RULES", "TP_RULES",
                                   "FSDP_TP_RULES"])
@pytest.mark.parametrize("spec,drop", [(dict(fsdp=8), True),
                                       (dict(fsdp=2, tp=4), False),
                                       (dict(fsdp=2, tp=4), True),
                                       (dict(sp=2, tp=4, fsdp=1), False),
                                       (dict(dp=2, ep=2, pp=2), True)])
def test_specs_and_drops_match_jax(rules, spec, drop):
    """spec_for, logical_to_mesh_axes, the missing-axis drop (named_sharding
    on a mesh without the trivial axes) and the non-dividing drop."""
    tr, jr = getattr(tsh, rules), getattr(jsh, rules)
    assert dict(tr) == dict(jr)
    jm = jmesh.create_mesh(jmesh.MeshSpec(**spec), drop_trivial_axes=drop)
    tm = _fake_mesh(spec, drop)
    assert tuple(tm.mesh_dim_names) == tuple(jm.axis_names)
    for logical in LOGICAL:
        assert tuple(tr.spec_for(logical)) == tuple(jr.spec_for(logical))
        t_spec = tsh.logical_to_mesh_axes(logical, tr)
        assert tuple(t_spec) == tuple(jsh.logical_to_mesh_axes(logical, jr))
        dropped = tsh._drop_missing_axes(t_spec, tm)
        assert _norm(dropped) == _norm(
            jsh.named_sharding(jm, logical, jr).spec)
        if logical in SHAPES:
            shape = SHAPES[logical]
            assert _norm(tsh._drop_nondividing_axes(dropped, tm, shape)) \
                == _norm(jsh._drop_nondividing_axes(
                    JP(*dropped), jm, shape))
    batch = tsh.batch_sharding(tm, tr, ndim=3).spec
    assert _norm(batch) == _norm(jsh.batch_sharding(jm, jr, ndim=3).spec)


def test_rules_overrides_and_refusals():
    rules = tsh.ShardingRules(embed="fsdp", mlp="tp", batch=("dp", "fsdp"))
    assert tuple(rules.spec_for(("embed", "mlp"))) == ("fsdp", "tp")
    assert tuple(rules.spec_for(None)) == ()
    assert tuple(rules.with_overrides(mlp=None).spec_for(("mlp",))) == \
        (None,)
    mesh = _fake_mesh(dict(fsdp=2, tp=4), False)
    with pytest.raises(ValueError, match="rank-2"):
        tsh._drop_nondividing_axes(tsh.P("fsdp", None, None), mesh, (4, 4))
    # a dimension split over two axes out of the mesh's order is refused
    with pytest.raises(ValueError, match="order"):
        tsh.NamedSharding(mesh, tsh.P(("tp", "fsdp"))).placements()
    placed = tsh.NamedSharding(mesh, tsh.P(("dp", "fsdp"), "tp"))
    assert [str(p) for p in placed.placements()] == [
        "S(0)", "S(0)", "R", "R", "S(1)", "R"]


def _jax_axes(cfg_kw, vit=False):
    """The JAX init's axes tree, traced abstractly (no compile, no draw)."""
    if vit:
        init, cfg = jvit.init_vit_params, jvit.ViTConfig.tiny(**cfg_kw)
    else:
        init, cfg = jinit, jtr.TransformerConfig.tiny(**cfg_kw)
    box = {}

    def params_only(key):
        params, box["axes"] = init(key, cfg)
        return params

    jax.eval_shape(params_only, jax.random.PRNGKey(0))
    return box["axes"]


@pytest.mark.parametrize("family,kw", [
    ("llama", {}),
    ("gpt2", dict(pos_emb="learned", activation="gelu", norm="layernorm",
                  tie_embeddings=True, n_kv_heads=None)),
    ("moe", dict(n_experts=4, expert_top_k=2)),
    ("vit", {})])
def test_params_axes_match_jax_init(family, kw):
    if family == "vit":
        assert vit_params_axes(ViTConfig.tiny(**kw)) == _jax_axes(kw, True)
    else:
        assert params_axes(TransformerConfig.tiny(**kw)) == _jax_axes(kw)


# -- four ranks ---------------------------------------------------------------

def _jax_tiny():
    cfg = jtr.TransformerConfig.tiny(dtype=jnp.float32, **CFG)
    params, axes = jinit(jax.random.PRNGKey(0), cfg)
    return params, axes


def _paths(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params, _ = _jax_tiny()
    rng = np.random.default_rng(0)
    checks = [
        ("gang", {}),
        ("shards", dict(params=jax.tree_util.tree_map(np.asarray, params),
                        cfg_kw=CFG, meshes=MESHES)),
        ("matmul", dict(x=rng.normal(size=(16, 32)).astype(np.float32),
                        w=rng.normal(size=(32, 8)).astype(np.float32))),
        ("constrain", dict(w=rng.normal(size=(8, 6)).astype(np.float32))),
    ]
    return checks, run_ranks(tmp_path_factory.mktemp("parallel"), WORLD,
                             checks)


def _check(ranks, name):
    checks, results = ranks
    return dict(checks)[name], [r[name] for r in results]


def test_join_mesh_gang_claims_every_rank(ranks):
    _, got = _check(ranks, "gang")
    assert sorted(g["rank"] for g in got) == list(range(WORLD))
    assert all(g["world"] == WORLD for g in got)


@pytest.mark.parametrize("which", range(len(MESHES)))
def test_every_rank_holds_jax_devices_shard(ranks, which):
    """FSDP_TP_RULES on the tiny llama: each leaf's to_local() on rank r is
    the shard of JAX's device r (tp=4 replicates the 2 kv heads)."""
    _, got = _check(ranks, "shards")
    params, axes = _jax_tiny()
    devs = jax.devices()[:WORLD]
    mesh = jmesh.create_mesh(jmesh.MeshSpec(**MESHES[which]), devices=devs)
    placed = jsh.shard_pytree(params, axes, mesh, jsh.FSDP_TP_RULES)
    for path, leaf in _paths(placed):
        by_dev = {s.device: np.asarray(s.data)
                  for s in leaf.addressable_shards}
        for r in range(WORLD):
            np.testing.assert_array_equal(got[r][which][path], by_dev[devs[r]],
                                          err_msg=f"{path} rank {r}")
    if MESHES[which].get("tp") == 4:
        assert got[0][which]["layers/wk"].shape[2] == 2        # replicated
        assert got[0][which]["layers/wq"].shape[2] == 1        # 4 heads / 4


def test_fsdp_matmul_matches_numpy_and_jax_shards(ranks):
    args, got = _check(ranks, "matmul")
    x, w = args["x"], args["w"]
    devs = jax.devices()[:WORLD]
    mesh = jmesh.create_mesh(jmesh.MeshSpec(fsdp=WORLD), devices=devs)
    xs = jax.device_put(x, jsh.named_sharding(mesh, ("batch", None),
                                              jsh.FSDP_RULES))
    ws = jax.device_put(w, jsh.named_sharding(mesh, ("embed", None),
                                              jsh.FSDP_RULES))
    for r in range(WORLD):
        for name, arr in (("local_x", xs), ("local_w", ws)):
            shard = [s for s in arr.addressable_shards
                     if s.device == devs[r]][0]
            np.testing.assert_array_equal(got[r][name], np.asarray(shard.data))
        np.testing.assert_allclose(got[r]["out"], x @ w, rtol=1e-5,
                                   atol=1e-5)


def test_constrain_redistributes_dtensors_only(ranks):
    args, got = _check(ranks, "constrain")
    w = args["w"]
    for r, g in enumerate(got):
        fsdp, tp = divmod(r, 2)
        np.testing.assert_array_equal(
            g["before"], w[4 * fsdp:4 * fsdp + 4, 3 * tp:3 * tp + 3])
        np.testing.assert_array_equal(g["after"], w[:, 3 * tp:3 * tp + 3])
        assert g["placements"] == ["R", "R", "R", "R", "S(1)", "R"]
        assert g["plain_same"] and g["outside_same"]
