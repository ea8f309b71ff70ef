"""The port's ViT family (`ray_tpu_torch.models.vit`) against the JAX
package's on the CPU, on the same numpy images and labels and the same
weights (the JAX init, carried over by
`ray_tpu_torch.convert.params_from_numpy`).  JAX runs its reference
attention on the CPU, the port the same bidirectional softmax."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import vit as jvit
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import param_leaves
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.models.transformer import _with_leaves

JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}
# logits atol = rtol: fp32 as the transformer's logits; bf16 the dense
# transformer's bf16 bound (tests/test_torch_models.py)
TOL = {"fp32": 1e-5, "bf16": 0.1}
# loss, gradients and AdamW as tests/test_torch_train.py
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-5, 1e-4
LR, B1, B2, EPS, WD = 1e-2, 0.9, 0.95, 1e-3, 0.1


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = jvit.ViTConfig.tiny(dtype=jnp.float32,
                               attention_impl="reference")
    tcfg = tvit.ViTConfig.tiny(dtype=torch.float32)
    # jitted: one compile instead of one for each of the init's ops
    jparams = jax.jit(lambda key: jvit.init_vit_params(key, jcfg)[0])(
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _models(dtype="fp32", **kw):
    """(JAX config, JAX params, port config, port params) on the same
    weights, shared by the tests, none of which writes to them."""
    jcfg, jparams, tcfg, tparams = _weights()
    return (dataclasses.replace(jcfg, dtype=JNP[dtype], **kw), jparams,
            dataclasses.replace(tcfg, dtype=TORCH[dtype], **kw), tparams)


def _batch(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"image": rng.standard_normal(
        (b, cfg.image_size, cfg.image_size, cfg.channels)).astype(np.float32),
        "label": rng.integers(0, cfg.num_classes, b, dtype=np.int32)}
    return batch, {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_patchify_matches_jax_and_refuses_another_layout():
    cfg = tvit.ViTConfig.tiny(channels=3)
    jcfg = jvit.ViTConfig.tiny(channels=3)
    img = np.random.default_rng(1).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    got = tvit.patchify(torch.from_numpy(img), cfg)
    assert tuple(got.shape) == (2, 16, 48)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jvit.patchify(img, jcfg)))
    with pytest.raises(ValueError, match="NHWC"):
        tvit.patchify(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()),
                      cfg)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_vit_forward_matches_jax(dtype):
    jcfg, jparams, tcfg, tparams = _models(dtype)
    batch, tbatch = _batch(tcfg, 3)
    # the JAX ViTConfig is not hashable: the config goes in by closure
    jlogits = jax.jit(functools.partial(jvit.vit_forward, cfg=jcfg))(
        jparams, batch["image"])
    tlogits = tvit.vit_forward(tparams, tbatch["image"], tcfg)
    assert tlogits.dtype == torch.float32 and tuple(tlogits.shape) == (3, 4)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), rtol=TOL[dtype],
                               atol=TOL[dtype])


def _loss_and_grads(params, batch, cfg):
    leaves = [p.detach().requires_grad_(True) for p in param_leaves(params)]
    loss, metrics = tvit.vit_loss(_with_leaves(params, leaves), batch, cfg)
    return loss.detach(), metrics, torch.autograd.grad(loss, leaves)


def test_vit_loss_accuracy_and_grads_match_jax():
    """Under remat, the encoder layers run under `torch.utils.checkpoint`
    (the AdamW test below runs them without)."""
    jcfg, jparams, tcfg, tparams = _models(remat=True)
    batch, tbatch = _batch(tcfg, 8, seed=2)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jvit.vit_loss, cfg=jcfg), has_aux=True))(
        jparams, batch)
    loss, metrics, grads = _loss_and_grads(tparams, tbatch, tcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL)
    assert float(metrics["accuracy"]) == float(jm["accuracy"])
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, w in zip(grads, jleaves):
        np.testing.assert_allclose(_np(g), _np(w), atol=GRAD_TOL, rtol=0)


def test_vit_adamw_steps_match_optax():
    jcfg, jparams, tcfg, tparams = _models()
    opt = optax.adamw(LR, b1=B1, b2=B2, eps=EPS, weight_decay=WD)
    jstep = jax.jit(jvit.make_vit_train_step(jcfg, opt))
    state = opt.init(jparams)
    tparams = jax.tree_util.tree_map(torch.clone, tparams)
    topt = torch.optim.AdamW(param_leaves(tparams), lr=LR, betas=(B1, B2),
                             eps=EPS, weight_decay=WD)
    tstep = tvit.make_vit_train_step(tcfg, topt)
    for seed in (1, 2, 3):
        batch, tbatch = _batch(tcfg, 8, seed=seed)
        jparams, state, jm = jstep(jparams, state, batch)
        tm = tstep(tparams, tbatch)
        assert set(tm) == set(jm) == {"loss", "accuracy"}
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_TOL)
        assert float(tm["accuracy"]) == float(jm["accuracy"])
    for g, w in zip(param_leaves(tparams), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(_np(g), _np(w), atol=PARAM_TOL, rtol=0)
    assert all(p.grad is None and not p.requires_grad
               for p in param_leaves(tparams))
    with pytest.raises(ValueError, match="param_leaves"):
        tvit.make_vit_train_step(tcfg, topt)(
            jax.tree_util.tree_map(torch.clone, tparams), tbatch)


def test_params_from_numpy_takes_vit_trees_and_checks_them():
    jcfg, jparams, tcfg, tparams = _models()
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tparams) == \
        tvit.vit_param_shapes(tcfg)
    for got, want in zip(param_leaves(tparams),
                         jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(got.numpy(), want)
    init = tvit.init_vit_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), init) == \
        tvit.vit_param_shapes(tcfg)
    bad = dict(tree, head={"w": tree["head"]["w"][:, :3],
                           "b": tree["head"]["b"]})
    with pytest.raises(ValueError, match="head/w"):
        params_from_numpy(bad, tcfg, "cpu")
    bad = dict(tree, extra=tree["pos"])
    with pytest.raises(ValueError, match="extra"):
        params_from_numpy(bad, tcfg, "cpu")
