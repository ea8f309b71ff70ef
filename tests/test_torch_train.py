"""The port's training path (``lm_loss``, ``make_train_step``, remat)
against the JAX package's on the CPU, on the same weights (the JAX init,
carried over by `ray_tpu_torch.convert.params_from_numpy`) and the same
numpy tokens and masks.  The optimizers are pinned on both sides:
``optax.adamw`` decays weights by 1e-4 by default, ``torch.optim.AdamW`` by
1e-2."""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import transformer as jtr
from ray_tpu_torch.convert import params_from_numpy
from ray_tpu_torch.models import transformer as ttr

tflash = importlib.import_module("ray_tpu_torch.ops.flash_attention")

JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}
GPT2 = dict(pos_emb="learned", activation="gelu", norm="layernorm",
            tie_embeddings=True, n_kv_heads=None)
# the whole slice on the flash path: head_dim 64, GQA, every training option
FLASH = dict(d_model=128, n_heads=2, n_kv_heads=1, attention_impl="flash",
             remat="dots", norm_remat=True, loss_chunk=16)
# AdamW, pinned on both sides.  EPS is large so that a parameter's move,
# LR * m / (sqrt(v) + EPS), changes by at most LR / EPS = 10 times any
# difference in its gradient; at 1e-8 the first move is LR * sign(g), and a
# gradient near 0 could take either sign in the two frameworks.
LR, B1, B2, EPS, WD = 1e-2, 0.9, 0.95, 1e-3, 0.1
# fp32 throughout: the two frameworks do the same arithmetic in another
# order.  Loss and grad norm to 1e-5 relative; gradients to 1e-5 absolute
# (measured 3e-6 at |grad| up to 0.4), so parameters to 1e-4 absolute
# against moves of up to 1e-2.
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-5, 1e-4


def _models(dtype="fp32", **kw):
    """(JAX config, JAX params, port config, port params) on the same
    weights."""
    jcfg = jtr.TransformerConfig.tiny(dtype=JNP[dtype], **kw)
    tcfg = ttr.TransformerConfig.tiny(dtype=TORCH[dtype], **kw)
    jparams, _ = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _batch(b, s, vocab, mask=None, seed=0):
    """The same batch as numpy (for JAX) and as tensors (for the port).
    ``mask`` = rows of valid-prefix lengths."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (b, s), dtype=np.int32)}
    if mask is not None:
        batch["mask"] = (np.arange(s)[None, :]
                         < np.asarray(mask)[:, None]).astype(np.int32)
    return batch, {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _loss_and_grads(params, batch, cfg):
    leaves = [p.detach().requires_grad_(True)
              for p in ttr.param_leaves(params)]
    loss = ttr.lm_loss(ttr._with_leaves(params, leaves), batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _assert_leaves_close(got, want, atol):
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), atol=atol, rtol=0)


@pytest.mark.parametrize("preset,kw,mask", [
    ("llama", {}, None),
    ("llama", {}, [16, 5]),
    ("llama", dict(loss_chunk=8), [16, 9]),
    ("llama", dict(embed_impl="one_hot"), None),
    ("gpt2", dict(loss_chunk=4), [3, 16]),
])
def test_lm_loss_and_grads_match_jax(preset, kw, mask):
    jcfg, jparams, tcfg, tparams = _models(**(GPT2 if preset == "gpt2"
                                              else {}), **kw)
    jb, tb = _batch(2, 16, jcfg.vocab_size, mask)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jtr.lm_loss, cfg=jcfg)))(jparams, jb)
    loss, grads = _loss_and_grads(tparams, tb, tcfg)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL)
    _assert_leaves_close(grads, jgrads, GRAD_TOL)


def _adamw_steps(jcfg, jparams, tcfg, tparams, batches, accum_steps=1):
    """Run the same batches through both train steps; → (JAX params,
    JAX metrics, port params, port metrics) after the last."""
    opt = optax.adamw(LR, b1=B1, b2=B2, eps=EPS, weight_decay=WD)
    jstep = jax.jit(jtr.make_train_step(jcfg, opt, accum_steps=accum_steps))
    state = opt.init(jparams)
    tparams = jax.tree_util.tree_map(torch.clone, tparams)
    topt = torch.optim.AdamW(ttr.param_leaves(tparams), lr=LR,
                             betas=(B1, B2), eps=EPS, weight_decay=WD)
    tstep = ttr.make_train_step(tcfg, topt, accum_steps=accum_steps)
    for jb, tb in batches:
        jparams, state, jm = jstep(jparams, state, jb)
        tm = tstep(tparams, tb)
    return jparams, jm, tparams, tm


def _assert_step_matches(jparams, jm, tparams, tm):
    for key in ("loss", "grad_norm"):
        assert tm[key].dtype == torch.float32
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=LOSS_TOL, err_msg=key)
    _assert_leaves_close(ttr.param_leaves(tparams), jparams, PARAM_TOL)


def test_adamw_train_steps_match_optax():
    jcfg, jparams, tcfg, tparams = _models()
    batches = [_batch(2, 16, jcfg.vocab_size, seed=s) for s in (1, 2)]
    before = [p.clone() for p in ttr.param_leaves(tparams)]
    jp, jm, tp, tm = _adamw_steps(jcfg, jparams, tcfg, tparams, batches)
    _assert_step_matches(jp, jm, tp, tm)
    # the step updates in place the tensors it is given, not the caller's
    # other trees, and leaves no gradient behind
    assert all(torch.equal(a, b) for a, b in
               zip(before, ttr.param_leaves(tparams)))
    assert all(p.grad is None and not p.requires_grad
               for p in ttr.param_leaves(tp))


def test_accum_steps_weight_microbatches_by_token_count():
    jcfg, jparams, tcfg, tparams = _models()
    # the second microbatch keeps 3 target tokens, the first 28: equal
    # weights would over-weight it
    batch = _batch(4, 16, jcfg.vocab_size, mask=[16, 14, 2, 3], seed=3)
    jp, jm, tp, tm = _adamw_steps(jcfg, jparams, tcfg, tparams, [batch],
                                  accum_steps=2)
    _assert_step_matches(jp, jm, tp, tm)
    # and it is the full-batch step, up to fp32 summation order
    _, _, full, fm = _adamw_steps(jcfg, jparams, tcfg, tparams, [batch])
    np.testing.assert_allclose(float(tm["loss"]), float(fm["loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(fm["grad_norm"]), rtol=LOSS_TOL)


def test_flash_path_train_step_matches_jax_pallas(monkeypatch):
    """The whole slice on the flash path: JAX runs its Pallas kernels in
    interpret mode, the port the kernels' plain versions."""
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
    jcfg, jparams, tcfg, tparams = _models(**FLASH)
    batch = _batch(2, 32, jcfg.vocab_size, mask=[32, 20], seed=4)
    counts = (tflash.flash_fwd.launches, tflash.flash_bwd_dq.launches,
              tflash.flash_bwd_dkv.launches)
    _assert_step_matches(*_adamw_steps(jcfg, jparams, tcfg, tparams,
                                       [batch]))
    # on the CPU the wrappers ran their plain versions: no launch counted
    assert counts == (tflash.flash_fwd.launches,
                      tflash.flash_bwd_dq.launches,
                      tflash.flash_bwd_dkv.launches)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func in (torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("preset", ["llama", "gpt2"])
def test_remat_options_give_the_same_loss_and_grads(preset):
    _, _, tcfg, tparams = _models(**(GPT2 if preset == "gpt2" else {}))
    _, tb = _batch(2, 16, tcfg.vocab_size, mask=[16, 11], seed=5)

    def run(**kw):
        cfg = dataclasses.replace(tcfg, **kw)
        leaves = [p.detach().requires_grad_(True)
                  for p in ttr.param_leaves(tparams)]
        loss = ttr.lm_loss(ttr._with_leaves(tparams, leaves), tb, cfg)
        with _CountMM() as backward:
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads, backward.mm

    loss0, grads0, mm0 = run(remat=False)
    mms = {}
    for remat, norm_remat in ((True, False), ("dots", False), ("dots", True),
                              (False, True), (True, True)):
        loss, grads, mms[remat, norm_remat] = run(remat=remat,
                                                  norm_remat=norm_remat)
        np.testing.assert_allclose(float(loss), float(loss0), rtol=1e-6)
        for g, g0 in zip(grads, grads0):
            np.testing.assert_allclose(_np(g), _np(g0), atol=1e-6, rtol=0)
    # "dots" keeps the products' outputs: the backward recomputes none of
    # them, while full remat recomputes the layer's forward products
    assert mms["dots", False] == mms["dots", True] == mms[False, True] == mm0
    assert mms[True, False] > mm0


def test_training_options_are_checked():
    _, _, tcfg, tparams = _models()
    _, tb = _batch(2, 12, tcfg.vocab_size)
    for bad in (dict(remat="full"), dict(embed_impl="lookup")):
        with pytest.raises(ValueError, match=next(iter(bad))):
            ttr.lm_loss(tparams, tb, dataclasses.replace(tcfg, **bad))
    with pytest.raises(ValueError, match="loss_chunk"):
        ttr.lm_loss(tparams, tb, dataclasses.replace(tcfg, loss_chunk=5))
    assert ttr.TransformerConfig().remat is True     # as the JAX default
    assert ttr.TransformerConfig.tiny().remat is False
    opt = torch.optim.AdamW(ttr.param_leaves(tparams))
    with pytest.raises(ValueError, match="accum_steps"):
        ttr.make_train_step(tcfg, opt, accum_steps=5)(tparams, tb)
    other = jax.tree_util.tree_map(torch.clone, tparams)
    with pytest.raises(ValueError, match="param_leaves"):
        ttr.make_train_step(tcfg, opt)(other, tb)
    # the order of jax.tree_util.tree_leaves on the same tree
    assert [tuple(p.shape) for p in ttr.param_leaves(tparams)] == [
        tuple(p.shape) for p in jax.tree_util.tree_leaves(tparams)]
