"""The port's ops (``ray_tpu_torch.ops``) against their JAX counterparts on
the CPU: the same numpy inputs, made from a seed, go through both.

The flash kernels' plain versions, forward and backward, are held against
the Pallas kernels themselves, run through the Pallas interpreter as the JAX
package's own tests run them.
"""

import functools
import importlib
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch.ops as tops
from ray_tpu.ops import attention as jattn
from ray_tpu.ops import norms as jnorms
from ray_tpu.ops import rotary as jrotary

# the package exports a function of the same name as this module
jflash = importlib.import_module("ray_tpu.ops.flash_attention")

JNP = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _pair(rng, shape, dtype):
    """One random array as (jax array, torch tensor) holding equal values."""
    x = rng.standard_normal(shape, dtype=np.float32)
    return (jnp.asarray(x).astype(JNP[dtype]),
            torch.from_numpy(x).to(TORCH[dtype]))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- flash attention: plain version vs the Pallas kernel (interpret mode) ----

# (O atol = rtol, LSE atol).  fp32: summation order only.  bf16: the Pallas
# kernel rounds P to bf16 against a per-block running max, the plain version
# against the row's max, so P·V differs by P's rounding.
FLASH_TOL = {"fp32": (1e-5, 1e-5), "bf16": (2e-2, 1e-4)}


_FLASH_CASES = [   # dtype, b, s_q, s_kv, h, h_kv, causal at d 64
    ("fp32", 1, 64, 64, 4, 2, True),     # GQA, causal, s_q = s_kv
    ("bf16", 1, 64, 64, 4, 2, True),
    ("fp32", 2, 64, 64, 2, 2, True),     # MHA
    ("bf16", 1, 32, 64, 4, 2, True),     # s_q < s_kv
    ("fp32", 1, 64, 32, 4, 2, True),     # s_q > s_kv: dead rows
    ("bf16", 1, 64, 32, 4, 2, True),
    ("fp32", 1, 32, 64, 4, 2, False),    # non-causal
    ("bf16", 1, 64, 64, 4, 1, False),
]


@pytest.mark.parametrize("dtype,b,s_q,s_kv,h,h_kv,causal,d,sm_scale,block", [
    *(pytest.param(*c, 64, None, 16, id="-".join(map(str, c)))
      for c in _FLASH_CASES),
    # the fp32 route at the Decision Transformer's width (one head of 128,
    # 60 rows: blocks of 20), 64 rows in blocks of 16, and negative scales
    # (the max is then taken after scaling)
    pytest.param("fp32", 1, 60, 60, 1, 1, True, 128, None, 20,
                 id="fp32-dt-60-d128"),
    pytest.param("fp32", 2, 64, 64, 1, 1, True, 128, None, 16,
                 id="fp32-64-d128"),
    pytest.param("fp32", 1, 60, 60, 1, 1, True, 128, -0.125, 20,
                 id="fp32-dt-60-d128-negative-scale"),
    pytest.param("fp32", 1, 64, 64, 4, 2, True, 64, -0.125, 16,
                 id="fp32-64-gqa-negative-scale"),
])
def test_flash_plain_matches_pallas_kernel(monkeypatch, dtype, b, s_q, s_kv,
                                           h, h_kv, causal, d, sm_scale,
                                           block):
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(7)
    (jq, q), (jk, k), (jv, v) = (
        _pair(rng, (b, s_q, h, d), dtype), _pair(rng, (b, s_kv, h_kv, d), dtype),
        _pair(rng, (b, s_kv, h_kv, d), dtype))
    scale = d ** -0.5 if sm_scale is None else sm_scale
    # blocks of 16 (or 20) rows and keys: several k-blocks per row, skipped
    # blocks too
    jo, jlse = jflash._flash_fwd(
        jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
        jnp.swapaxes(jv, 1, 2), causal, scale, block, block)
    o, lse = tops.flash_attention_plain(q, k, v, causal, scale)
    assert o.dtype == TORCH[dtype] and lse.dtype == torch.float32
    tol_o, tol_lse = FLASH_TOL[dtype]
    np.testing.assert_allclose(_np(o), _np(jnp.swapaxes(jo, 1, 2)),
                               atol=tol_o, rtol=tol_o)
    np.testing.assert_allclose(_np(lse), _np(jlse[..., 0]), atol=tol_lse,
                               rtol=0)
    if causal and s_q > s_kv:   # rows that see no key: O = 0, LSE = 0
        assert not _np(o[:, :s_q - s_kv]).any()
        assert not _np(lse[:, :, :s_q - s_kv]).any()


def test_flash_wrapper_on_cpu_runs_plain_version_and_checks_inputs():
    rng = np.random.default_rng(1)
    _, q = _pair(rng, (1, 16, 4, 64), "bf16")
    _, k = _pair(rng, (1, 16, 2, 64), "fp32")
    _, v = _pair(rng, (1, 16, 2, 64), "fp32")
    before = tops.flash_fwd.launches
    # k, v are cast to q's dtype, as the JAX entry does
    out = tops.flash_attention(q, k, v, causal=True)
    ref, _ = tops.flash_attention_plain(q, k.bfloat16(), v.bfloat16(), True,
                                        64 ** -0.5)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)
    assert tops.flash_fwd.launches == before   # the plain version is no launch
    with pytest.raises(ValueError, match="head_dim"):
        tops.flash_fwd(q[..., :32].contiguous(), k[..., :32].bfloat16(),
                       v[..., :32].bfloat16(), True, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        tops.flash_fwd(q, k.bfloat16().transpose(1, 2).contiguous()
                       .transpose(1, 2), v.bfloat16(), True, 1.0)
    with pytest.raises(TypeError):
        tops.flash_fwd(q, k, v, True, 1.0)
    with pytest.raises(ValueError, match="multiple"):
        tops.flash_fwd(q[:, :, :3].contiguous(), k.bfloat16(), v.bfloat16(),
                       True, 1.0)


@pytest.mark.parametrize("b,s_q,s_kv,h,h_kv,causal", [
    (1, 256, 256, 4, 2, True),     # GQA, causal, s_q = s_kv
    (1, 320, 192, 4, 2, True),     # s_q > s_kv: dead rows, ragged tiles
    (2, 192, 320, 4, 2, False),    # non-causal
])
def test_tile_rel_err_refuses_planted_forward_faults(b, s_q, s_kv, h, h_kv,
                                                     causal):
    """The tile error that holds the forward kernel's O on the card: the
    plain version in bf16 against fp32 on the same inputs (every bf16
    rounding at once) stays under the bf16 bound (1e-2); each planted fault
    (the last q tile zeroed, V from another KV head, the middle key tile
    dropped for the q tiles after it) scores far above it."""
    rng = np.random.default_rng(7)
    d, scale = 64, 64 ** -0.5
    q, k, v = (_pair(rng, shape, "bf16")[1] for shape in (
        (b, s_q, h, d), (b, s_kv, h_kv, d), (b, s_kv, h_kv, d)))
    o, _ = tops.flash_attention_plain(q, k, v, causal, scale)
    o32, _ = tops.flash_attention_plain(q.float(), k.float(), v.float(),
                                        causal, scale)
    assert 1e-3 < tops.tile_rel_err(o, o32) < 1e-2
    faults = tops.planted_fwd_faults(tops.flash_attention_plain, q, k, v, o,
                                     causal, scale)
    assert len(faults) == 3
    for what, bad in faults.items():
        assert tops.tile_rel_err(bad, o) > 0.1, what


# dQ, dK, dV atol = rtol.  fp32: summation order only (measured up to 2e-6
# at |grad| <= 5).  bf16: both round P and dS to bf16 and the results to
# bf16; S and dP come out of products summed in another order, so a value
# may round the other way, one bf16 step (2**-8 relative).
FLASH_BWD_TOL = {"fp32": 1e-5, "bf16": 1e-2}


@pytest.mark.parametrize("dtype,b,s_q,s_kv,h,h_kv,causal", [
    ("fp32", 1, 64, 64, 4, 2, True),     # GQA, causal, s_q = s_kv
    ("bf16", 1, 64, 64, 4, 2, True),
    ("fp32", 2, 64, 64, 2, 2, True),     # MHA
    ("bf16", 1, 32, 64, 4, 2, True),     # s_q < s_kv
    ("fp32", 1, 64, 32, 4, 2, True),     # s_q > s_kv: dead rows
    ("bf16", 1, 64, 32, 4, 2, True),
    ("fp32", 1, 32, 64, 4, 2, False),    # non-causal
    ("bf16", 1, 64, 64, 4, 1, False),
])
def test_flash_bwd_plain_matches_pallas_kernels(monkeypatch, dtype, b, s_q,
                                               s_kv, h, h_kv, causal):
    monkeypatch.setenv("RAY_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(8)
    d = 64
    (jq, q), (jk, k), (jv, v), (jdo, do) = (
        _pair(rng, (b, s_q, h, d), dtype), _pair(rng, (b, s_kv, h_kv, d), dtype),
        _pair(rng, (b, s_kv, h_kv, d), dtype), _pair(rng, (b, s_q, h, d), dtype))
    scale = d ** -0.5
    # the forward's residuals from the port's plain version, given to both
    o, lse = tops.flash_attention_plain(q, k, v, causal, scale)
    jo = jnp.asarray(_np(o)).astype(JNP[dtype])
    jlse = jnp.asarray(_np(lse))[..., None]
    # block_q 16, block_k 16: several blocks each way, skipped blocks too
    t = functools.partial(jnp.swapaxes, axis1=1, axis2=2)
    want = jflash._flash_bwd(t(jq), t(jk), t(jv), t(jo), jlse, t(jdo),
                             causal, scale, 16, 16)
    got = tops.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    tol = FLASH_BWD_TOL[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == TORCH[dtype], name
        np.testing.assert_allclose(_np(g), _np(t(w)), atol=tol, rtol=tol,
                                   err_msg=name)
    if causal and s_q > s_kv:   # rows that see no key get no gradient
        assert not _np(got[0][:, :s_q - s_kv]).any()


@pytest.mark.parametrize("s_q,s_kv,h,h_kv,causal", [
    (64, 64, 4, 2, True),      # GQA, causal, s_q = s_kv
    (72, 40, 4, 2, True),      # s_q > s_kv: dead rows, ragged tiles
    (40, 56, 4, 1, False),     # non-causal, ragged tiles
])
def test_tile_rel_err_passes_rounding_and_refuses_planted_faults(
        s_q, s_kv, h, h_kv, causal):
    """The tile error that holds the backward kernels on the card: bf16
    rounding alone stays under its bf16 bound (1e-2); a tile, a key range or
    a query head of each group left out scores far above it."""
    rng = np.random.default_rng(9)
    d, scale = 64, 64 ** -0.5
    q, k, v, do = (_pair(rng, shape, "bf16")[1] for shape in (
        (2, s_q, h, d), (2, s_kv, h_kv, d), (2, s_kv, h_kv, d), (2, s_q, h, d)))
    o, lse = tops.flash_attention_plain(q, k, v, causal, scale)
    got = tops.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    assert all(tops.tile_rel_err(g, g.clone(), 16) == 0 for g in got)
    # the same inputs in fp32: only bf16's roundings of O, P, dS and the
    # results differ
    f32 = [t.float() for t in (q, k, v, do)]
    o32, lse32 = tops.flash_attention_plain(*f32[:3], causal, scale)
    want = tops.flash_attention_bwd_plain(*f32[:3], o32, lse32, f32[3],
                                          causal, scale)
    for g, w in zip(got, want):
        assert tops.tile_rel_err(g, w, 16) < 1e-2
    faults = []
    for i, s in ((0, s_q), (1, s_kv), (2, s_kv)):
        bad = got[i].clone()
        bad[:, (s - 1) // 16 * 16:] = 0
        faults.append((i, bad))
    do_cut = do.clone()
    do_cut[:, :, ::h // h_kv] = 0
    delta_cut = (do_cut.float() * o.float()).sum(-1).transpose(1, 2)
    faults += enumerate(tops.flash_bwd_dkv_plain(
        q, k, v, do_cut, lse, delta_cut.contiguous(), causal, scale), 1)
    for i, bad in faults:
        assert tops.tile_rel_err(bad, got[i], 16) > 0.1
    if causal and s_q > s_kv:   # dead rows: zero against zero, else inf
        assert tops.tile_rel_err(got[0][:, :16], got[0][:, :16]) == 0
        assert tops.tile_rel_err(got[0][:, :16] + 1, got[0][:, :16]) == (
            float("inf"))


def test_flash_autograd_on_cpu_is_the_plain_backward():
    rng = np.random.default_rng(2)
    q, k, v, do = (_pair(rng, shape, "bf16")[1] for shape in (
        (2, 24, 4, 64), (2, 40, 2, 64), (2, 40, 2, 64), (2, 24, 4, 64)))
    counts = (tops.flash_fwd.launches, tops.flash_bwd_dq.launches,
              tops.flash_bwd_dkv.launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tops.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    o, lse = tops.flash_attention_plain(q, k, v, True, 64 ** -0.5)
    want = tops.flash_attention_bwd_plain(q, k, v, o, lse, do, True,
                                          64 ** -0.5)
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)
    # the plain versions are no launches
    assert counts == (tops.flash_fwd.launches, tops.flash_bwd_dq.launches,
                      tops.flash_bwd_dkv.launches)
    with pytest.raises(TypeError, match="lse"):
        tops.flash_bwd_dq(q, k, v, do, lse[:, :, :4], lse, True, 1.0)
    with pytest.raises(TypeError, match="dO"):
        tops.flash_bwd_dkv(q, k, v, do.float(), lse, lse, True, 1.0)


# -- norms, rotary, attention -------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("fp32", 1e-5), ("bf16", 1e-2)])
def test_norms_match_jax(dtype, tol):
    rng = np.random.default_rng(3)
    jx, x = _pair(rng, (2, 5, 64), dtype)
    js, s = _pair(rng, (64,), "fp32")
    jb, b = _pair(rng, (64,), "fp32")
    y = tops.rmsnorm(x, s)
    assert y.dtype == x.dtype
    np.testing.assert_allclose(_np(y), _np(jnorms.rmsnorm(jx, js)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(tops.layernorm(x, s, b)),
                               _np(jnorms.layernorm(jx, js, jb)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(tops.layernorm(x, s)),
                               _np(jnorms.layernorm(jx, js)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [("fp32", 1e-5), ("bf16", 1e-2)])
def test_rotary_matches_jax(dtype, tol):
    rng = np.random.default_rng(4)
    jx, x = _pair(rng, (2, 6, 3, 32), dtype)
    cos, sin = tops.rotary_angles(6, 32, 10000.0, offset=5, device="cpu")
    jcos, jsin = jrotary.rotary_angles(6, 32, 10000.0, offset=5)
    np.testing.assert_allclose(_np(cos), _np(jcos), atol=1e-6)
    np.testing.assert_allclose(_np(sin), _np(jsin), atol=1e-6)
    y = tops.apply_rotary(x, cos, sin)
    assert y.dtype == x.dtype
    np.testing.assert_allclose(_np(y), _np(jrotary.apply_rotary(jx, jcos,
                                                                jsin)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [("fp32", 1e-5), ("bf16", 1e-2)])
@pytest.mark.parametrize("s_q,s_kv,h,h_kv,causal", [
    (12, 12, 4, 2, True),    # GQA
    (5, 12, 4, 2, True),     # s_q < s_kv: bottom-right mask
    (12, 5, 4, 4, True),     # s_q > s_kv: rows with no key average V
    (7, 9, 4, 1, False),
])
def test_attention_matches_jax(dtype, tol, s_q, s_kv, h, h_kv, causal):
    rng = np.random.default_rng(5)
    jq, q = _pair(rng, (2, s_q, h, 16), dtype)
    jk, k = _pair(rng, (2, s_kv, h_kv, 16), dtype)
    jv, v = _pair(rng, (2, s_kv, h_kv, 16), dtype)
    ref = jattn.reference_attention(jq, jk, jv, causal=causal)
    out = tops.reference_attention(q, k, v, causal=causal)
    assert out.dtype == q.dtype
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)
    # "auto" on a CPU tensor is the reference path, as JAX on the CPU
    auto = tops.multi_head_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(
        _np(auto), _np(jattn.multi_head_attention(jq, jk, jv, causal=causal)),
        atol=tol, rtol=tol)
    np.testing.assert_array_equal(
        _np(tops.repeat_kv(k, h // h_kv)),
        _np(jattn.repeat_kv(jk, h // h_kv)))


def test_attention_dispatch_refuses_ring_and_unknown():
    """``impl="ring"`` with no mesh (sp 1) falls back to reference
    attention, as the JAX dispatch does; an unknown impl is refused."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 4, 2, 64)).astype(
        np.float32)) for _ in range(3))
    assert torch.equal(tops.multi_head_attention(q, k, v, impl="ring"),
                       tops.reference_attention(q, k, v))
    with pytest.raises(ValueError):
        tops.multi_head_attention(q, q, q, impl="nope")


# -- isolation ------------------------------------------------------------------

def test_port_imports_neither_jax_nor_ray_tpu():
    code = (
        "import sys, pkgutil, importlib\n"
        "import ray_tpu_torch\n"
        "for m in pkgutil.walk_packages(ray_tpu_torch.__path__, "
        "'ray_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'ray_tpu' or m.startswith('ray_tpu.')]\n"
        "for m in ('serve.decode_session', 'rl.ppo', 'rl.env', 'air',\n"
        "          'train.rl', 'metrics', 'core.runtime_metrics',\n"
        "          'util.tracing', 'util.fault_injection', 'rl.pg',\n"
        "          'rl.exploration', 'rl.replay', 'rl.dqn', 'rl.learner',\n"
        "          'rl.r2d2', 'rl.td3', 'rl.sac', 'rl.impala',\n"
        "          'rl.multi_agent', 'rl.qmix', 'rl.maddpg', 'rl.offline',\n"
        "          'rl.bandit', 'rl.es', 'rl.maml', 'rl.dreamer', 'rl.dt',\n"
        "          'rl.alpha_zero', 'rl.slateq', 'rl.ddppo',\n"
        "          'parallel.mesh', 'parallel.sharding',\n"
        "          'parallel.collectives', 'parallel.pipeline',\n"
        "          'parallel.coordinator', 'ops.ring_attention',\n"
        "          'core.actors', 'air.session', 'air.config',\n"
        "          'train.backend', 'train.backend_executor',\n"
        "          'train.worker_group', 'train.trainer',\n"
        "          'train.checkpointing', 'train.host_collective',\n"
        "          'util.collective', 'core.serialization',\n"
        "          'air.checkpoint', 'serve.gang', 'serve.replica'):\n"
        "    assert 'ray_tpu_torch.' + m in sys.modules, m\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_raise_without_cuda_and_device(monkeypatch):
    from ray_tpu_torch.models import (TransformerConfig, init_kv_cache,
                                      init_slot_cache)
    from ray_tpu_torch.serve import DecodeSessionCore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeSessionCore(cfg, max_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kv_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_slot_cache(cfg, 2, 16)
