"""The port's CUDA kernels against their plain PyTorch versions, and the
serve engine's decode step captured as a CUDA graph, on the card.

Marked ``gpu``; every test skips where no CUDA device is present (the
kernels have no CPU mode).  Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_cuda.py -q

(The suite's conftest imports JAX; on a machine without it, add
``--noconftest``.)
"""

import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops.flash_attention import (flash_attention_bwd_plain,
                                               flash_attention_plain,
                                               flash_bwd, flash_bwd_dkv,
                                               flash_bwd_dq, flash_fwd,
                                               planted_fwd_faults,
                                               tile_rel_err)

pytestmark = pytest.mark.gpu

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# (O atol = rtol, LSE atol): bf16 rounds P and O at other block boundaries
# than the plain version, fp32 differs only in summation order
TOL = {"bf16": (2e-2, 1e-3), "fp32": (1e-4, 1e-4)}
# O's tile error (tile_rel_err, every 64-row tile of each batch and head,
# whatever its scale): the elementwise bound above is as large as many
# values of O; the plain version in bf16 against fp32 scores about 2.4e-3,
# a dropped tile, head or key range 0.25 to 1.5.
FWD_TILE_TOL = {"bf16": 1e-2, "fp32": 1e-4}
# dQ, dK, dV atol = rtol.  bf16: S and dP come out of the tensor cores in
# another summation order than the plain fp32 products, so P and dS round
# to bf16 differently in a few places, and the outputs are rounded to bf16;
# fp32: summation order only (dK and dV sum over up to 4 heads x 2048 rows).
# That bound guards single elements; what fails a wrong kernel is the tile
# error (tile_rel_err, every 64-row tile of each batch and head, whatever its
# scale): bf16's roundings alone score about 3e-3 there.
BWD_TOL = {"bf16": 2e-2, "fp32": 1e-4}
BWD_TILE_TOL = {"bf16": 1e-2, "fp32": 1e-4}
CASES = [
    (1, 2048, 2048, 32, 8, 64, "bf16", True),    # llama-1b prefill shape
    (1, 256, 1000, 32, 8, 64, "bf16", True),     # s_q < s_kv
    (1, 1000, 256, 8, 2, 64, "bf16", True),      # s_q > s_kv: dead rows
    (2, 1000, 1000, 8, 8, 64, "bf16", True),     # ragged tiles, MHA
    (1, 512, 700, 8, 2, 64, "bf16", False),      # non-causal
    (1, 1024, 1024, 16, 4, 128, "bf16", True),   # head_dim 128
    (1, 300, 300, 4, 2, 64, "fp32", True),       # fp32
    (1, 300, 500, 4, 2, 128, "fp32", False),     # fp32, d 128, non-causal
    (64, 60, 60, 1, 1, 128, "fp32", True),       # the DT at its paper's
    (1, 60, 60, 1, 1, 128, "fp32", True),        # width: train, evaluate
]
# the forward kernel's edges: a CTA owns 128 q rows, 64 per consumer
# warpgroup, and walks 128-key tiles.  fp32: a CTA owns 64 q rows (32 at
# d 128), halved down to 16 where the grid would not give each SM two CTAs,
# and walks 32-key tiles
FWD_EDGE_CASES = [
    (4, 1024, 1024, 32, 8, 64, "bf16", True),    # llama-1b training shape
    (1, 17, 17, 4, 2, 64, "bf16", True),         # one consumer idle
    (1, 64, 64, 4, 2, 64, "bf16", True),         # the second one empty
    (1, 65, 65, 4, 2, 64, "bf16", True),         # ... and with one row
    (1, 129, 129, 4, 2, 64, "bf16", True),       # one key in the last tile
    (1, 300, 100, 4, 2, 64, "bf16", True),       # dead rows over 2 CTAs
    (1, 384, 300, 4, 2, 128, "bf16", False),     # d 128, non-causal
    (1, 17, 17, 4, 2, 64, "fp32", True),         # one ragged 16-row slice
    (2, 60, 60, 1, 1, 128, "fp32", True),        # DT's 60 rows, 16 a CTA
    (1, 129, 129, 4, 2, 64, "fp32", True),       # one row, one key past 128
    (1, 300, 100, 4, 2, 128, "fp32", True),      # s_q > s_kv: dead rows
    (1, 2048, 1000, 8, 2, 64, "fp32", True),     # ... in 32-row slices
    (1, 256, 256, 8, 2, 64, "fp32", True),       # GQA group 4
    (1, 384, 300, 4, 2, 128, "fp32", False),     # d 128, non-causal
    (1, 200, 200, 1, 1, 64, "fp32", True),       # b * h = 1
    (64, 128, 128, 12, 4, 64, "fp32", True),     # b * h >> 132: 64 rows,
    (16, 256, 256, 16, 16, 128, "fp32", True),   # 32 rows a CTA
]
# the backward kernels' edges: a dK/dV item is 128 keys (64 per consumer
# warpgroup) walking q tiles of 128 rows (64 at d 128); a dQ item is 128
# rows walking 128-key tiles; both grids hold at most one CTA per SM.
# fp32: a dQ CTA owns 64 q rows (32 at d 128) and a dK/dV CTA 32 keys,
# each halved down to 16 where the grid would not give each SM two CTAs;
# dQ walks 32-key tiles, dK/dV 64-row q tiles (32 at d 128)
BWD_EDGE_CASES = [
    (1, 128, 128, 4, 2, 64, "bf16", True),       # fewer items than SMs
    (1, 17, 17, 4, 2, 64, "bf16", True),         # one ragged tile
    (1, 129, 129, 4, 2, 64, "bf16", True),       # one key, one row past 128
    (1, 1000, 1000, 32, 8, 64, "bf16", True),    # ragged 1000 tokens, GQA
    (1, 2048, 1000, 32, 8, 64, "bf16", True),    # s_q > s_kv: dead rows
    (1, 300, 100, 4, 2, 128, "bf16", True),      # ... at d 128
    (2, 1024, 1024, 16, 16, 64, "bf16", True),   # MHA
    (1, 2048, 2048, 24, 8, 128, "bf16", True),   # d 128
    (1, 384, 300, 4, 2, 128, "bf16", False),     # d 128, non-causal
    (1, 17, 17, 4, 2, 64, "fp32", True),         # one ragged 16-row slice
    (2, 60, 60, 1, 1, 128, "fp32", True),        # DT's 60 rows, 16 a CTA
    (1, 129, 129, 4, 2, 64, "fp32", True),       # one row, one key past 128
    (1, 300, 100, 4, 2, 128, "fp32", True),      # s_q > s_kv: dead rows
    (1, 2048, 1000, 8, 2, 64, "fp32", True),     # ... in 64-row slices
    (1, 256, 256, 8, 2, 64, "fp32", True),       # GQA group 4
    (1, 384, 300, 4, 2, 128, "fp32", False),     # d 128, non-causal
    (1, 200, 200, 1, 1, 64, "fp32", True),       # b * h = 1
    (64, 128, 128, 12, 4, 64, "fp32", True),     # b * h >> 132: 64 rows,
    (16, 256, 256, 16, 16, 128, "fp32", True),   # 32 keys a CTA
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(seed, b, s_q, s_kv, h, h_kv, d, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .to(device=device, dtype=DTYPES[dtype])
            for shape in ((b, s_q, h, d), (b, s_kv, h_kv, d),
                          (b, s_kv, h_kv, d))]


@pytest.mark.parametrize("b,s_q,s_kv,h,h_kv,d,dtype,causal",
                         CASES + FWD_EDGE_CASES)
def test_flash_fwd_matches_plain(cuda, b, s_q, s_kv, h, h_kv, d, dtype,
                                 causal):
    q, k, v = _qkv(0, b, s_q, s_kv, h, h_kv, d, dtype, cuda)
    scale = d ** -0.5
    before = flash_fwd.launches
    o, lse = flash_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal, scale)
    tol_o, tol_lse = TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol_o,
                               rtol=tol_o)
    torch.testing.assert_close(lse, lse_ref, atol=tol_lse, rtol=0)
    assert tile_rel_err(o, o_ref) <= FWD_TILE_TOL[dtype]
    if causal and s_q > s_kv:
        dead = s_q - s_kv
        assert torch.all(o[:, :dead] == 0) and torch.all(lse[:, :, :dead] == 0)


@pytest.mark.parametrize("b,s_q,s_kv,h,h_kv,d,dtype,causal",
                         [c for c in CASES if c[4] > 1])   # GQA or MHA
def test_flash_fwd_tile_error_refuses_planted_faults(cuda, b, s_q, s_kv, h,
                                                     h_kv, d, dtype, causal):
    """O with its last q tile zeroed, with V from another KV head, and with
    a key tile dropped for the q tiles after it fails the tile bound."""
    q, k, v = _qkv(0, b, s_q, s_kv, h, h_kv, d, dtype, cuda)
    scale = d ** -0.5
    o, _ = flash_fwd(q, k, v, causal, scale)
    faults = planted_fwd_faults(flash_fwd, q, k, v, o, causal, scale)
    assert len(faults) == 3
    for what, bad in faults.items():
        assert tile_rel_err(bad, o) > 10 * FWD_TILE_TOL[dtype], what


@pytest.mark.parametrize("dtype,d", [("bf16", 64), ("fp32", 64),
                                     ("fp32", 128)])
@pytest.mark.parametrize("sm_scale", [-0.125, 0.0, 1e-3])
def test_flash_fwd_matches_plain_at_any_softmax_scale(cuda, sm_scale, dtype,
                                                      d):
    """A scale >= 0 is folded into the exponent, a negative one (which
    reverses the order of the scores) is applied first; 0 is uniform."""
    q, k, v = _qkv(6, 1, 300, 300, 4, 2, d, dtype, cuda)
    o, lse = flash_fwd(q, k, v, True, sm_scale)
    o_ref, lse_ref = flash_attention_plain(q, k, v, True, sm_scale)
    tol_o, tol_lse = TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol_o,
                               rtol=tol_o)
    torch.testing.assert_close(lse, lse_ref, atol=tol_lse, rtol=0)
    assert tile_rel_err(o, o_ref) <= FWD_TILE_TOL[dtype]


@pytest.mark.parametrize("b,s_q,s_kv,h,h_kv,d,causal", [
    (64, 60, 60, 1, 1, 128, True),       # DT: 16 rows a CTA
    (1, 1024, 1024, 32, 8, 64, True),    # 64 rows a CTA
    (1, 384, 300, 4, 2, 128, False),
])
def test_flash_fwd_is_bitwise_deterministic_in_fp32(cuda, b, s_q, s_kv, h,
                                                    h_kv, d, causal):
    """No atomics and no sums across CTAs: each row's O and LSE are written
    once by the CTA that owns it, so two calls give the same bits."""
    q, k, v = _qkv(8, b, s_q, s_kv, h, h_kv, d, "fp32", cuda)
    first = flash_fwd(q, k, v, causal, d ** -0.5)
    second = flash_fwd(q, k, v, causal, d ** -0.5)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1],
                                                            second[1])


def test_flash_fwd_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(1, 1, 64, 64, 4, 2, 64, "bf16", cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                  True, 0.125)
    with pytest.raises(TypeError):
        flash_fwd(q, k.float(), v, True, 0.125)
    q96, k96, v96 = _qkv(1, 1, 64, 64, 4, 2, 96, "bf16", cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd(q96, k96, v96, True, 0.125)


@pytest.mark.parametrize("b,s_q,s_kv,h,h_kv,d,dtype,causal", [
    (4, 1024, 1024, 32, 8, 64, "bf16", True),    # llama-1b training shape:
    *CASES[1:], *BWD_EDGE_CASES])                # more items than the grid
def test_flash_bwd_matches_plain(cuda, b, s_q, s_kv, h, h_kv, d, dtype,
                                 causal):
    q, k, v = _qkv(2, b, s_q, s_kv, h, h_kv, d, dtype, cuda)
    do = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (b, s_q, h, d), dtype=np.float32)).to(device=cuda,
                                              dtype=DTYPES[dtype])
    scale = d ** -0.5
    o, lse = flash_fwd(q, k, v, causal, scale)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    grads = flash_bwd(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale)
    tol = BWD_TOL[dtype]
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol, msg=name)
        assert tile_rel_err(got, ref) <= BWD_TILE_TOL[dtype], name
    if causal and s_q > s_kv:   # rows that see no key get no gradient
        assert torch.all(grads[0][:, :s_q - s_kv] == 0)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sm_scale", [-0.125, 0.0, 1e-3])
def test_flash_bwd_matches_plain_at_any_softmax_scale(cuda, sm_scale, d):
    """P = exp2(S * sm_scale * log2 e - LSE * log2 e) is one FFMA whatever
    the scale's sign (the backward has no running max to take); a scale of
    0 gives uniform rows and dS = 0."""
    q, k, v = _qkv(6, 1, 300, 300, 4, 2, d, "bf16", cuda)
    do = torch.from_numpy(np.random.default_rng(7).standard_normal(
        q.shape, dtype=np.float32)).to(device=cuda, dtype=torch.bfloat16)
    o, lse = flash_fwd(q, k, v, True, sm_scale)
    grads = flash_bwd(q, k, v, o, lse, do, True, sm_scale)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, True, sm_scale)
    tol = BWD_TOL["bf16"]
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol, msg=name)
        assert tile_rel_err(got, ref) <= BWD_TILE_TOL["bf16"], name


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_flash_bwd_is_bitwise_deterministic(cuda, dtype):
    """No atomics: every dQ, dK and dV tile is written once by the CTA
    that owns it (fp32: the dK/dV warp groups' sums added in a fixed
    order), so two calls at the training shape give the same bits."""
    q, k, v = _qkv(8, 4, 1024, 1024, 32, 8, 64, dtype, cuda)
    do = torch.from_numpy(np.random.default_rng(9).standard_normal(
        q.shape, dtype=np.float32)).to(device=cuda, dtype=DTYPES[dtype])
    o, lse = flash_fwd(q, k, v, True, 0.125)
    first = flash_bwd(q, k, v, o, lse, do, True, 0.125)
    second = flash_bwd(q, k, v, o, lse, do, True, 0.125)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_flash_bwd_tile_error_refuses_planted_faults(cuda, dtype):
    """A dK/dV kernel that left out one query head of each group, and a
    kernel that dropped the last key tile, fail the tile bound."""
    q, k, v = _qkv(4, 2, 1000, 1000, 32, 8, 64, dtype, cuda)
    do = torch.from_numpy(np.random.default_rng(5).standard_normal(
        q.shape, dtype=np.float32)).to(device=cuda, dtype=DTYPES[dtype])
    o, lse = flash_fwd(q, k, v, True, 0.125)
    _, dk, dv = flash_bwd(q, k, v, o, lse, do, True, 0.125)
    do[:, :, ::4] = 0
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    faults = list(zip((dk, dv), flash_bwd_dkv(q, k, v, do, lse, delta, True,
                                              0.125)))
    for good in (dk, dv):
        bad = good.clone()
        bad[:, 960:] = 0
        faults.append((good, bad))
    for good, bad in faults:
        assert tile_rel_err(bad, good) > 10 * BWD_TILE_TOL[dtype]


def test_flash_bwd_rejects_what_the_kernels_do_not_take(cuda):
    q, k, v = _qkv(1, 1, 64, 64, 4, 2, 64, "bf16", cuda)
    o, lse = flash_fwd(q, k, v, True, 0.125)
    delta = torch.zeros_like(lse)
    with pytest.raises(TypeError, match="dO"):
        flash_bwd_dq(q, k, v, o.float(), lse, delta, True, 0.125)
    with pytest.raises(TypeError, match="lse"):
        flash_bwd_dkv(q, k, v, o, lse.bfloat16(), delta, True, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        flash_bwd_dq(q, k, v, o, lse, delta.transpose(1, 2).contiguous()
                     .transpose(1, 2), True, 0.125)
    with pytest.raises(ValueError, match="device"):
        flash_bwd_dkv(q, k, v, o, lse.cpu(), delta, True, 0.125)


# -- the serve engine's decode step as a CUDA graph ---------------------------

def _tiny_slot_state(device, dtype, slots=4, max_len=64, seed=0, **kw):
    """A tiny llama's params (``kw`` changes its config) and a slot cache
    of random K/V, each slot at another pos (one on the last row, one past
    the end)."""
    from ray_tpu_torch.models import (TransformerConfig, init_params,
                                      init_slot_cache)

    cfg = TransformerConfig.tiny(dtype=dtype, param_dtype=dtype, **kw)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device)
    cache = init_slot_cache(cfg, slots, max_len, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for name in ("k", "v"):
        cache[name].copy_(torch.randn(cache[name].shape, generator=gen,
                                      device=device, dtype=dtype))
    cache["pos"].copy_(torch.tensor([5, max_len - 1, 17, max_len][:slots]))
    return cfg, params, cache


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_decode_step_graph_matches_the_eager_step(cuda, dtype):
    _graph_against_eager(cuda, dtype)


def test_moe_decode_step_graph_matches_the_eager_step(cuda):
    """With experts, the step still captures (routing reads nothing back
    to the host) and replays bitwise the eager step."""
    _graph_against_eager(cuda, "bf16", n_experts=8, expert_top_k=2)


def _graph_against_eager(cuda, dtype, **kw):
    from ray_tpu_torch.models import decode_step_slots
    from ray_tpu_torch.serve.step_graph import FusedDecodeStep

    cfg, params, cache = _tiny_slot_state(cuda, DTYPES[dtype], **kw)
    saved = {name: t.clone() for name, t in cache.items()}
    tokens = np.array([3, 9, 27, 81])
    active = np.array([True, True, False, True])
    step = FusedDecodeStep(params, cache, cfg)
    step.capture()
    for name, t in saved.items():       # the warm-up wrote K/V rows
        cache[name].copy_(t)
    got = step.run(tokens, active)
    assert step.replays == 1
    graph_logits = step.logits.clone()
    graph_cache = {name: t.clone() for name, t in cache.items()}
    logits, want_cache = decode_step_slots(
        params, torch.tensor(tokens, device=cuda), saved,
        torch.tensor(active, device=cuda), cfg)
    want = torch.where(torch.tensor(active, device=cuda), logits.argmax(-1),
                       torch.tensor(tokens, device=cuda))
    assert got.tolist() == want.tolist()
    assert graph_cache["pos"].tolist() == want_cache["pos"].tolist()
    assert torch.equal(graph_logits, logits)
    assert torch.equal(graph_cache["k"], want_cache["k"])
    assert torch.equal(graph_cache["v"], want_cache["v"])


def test_engine_on_the_card_matches_the_cpu_in_fp32(cuda):
    """Three sessions through an engine core on the card (the decode step
    a CUDA graph) and through the same core on the CPU: fp32 streams
    identical."""
    from ray_tpu_torch.models import TransformerConfig, init_params
    from ray_tpu_torch.serve import DecodeSessionCore

    cfg = TransformerConfig.tiny(dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (3, 40, 17)]
    streams = {}
    for device in ("cpu", cuda):
        core = DecodeSessionCore(
            cfg, max_len=64, device=device,
            params={k: ({n: w.to(device) for n, w in v.items()}
                        if isinstance(v, dict) else v.to(device))
                    for k, v in params.items()})
        starts = [core.handle({"op": "start", "prompt": p}) for p in prompts]
        out = []
        for r in starts:
            toks = list(r["token"])
            while len(toks) < 20:
                got = core.handle({"op": "next_chunk", "sid": r["sid"],
                                   "max_tokens": 20 - len(toks)})
                assert "error" not in got, got
                toks += got["tokens"]
            core.handle({"op": "end", "sid": r["sid"]})
            out.append(toks)
        # ended sessions leave their slots at the loop's next turn, after
        # the last step that counted them: the counters are then settled
        while core.handle({"op": "stats"})["engine"]["occupied_slots"]:
            time.sleep(0.01)
        stats = core.handle({"op": "stats"})["engine"]
        core.engine.shutdown()
        streams[str(device)] = out
        if device != "cpu":
            assert stats["graph_replays"] == stats["steps"] > 0
    assert streams["cpu"] == streams[str(cuda)]


# -- mixture of experts and ViT at their full widths --------------------------

def test_moe_layer_at_gpt2_small_widths_matches_the_reference(cuda):
    """gpt2-small's MoE FFN (d 768, d_ff 3072, 8 experts, top 2) in bf16
    with ample capacity (factor E / k: no token drops) against the
    per-token fp32 reference: the routing is the same fp32 arithmetic, the
    expert products round to bf16 (relative error of the whole output
    within 1e-2, each element within atol = rtol = 5e-2)."""
    from ray_tpu_torch.ops import moe_ffn, moe_ffn_reference

    gen = torch.Generator(device=cuda).manual_seed(0)
    d, f, n_experts = 768, 3072, 8

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    y = randn(2, 512, d).to(torch.bfloat16)
    router = randn(d, n_experts, scale=d ** -0.5)
    w_in = randn(n_experts, d, f, scale=d ** -0.5)
    w_out = randn(n_experts, f, d, scale=f ** -0.5)
    out, aux = moe_ffn(y, router, w_in, w_out, top_k=2,
                       capacity_factor=n_experts / 2)
    ref = moe_ffn_reference(y, router, w_in, w_out, top_k=2)
    assert out.dtype == torch.bfloat16 and torch.isfinite(aux)
    rel = float((out.float() - ref.float()).norm() / ref.float().norm())
    assert rel <= 1e-2, rel
    torch.testing.assert_close(out.float(), ref.float(), atol=5e-2,
                               rtol=5e-2)


def test_vit_forward_with_flash_matches_reference_attention(cuda):
    """ViT-B/16 (s 197, bidirectional) in bf16 through the flash kernels
    against the same model with reference attention."""
    import dataclasses

    from ray_tpu_torch.models import ViTConfig, init_vit_params, vit_forward

    cfg = ViTConfig.base()
    params = init_vit_params(cfg, torch.Generator(device=cuda).manual_seed(
        0), cuda)
    images = torch.randn((8, 224, 224, 3), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    launches = flash_fwd.launches
    with torch.no_grad():
        got = vit_forward(params, images, cfg)
        assert flash_fwd.launches == launches + cfg.n_layers
        ref = vit_forward(params, images, dataclasses.replace(
            cfg, attention_impl="reference"))
    assert torch.isfinite(got).all()
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
    assert float(cos.min()) >= 0.99


# -- the engine's hooks and PPO on the card ------------------------------------

def test_engine_hooks_on_the_card(cuda):
    """A speculating fp32 engine on the card feeds the serve series with its
    stats() counts and records its spans; armed with serve.spec_verify it
    falls back to plain graph steps with the same stream."""
    from ray_tpu_torch import metrics
    from ray_tpu_torch.models import TransformerConfig, init_params
    from ray_tpu_torch.serve import DecodeEngineConfig, DecodeSessionCore
    from ray_tpu_torch.util import fault_injection, tracing

    cfg = TransformerConfig.tiny(max_seq_len=64, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    streams = {}
    for what in ("spec", "armed"):
        core = DecodeSessionCore(cfg, max_len=64, params=params,
                                 engine=DecodeEngineConfig(
                                     prefill_chunk_tokens=4,
                                     spec_draft="shared", spec_k=3))
        core.engine.name = f"card-hooks-{what}"
        if what == "armed":
            fault_injection.arm([{"site": "serve.spec_verify",
                                  "action": "error", "match": {
                                      "regex": f"^{core.engine.name}$"}}])
        try:
            r = core.handle({"op": "start", "prompt": list(range(11))})
            toks = list(r["token"])
            while len(toks) < 20:
                got = core.handle({"op": "next_chunk", "sid": r["sid"],
                                   "max_tokens": 20 - len(toks)})
                assert "error" not in got, got
                toks += got["tokens"]
            core.handle({"op": "end", "sid": r["sid"]})
        finally:
            fault_injection.disarm()
            core.engine.shutdown()
            core.engine._thread.join(timeout=30)
        streams[what] = toks
        st = core.handle({"op": "stats"})["engine"]
        text = metrics.prometheus_text()
        for series, want in (("ray_tpu_serve_tokens_total", st["tokens"]),
                             ("ray_tpu_serve_prefill_chunks_total",
                              st["prefill_chunks"])):
            line = f'{series}{{deployment="{core.engine.name}"}} '
            assert f"{line}{float(want)}" in text, series
        names = {e["name"] for e in tracing.span_events()}
        assert f"serve_prefill_chunk::{core.engine.name}" in names
        if what == "armed":
            assert st["spec"]["disabled"] and st["spec"]["fallbacks"] == 3
            assert st["graph_replays"] > 0
    assert streams["armed"] == streams["spec"]


def test_ppo_rollout_and_update_on_the_card_match_the_cpu(cuda):
    """A PixelPong conv-PPO rollout (64 envs x 4 steps) from the same
    weights and draws, then one update (2 epochs x 4 minibatches) of the
    CPU's batch with the same permutations, in full fp32: observations,
    actions, rewards and dones equal, but for an env whose action is a
    near-tie of pi + noise (top two within 1e-5; that env is compared up
    to there); log-probs and values within rtol 1e-4 / atol 1e-5; the first
    minibatch's gradients within 1e-4 of each leaf's norm; the params after
    the update's 8 Adam steps within half a step (lr) per element, as Adam
    turns the rounding of a near-zero gradient element into a share of a
    step (chip_smoke.py's rl phase and bounds, smaller)."""
    from ray_tpu_torch.rl import (ClippedAdam, PixelPong, PPOConfig,
                                  build_policy, compute_gae,
                                  make_rollout_fn, make_update_fn)
    from ray_tpu_torch.rl.policy import tree_leaves, tree_map

    n, steps = 64, 4
    cfg = PPOConfig(num_envs=n, rollout_length=steps, num_sgd_epochs=2,
                    num_minibatches=4)

    class FirstGrads(ClippedAdam):
        first = None

        def update(self, grads, state, params):
            if self.first is None:
                self.first = [g.detach().clone() for g in grads]
            super().update(grads, state, params)

    gen = torch.Generator().manual_seed(0)
    cpu_env = PixelPong(device="cpu")
    cpu_pol = build_policy(cpu_env, {"hidden": cfg.hidden}, device="cpu")
    params = cpu_pol.init(gen)
    first = cpu_env.reset_draws(n, gen)
    draws = [{"noise": cpu_pol.draw_noise(n, gen),
              "reset": cpu_env.reset_draws(n, gen)} for _ in range(steps)]
    perms = torch.stack([torch.randperm(n * steps, generator=gen)
                         for _ in range(2)])
    saved = (torch.backends.cuda.matmul.fp32_precision,
             torch.backends.cudnn.conv.fp32_precision)
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    out, flat = {}, None
    try:
        for device in ("cpu", cuda):
            env = PixelPong(device=device)
            pol = build_policy(env, {"hidden": cfg.hidden}, device=device)

            def to(tree):
                return tree_map(lambda x: x.to(device), tree)

            p = pol.set_weights(params, pol.get_weights(params))
            state, obs = env.reset_given(to(first))
            traj, _, _, _, last = make_rollout_fn(env, pol, n, steps)(
                p, state, obs, (), None, to(draws))
            if flat is None:          # the CPU's batch, for both updates
                adv, ret = compute_gae(traj, last, cfg.gamma, cfg.gae_lambda)
                flat = {"obs": traj["obs"].reshape(n * steps, -1),
                        "action": traj["action"].reshape(-1),
                        "logp": traj["logp"].reshape(-1),
                        "adv": adv.reshape(-1), "ret": ret.reshape(-1)}
            opt = FirstGrads(cfg.max_grad_norm, cfg.lr)
            make_update_fn(pol, opt, cfg, n * steps)(
                p, opt.init(p), to(flat), None, perms.to(device))
            out[str(device)] = tree_map(lambda x: x.cpu(),
                                        (traj, p, opt.first))
    finally:
        (torch.backends.cuda.matmul.fp32_precision,
         torch.backends.cudnn.conv.fp32_precision) = saved
    (ctraj, cparams, cgrads), (gtraj, gparams, ggrads) = (out["cpu"],
                                                          out[str(cuda)])
    differs = gtraj["action"] != ctraj["action"]
    diverged = torch.where(differs.any(0), differs.int().argmax(0),
                           torch.full((n,), steps))
    for env in torch.nonzero(diverged < steps).flatten().tolist():
        t = int(diverged[env])
        pi, _ = cpu_pol.forward(params, ctraj["obs"][t, env:env + 1])
        top = (pi[0] + draws[t]["noise"][env]).topk(2).values
        assert float(top[0] - top[1]) <= 1e-5, (t, env)
    t = torch.arange(steps)[:, None]
    seen, acted = t <= diverged, t < diverged
    for k, mask in (("obs", seen), ("action", acted), ("reward", acted),
                    ("done", acted)):
        assert torch.equal(gtraj[k][mask], ctraj[k][mask]), k
    for k in ("logp", "value"):
        torch.testing.assert_close(gtraj[k][seen], ctraj[k][seen],
                                   rtol=1e-4, atol=1e-5)
    for g, c in zip(ggrads, cgrads):
        assert float((g - c).norm() / c.norm()) <= 1e-4
    for g, c in zip(tree_leaves(gparams), tree_leaves(cparams)):
        assert float((g - c).abs().max()) <= 0.5 * cfg.lr


def _copy_learner(src, dst):
    """``src``'s params, targets, Adam state, buffer, envs and env-step
    count onto ``dst``, its twin on another device."""
    from ray_tpu_torch.rl.policy import tree_map

    def to(tree):
        return tree_map(lambda x: x.to(dst.device, copy=True), tree)

    dst.params, dst.target_params = to(src.params), to(src.target_params)
    dst.opt_state = {"count": src.opt_state["count"],
                     "mu": to(src.opt_state["mu"]),
                     "nu": to(src.opt_state["nu"])}
    dst.buffer = {k: (to(v) if torch.is_tensor(v) or isinstance(v, dict)
                      else v) for k, v in src.buffer.items()}
    dst.env_states, dst.obs = to(src.env_states), to(src.obs)
    dst._total_env_steps = src._total_env_steps


def test_rainbow_iteration_on_the_card_matches_the_cpu(cuda):
    """One Rainbow iteration (double-Q, dueling, 3-step, PER, 51 atoms; 8
    envs x 4 steps, buffer 128, batch 16, 2 updates) from the same weights,
    buffer and draws, in full fp32 (chip_smoke.py's offpolicy check and
    bounds, smaller): actions, rewards, dones, cursor and size equal, but
    for an env whose action is a Q near-tie (top two within 1e-5; compared
    up to there), observations within rtol 1e-5 / atol 1e-6; then, from
    the CPU's buffer on both sides, the first update's sampled slots
    equal, its loss and gradients within 1e-5 of a norm, and after both
    updates the params within 0.01 of an Adam step (lr)."""
    import dataclasses

    from ray_tpu_torch.rl import CartPole, RainbowConfig
    from ray_tpu_torch.rl.learner import value_and_grad
    from ray_tpu_torch.rl.policy import tree_leaves, tree_map

    kw = dict(num_envs=8, rollout_steps=4, buffer_capacity=128,
              batch_size=16, num_updates=2, learn_start=16, eps_start=0.3,
              seed=0)
    n, steps, b = 8, 4, 16
    cpu = RainbowConfig(env=CartPole, device="cpu", **kw).build()
    gpu = RainbowConfig(env=CartPole, device=cuda, **kw).build()
    saved = torch.backends.cuda.matmul.fp32_precision
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    try:
        cpu.collect()                          # past learn_start
        _copy_learner(cpu, gpu)
        gen = torch.Generator().manual_seed(0)
        draws = [{"uniform": torch.rand(n, generator=gen),
                  "random": torch.randint(2, (n,), generator=gen),
                  "reset": cpu.env.reset_draws(n, gen)}
                 for _ in range(steps)]
        us = [torch.rand(b, generator=gen) for _ in range(2)]
        cursor = cpu.buffer["cursor"]
        cpu.collect(draws)
        gpu.collect(tree_map(lambda x: x.to(cuda), draws))
        assert (gpu.buffer["cursor"], gpu.buffer["size"]) == \
            (cpu.buffer["cursor"], cpu.buffer["size"])
        idx = (cursor + torch.arange(steps * n)) % kw["buffer_capacity"]
        rows = [{k: v[idx.to(v.device)].cpu().reshape(
            (steps, n) + v.shape[1:]) for k, v in a.buffer["data"].items()}
            for a in (cpu, gpu)]
        differs = rows[1]["action"] != rows[0]["action"]
        first = torch.where(differs.any(0), differs.int().argmax(0),
                            torch.full((n,), steps))
        for env in torch.nonzero(first < steps).flatten().tolist():
            q = cpu.q.apply(cpu.params,
                            rows[0]["obs"][int(first[env]), env:env + 1])
            top = q[0].topk(2).values
            assert float(top[0] - top[1]) <= 1e-5, env
        t = torch.arange(steps)[:, None]
        for k, mask in (("obs", t <= first), ("action", t < first),
                        ("reward", t < first), ("done", t < first)):
            got, want = rows[1][k][mask], rows[0][k][mask]
            if k == "obs":
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            else:
                assert torch.equal(got, want), k
        _copy_learner(cpu, gpu)
        sample = cpu._replay_ops[2]
        for k, u in enumerate(us):
            _, ci, _ = sample(cpu.buffer, b, draw={"u": u})
            _, gi, _ = sample(gpu.buffer, b, draw={"u": u.to(cuda)})
            if k == 0:
                assert torch.equal(gi.cpu(), ci)
                parts = []
                for algo, dev in ((cpu, "cpu"), (gpu, cuda)):
                    batch, i, w = sample(algo.buffer, b,
                                         draw={"idx": ci.to(dev)})
                    batch = algo._targets_batch(batch, i)
                    loss, _, grads = value_and_grad(
                        algo._td_loss, algo.params, algo.target_params,
                        batch, w)
                    parts.append((loss.cpu(), [g.cpu() for g in grads]))
                (cl, cg), (gl, gg) = parts
                assert float((gl - cl).abs() / cl.abs()) <= 1e-5
                for g, c in zip(gg, cg):
                    assert float((g - c).norm() / c.norm()) <= 1e-5
            for algo, dev in ((cpu, "cpu"), (gpu, cuda)):
                algo.config = dataclasses.replace(algo.config,
                                                  num_updates=1)
                algo.learn([{"idx": ci.to(dev)}])
    finally:
        torch.backends.cuda.matmul.fp32_precision = saved
    for g, c in zip(tree_leaves(gpu.params), tree_leaves(cpu.params)):
        assert float((g.cpu() - c).abs().max()) <= 0.01 * cpu.config.lr


def test_dqn_at_the_jax_packages_row_trains_on_the_card(cuda):
    """Double DQN on CartPole at the JAX package's DQN row (128 envs x 32
    steps, buffer 100,000, batch 256, 16 updates, learn_start 1024;
    tpu_probe2.py:107-111): the first iteration's 4,096 rows pass the
    gate, so its updates run on the card with a finite, nonzero loss."""
    from ray_tpu_torch.rl import CartPole, DQNConfig

    algo = DQNConfig(env=CartPole, num_envs=128, rollout_steps=32,
                     buffer_capacity=100_000, batch_size=256,
                     num_updates=16, learn_start=1024, seed=0).build()
    res = algo.train()
    assert algo.buffer["size"] == 4096 >= algo.config.learn_start
    assert algo.buffer["data"]["obs"].is_cuda
    assert np.isfinite(res["td_loss"]) and res["td_loss"] != 0
    assert algo.opt_state["count"] == 16


@pytest.mark.parametrize("check", ["impala_card_equals_cpu",
                                   "qmix_card_equals_cpu",
                                   "lints_card_equals_cpu"])
def test_rl_breadth_card_matches_the_cpu(cuda, check):
    """chip_smoke.py's rl_breadth checks, in full fp32: an IMPALA
    iteration (CartPole 16 x 8: actions, rewards, dones equal, mean rho 1
    within 1e-5, V-trace, loss and clipped gradients within
    chip_smoke.BREADTH_TOL of a norm), a QMIX iteration past the gate
    (SpreadLine(4), 8 x 8, buffer 512: actions equal but at a Q near-tie,
    the first update's slots equal, Q_tot, loss and gradients, then 4
    updates within the measured drift) and 512 LinTS steps (arms equal
    but at a printed near-tie, A and b within the bound); each raises on
    a difference past its bound."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    name = torch.cuda.get_device_name(0)
    with chip_smoke.fp32_ieee():
        out = getattr(chip_smoke, check)(name)
    assert out["max_err"]


def _chip_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("b", [64, 1])
def test_flash_fwd_refuses_planted_faults_within_one_tile(cuda, b):
    """At the Decision Transformer's shape (60 tokens, one head of 128,
    fp32: one tile, no key tile to drop), O with its tile zeroed, with the
    causal mask off and with the first key dropped each fail the fp32 tile
    bound (chip_smoke.short_fwd_faults)."""
    from ray_tpu_torch import ops

    q, k, v = _qkv(0, b, 60, 60, 1, 1, 128, "fp32", cuda)
    scale = 128 ** -0.5
    o, _ = flash_fwd(q, k, v, True, scale)
    faults = planted_fwd_faults(flash_fwd, q, k, v, o, True, scale)
    faults.update(_chip_smoke().short_fwd_faults(ops, q, k, v, o, True,
                                                 scale))
    assert len(faults) == 3
    for what, bad in faults.items():
        assert tile_rel_err(bad, o) > 10 * FWD_TILE_TOL["fp32"], what


@pytest.mark.parametrize("b", [64, 1])
def test_flash_bwd_refuses_planted_faults_within_one_tile(cuda, b):
    """At the Decision Transformer's shape (60 tokens, one head of 128,
    fp32: one key tile), dQ, dK and dV with the last tile zeroed, dQ and dV
    with the causal mask off and dK with the first key dropped each fail
    the fp32 tile bound (chip_smoke.planted_faults)."""
    from ray_tpu_torch import ops

    q, k, v = _qkv(2, b, 60, 60, 1, 1, 128, "fp32", cuda)
    do = torch.from_numpy(np.random.default_rng(3).standard_normal(
        q.shape, dtype=np.float32)).to(cuda)
    scale = 128 ** -0.5
    o, lse = flash_fwd(q, k, v, True, scale)
    got = flash_bwd(q, k, v, o, lse, do, True, scale)
    faults = _chip_smoke().planted_faults(ops, q, k, v, o, lse, do, True,
                                          scale, got)
    assert len(faults) == 6
    for what, (i, bad) in faults.items():
        assert tile_rel_err(bad, got[i]) > 10 * BWD_TILE_TOL["fp32"], what


@pytest.mark.parametrize("check", ["maml_card_equals_cpu",
                                   "alphazero_card_equals_cpu",
                                   "slateq_card_equals_cpu",
                                   "dt_card_equals_cpu",
                                   "dt_flash_against_reference"])
def test_rl_rest_card_matches_the_cpu(cuda, check):
    """chip_smoke.py's rl_rest checks, in full fp32: a MAML meta-step (4
    tasks x 4 envs; the meta-gradient within chip_smoke.REST_TOL of a
    norm), an AlphaZero self-play (4 games x 8 simulations; visits and
    actions equal), a SlateQ iteration past the gate (rows equal but at a
    printed near-tie, 4 updates within the bound), the Decision
    Transformer at its paper's width (the card's flash kernels against
    the CPU's reference attention: gradients, one AdamW step, an
    evaluation episode's return; and flash against reference attention
    on the card); each raises on a difference past its bound."""
    from ray_tpu_torch import ops

    chip_smoke = _chip_smoke()
    name = torch.cuda.get_device_name(0)
    with chip_smoke.fp32_ieee():
        if check.startswith("dt"):
            dataset, _ = chip_smoke.expert_dataset()
            args = (dataset, (ops.flash_fwd, ops.flash_bwd_dq,
                              ops.flash_bwd_dkv)) \
                if check == "dt_flash_against_reference" else (dataset,)
            out = getattr(chip_smoke, check)(name, *args)
        else:
            out = getattr(chip_smoke, check)(name)
    assert out["max_err"]


def test_sequence_parallel_attention_on_the_card(cuda):
    """Ulysses and the ring shard function at sp=1 on a one-rank NCCL mesh,
    at the llama-1b train attention shape, against reference attention
    forward and backward (chip_smoke.py's parallel phase, items 2-3):
    Ulysses launches each flash kernel once a call, the ring none."""
    import torch.distributed as dist

    chip_smoke = _chip_smoke()
    from ray_tpu_torch import ops
    from ray_tpu_torch.parallel import MeshSpec, create_mesh

    mesh = create_mesh(MeshSpec(), device="cuda")
    try:
        launches, out = chip_smoke.par_attention(
            torch.cuda.get_device_name(0), ops, mesh)
    finally:
        dist.destroy_process_group()
    assert launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                        "flash_bwd_dkv": 1}
    assert set(out["ring"]["launches"].values()) == {0}



def test_train_gang_on_the_card(cuda, tmp_path, monkeypatch):
    """chip_smoke.py's train_gang (a) at a tiny flash config: the model's
    steps in this process, then through TorchTrainer(num_workers=1) with
    SpmdConfig (a one-rank NCCL gang in a spawned process): the gang's
    first loss and grad norm bitwise the in-process step's, launches
    4/2/2 a step counted in the rank."""
    import torch.distributed as dist

    chip_smoke = _chip_smoke()
    monkeypatch.setattr(chip_smoke, "GANG_DIR", str(tmp_path))
    cfg = dict(d_model=128, n_heads=2, n_kv_heads=1, attention_impl="flash",
               remat="dots", norm_remat=True, loss_chunk=16, max_seq_len=64,
               param_dtype=torch.bfloat16)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 64))
    per_step = {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    try:
        launches, out = chip_smoke.gang_llama(
            torch.cuda.get_device_name(0), "tiny", cfg, tokens, per_step)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert launches == {k: n * chip_smoke.GANG_STEPS
                        for k, n in per_step.items()}
    assert (out["first_loss"], out["first_grad_norm"]) == tuple(
        out["plain_first"])


def test_tensor_staging_and_a_tree_checkpoint_on_the_card(cuda, tmp_path):
    """`core.serialization` stages a card tensor through the host and back
    onto the card, bitwise; `Checkpoint.from_pytree` of a small tree of
    card tensors restores onto the card whole (no device given) and into
    card targets in place, bitwise."""
    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.core.serialization import (deserialize,
                                                  serialize_to_bytes)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = torch.randn((5, 7), generator=gen, device=cuda).to(torch.bfloat16)
    back = deserialize(serialize_to_bytes({"t": t, "n": 3}))
    assert back["n"] == 3 and back["t"].device.type == "cuda"
    assert back["t"].dtype == torch.bfloat16 and torch.equal(back["t"], t)

    tree = {"w": torch.randn((64, 64), generator=gen, device=cuda),
            "opt": {"m": t, "step": torch.tensor(2.0)}, "step": 3}
    ck = Checkpoint.from_pytree(tree, path=str(tmp_path / "ck"))
    whole = ck.to_pytree()
    assert whole["w"].device.type == "cuda" and whole["step"] == 3
    assert torch.equal(whole["w"], tree["w"])
    assert torch.equal(whole["opt"]["m"], t)
    target = {"w": torch.zeros((64, 64), device=cuda),
              "opt": {"m": torch.zeros_like(t), "step": torch.tensor(0.0)}}
    placed = ck.to_pytree(target)
    assert placed["w"] is target["w"] and torch.equal(target["w"], tree["w"])
    assert torch.equal(target["opt"]["m"], t)
    assert float(target["opt"]["step"]) == 2.0
