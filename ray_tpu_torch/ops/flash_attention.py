"""Fused attention, forward and backward: the Hopper kernels
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` and their plain PyTorch
versions.

Counterpart of ``ray_tpu/ops/flash_attention.py``.  Inputs are
``[batch, seq, heads, head_dim]``; KV heads may be a divisor of the query
heads (GQA).  The kernels read that layout directly (no transposes); LSE and
delta are ``[batch, heads, s_q]`` in fp32.

Each wrapper (`flash_fwd`, `flash_bwd_dq`, `flash_bwd_dkv`) launches its
kernel for CUDA tensors and counts the launch in its ``.launches``; for CPU
tensors it runs its plain version, the same function computed step by step
in PyTorch, which the tests and ``chip_smoke.py`` also hold the kernel
against.  There is no fallback: a CUDA tensor the kernel does not take
raises.  `flash_attention` is differentiable: its backward is `flash_bwd`,
the two backward kernels behind one `torch.autograd.Function`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # as the TPU kernel: avoids inf - inf in the online softmax
HEAD_DIMS = (64, 128)
DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [b,s_q,h,d] and k, v [b,s_kv,h_kv,d]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s_q, h, d = q.shape
    bk, s_kv, h_kv, dk = k.shape
    if bk != b or dk != d or h % h_kv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         f"disagree (batch, head_dim, or heads not a "
                         f"multiple of kv heads)")
    if s_q == 0 or s_kv == 0:
        raise ValueError("empty sequence")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{list(DTYPES)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")


def _heads_f32(x: torch.Tensor, group: int) -> torch.Tensor:
    """[b, s, heads, d] → fp32 [b, heads * group, s, d], each head repeated
    ``group`` times (a KV head for the query heads that read it)."""
    return x.float().transpose(1, 2).repeat_interleave(group, dim=1)


def _scores(qf: torch.Tensor, kf: torch.Tensor, causal: bool,
            sm_scale: float) -> torch.Tensor:
    """fp32 S = Q Kᵀ · sm_scale, NEG_INF where the bottom-right causal mask
    hides the key."""
    s = (qf @ kf.transpose(-1, -2)) * sm_scale                  # [b,h,sq,skv]
    if causal:
        s_q, s_kv = s.shape[-2:]
        rows = torch.arange(s_q, device=s.device)[:, None] + (s_kv - s_q)
        visible = rows >= torch.arange(s_kv, device=s.device)[None, :]
        s = torch.where(visible, s, NEG_INF)
    return s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, sm_scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch → (O [b,s_q,h,d] in q.dtype,
    LSE [b,h,s_q] fp32): fp32 scores, the bottom-right causal mask, P
    rounded to the input dtype before P·V, and rows that see no key get
    O = 0 and LSE = 0."""
    group = q.shape[2] // k.shape[2]
    s = _scores(_heads_f32(q, 1), _heads_f32(k, group), causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    dead = m <= NEG_INF * 0.5
    p = torch.where(dead, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(q.dtype).float() @ _heads_f32(v, group)) / torch.where(
        l == 0.0, 1.0, l)
    lse = torch.where(dead, 0.0, m + torch.log(l.clamp_min(1e-30)))
    return (o.to(q.dtype).transpose(1, 2).contiguous(),
            lse.squeeze(-1).contiguous())


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, sm_scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (O, LSE) of `flash_attention_plain`, by the CUDA kernel for CUDA
    tensors.  ``flash_fwd.launches`` counts the kernel's launches (the plain
    version is not counted)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, sm_scale)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1],
                      dtype=torch.float32, device=q.device)
    _launch("flash_fwd", (q, k, v, o, lse), q, k, causal, sm_scale)
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


# -- backward -----------------------------------------------------------------

def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise TypeError(f"dO must have q's shape and dtype: got "
                        f"{tuple(do.shape)} {do.dtype}, q {tuple(q.shape)} "
                        f"{q.dtype}")
    stats = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != stats or t.dtype != torch.float32:
            raise TypeError(f"{name} must be fp32 [b, h, s_q] = {stats}; "
                            f"got {tuple(t.shape)} {t.dtype}")
    if not all(t.device == q.device for t in (do, lse, delta)):
        raise ValueError("dO, lse and delta must lie on q's device")
    if not (do.is_contiguous() and lse.is_contiguous()
            and delta.is_contiguous()):
        raise ValueError("dO, lse and delta must be contiguous")


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """δ = rowsum(dO ∘ O) in fp32 → [b, h, s_q], as the JAX package computes
    it outside its kernels.  dO is upcast inside the product, the same
    values as ``do.float() * o.float()`` with one pass less."""
    return (do * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_probs(q, k, v, do, lse, delta, causal, sm_scale):
    """→ (P, dS, Q, K, dO), fp32 [b, h, ·, ·] with K repeated over each
    group: P = exp(S − LSE) and dS = P∘(dP − δ)·sm_scale rounded to the
    input dtype, as both TPU kernels compute them."""
    group = q.shape[2] // k.shape[2]
    qf, kf, dof = _heads_f32(q, 1), _heads_f32(k, group), _heads_f32(do, 1)
    p = torch.exp(_scores(qf, kf, causal, sm_scale) - lse[..., None])
    dp = dof @ _heads_f32(v, group).transpose(-1, -2)
    ds = (p * (dp - delta[..., None]) * sm_scale).to(q.dtype).float()
    return p, ds, qf, kf, dof


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool,
                       sm_scale: float) -> torch.Tensor:
    """The dQ kernel's function in plain PyTorch → dQ = dS·K in q.dtype."""
    _, ds, _, kf, _ = _bwd_probs(q, k, v, do, lse, delta, causal, sm_scale)
    return (ds @ kf).to(q.dtype).transpose(1, 2).contiguous()


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool,
                        sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel's function in plain PyTorch → (dK = dSᵀ·Q,
    dV = round(P)ᵀ·dO) in k.dtype, each KV head's sum over its group of
    query heads taken in fp32."""
    p, ds, qf, _, dof = _bwd_probs(q, k, v, do, lse, delta, causal,
                                   sm_scale)
    h_kv = k.shape[2]

    def fold(x):   # [b, h, s_kv, d] → [b, s_kv, h_kv, d]
        return (x.unflatten(1, (h_kv, -1)).sum(2).to(k.dtype)
                .transpose(1, 2).contiguous())

    dv = p.to(q.dtype).float().transpose(-1, -2) @ dof
    dk = ds.transpose(-1, -2) @ qf
    return fold(dk), fold(dv)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool,
                              sm_scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward of `flash_attention_plain` as the two TPU kernels
    compute it → (dQ, dK, dV): fp32 products of the upcast operands, the
    same mask, P = exp(S − LSE), P rounded before dV and dS before dQ and
    dK."""
    delta = _delta(o, do)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, sm_scale)
    return (dq, *flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                     sm_scale))


def tile_rel_err(got: torch.Tensor, want: torch.Tensor, rows: int = 64
                 ) -> float:
    """The largest ‖got − want‖ / ‖want‖ over the tiles of ``rows`` rows of
    each batch and head of two [b, s, heads, d] tensors.  It does not depend
    on scale, so a tile, head or key range that a kernel got wrong shows in
    full, however small its values are beside the rest.  A tile that is
    zero in ``want`` scores 0 only where ``got`` is zero there too."""
    pad = (0, 0, 0, 0, 0, -got.shape[1] % rows)
    err, ref = (torch.nn.functional.pad(x, pad).unflatten(1, (-1, rows))
                .sum((2, 4))
                for x in ((got.float() - want.float()).square(),
                          want.float().square()))
    ratio = torch.where(ref > 0, err / ref,
                        torch.where(err == 0, 0.0, float("inf")))
    return float(ratio.max().sqrt())


def planted_fwd_faults(fwd, q, k, v, o, causal: bool,
                       sm_scale: float) -> dict:
    """{what: O} of three wrong forward kernels that a check of O must
    refuse: the last 64-row q tile zeroed; each group's V taken from another
    KV head (none when there is one KV head); the middle 64-key tile of V
    dropped for the q tiles after it (none when no q tile comes after it).
    ``fwd`` is `flash_fwd` or `flash_attention_plain`, ``o`` its good O."""
    rows = 64   # the tiles of `tile_rel_err`
    s_q, s_kv = q.shape[1], k.shape[1]
    faults = {}
    bad = o.clone()
    bad[:, (s_q - 1) // rows * rows:] = 0
    faults["last q tile zeroed"] = bad
    if k.shape[2] > 1:
        faults["V from another KV head"] = fwd(
            q, k, v.roll(1, dims=2).contiguous(), causal, sm_scale)[0]
    tile = s_kv // rows // 2
    v_cut = v.clone()
    v_cut[:, tile * rows:(tile + 1) * rows] = 0
    # the first q tile whose rows all come after the dropped keys
    first = max(0, -(-((tile + 1) * rows - (s_kv - s_q)) // rows) * rows)
    if first < s_q:
        bad = o.clone()
        bad[:, first:] = fwd(q, k, v_cut, causal, sm_scale)[0][:, first:]
        faults["a key tile dropped"] = bad
    return faults


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool,
                 sm_scale: float) -> torch.Tensor:
    """→ dQ of `flash_bwd_dq_plain`, by the CUDA kernel for CUDA tensors;
    ``flash_bwd_dq.launches`` counts its launches."""
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, sm_scale)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", (q, k, v, do, lse, delta, dq), q, k, causal,
            sm_scale)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, sm_scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (dK, dV) of `flash_bwd_dkv_plain`, by the CUDA kernel for CUDA
    tensors; ``flash_bwd_dkv.launches`` counts its launches."""
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                   sm_scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv), q, k,
            causal, sm_scale)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd(q, k, v, o, lse, do, causal: bool, sm_scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (dQ, dK, dV) from the forward's residuals: δ in fp32 with plain
    torch, then the dQ and the dK/dV wrappers."""
    if o.shape != q.shape or o.dtype != q.dtype:
        raise TypeError(f"O must have q's shape and dtype: got "
                        f"{tuple(o.shape)} {o.dtype}")
    delta = _delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale)
    return dq, dk, dv


# -- binding ------------------------------------------------------------------

# kernel → (CUDA source, tensor pointers of its C entry point
# ``ray_tpu_<kernel>``); each entry then takes dtype, b, h, h_kv, s_q, s_kv,
# d, causal, sm_scale, the device and the stream
_KERNELS = {"flash_fwd": ("flash_fwd", 5), "flash_bwd_dq": ("flash_bwd", 7),
            "flash_bwd_dkv": ("flash_bwd", 8)}


@functools.cache
def _library(source: str) -> ctypes.CDLL:
    from ..kernels import build

    lib = build.load(source)
    # every pointer and the stream as c_void_p: a bare Python int would be
    # passed as a 32-bit int and cut the pointer
    for kernel, (src, n_ptr) in _KERNELS.items():
        if src == source:
            fn = getattr(lib, f"ray_tpu_{kernel}")
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    lib.ray_tpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ray_tpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(kernel: str, tensors, q: torch.Tensor, k: torch.Tensor,
            causal: bool, sm_scale: float) -> None:
    """Launch ``kernel`` on PyTorch's current stream with the pointers of
    ``tensors`` (inputs, then the outputs it writes) and q's and k's
    dimensions; raise on anything the launch reports but success."""
    if q.device.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda or cpu, not {q.device}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel} needs 16-byte aligned inputs")
    lib = _library(_KERNELS[kernel][0])
    b, s_q, h, d = q.shape
    s_kv, h_kv = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, f"ray_tpu_{kernel}")(
        *(t.data_ptr() for t in tensors), DTYPES[q.dtype], b, h, h_kv, s_q,
        s_kv, d, int(causal), float(sm_scale), q.device.index, stream)
    if err:
        msg = lib.ray_tpu_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)   # the JAX residuals
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), ctx.causal,
                               ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention over ``[batch, seq, heads, head_dim]`` inputs → O in
    q's dtype.  k and v are cast to q's dtype first, as the JAX entry does;
    ``sm_scale`` defaults to ``head_dim ** -0.5``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k.to(q.dtype), v.to(q.dtype), causal,
                                 sm_scale)
