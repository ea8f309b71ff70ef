"""Autoregressive generation with a KV cache (counterpart of
``ray_tpu/models/generate.py``).

Two families of functions:

* the whole-prompt path: `prefill` runs the prompt once through the flash
  kernel and writes each layer's K/V into a fixed-capacity cache;
  `decode_step` attends one query position against the cache; `generate`
  strings them together;
* the continuous-batching engine's functions: `prefill_chunk` (one chunk
  of prompt tokens against the cache, dense attention; the one chunk
  function behind `prefill_chunked`, `resume_prefill` and the engine's
  admission), the slot cache (`init_slot_cache`, `cache_insert_slot`,
  `cache_gather_slot`) with a ``pos`` per slot, `decode_step_slots` (one
  step over every slot) and the speculative pair `draft_propose_slots` /
  `verify_step_slots`.

The whole-prompt functions and `prefill_chunk` take parameters placed as
DTensors (`parallel.shard_pytree`) too: each gathers them whole once a call
(`transformer.whole_params`) and keeps the KV cache a plain tensor on every
rank.

Unlike the JAX package's immutable arrays, K and V are written in place: a
call returns the cache with the same K/V tensors and a new ``pos``, and the
cache passed in is not to be reused.  ``pos`` itself is never written in
place (a slot cache's ``pos`` is a new tensor in the returned cache), so a
caller commits it when it chooses, as the engine does after it has read a
step's tokens.

XLA's out-of-bounds rules, which the JAX functions rely on, are reproduced
explicitly: a gather clamps its index (learned positions, rotary rows); a
scatter past the cache's end is dropped (the slot functions clamp the row
and write the old row back under a ``where``, so shapes stay static for a
CUDA graph); ``dynamic_slice`` and ``dynamic_update_slice`` clamp their
start, so a chunk that overruns the cache is written, and takes its angles,
shifted back to ``max_len - c`` while its causal mask keeps the unshifted
positions.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..ops.rotary import apply_rotary, rotary_angles
from .transformer import (TransformerConfig, _embed, _ffn, _heads,
                          _layer_kv, _layer_params, _norm, _project_kv,
                          _unembed, whole_params)

Params = Any
# {"k","v": [L, B, max_len, hk, hd], "pos": int}; a slot cache's "pos" is
# an int64 tensor [slots]
KVCache = Dict[str, Any]


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  device: DeviceLike = None) -> KVCache:
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": 0}


def _check_decodable(cfg: TransformerConfig) -> None:
    if cfg.pp_stages > 1:
        raise NotImplementedError(
            "KV-cache decode over a pipeline mesh is not supported; "
            "serve pp-sharded models stage-per-gang instead")


def prefill(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt; → (logits of the LAST position [B, vocab] fp32,
    cache holding the prompt's K/V with pos = prompt length)."""
    _check_decodable(cfg)
    params = whole_params(params)
    s = tokens.shape[1]
    if s > cache["k"].shape[2]:
        raise ValueError(f"prompt length {s} exceeds cache capacity "
                         f"{cache['k'].shape[2]}")
    x = _embed(params, tokens, cfg, slice(0, s))
    cos, sin = (rotary_angles(s, cfg.head_dim, cfg.rope_base,
                              device=x.device)
                if cfg.pos_emb == "rope" else (None, None))
    for i in range(cfg.n_layers):
        x, _, k, v = _layer_kv(cfg, x, _layer_params(params, i), cos, sin)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_b"))
    logits = x[:, -1] @ _unembed(params, cfg)
    return logits.float(), {"k": cache["k"], "v": cache["v"], "pos": s}


def _attend(cfg: TransformerConfig, q: torch.Tensor, ck: torch.Tensor,
            cv: torch.Tensor, visible: torch.Tensor) -> torch.Tensor:
    """Dense GQA attention of queries q [B, C, h, hd] against a cache's
    K/V [B, T, hk, hd] → [B, C, h * hd].  ``visible`` [B or 1, C, T] says
    which cached positions each query sees.  Scores in ``cfg.dtype`` as the
    JAX package computes them, softmax in fp32, probabilities back to
    ``cfg.dtype``, masked scores -1e30."""
    dt = cfg.dtype
    b, c, h, hd = q.shape
    hk = cfg.kv_heads
    qh = q.reshape(b, c, hk, h // hk, hd)
    scores = torch.einsum("bskgd,btkd->bskgt", qh, ck.to(dt)) \
        / math.sqrt(hd)
    scores = scores.masked_fill(~visible[:, :, None, None, :], -1e30)
    probs = torch.softmax(scores.float(), dim=-1)
    attn = torch.einsum("bskgt,btkd->bskgd", probs.to(dt), cv.to(dt))
    return attn.reshape(b, c, h * hd)


def _block_tail(cfg: TransformerConfig, x: torch.Tensor,
                attn: torch.Tensor, lp: Params) -> torch.Tensor:
    """The rest of a block after attention: output projection, residual,
    the FFN and its residual."""
    x = x + attn @ lp["wo"].to(cfg.dtype).flatten(0, 1)
    y = _norm(cfg, x, lp["mlp_norm"], lp.get("mlp_norm_b"))
    z, _ = _ffn(cfg, y, lp)
    return x + z


def decode_step(params: Params, token: torch.Tensor, cache: KVCache,
                cfg: TransformerConfig) -> Tuple[torch.Tensor, KVCache]:
    """One token [B] → (next-token logits [B, vocab] fp32, cache').

    A step at or past the cache's end behaves as the JAX package's does:
    `jax.lax.dynamic_update_slice` and `dynamic_slice` clamp their start,
    so the step rewrites the last cache row with the last row's rotary
    angles, attends over the whole cache, and ``pos`` still advances."""
    _check_decodable(cfg)
    params = whole_params(params)
    dt = cfg.dtype
    pos = cache["pos"]
    max_len = cache["k"].shape[2]
    row = min(pos, max_len - 1)
    table_row = min(pos, cfg.max_seq_len - 1)   # learned positions clamp too
    x = _embed(params, token[:, None], cfg, slice(table_row, table_row + 1))
    cos, sin = (rotary_angles(1, cfg.head_dim, cfg.rope_base, offset=row,
                              device=x.device)
                if cfg.pos_emb == "rope" else (None, None))
    visible = (torch.arange(max_len, device=x.device) <= pos)[None, None]
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        ck, cv = cache["k"][i], cache["v"][i]            # [B, max_len, hk, hd]
        y = _norm(cfg, x, lp["attn_norm"], lp.get("attn_norm_b"))
        q = _heads(y, lp["wq"].to(dt))
        if cfg.pos_emb == "rope":
            q = apply_rotary(q, cos, sin)
        k_new, v_new = _project_kv(cfg, y, lp, cos, sin)
        ck[:, row] = k_new[:, 0]
        cv[:, row] = v_new[:, 0]
        x = _block_tail(cfg, x, _attend(cfg, q, ck, cv, visible), lp)
    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_b"))
    logits = x[:, 0] @ _unembed(params, cfg)
    return logits.float(), {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def prefill_chunk(params: Params, tokens: torch.Tensor, cache: KVCache,
                  cfg: TransformerConfig) -> Tuple[torch.Tensor, KVCache]:
    """Extend the cache with a chunk of prompt tokens [B, C] starting at
    ``cache["pos"]`` → (logits of the chunk's last position [B, vocab]
    fp32, cache with pos + C).

    The one chunk function behind the engine's admission, failover
    `resume_prefill` and `prefill_chunked`, as the JAX package's single
    chunk program.  Attention is dense against the cache's ``max_len``
    (no flash kernel).  A chunk that overruns ``max_len`` is written, and
    takes its rotary angles (and learned positions), at the start clamped
    to ``max_len - C`` (``max_seq_len - C``), as the JAX package's
    ``dynamic_update_slice`` / ``dynamic_slice`` do; the mask keeps the
    unshifted positions."""
    _check_decodable(cfg)
    params = whole_params(params)
    b, c = tokens.shape
    dt = cfg.dtype
    pos = int(cache["pos"])
    max_len = cache["k"].shape[2]
    row = min(max(pos, 0), max_len - c)
    x = params["embed"]["tok"][tokens].to(dt)
    if cfg.pos_emb == "learned":
        start = min(max(pos, 0), cfg.max_seq_len - c)
        x = x + params["embed"]["pos"][start:start + c].to(dt)
    cos, sin = (rotary_angles(c, cfg.head_dim, cfg.rope_base, offset=row,
                              device=x.device)
                if cfg.pos_emb == "rope" else (None, None))
    # visible[i, t]: cached position t seen by chunk token i (causal in
    # the chunk, everything before it)
    visible = (torch.arange(max_len, device=x.device)[None, :]
               <= (pos + torch.arange(c, device=x.device))[:, None])[None]
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        ck, cv = cache["k"][i], cache["v"][i]            # [B, max_len, hk, hd]
        y = _norm(cfg, x, lp["attn_norm"], lp.get("attn_norm_b"))
        q = _heads(y, lp["wq"].to(dt))
        if cfg.pos_emb == "rope":
            q = apply_rotary(q, cos, sin)
        k_new, v_new = _project_kv(cfg, y, lp, cos, sin)
        ck[:, row:row + c] = k_new
        cv[:, row:row + c] = v_new
        x = _block_tail(cfg, x, _attend(cfg, q, ck, cv, visible), lp)
    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_b"))
    logits = x[:, -1] @ _unembed(params, cfg)
    return logits.float(), {"k": cache["k"], "v": cache["v"],
                            "pos": pos + c}


def prefill_chunked(params: Params, tokens: torch.Tensor,
                    cfg: TransformerConfig, cache: KVCache, *,
                    chunk: int = 512) -> Tuple[torch.Tensor, KVCache]:
    """Whole-prompt prefill as ceil(s / chunk) calls of `prefill_chunk`
    (chunks of ``chunk``, then the remainder); a drop-in for `prefill`."""
    s = tokens.shape[1]
    if s > cache["k"].shape[2]:
        raise ValueError(f"prompt length {s} exceeds cache capacity "
                         f"{cache['k'].shape[2]}")
    logits = None
    for off in range(0, s, chunk):
        logits, cache = prefill_chunk(params, tokens[:, off:off + chunk],
                                      cache, cfg)
    return logits, cache


def resume_prefill(params: Params, tokens: torch.Tensor,
                   cfg: TransformerConfig, cache: KVCache, *,
                   chunk: int = 32) -> Tuple[torch.Tensor, KVCache]:
    """Teacher-forced prefix prefill for decode-session failover: the
    prefix (prompt + tokens generated so far) in ``[B, chunk]`` blocks,
    then ``[B, 1]`` steps for the remainder, the two chunk shapes the
    engine's admission also runs."""
    s = tokens.shape[1]
    if s > cache["k"].shape[2]:
        raise ValueError(f"resume prefix length {s} exceeds cache "
                         f"capacity {cache['k'].shape[2]}")
    logits = None
    off = 0
    while off + chunk <= s:
        logits, cache = prefill_chunk(params, tokens[:, off:off + chunk],
                                      cache, cfg)
        off += chunk
    while off < s:
        logits, cache = prefill_chunk(params, tokens[:, off:off + 1],
                                      cache, cfg)
        off += 1
    return logits, cache


def init_slot_cache(cfg: TransformerConfig, slots: int, max_len: int,
                    device: DeviceLike = None) -> KVCache:
    """KV cache of a continuous-batching engine: ``slots`` independent
    sessions share one batched step, so ``pos`` is a per-slot int64
    tensor [slots] instead of `init_kv_cache`'s single int."""
    device = resolve_device(device)
    shape = (cfg.n_layers, slots, max_len, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": torch.zeros(slots, dtype=torch.long, device=device)}


def cache_insert_slot(slot_cache: KVCache, cache: KVCache,
                      slot: int) -> KVCache:
    """Write a batch-1 session cache (from `prefill_chunk`) into slot
    ``slot`` of a slot cache, in place (K, V and that slot's ``pos``), so
    the engine's one slot-cache allocation, which its CUDA graph reads,
    never moves.  Returns ``slot_cache``."""
    slot_cache["k"][:, slot:slot + 1] = cache["k"]
    slot_cache["v"][:, slot:slot + 1] = cache["v"]
    slot_cache["pos"][slot] = cache["pos"]
    return slot_cache


def cache_gather_slot(slot_cache: KVCache, slot: int, upto: int) -> KVCache:
    """Slot ``slot`` of a slot cache as a new batch-1 cache (a copy) with
    ``pos = upto``: the prefix-reuse admission primitive (the inverse of
    `cache_insert_slot`).  Rows at positions >= ``upto`` still hold the
    donor's later tokens; every function masks reads to positions <= pos,
    and the suffix prefill overwrites them before pos reaches them."""
    return {"k": slot_cache["k"][:, slot:slot + 1].clone(),
            "v": slot_cache["v"][:, slot:slot + 1].clone(),
            "pos": int(upto)}


def _rotate_slots(x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor) -> torch.Tensor:
    """`apply_rotary` with an angle row per slot (and per fed token):
    cos/sin broadcast against x [S, C, heads, hd] as [S, C, 1, hd // 2];
    the same fp32 rotate-half arithmetic."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _row_writes(posm: torch.Tensor, max_len: int):
    """For each fed column j of positions posm [S, C]: (slot index, row
    clamped into the cache, keep mask) of its per-slot write, as
    `_write_rows` takes them."""
    slot_ix = torch.arange(posm.shape[0], device=posm.device)
    return [(slot_ix, posm[:, j].clamp(0, max_len - 1),
             (posm[:, j] < max_len)[:, None, None])
            for j in range(posm.shape[1])]


def _write_rows(c: torch.Tensor, write, new: torch.Tensor) -> None:
    """c[s, row[s]] = new[s] for every slot s, in place, with the writes
    at rows >= max_len dropped (XLA's scatter): the row is clamped and the
    old row written back, so no shape depends on the data."""
    slot_ix, at, keep = write
    c[slot_ix, at] = torch.where(keep, new.to(c.dtype), c[slot_ix, at])


def _slot_inputs(params: Params, tokens: torch.Tensor, posm: torch.Tensor,
                 max_len: int, cfg: TransformerConfig):
    """Embeddings [S, C, d] and rotary rows [S, C, 1, hd // 2] of tokens
    [S, C] at positions posm [S, C]; both gathers clamp, as XLA's do."""
    x = params["embed"]["tok"][tokens].to(cfg.dtype)
    if cfg.pos_emb == "learned":
        x = x + params["embed"]["pos"][
            posm.clamp(0, cfg.max_seq_len - 1)].to(cfg.dtype)
    if cfg.pos_emb != "rope":
        return x, None, None
    full_cos, full_sin = rotary_angles(max_len, cfg.head_dim, cfg.rope_base,
                                       device=x.device)
    at = posm.clamp(0, max_len - 1)
    return x, full_cos[at][:, :, None, :], full_sin[at][:, :, None, :]


def _slot_forward(params: Params, tokens: torch.Tensor, cache: KVCache,
                  cfg: TransformerConfig) -> torch.Tensor:
    """Tokens [S, C] fed at each slot's ``pos`` .. ``pos + C - 1``: writes
    their K/V into the slot cache in place (writes past ``max_len``
    dropped) and returns the final hidden states [S, C, d]."""
    c = tokens.shape[1]
    dt = cfg.dtype
    pos = cache["pos"]                                         # [S]
    max_len = cache["k"].shape[2]
    posm = pos[:, None] + torch.arange(c, device=pos.device)[None, :]
    x, cos, sin = _slot_inputs(params, tokens, posm, max_len, cfg)
    # visible[s, i, t]: cached position t seen by fed token i of slot s
    visible = (torch.arange(max_len, device=pos.device)[None, None, :]
               <= posm[:, :, None])
    writes = _row_writes(posm, max_len)
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        ck, cv = cache["k"][i], cache["v"][i]            # [S, max_len, hk, hd]
        y = _norm(cfg, x, lp["attn_norm"], lp.get("attn_norm_b"))
        q = _heads(y, lp["wq"].to(dt))
        k_new = _heads(y, lp["wk"].to(dt))
        v_new = _heads(y, lp["wv"].to(dt))
        if cfg.pos_emb == "rope":
            q = _rotate_slots(q, cos, sin)
            k_new = _rotate_slots(k_new, cos, sin)
        # one fed token at a time: the clamped rows of dropped writes may
        # repeat within a slot, and each write must see the last one
        for j, write in enumerate(writes):
            _write_rows(ck, write, k_new[:, j])
            _write_rows(cv, write, v_new[:, j])
        x = _block_tail(cfg, x, _attend(cfg, q, ck, cv, visible), lp)
    return _norm(cfg, x, params["final_norm"], params.get("final_norm_b"))


def decode_step_slots(params: Params, token: torch.Tensor, cache: KVCache,
                      active: torch.Tensor, cfg: TransformerConfig
                      ) -> Tuple[torch.Tensor, KVCache]:
    """One continuous-batching decode step over every slot at once.

    ``token`` [S] (each slot's last token; free or paused slots may carry
    any value), ``cache`` a slot cache with per-slot ``pos`` [S],
    ``active`` [S] bool → (logits [S, vocab] fp32, cache') where ``pos``
    advances on active slots only.  Inactive slots still compute (the
    shape is fixed: one program, one CUDA graph), their K/V write lands at
    their un-advanced ``pos`` and is overwritten by their next active step
    before any read.  A slot at ``pos >= max_len`` has its write dropped
    and its angles taken from the last row, as XLA's scatter and gather
    do (unlike the batch-1 `decode_step`, which rewrites the last row)."""
    _check_decodable(cfg)
    x = _slot_forward(params, token[:, None], cache, cfg)
    logits = x[:, 0] @ _unembed(params, cfg)
    return logits.float(), {"k": cache["k"], "v": cache["v"],
                            "pos": cache["pos"] + active.long()}


def draft_propose_slots(params: Params, token: torch.Tensor,
                        cache: KVCache, active: torch.Tensor,
                        cfg: TransformerConfig, k: int
                        ) -> Tuple[torch.Tensor, KVCache]:
    """Draft ``k`` greedy tokens per slot: ``k`` chained
    `decode_step_slots`, each argmax fed back in (the JAX package scans
    them in one program) → (proposals [S, k], cache with pos + k on active
    slots).  ``cache`` is the draft model's slot cache, whose ``pos`` the
    engine re-syncs from the target every iteration."""
    tok = token
    toks = []
    for _ in range(k):
        logits, cache = decode_step_slots(params, tok, cache, active, cfg)
        tok = torch.where(active, torch.argmax(logits, dim=-1), tok)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache


def verify_step_slots(params: Params, tokens: torch.Tensor,
                      proposals: torch.Tensor, cache: KVCache,
                      active: torch.Tensor, cfg: TransformerConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Speculative verification: one forward over ``C`` tokens per slot
    checks a draft's ``C - 1`` proposals and yields 1..C tokens per slot.

    ``tokens`` [S, C] (per slot its pending token, then the proposals),
    ``proposals`` [S, C - 1] → ``(greedy [S, C], accepted [S], cache')``:
    ``greedy[s, i]`` is the target's argmax after ``tokens[s, :i + 1]``,
    ``accepted[s]`` is 1 + the longest proposal prefix matching that
    chain, clamped to the cache's room (at least 1), and ``pos`` advances
    by ``accepted`` on active slots.  The K/V of every fed token is
    written at its position; rejected writes sit past the new ``pos`` and
    are rewritten before any read; writes past ``max_len`` are dropped."""
    _check_decodable(cfg)
    x = _slot_forward(params, tokens, cache, cfg)
    logits = x @ _unembed(params, cfg)
    greedy = torch.argmax(logits, dim=-1)                      # [S, C]
    pos = cache["pos"]
    ok = (greedy[:, :-1] == proposals).long()
    accepted = 1 + torch.cumprod(ok, dim=1).sum(dim=1)
    room = (cache["k"].shape[2] - pos).clamp(min=1)
    accepted = torch.minimum(accepted, room)
    advance = torch.where(active, accepted, torch.zeros_like(accepted))
    return greedy, accepted, {"k": cache["k"], "v": cache["v"],
                              "pos": pos + advance}


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            greedy: bool, temperature: float,
            top_k: Optional[int]) -> torch.Tensor:
    if greedy:
        return torch.argmax(logits, dim=-1)   # first maximal index, as JAX
    logits = logits / temperature
    if top_k:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(params: Params, prompt, *, cfg: TransformerConfig,
             max_new_tokens: int, temperature: float = 0.0,
             top_k: Optional[int] = None, max_len: Optional[int] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """prompt [B, S] → generated tokens [B, max_new_tokens] int32, on the
    parameters' device.

    Greedy when ``temperature == 0`` (default), else temperature / top-k
    sampling from ``generator`` (seed 0 on the parameters' device when
    None).  Token i is sampled from the logits of the step before it, so
    only ``max_new_tokens - 1`` decode passes run.  Placed weights are
    gathered whole once for the call (`whole_params`)."""
    params = whole_params(params)
    device = params["embed"]["tok"].device
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=device)
    b, s = prompt.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, "
                         f"got {max_new_tokens}")
    total = max_len or (s + max_new_tokens)
    if total < s + max_new_tokens:
        raise ValueError(
            f"max_len={total} < prompt ({s}) + max_new_tokens "
            f"({max_new_tokens})")
    if cfg.pos_emb == "learned" and total > cfg.max_seq_len:
        raise ValueError(
            f"prompt + max_new_tokens ({total}) exceeds the learned "
            f"position table ({cfg.max_seq_len})")
    greedy = float(temperature) == 0.0
    if not greedy and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cache = init_kv_cache(cfg, b, total, device)
    logits, cache = prefill(params, prompt, cfg, cache)
    toks = []
    for _ in range(max_new_tokens - 1):
        tok = _sample(logits, generator, greedy, temperature, top_k)
        toks.append(tok)
        logits, cache = decode_step(params, tok, cache, cfg)
    toks.append(_sample(logits, generator, greedy, temperature, top_k))
    return torch.stack(toks, dim=1).to(torch.int32)
