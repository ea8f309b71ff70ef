"""The serve engine's per-step program, captured as a CUDA graph.

The counterpart of the JAX engine's ``jax.jit(fused_step)``
(``ray_tpu/serve/decode_session.py:163-182``): `decode_step_slots` over
every slot, the greedy argmax and the carry ``where(active, next, tok)``,
one fixed-shape program a step.  Eager PyTorch spends host time on each
of the step's ops, over a hundred a layer, and a decode step on the card
is bound by that host time; a CUDA graph replays all its kernels in one
launch.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from ..models.generate import KVCache, decode_step_slots


class FusedDecodeStep:
    """One decode step over a slot cache's ``S`` slots, with static
    buffers: inputs ``tok`` [S] and ``active`` [S], outputs ``out`` [S]
    (each slot's next token, its old one where inactive) and ``logits``
    [S, vocab].  The cache's K/V are written and its ``pos`` advanced in
    place, so the cache's tensors never move.

    On a CUDA device `capture` warms the step on a side stream and captures
    it once; `run` then replays the graph, and raises if there is none: it
    never falls back to eager steps.  On the CPU `run` computes the step
    eagerly.  ``replays`` counts the graph's launches."""

    def __init__(self, params: Any, cache: KVCache, cfg):
        self.params = params
        self.cache = cache
        self.cfg = cfg
        device = cache["k"].device
        self.cuda = device.type == "cuda"
        slots = cache["pos"].shape[0]
        self.tok = torch.zeros(slots, dtype=torch.long, device=device)
        self.active = torch.zeros(slots, dtype=torch.bool, device=device)
        self.out = self.logits = None
        self.graph = None
        self.replays = 0
        if self.cuda:
            # page-locked staging, so the [S] copies in and out are
            # asynchronous on the caller's stream: a step's one sync is
            # the wait for its tokens
            self._in_tok = torch.zeros(slots, dtype=torch.long).pin_memory()
            self._in_active = torch.zeros(slots,
                                          dtype=torch.bool).pin_memory()
            self._out_host = torch.zeros(slots,
                                         dtype=torch.long).pin_memory()

    def _step(self) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, cache = decode_step_slots(self.params, self.tok, self.cache,
                                          self.active, self.cfg)
        nxt = torch.argmax(logits, dim=-1)
        self.cache["pos"].copy_(cache["pos"])
        return logits, torch.where(self.active, nxt, self.tok)

    def capture(self) -> None:
        """Warm the step on a side stream, then capture it.  The warm-up
        steps run with every slot inactive: each writes K/V at its slot's
        ``pos``, a row that slot's next active step rewrites before
        reading it, and advances no ``pos``."""
        if not self.cuda:
            raise RuntimeError("a CUDA graph needs a CUDA slot cache")
        self.active.zero_()
        side = torch.cuda.Stream(device=self.tok.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                self._step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: a client thread's CUDA call during the capture
        # neither fails nor spoils it
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.logits, self.out = self._step()
        self.graph = graph

    def load(self, tokens: np.ndarray, active: np.ndarray) -> None:
        """Copy the host's [S] tokens and active mask into the static
        inputs (asynchronously on the card)."""
        if self.cuda:
            self._in_tok.copy_(torch.from_numpy(tokens.astype(np.int64)))
            self._in_active.copy_(torch.from_numpy(active.astype(bool)))
            self.tok.copy_(self._in_tok, non_blocking=True)
            self.active.copy_(self._in_active, non_blocking=True)
        else:
            self.tok.copy_(torch.from_numpy(tokens.astype(np.int64)))
            self.active.copy_(torch.from_numpy(active.astype(bool)))

    def run(self, tokens: np.ndarray, active: np.ndarray) -> np.ndarray:
        """One step from host tokens and mask [S] → next tokens [S] on the
        host (one device-to-host read, the step's one sync)."""
        self.load(tokens, active)
        if not self.cuda:
            self.logits, self.out = self._step()
            return self.out.numpy().copy()
        if self.graph is None:
            raise RuntimeError("the decode step graph was not captured")
        self.graph.replay()
        self.replays += 1
        self._out_host.copy_(self.out, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return self._out_host.numpy().copy()
