"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

The JAX package ``ray_tpu`` is the reference; this package mirrors its
structure (``ops``, ``models``, ``parallel``, ``serve``, ``rl``, ``air``,
``train``, ``metrics``, ``core``, ``util``) in PyTorch, and every Pallas TPU
kernel on a ported path becomes a hand-written CUDA kernel (``csrc/``,
built by ``kernels.build``).  It imports nothing of ``ray_tpu`` and nothing
of JAX.  Entry points run on the CUDA device unless the caller passes
``device="cpu"``.

Ported so far: serving (the continuous-batching engine, with its metrics,
spans and chaos site, and the whole-prompt path) and training of the
transformer family, dense or with experts, and ViT, with the three
flash-attention kernels; every on-card module of RL (``rl``: PPO to
DD-PPO, the replay family, IMPALA, multi-agent, offline, bandits, ES,
MAML, Dreamer, DT, AlphaZero, SlateQ); and the parallel layer
(``parallel``: meshes, sharding rules on DTensors, the pipeline, the gang
bootstrap) with ring and Ulysses attention; the Train gang on the port's
own actor layer (``train``), with host collectives (``HostArrayConfig``,
``util.collective``) on a store, array staging (``core.serialization``)
and sharded tree checkpoints (``air.Checkpoint.from_pytree``); gang
replicas (``serve.gang``: one replica over a process group, serving from
placed weights), with the chaos plan reaching every spawned actor.
``ROADMAP.md`` lists what is still to come: the rest of the multi-process
runtime pieces.
"""

from .device import resolve_device  # noqa: F401
