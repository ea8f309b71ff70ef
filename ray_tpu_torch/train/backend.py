"""Train backends: how a worker gang becomes a communicating group
(counterpart of ``ray_tpu/train/backend.py``).

  * `SpmdConfig`: the default.  Every rank joins one process group through
    the port's gang bootstrap (`parallel.coordinator.join_mesh_gang`: NCCL
    on the card, gloo with ``device="cpu"``) and the gang's `DeviceMesh`
    hangs on the session (`air.session.get_mesh`).  Teardown leaves the gang
    and destroys the process group.
  * `HostArrayConfig`: no process group.  The trainer's process hosts a
    `TCPStore` for the attempt (the counterpart of the reducer actor the JAX
    trainer owns) and each rank reduces host arrays through it with
    `train.host_collective`; a restart gets a fresh store and key prefix.
  * The gloo group for reference-style torch train functions is
    `trainer.TorchCompatTrainer`'s backend.

A backend's setup and teardown functions cross to the ranks by reference
(module-level functions under `functools.partial`), so no backend needs
cloudpickle.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Type, Union

from ..parallel.mesh import MeshSpec

#: how long a backend's teardown may take on the ranks before they are
#: killed all the same
TEARDOWN_TIMEOUT_S = 30.0


@dataclasses.dataclass
class BackendConfig:
    @property
    def backend_cls(self) -> Type["Backend"]:
        return Backend


class Backend:
    """Hooks run by the BackendExecutor around the training lifecycle.
    ``on_start``/``on_shutdown`` run in the trainer's process;
    ``worker_setup_fn`` returns a function executed ON EACH WORKER before
    the train loop."""

    def __init__(self, config: BackendConfig):
        self.config = config

    def on_start(self, worker_group, executor) -> None:
        pass

    def worker_setup_fn(self, executor):
        return None

    def on_shutdown(self, worker_group, executor) -> None:
        pass


@dataclasses.dataclass
class SpmdConfig(BackendConfig):
    """One process group over the gang and a mesh spanning it."""

    mesh: Union[MeshSpec, str, None] = None   # "dp=2,tp=4" gang layout
    timeout_s: float = 120.0

    @property
    def backend_cls(self):
        return _SpmdBackend


def _join_gang(group_name: str, world_size: int,
               spec: Optional[MeshSpec], timeout_s: float) -> None:
    """On a rank: join the gang's process group and put its mesh on the
    session."""
    from ..air import session
    from ..parallel.coordinator import join_mesh_gang
    from ..util import tracing
    s = session._get_session()
    # rendezvous span: gang-join stalls (a slow peer) show up on the
    # timeline per rank
    with tracing.span(f"train_rendezvous::{group_name}", "train",
                      rank=s.world_rank, world_size=world_size):
        s.mesh = join_mesh_gang(group_name, world_size, rank=s.world_rank,
                                timeout_s=timeout_s, spec=spec,
                                device=s.device.type)


def _leave_gang(group_name: str) -> None:
    from ..parallel.coordinator import leave_mesh_gang
    leave_mesh_gang(group_name)


class _SpmdBackend(Backend):
    def worker_setup_fn(self, executor):
        mesh = self.config.mesh
        spec = MeshSpec.parse(mesh) if isinstance(mesh, str) else mesh
        return functools.partial(_join_gang, f"train_gang_{executor.run_id}",
                                 executor.num_workers, spec,
                                 self.config.timeout_s)

    def on_shutdown(self, worker_group, executor) -> None:
        worker_group.execute(
            functools.partial(_leave_gang, f"train_gang_{executor.run_id}"),
            timeout=TEARDOWN_TIMEOUT_S)


@dataclasses.dataclass
class HostArrayConfig(BackendConfig):
    """Host-side collective backend: a store per gang attempt,
    `train.host_collective` on the ranks, no process group."""

    @property
    def backend_cls(self):
        return _HostArrayBackend


def _join_host_store(host: str, port: int, prefix: str,
                     world_size: int) -> None:
    """On a rank: connect to the trainer's store and hand it to
    `host_collective` with this rank's place in the gang."""
    from datetime import timedelta

    import torch.distributed as dist

    from ..air import session
    from . import host_collective
    store = dist.TCPStore(host, port, is_master=False,
                          timeout=timedelta(seconds=120))
    host_collective._set_store(store, prefix, world_size,
                               session.get_world_rank())


class _HostArrayBackend(Backend):
    def on_start(self, worker_group, executor) -> None:
        import uuid
        from datetime import timedelta

        import torch.distributed as dist

        from ..parallel.coordinator import _free_port
        self._port = _free_port()
        self._store = dist.TCPStore(
            executor.shared_env["master_addr"], self._port, is_master=True,
            wait_for_workers=False, timeout=timedelta(seconds=120))
        self._prefix = f"host_collective/{executor.run_id}-" \
                       f"{uuid.uuid4().hex[:8]}"

    def worker_setup_fn(self, executor):
        return functools.partial(
            _join_host_store, executor.shared_env["master_addr"], self._port,
            self._prefix, executor.num_workers)

    def on_shutdown(self, worker_group, executor) -> None:
        self._store = None
