"""Device meshes with canonical parallelism axes (counterpart of
``ray_tpu/parallel/mesh.py``).

The JAX package lays all devices out as one `jax.sharding.Mesh`; here the
same six named axes name the dimensions of a
`torch.distributed.device_mesh.DeviceMesh` over the process group's ranks,
one rank a device:

  ``dp``    pure data parallelism (gradients summed over it)
  ``fsdp``  data parallelism with parameters and optimizer state sharded
  ``pp``    pipeline stages (`parallel.pipeline`)
  ``sp``    sequence parallelism (`ops.ring_attention`)
  ``tp``    tensor parallelism (weights sharded; the products gather them)
  ``ep``    expert parallelism (expert weights sharded)

Ranks are laid out row-major in that order, as the JAX package reshapes its
device list, so rank r holds what JAX's device r holds.  `use_mesh` sets
the ambient mesh the attention dispatch, the pipeline and the train step
read (`current_mesh`), the counterpart of ``jax.set_mesh``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

MESH_AXES: Tuple[str, ...] = ("dp", "fsdp", "pp", "sp", "tp", "ep")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named axis sizes; -1 on at most one axis means "absorb the rest"."""

    dp: int = 1
    fsdp: int = -1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    def sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in MESH_AXES}

    def resolve(self, n_devices: int) -> Dict[str, int]:
        """Fill the -1 axis so the product equals ``n_devices``."""
        sizes = self.sizes()
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed} ({sizes})")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh spec {sizes} wants {fixed} devices, have {n_devices}")
        return sizes

    @staticmethod
    def parse(text: str) -> "MeshSpec":
        """Parse ``"dp=2,tp=4"`` style strings (CLI / config surface)."""
        kwargs = {}
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            axis, _, val = part.partition("=")
            if axis not in MESH_AXES:
                raise ValueError(f"unknown mesh axis {axis!r}")
            kwargs[axis] = int(val)
        return MeshSpec(**kwargs)


def auto_mesh_shape(n_devices: int, model_parallel: int = 1) -> MeshSpec:
    """Heuristic layout: ``model_parallel`` on tp (innermost), the
    remainder on fsdp."""
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"model_parallel={model_parallel} must divide {n_devices}")
    return MeshSpec(dp=1, fsdp=n_devices // model_parallel, tp=model_parallel)


def mesh_shape_for(spec: MeshSpec, n_devices: int) -> Tuple[int, ...]:
    sizes = spec.resolve(n_devices)
    return tuple(sizes[a] for a in MESH_AXES)


def _ensure_group(device_type: str) -> None:
    """A one-rank process group on a local store when none is up yet: the
    world of a single process needs no rendezvous."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def create_mesh(spec: Optional[MeshSpec] = None, *,
                drop_trivial_axes: bool = False,
                device: Optional[str] = None) -> DeviceMesh:
    """A `DeviceMesh` with the canonical axes over the process group's
    ranks, laid out row-major in `MESH_AXES` order.  ``device`` is
    ``"cuda"`` (NCCL, the default) or ``"cpu"`` (gloo); each rank's card
    is ``cuda:<local rank>``.  With no process group up, a one-rank group
    starts on a local store."""
    device = device or "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_mesh on CUDA and no CUDA device is "
                           "available; pass device='cpu' for gloo")
    _ensure_group(device)
    spec = spec or MeshSpec()
    sizes = spec.resolve(dist.get_world_size())
    axes = MESH_AXES
    if drop_trivial_axes:
        axes = tuple(a for a in MESH_AXES if sizes[a] > 1) or ("dp",)
    shape = tuple(sizes[a] for a in axes)
    ranks = torch.arange(dist.get_world_size()).reshape(shape)
    return DeviceMesh(device, ranks, mesh_dim_names=axes)


def local_mesh(*, device: Optional[str] = None, **axis_sizes: int
               ) -> DeviceMesh:
    """Mesh over every rank of the group, e.g. ``local_mesh(tp=4)``; an
    unlisted size defaults to fsdp absorbing the remainder."""
    spec = MeshSpec(**axis_sizes) if axis_sizes else MeshSpec()
    return create_mesh(spec, device=device)


def slice_topology() -> Dict[str, object]:
    """Describe the cards the group spans: platform, kind and counts."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    info: Dict[str, object] = {
        "platform": "gpu" if torch.cuda.is_available() else "cpu",
        "device_count": world,
        "local_device_count": (torch.cuda.device_count()
                               if torch.cuda.is_available() else 0),
        "process_count": world,
    }
    if torch.cuda.is_available():
        info["device_kind"] = torch.cuda.get_device_name(0)
    return info


def pick_divisor_shape(n: int, ndim: int = 2) -> List[int]:
    """Factor ``n`` into ``ndim`` near-equal factors (largest last), used for
    default 2D sp×tp layouts."""
    shape = [1] * ndim
    rem = n
    for i in range(ndim - 1):
        f = int(math.isqrt(rem))
        while f > 1 and rem % f:
            f -= 1
        shape[i] = f
        rem //= f
    shape[-1] = rem
    return shape


# -- the ambient mesh ----------------------------------------------------------

_AMBIENT: List[DeviceMesh] = []


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """Make ``mesh`` the ambient mesh inside the block (``jax.set_mesh``)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh() -> Optional[DeviceMesh]:
    """The innermost `use_mesh` mesh, or None outside any."""
    return _AMBIENT[-1] if _AMBIENT else None


_SIZES: "weakref.WeakKeyDictionary[DeviceMesh, Dict[str, int]]" = \
    weakref.WeakKeyDictionary()


def axis_sizes(mesh: Optional[DeviceMesh]) -> Dict[str, int]:
    """{axis name: size} of ``mesh`` ({} for None), kept per mesh: reading
    ``DeviceMesh.mesh`` builds a tensor (tens of µs a call)."""
    if mesh is None:
        return {}
    sizes = _SIZES.get(mesh)
    if sizes is None:
        sizes = _SIZES[mesh] = dict(zip(mesh.mesh_dim_names,
                                        mesh.mesh.shape))
    return sizes


def axis_size(axis: str, mesh: Optional[DeviceMesh]) -> int:
    """The size of ``axis`` on ``mesh``; 1 where the mesh lacks it or
    ``mesh`` is None.  The mesh is always given: no ambient default."""
    return axis_sizes(mesh).get(axis, 1)
