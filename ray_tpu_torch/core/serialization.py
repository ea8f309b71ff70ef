"""Object serialization: pickle protocol 5 with out-of-band buffers and
zero-copy reads (counterpart of ``ray_tpu/core/serialization.py``).

Objects are pickled with protocol 5; every contiguous buffer the pickler
hands out of band (numpy arrays, tensors' bytes) is carried after the
pickled body, each aligned to 64 bytes, and deserialization gives numpy
arrays back as read-only views into the one buffer it was handed.

The layout: ``_MAGIC``, a little-endian u32 header length, the header (u64
body length, u32 buffer count, a u64 length a buffer; ``struct``, where the
JAX package packs the same table with msgpack), the pickled body, then each
buffer after zero padding to the next 64-byte offset.

Tensor staging (the JAX package stages a ``jax.Array`` through the host and
``jax.device_put``): a `torch.Tensor` travels as its bytes out of band with
its dtype and shape, and comes back on the receiving process's current CUDA
device if it was on CUDA, as a fresh CPU tensor if it was on the CPU.  A
CUDA tensor that arrives in a process without CUDA raises, naming its shape
and dtype: there is no quiet CPU fallback.  A DTensor is refused (send its
``to_local()`` shard or its ``full_tensor()``).  Functions by value are
`core.actors.dumps_function`'s job; the cross-language encoding waits for
the port of the RPC plane.
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
import warnings
from typing import Any, List, Optional

import torch

_MAGIC = b"RTO1"  # ray-tpu object, version 1
_ALIGN = 64

# The JAX package registers its ObjectRef class here so the pickler can
# report refs contained in a value; the port has no object store, so the
# hook stays empty unless a caller registers a class.
_REF_CLASS = None


def register_ref_class(cls) -> None:
    global _REF_CLASS
    _REF_CLASS = cls


def _reduce_tensor(t: torch.Tensor):
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is not None and isinstance(t, dtensor.DTensor):
        raise TypeError("a DTensor does not serialize: send its to_local() "
                        "shard or its full_tensor()")
    host = t.detach().contiguous().cpu()
    raw = host.reshape(-1).view(torch.uint8).numpy()
    return (_restore_tensor,
            (raw, str(host.dtype).removeprefix("torch."), tuple(host.shape),
             t.device.type == "cuda", t.requires_grad,
             isinstance(t, torch.nn.Parameter)))


def _restore_tensor(raw, dtype: str, shape, on_cuda: bool,
                    requires_grad: bool, parameter: bool) -> torch.Tensor:
    dt = getattr(torch, dtype)
    if on_cuda and not torch.cuda.is_available():
        raise RuntimeError(f"a CUDA tensor of shape {tuple(shape)} and dtype "
                           f"{dtype} arrived in a process without CUDA")
    if raw.size == 0:
        out = torch.empty(shape, dtype=dt)
    else:
        with warnings.catch_warnings():
            # a read-only view is only read: it is copied just below
            warnings.simplefilter("ignore", UserWarning)
            flat = torch.from_numpy(raw)
        out = flat.view(dt).reshape(shape)
    if on_cuda:
        out = out.to(torch.device("cuda", torch.cuda.current_device()))
    else:
        out = out.clone()
    if parameter:
        return torch.nn.Parameter(out, requires_grad=requires_grad)
    return out.requires_grad_(requires_grad)


class _Pickler(pickle.Pickler):
    def __init__(self, file, buffer_callback, ref_collector=None):
        super().__init__(file, protocol=5, buffer_callback=buffer_callback)
        self._ref_collector = ref_collector

    def reducer_override(self, obj):
        if self._ref_collector is not None and _REF_CLASS is not None \
                and isinstance(obj, _REF_CLASS):
            self._ref_collector.append(obj.binary())
            return NotImplemented  # fall through to the class's own reduce
        if isinstance(obj, torch.Tensor):
            return _reduce_tensor(obj)
        return NotImplemented


def serialize(value: Any, ref_collector: Optional[list] = None
              ) -> List[memoryview]:
    """``value`` as a list of buffers: header + pickled body + payload
    buffers (with their padding).  The caller concatenates them."""
    buffers: List[pickle.PickleBuffer] = []
    f = io.BytesIO()
    _Pickler(f, buffers.append, ref_collector).dump(value)
    body = f.getvalue()

    raw: List[memoryview] = []
    for pb in buffers:
        m = pb.raw()
        if not m.contiguous:
            m = memoryview(bytes(m))
        raw.append(m)
    sizes = [m.nbytes for m in raw]
    table = struct.pack(f"<QI{len(sizes)}Q", len(body), len(sizes), *sizes)
    header = _MAGIC + struct.pack("<I", len(table)) + table
    out = [memoryview(header), memoryview(body)]
    offset = len(header) + len(body)
    for m in raw:
        pad = (-offset) % _ALIGN
        if pad:
            out.append(memoryview(b"\x00" * pad))
            offset += pad
        out.append(m)
        offset += m.nbytes
    return out


def serialize_to_bytes(value: Any) -> bytes:
    return b"".join(serialize(value))


def deserialize(data) -> Any:
    """``value`` from one contiguous buffer.  Out-of-band buffers come back
    as zero-copy views into ``data``: numpy arrays made here alias it and
    are read-only."""
    data = memoryview(data)
    if bytes(data[:4]) != _MAGIC:
        raise ValueError("corrupt object: bad magic")
    (hlen,) = struct.unpack("<I", data[4:8])
    body_len, n = struct.unpack("<QI", data[8:20])
    sizes = struct.unpack(f"<{n}Q", data[20: 20 + 8 * n])
    off = 8 + hlen
    body = data[off: off + body_len]
    off += body_len
    bufs = []
    for size in sizes:
        off += (-off) % _ALIGN
        bufs.append(data[off: off + size].toreadonly())
        off += size
    return pickle.loads(body, buffers=bufs)
