"""Checkpoint: dict ⇄ directory ⇄ bytes, and sharded trees of tensors
(counterpart of ``ray_tpu/air/checkpoint.py``).

Dict checkpoints pickle; a fitted preprocessor rides along
(`with_preprocessor`).  `from_pytree` / `to_pytree` save and restore a tree
of tensors with `torch.distributed.checkpoint` (DCP), where the JAX package
uses orbax: each rank writes only its own shards of a DTensor, and a
restore lands on whatever placements the target carries, another mesh
included (the cross-topology resume).  Each save commits into a fresh
numbered ``pytree-NNNNNN`` directory (written under a temporary name, then
renamed by rank 0 between two barriers of the gang's process group); the
newest save wins.  DCP flattens keys, so a small sidecar in each save keeps
the tree's nesting and its non-tensor leaves.
"""

from __future__ import annotations

import contextlib
import io
import os
import pickle
import shutil
import tarfile
import tempfile
import uuid
import warnings
from typing import Any, Dict, Optional, Tuple

_DICT_FILE = "checkpoint.pkl"
_PYTREE_DIR = "pytree"
_TREE_FILE = "tree.pkl"


def _pytree_saves(path: str) -> list:
    """Committed pytree save dirs under ``path``, oldest → newest (a save
    is renamed into place when complete, so presence means complete)."""
    try:
        names = os.listdir(path)
    except OSError:
        return []
    out = [n for n in names
           if n == _PYTREE_DIR
           or (n.startswith(_PYTREE_DIR + "-") and
               n[len(_PYTREE_DIR) + 1:].isdigit())]
    return sorted(out)


def _next_pytree_dir(path: str) -> str:
    saves = _pytree_saves(path)
    nums = [int(n[len(_PYTREE_DIR) + 1:]) for n in saves
            if n != _PYTREE_DIR]
    nxt = (max(nums) + 1) if nums else (1 if saves else 0)
    return f"{_PYTREE_DIR}-{nxt:06d}"


def _latest_pytree_dir(path: str):
    saves = _pytree_saves(path)
    if not saves:
        return None
    return os.path.join(path, saves[-1])


class _Leaf:
    """Where an array leaf of a saved tree sits: its key in the DCP state
    dict, and whether it was a numpy array."""

    def __init__(self, key: str, numpy: bool):
        self.key = key
        self.numpy = numpy


def _rebuild(node, items):
    if hasattr(node, "_fields"):          # a namedtuple
        return type(node)(*items)
    return type(node)(items)


def _split(tree) -> Tuple[Any, Dict[str, Any]]:
    """The tree's skeleton (array leaves as `_Leaf`s; scalars, strings and
    None kept) and its array leaves by key: a tensor or DTensor as it is, a
    numpy array as a tensor on its memory."""
    import numpy as np
    import torch
    flat: Dict[str, Any] = {}

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return _rebuild(node, [walk(v, path + (i,))
                                   for i, v in enumerate(node)])
        if isinstance(node, (torch.Tensor, np.ndarray)):
            key = "/".join(map(str, path)) or "_"
            if key in flat:
                raise ValueError(f"two leaves of the tree map to {key!r}")
            numpy = isinstance(node, np.ndarray)
            flat[key] = torch.from_numpy(np.ascontiguousarray(node)) \
                if numpy else node
            return _Leaf(key, numpy)
        return node

    return walk(tree, ()), flat


def _join(skeleton, flat: Dict[str, Any]):
    """``skeleton`` with each `_Leaf` replaced by its tensor of ``flat`` (a
    numpy array where the saved leaf was one)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return _rebuild(node, [walk(v) for v in node])
        if isinstance(node, _Leaf):
            if node.key not in flat:
                raise ValueError(f"the target has no leaf at {node.key!r}")
            t = flat[node.key]
            return t.cpu().numpy() if node.numpy else t
        return node

    return walk(skeleton)


@contextlib.contextmanager
def _quiet_dcp():
    """DCP warns on every call in a single process that it assumes one."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message="torch.distributed is disabled")
        yield


def _gang_size() -> int:
    """Ranks of this process's gang: its process group's, or the Train
    session's where there is no group."""
    import torch.distributed as dist

    from . import session
    world = dist.get_world_size() if dist.is_initialized() else 1
    s = session._get_session()
    return max(world, s.world_size if s is not None else 1)


class Checkpoint:
    """Immutable handle on checkpoint data, either in memory or on disk."""

    def __init__(self, *, _data: Optional[Dict[str, Any]] = None,
                 _path: Optional[str] = None):
        if (_data is None) == (_path is None):
            raise ValueError("exactly one of data dict or path required")
        self._data = _data
        self._path = _path

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(_data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"not a directory: {path}")
        return cls(_path=os.path.abspath(path))

    @classmethod
    def from_pytree(cls, tree: Any, path: Optional[str] = None
                    ) -> "Checkpoint":
        """Save a tree (dicts, lists, tuples) of tensors, DTensors, numpy
        arrays and scalars with DCP.  Every rank of a gang calls it with the
        same ``path`` (on a filesystem they share); each writes only its own
        shards.  A save never overwrites: it commits into a fresh numbered
        ``pytree-NNNNNN`` under ``path`` (a temporary name, a barrier, rank
        0's rename, a barrier), so a retried or resumed run can save to the
        same ``path`` again."""
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp
        if path is None and _gang_size() > 1:
            raise ValueError(
                "a gang's from_pytree needs an explicit path on a SHARED "
                "filesystem (every rank must save into the same directory "
                "for its shard writers to commit together)")
        path = os.path.abspath(path or tempfile.mkdtemp(
            prefix="ray_tpu_torch_ckpt_"))
        os.makedirs(path, exist_ok=True)
        final = os.path.join(path, _next_pytree_dir(path))
        gang = dist.is_initialized() and dist.get_world_size() > 1
        lead = not gang or dist.get_rank() == 0
        # ranks of one group agree on the temporary name; a lone process
        # gets its own, so two saving into one path fail at the rename
        tmp = final + (".tmp" if gang else f".tmp-{uuid.uuid4().hex[:8]}")
        skeleton, flat = _split(tree)
        if lead:
            shutil.rmtree(tmp, ignore_errors=True)   # a dead attempt's
        if gang:
            dist.barrier()
        with _quiet_dcp():
            dcp.save(flat, storage_writer=dcp.FileSystemWriter(tmp),
                     no_dist=not gang)
        if lead:
            with open(os.path.join(tmp, _TREE_FILE), "wb") as f:
                pickle.dump(skeleton, f)
        if gang:
            dist.barrier()
        if lead:
            os.rename(tmp, final)
        if gang:
            dist.barrier()
        return cls.from_directory(path)

    def to_pytree(self, target: Any = None, *, device=None) -> Any:
        """Restore the newest tree saved with :meth:`from_pytree`.

        With ``target``, a tree of the same shape, its tensors and DTensors
        are loaded in place and returned: they decide devices and
        placements, another mesh than the save's included (cross-topology
        resume).  Without one, every array comes back whole on ``device``
        (the card by default; without CUDA pass ``device="cpu"``), a saved
        numpy array as numpy on the host.  Non-tensor leaves come from the
        save."""
        import torch
        import torch.distributed.checkpoint as dcp
        item = None if self._path is None else \
            _latest_pytree_dir(self._path)
        if item is None:
            # dict checkpoints never hold a pytree dir
            raise ValueError("checkpoint holds no pytree "
                             "(was it saved with from_pytree?)")
        with open(os.path.join(item, _TREE_FILE), "rb") as f:
            skeleton = pickle.load(f)
        reader = dcp.FileSystemReader(item)
        if target is None:
            from ..device import resolve_device
            dev = resolve_device(device)
            meta = reader.read_metadata().state_dict_metadata
            flat = {k: torch.empty(m.size, dtype=m.properties.dtype,
                                   device=dev) for k, m in meta.items()}
        else:
            _, flat = _split(target)
        with _quiet_dcp():
            dcp.load(flat, storage_reader=reader, no_dist=True)
        return _join(skeleton, flat)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "Checkpoint":
        """A checkpoint from `to_bytes` output (unpickled: pass only bytes
        this program wrote)."""
        obj = pickle.loads(blob)
        if isinstance(obj, dict) and obj.get("__ckpt_kind__") == "tar":
            tmp = tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
            with tarfile.open(fileobj=io.BytesIO(obj["tar"])) as tf:
                tf.extractall(tmp, filter="data")
            return cls.from_directory(tmp)
        return cls.from_dict(obj)

    # -- conversions --------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return dict(self._data)
        fp = os.path.join(self._path, _DICT_FILE)
        if os.path.exists(fp):
            with open(fp, "rb") as f:
                return pickle.load(f)
        # a generic directory: a special key holding the file map
        out: Dict[str, Any] = {}
        for root, _, files in os.walk(self._path):
            for name in files:
                full = os.path.join(root, name)
                rel = os.path.relpath(full, self._path)
                with open(full, "rb") as f:
                    out[rel] = f.read()
        return {"__files__": out}

    def to_directory(self, path: Optional[str] = None) -> str:
        path = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(path, exist_ok=True)
        if self._path is not None:
            if os.path.abspath(path) != self._path:
                shutil.copytree(self._path, path, dirs_exist_ok=True)
            return path
        data = self._data
        if "__files__" in data:
            for rel, blob in data["__files__"].items():
                full = os.path.join(path, rel)
                os.makedirs(os.path.dirname(full) or path, exist_ok=True)
                with open(full, "wb") as f:
                    f.write(blob)
        else:
            with open(os.path.join(path, _DICT_FILE), "wb") as f:
                pickle.dump(data, f)
        return path

    def to_bytes(self) -> bytes:
        if self._data is not None:
            return pickle.dumps(self._data)
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tf:
            tf.add(self._path, arcname=".")
        return pickle.dumps({"__ckpt_kind__": "tar", "tar": buf.getvalue()})

    # -- preprocessor attachment --------------------------------------------
    _PREPROCESSOR_KEY = "_preprocessor"
    _PREPROCESSOR_FILE = "preprocessor.pkl"

    def with_preprocessor(self, preprocessor: Any) -> "Checkpoint":
        """Attach a fitted preprocessor (the trainer attaches its own to
        every checkpoint it registers, so inference applies the same
        transforms).  Dict checkpoints return a NEW checkpoint; directory
        checkpoints attach IN PLACE (a ``preprocessor.pkl`` sidecar next to
        the payload) and return self.  The preprocessor pickles by
        reference, by value through cloudpickle where it must
        (`core.actors.dumps_function`)."""
        from ..core.actors import dumps_function
        blob = dumps_function(preprocessor)
        if self._data is not None:
            data = dict(self._data)
            data[self._PREPROCESSOR_KEY] = blob
            return Checkpoint.from_dict(data)
        with open(os.path.join(self._path, self._PREPROCESSOR_FILE),
                  "wb") as f:
            f.write(blob)
        return self

    def get_preprocessor(self) -> Optional[Any]:
        if self._data is not None:
            blob = self._data.get(self._PREPROCESSOR_KEY)
            if blob is None:
                # a directory checkpoint shipped via to_dict carries the
                # sidecar in its file map
                blob = self._data.get("__files__", {}).get(
                    self._PREPROCESSOR_FILE)
            return pickle.loads(blob) if blob is not None else None
        fp = os.path.join(self._path, self._PREPROCESSOR_FILE)
        if os.path.exists(fp):
            with open(fp, "rb") as f:
                return pickle.loads(f.read())
        # a dict checkpoint persisted to a directory (CheckpointManager)
        # carries the key inside checkpoint.pkl, not as a sidecar
        dp = os.path.join(self._path, _DICT_FILE)
        if os.path.exists(dp):
            with open(dp, "rb") as f:
                blob = pickle.load(f).get(self._PREPROCESSOR_KEY)
            if blob is not None:
                return pickle.loads(blob)
        return None

    def _to_wire(self):
        """How the checkpoint crosses between the trainer and a rank: a
        directory by its path (every rank runs on the trainer's host, and a
        sharded save may be many GB), a dict as `to_bytes`."""
        return {"path": self._path} if self._path is not None \
            else self.to_bytes()

    @classmethod
    def _from_wire(cls, wire) -> "Checkpoint":
        if isinstance(wire, dict):
            return cls.from_directory(wire["path"])
        return cls.from_bytes(wire)

    @property
    def path(self) -> Optional[str]:
        return self._path

    def __repr__(self):
        src = self._path if self._path else f"dict[{len(self._data)} keys]"
        return f"Checkpoint({src})"
