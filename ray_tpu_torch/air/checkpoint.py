"""Checkpoint: dict ⇄ directory ⇄ bytes (counterpart of the dict-backed
half of ``ray_tpu/air/checkpoint.py``).

Dict checkpoints pickle; a fitted preprocessor rides along
(`with_preprocessor`).  The sharded save of a tree of tensors (the JAX
package's ``from_pytree`` / ``to_pytree``) comes with the next slice of the
distributed training pieces.
"""

from __future__ import annotations

import io
import os
import pickle
import shutil
import tarfile
import tempfile
from typing import Any, Dict, Optional

_DICT_FILE = "checkpoint.pkl"


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

    @property
    def path(self) -> Optional[str]:
        return self._path

    def __repr__(self):
        src = self._path if self._path else f"dict[{len(self._data)} keys]"
        return f"Checkpoint({src})"
