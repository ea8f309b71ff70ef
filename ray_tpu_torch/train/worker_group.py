"""The training gang: one actor process a rank (counterpart of
``ray_tpu/train/worker_group.py``).

`TrainWorker` hosts one rank; the train function runs on a session thread
so the actor still answers result polls.  `WorkerGroup` starts the gang on
the port's actor layer (`core.actors`: spawned processes, every call
bounded).  There is no placement group: every rank runs on this host.
"""

from __future__ import annotations

import os
import queue
import socket
import threading
from typing import Any, Callable, Dict, List, Optional

from ..core import actors
from ..core.actors import dumps_function, loads_function


class TrainWorker:
    """Actor hosting one rank of the training gang.  The train function
    runs on a session thread so actor methods stay responsive for result
    polling."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._session = None
        self._error: Optional[Exception] = None
        self._finished = False

    def metadata(self) -> Dict[str, Any]:
        return {"hostname": socket.gethostname(), "pid": os.getpid()}

    def execute(self, fn_bytes: bytes, *args, **kwargs):
        return loads_function(fn_bytes)(*args, **kwargs)

    def init_session(self, *, world_rank: int, local_rank: int,
                     world_size: int, node_rank: int,
                     trial_name: str = "train",
                     checkpoint: Any = None,
                     dataset_shard=None, device: Optional[str] = None):
        """``device`` "cpu", or the card (None / "cuda"): this rank computes
        on ``cuda:<local_rank>``."""
        import torch

        from ..air.checkpoint import Checkpoint
        from ..air.session import _Session, _set_session
        if device == "cpu":
            dev = torch.device("cpu")
        else:
            torch.cuda.set_device(local_rank)
            dev = torch.device("cuda", local_rank)
        self._session = _Session(
            world_rank=world_rank, local_rank=local_rank,
            world_size=world_size, node_rank=node_rank,
            trial_name=trial_name, dataset_shard=dataset_shard, device=dev)
        if checkpoint is not None:     # as `Checkpoint._to_wire` gives it
            self._session.last_checkpoint = Checkpoint._from_wire(checkpoint)
        # install on the actor main thread as well: backend setup fns run
        # there (via execute) and need ranks / a place to hang the mesh
        _set_session(self._session)

    def start_training(self, fn_bytes: bytes, config: Dict[str, Any]):
        import inspect

        from ..air.session import _set_session
        train_fn = loads_function(fn_bytes)
        session = self._session

        def run():
            _set_session(session)
            try:
                if inspect.signature(train_fn).parameters:
                    train_fn(config)
                else:
                    train_fn()
            except SystemExit:
                pass
            except Exception as e:  # surfaced via finish()
                self._error = e
            finally:
                session.queue.put(None)  # sentinel: training done

        self._error = None
        self._finished = False
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return True

    def next_result(self, timeout_s: float = 10.0):
        """One queued report (metrics + optional checkpoint, as
        `Checkpoint._to_wire` gives it: a directory by its path), the
        sentinel None when training ended, or "__timeout__".  Completion is
        latched: after the sentinel has been seen once, every later poll
        returns None at once, so a rank that ended early never keeps the
        executor's all-None condition out of reach."""
        if self._finished:
            return None
        try:
            item = self._session.queue.get(timeout=timeout_s)
        except queue.Empty:
            return "__timeout__"
        if item is None:
            self._finished = True
            return None
        ckpt = item.get("checkpoint")
        if ckpt is not None:
            item = dict(item, checkpoint=ckpt._to_wire())
        return item

    def finish(self, timeout_s: float):
        """Join the train thread (within ``timeout_s``); re-raise the train
        function's error with its traceback."""
        if self._thread is not None:
            self._thread.join(timeout_s)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"the train function still runs after {timeout_s} s")
        if self._error is not None:
            import traceback
            raise RuntimeError("train function failed: " + "".join(
                traceback.format_exception(self._error)))
        return True

    def stop_session(self):
        if self._session is not None:
            self._session.stop_event.set()
        return True


class WorkerGroup:
    """N TrainWorker actors, each a spawned process on this host; ``env``
    is applied in each before anything of the rank is imported."""

    def __init__(self, num_workers: int,
                 rank_env: Optional[Dict[str, Any]] = None):
        self.num_workers = num_workers
        actor_cls = actors.remote(TrainWorker).options(env=rank_env or {})
        self.workers: List[actors.ActorHandle] = []
        try:
            for _ in range(num_workers):
                self.workers.append(actor_cls.remote())
        except BaseException:
            self.shutdown()
            raise

    def execute(self, fn: Callable, *args, timeout: float = 600.0,
                **kwargs) -> List[Any]:
        """Run fn on every worker, return per-rank results."""
        blob = dumps_function(fn)
        return actors.get([w.execute.remote(blob, *args, **kwargs)
                           for w in self.workers], timeout)

    def all_alive(self) -> bool:
        return all(w.is_alive() for w in self.workers)

    def shutdown(self):
        for w in self.workers:
            actors.kill(w)
        self.workers = []
