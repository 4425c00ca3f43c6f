"""A background checkpoint writer: serialization (and, with
`async_checkpoint_fetch`, the device-to-host copy) off the training thread.
Counterpart: `map_tpu/train/async_writer.py`.

The writer runs one job at a time: `submit` waits for the job in flight
first, so writes land in order and at most one snapshot is held; every
checkpoint read (load_model, the finetune restore, resume) and the end of
a run wait for it (`wait`), and a job's exception is raised again on the
training thread by the next `wait` or `submit`.

The snapshot is the port's own. K1 and K7 update the parameters and the
moments in place, and a replayed graph does so before the host sees it, so
a job that read the live tensors would save a later step (map_tpu's
reason is donation: its step deletes the arrays it was given).
`snapshot_tensors` copies them on the device, on the compute stream, and
records an event there; `fetch_snapshot`, in the job, waits for that event
and copies to the host on a stream of its own, holding `train/graph.py`'s
`CUDA_WORK` lock so that no capture runs beside its CUDA calls. On the
CPU the copy is the snapshot.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Optional, Tuple

import torch

from map_tpu_torch.train.graph import CUDA_WORK

logger = logging.getLogger(__name__)


def map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """`fn` on every tensor of nested dicts, lists and tuples; other leaves
    (numbers, strings, None) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def host_copy(tree: Any) -> Any:
    """Owned host copies of the tensors of `tree` (on the calling thread)."""
    return map_tensors(lambda t: t.detach().to("cpu", copy=True), tree)


def snapshot_tensors(tree: Any) -> Tuple[Any, Optional[torch.cuda.Event]]:
    """Device copies of the tensors of `tree`, made on the current stream,
    and the event recorded after them (None where nothing is on a card)."""
    snap = map_tensors(lambda t: t.detach().clone(), tree)
    done = None
    if _card(snap) is not None:
        done = torch.cuda.Event()
        done.record()
    return snap, done


def fetch_snapshot(snap: Any, done: Optional[torch.cuda.Event]) -> Any:
    """`snap` on the host, once `done` has passed; for a worker thread."""
    if done is None:
        return snap
    done.synchronize()
    with CUDA_WORK:
        stream = torch.cuda.Stream(_card(snap))
        with torch.cuda.stream(stream):
            out = map_tensors(lambda t: t.to("cpu"), snap)
        stream.synchronize()
    return out


def _card(tree: Any) -> Optional[torch.device]:
    """The device of the first tensor of `tree` on a card, if any."""
    return next((t.device for t in _tensors(tree) if t.is_cuda), None)


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class AsyncCheckpointWriter:
    """One worker thread at a time, depth 1."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def submit(self, job: Callable[[], None], label: str = "checkpoint") -> None:
        """Run `job` on a worker thread, once the job in flight has ended."""
        self.wait()

        def run() -> None:
            try:
                job()
            except BaseException as e:  # raised again on the training thread
                logger.exception(f"async {label} write failed")
                self._exc = e

        self._thread = threading.Thread(target=run, name=f"ckpt-writer-{label}",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the job in flight, if any, and raise its exception."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    @property
    def busy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()
