"""Multi-step dispatch: `steps_per_call` train steps or eval batches a host
call. Counterpart: `map_tpu/train/train_step.py:33-50 make_multi_step`,
`:90-112 make_resident_step / make_resident_multi_step` and `:114-143
make_multi_eval` (a `lax.scan` of the step over a stacked batch in one
jitted dispatch), as `map_tpu/train/trainer.py:515-533 _run_train_step` and
`:464-482 _eval_dispatch` call them.

`GraphedCalls` is the dispatch; `MultiStep` (train steps: the optimizer's
scalar rows below) and `MultiEval` (eval batches: forward only) are its two
kinds. What follows is said of train steps; an eval call is the same with
no optimizer state, its generator (the MFP and RFD evals' draws)
registered as the steps' are.

The torch counterpart of one fused dispatch is a CUDA graph. `MultiStep`
takes a group of n batches stacked on a leading axis (`Batcher.epoch_stacked`
on the device: host or index batches) and returns the steps' metrics
stacked the same way, each step's in row j of a (n, ...) tensor:

- On the card, with steps_per_call K > 1: the first call runs its steps
  eagerly on a side stream (the warm-up PyTorch asks for before a capture:
  lazy handles, plan caches); they are the run's first steps, not extra
  ones. A call of n steps then captures, once for each n (K, and 1 for an
  epoch's tail), the whole n steps (forward, backward, `AdamW.step`) with
  `torch.cuda.graph` into a graph of its own private pool: its inputs are
  static (n, ...) buffers, step j reads row j and its optimizer update reads
  scalar slot j (`AdamW.reserve`), its metrics are stacked into static
  outputs. Every call copies its group into the inputs, writes the n steps'
  scalars (`AdamW.begin`: one copy from pinned memory), replays the graph
  (one host call for the n steps' kernels: no Python, autograd or
  allocator work), moves the optimizer's host state on (`AdamW.advance`)
  and returns copies of the outputs. K steps in one graph rather than one
  step replayed K times: the scalars and the batch numbers of a call go
  over in one copy each, and a call is one replay.
- The step's generators (the MFP / RFD draws, dropout) are registered with
  each graph (`register_generator_state`), so a replay draws from where the
  generator stands and moves it on: replays do not repeat draws.
- The model's buffers are state the graph writes in place, as it writes
  the parameters: FGCNN's BatchNorm running statistics move on every
  replayed step, as on every eager one.
- A capture that fails raises; nothing runs eagerly in its place on the card.
- With K = 1 on the card, or on the CPU, a call runs its n steps eagerly,
  one by one: the plain path, which gives the same results as n single
  steps.

The kernels' wrappers count a launch where they launch, and a captured
launch is counted once, at the capture. `captured` (the launches the
captures counted, which did not run then) and `replayed` (each graph's
launches times its replays) turn the counters into the launches that ran:
`counters - captured + replayed` (`launches_run`).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional

import torch

from map_tpu_torch.train.optimizer import AdamW

Metrics = Dict[str, torch.Tensor]

# Held by a capture, and by the input pipeline's copy thread around its CUDA
# work: a capture forbids other threads calls that may synchronize (the
# pinned allocator queries events), so the copies wait while it runs.
CUDA_WORK = threading.Lock()


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter."""
    from map_tpu_torch.ops import (
        cross,
        embedding,
        field_gather,
        fused_adamw,
        scan,
        scatter,
        scatter_unique,
        sparse_adamw,
    )

    return {"embedding_gather": embedding.launches, "cross_net": cross.launches,
            "fused_adamw": fused_adamw.launches, "scatter_add": scatter.launches,
            "scatter_unique_sorted": scatter_unique.launches,
            "block_cumsum": scan.launches, "sparse_adamw": sparse_adamw.launches,
            "field_block_gather": field_gather.gather_launches,
            "field_block_scatter": field_gather.scatter_launches}


def _stack(outs: List[Metrics]) -> Metrics:
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _row(batch: Dict[str, torch.Tensor], j: int) -> Dict[str, torch.Tensor]:
    return {k: v[j] for k, v in batch.items()}


class _Captured:
    def __init__(self, graph: torch.cuda.CUDAGraph, inputs: Dict[str, torch.Tensor],
                 outputs: Metrics, launches: Dict[str, int]):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches  # the kernels' launches of one replay
        self.replays = 0


class GraphedCalls:
    """n calls of `step` a host call, each on row j of a batch stacked (n,
    ...), their outputs stacked the same way: a captured CUDA graph a call
    on the card with K > 1 (after one eager warm-up call on a side stream),
    the calls one by one otherwise. `MultiStep` and `MultiEval` are its
    two kinds; `_begin`, `_advance` and `_capture_calls` are where a train
    step's optimizer state comes in."""

    def __init__(self, step: Callable[[Dict[str, torch.Tensor]], Metrics],
                 steps_per_call: int, device: torch.device,
                 generators: Iterable[Optional[torch.Generator]] = ()):
        self.step = step
        self.k = max(1, int(steps_per_call))
        self.device = torch.device(device)
        self.generators = [g for g in generators if g is not None]
        self.graphed = self.device.type == "cuda" and self.k > 1
        self.graphs: Dict[int, _Captured] = {}
        self.warmed = False
        self.captured: Dict[str, int] = {}

    def __call__(self, n: int, batch: Dict[str, torch.Tensor]) -> Metrics:
        """n > 1 calls of a batch stacked (n, ...), or one call of an
        unstacked batch -> their outputs, stacked (n, ...)."""
        if n == 1:
            batch = {k: v.unsqueeze(0) for k, v in batch.items()}
        if not self.graphed:
            return self._eager(n, batch)
        if not self.warmed:
            return self._warm_up(n, batch)
        g = self.graphs.get(n)
        if g is None:
            g = self.graphs[n] = self._capture(n, batch)
        for k, v in batch.items():
            g.inputs[k].copy_(v)
        self._begin(n)
        g.graph.replay()
        self._advance(n)
        g.replays += 1
        return {k: v.clone() for k, v in g.outputs.items()}

    def _begin(self, n: int) -> None:
        """Before a replay of n calls."""

    def _advance(self, n: int) -> None:
        """After a replay of n calls."""

    def _capture_calls(self, n: int, inputs: Dict[str, torch.Tensor]) -> Metrics:
        """The n calls, under capture."""
        return _stack([self.step(_row(inputs, j)) for j in range(n)])

    def _eager(self, n: int, batch: Dict[str, torch.Tensor]) -> Metrics:
        outs = [self.step(_row(batch, j)) for j in range(n)]
        if n == 1:  # a view, as the one-call batch is
            return {k: v.unsqueeze(0) for k, v in outs[0].items()}
        return _stack(outs)

    def _warm_up(self, n: int, batch: Dict[str, torch.Tensor]) -> Metrics:
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._eager(n, batch)
        main.wait_stream(side)
        self.warmed = True
        return out

    def _capture(self, n: int, batch: Dict[str, torch.Tensor]) -> _Captured:
        inputs = {k: torch.empty_like(v) for k, v in batch.items()}
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = launch_counts()
        with CUDA_WORK, torch.cuda.graph(graph):
            outputs = self._capture_calls(n, inputs)
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        for k, v in launches.items():
            self.captured[k] = self.captured.get(k, 0) + v
        return _Captured(graph, inputs, outputs, launches)

    def replayed(self) -> Dict[str, int]:
        """The launches the replays ran, by kernel."""
        out: Dict[str, int] = {}
        for g in self.graphs.values():
            for k, v in g.launches.items():
                out[k] = out.get(k, 0) + v * g.replays
        return out

    def launches_run(self, counts: Dict[str, int]) -> Dict[str, int]:
        """The launches that ran, from the wrappers' counters `counts` (taken
        from 0 before this object's first call, with no other object's
        captures among them)."""
        return launches_run(counts, [self])


def launches_run(counts: Dict[str, int], owners: Iterable[GraphedCalls]) -> Dict[str, int]:
    """The launches that ran, from the wrappers' counters `counts` (taken
    from 0 before the first call of any of `owners`, whose captures are all
    the captures among them): counts - captured + replayed."""
    out = dict(counts)
    for o in owners:
        replayed = o.replayed()
        for k in out:
            out[k] += replayed.get(k, 0) - o.captured.get(k, 0)
    return out


class MultiStep(GraphedCalls):
    """`steps_per_call` train steps a call: the optimizer's scalar rows for
    the n steps are reserved under capture, written before each replay
    (`AdamW.begin`) and its host state moved on after (`AdamW.advance`)."""

    def __init__(self, step: Callable[[Dict[str, torch.Tensor]], Metrics],
                 steps_per_call: int, optimizer: AdamW, device: torch.device,
                 generators: Iterable[Optional[torch.Generator]] = ()):
        super().__init__(step, steps_per_call, device, generators)
        self.optimizer = optimizer

    def _begin(self, n: int) -> None:
        self.optimizer.begin(n)

    def _advance(self, n: int) -> None:
        self.optimizer.advance(n)

    def _capture_calls(self, n: int, inputs: Dict[str, torch.Tensor]) -> Metrics:
        count = self.optimizer.count
        self.optimizer.reserve(n)
        try:
            return super()._capture_calls(n, inputs)
        finally:
            self.optimizer.rewind(count)


class MultiEval(GraphedCalls):
    """`steps_per_call` eval batches a call (map_tpu `make_multi_eval`): the
    eval step, forward only, reads the parameters and buffers the training
    graphs write in place; its generator (the MFP and RFD evals' draws) is
    registered with each graph, so a grouped pass draws what the eager one
    does, batch after batch."""
