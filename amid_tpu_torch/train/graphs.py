"""CUDA graphs of the trainer's step kinds — what `jax.jit` plus `lax.scan`
give the JAX package's fast loops (`amid_tpu/train/steps.py::
make_resident_chunk_runner`, `make_scanned_eval`): the host launches a
step's ~800 kernels once, at capture, and from then on one graph a step.

`StepGraph(body, generators, pool)` is one step kind. `body()` runs one step
whose inputs all lie in device memory that stays put (the resident dataset,
the step's index in a device scalar, the model's parameters and optimizer
state, updated in place) and returns its outputs. Its calls:

1. the first call runs `body()` eagerly, on the pool's side stream: a real
   step, which also leaves every lazily made thing (the kernels' libraries,
   their shared-memory opt-ins, cuBLAS's workspace for that stream) made
   before a capture;
2. the second call captures `body()` on the same stream into a
   `torch.cuda.CUDAGraph` (nothing runs), with the step's generators
   registered, then replays it;
3. every later call replays it.

A replay runs the step the capture recorded, with the values its inputs hold
at the replay. The caller sets them before each call: the step's index
(a fill of a device scalar) and the generators' seeds (`StepRandom.reseed`,
host-side: a registered generator's seed and offset are copied into device
memory at each replay, so a replay after `reseed(k)` draws what an eager
step after `reseed(k)` draws). The outputs are the same tensors at every
replay: a caller that keeps a value past the next call clones it.

The launch counts (`ops/launches.py`) move at capture only; each replay adds
what the capture counted.

`GraphPool` holds what the step kinds of one trainer run share: one memory
pool (the graphs never run at once, and every graph's outputs stay alive as
long as the graph), one side stream, and the graphs, which `close()`
releases. Capture or replay failing raises: there is no eager fallback. A
failed capture names the fast loops' flags (`fast_train`, `fast_eval`):
on a mesh the capture holds the steps' NCCL collectives
(`parallel/distributed.py` prepares the process group for it), and a torch
that refuses to capture them must not leave a mesh run on the per-step loop
unnoticed.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from amid_tpu_torch.ops import launches


class GraphPool:
    """The memory pool, side stream and graphs of one trainer run."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device; got {self.device}")
        self.handle = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.graphs: list[StepGraph] = []

    def close(self) -> None:
        """Releases every graph of the pool and its memory."""
        for g in self.graphs:
            g.release()
        self.graphs.clear()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()


class StepGraph:
    """One step kind: eager first call, capture at the second, then replays."""

    def __init__(self, body: Callable[[], object], generators: Sequence[torch.Generator],
                 pool: GraphPool) -> None:
        self.body = body
        self.generators = tuple(generators)
        self.pool = pool
        self.graph = None
        self.out = None
        self.calls = 0
        self.replays = 0
        self.captured: dict[str, int] = {}  # kernel launches in one replay, by kernel
        pool.graphs.append(self)

    def __call__(self):
        self.calls += 1
        if self.calls == 1:
            return self._eager()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        launches.add(self.captured)
        return self.out

    def _eager(self):
        side = self.pool.stream
        side.wait_stream(torch.cuda.current_stream(self.pool.device))
        with torch.cuda.stream(side):
            out = self.body()
        # once a kind: the step's results are read on the current stream
        torch.cuda.synchronize(self.pool.device)
        return out

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = launches.read()
        try:
            with torch.cuda.graph(graph, pool=self.pool.handle, stream=self.pool.stream):
                out = self.body()
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing a step of the fast loops as a CUDA graph failed ({e}); "
                "train with fast_train=False and fast_eval=False (--fast_train False "
                "--fast_eval False) to take the per-step loop") from e
        self.captured = launches.since(before)
        # the capture launched nothing on the device
        launches.add({k: -n for k, n in self.captured.items()})
        self.graph, self.out = graph, out

    def release(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.out = None
