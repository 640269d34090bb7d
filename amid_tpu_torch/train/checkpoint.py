"""Checkpoints of the trainer's state — the counterpart of
`amid_tpu/train/checkpoint.py` (`CheckpointManager`), with `torch.save` /
`torch.load` of flat name -> CPU tensor dictionaries in place of orbax.

A step is one file, `<directory>/<step>.pt`, written under `<step>.pt.tmp`,
flushed to disk and then renamed, so `latest_step()` never reports a step
that is half written. `keep` keeps the `keep` newest steps, as orbax's
`max_to_keep` does. `payload_mode.txt` records the payload on first use; a
manager reopened with another payload raises the JAX package's
`ValueError`.

Payloads, as in the JAX package: "full" (parameters and every optimizer
leaf), "bf16_moments" (the float32 optimizer leaves cast to bfloat16 by
round-to-nearest-even, as `jnp.astype` rounds; the int32 counts as they
are), "params_only" (no optimizer state: `restore` zeroes every moment and
every count, so a roll-back restarts Adam cleanly, never from the moments it
is rolling away).

What differs from the JAX package, because the trainer's tensors are
written in place (the fast loops replay CUDA graphs captured on the
parameters, Adam's `mu`/`nu` and the int32 step counts, `train/graphs.py`):

* `restore(state)` writes the saved values INTO `state`'s own tensors
  (`copy_`: host to device, bfloat16 widened to float32) and returns that
  same object; a new object would leave the graphs reading the old memory.
* `save(step, state)` with `async_save` takes its snapshot before it
  returns: every leaf is copied to host memory (pinned buffers, kept for the
  next save) on the current stream, where the steps and the graphs' replays
  run, and that stream is synchronised. Only then does a background thread,
  which makes no CUDA call, write the file; the next step may overwrite the
  device tensors at once. A second `save` waits for the first, as orbax's
  does, and `restore`, `wait_until_finished` and `close` wait for a save in
  flight and raise what it raised.

On a mesh (`mesh=`, `parallel/mesh.py`) the file is the one a
single-process run writes, leaf for leaf: every rank takes part in
gathering the row-sharded leaves (`parallel.mesh.state_layout`: the table
and its moments) over its `model` group, and rank 0 alone writes (the
directory, the payload mode and the steps). A restore waits for rank 0's
write in flight and meets the other ranks at a barrier; then each rank
reads the file and writes its own rows of each sharded leaf, and the whole
of every other, into its tensors in place.
"""

from __future__ import annotations

import dataclasses
import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

PAYLOADS = ("full", "bf16_moments", "params_only")
_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def state_leaves(state: Any) -> dict[str, torch.Tensor]:
    """Every tensor of a `TrainState` by a flat name: `params/<name>`, then
    the optimizer states' fields (`opt_state/count`, `opt_state/mu/<name>`;
    the lazy table state's `opt_state/dense_opt/mu/<name>`, `opt_state/mu`,
    ...), `opt_state2/...` where there is a second slot."""
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, x: Any) -> None:
        if x is None:
            return
        if isinstance(x, torch.Tensor):
            out[prefix] = x
        elif isinstance(x, Mapping):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(f"{prefix}/{f.name}", getattr(x, f.name))
        else:
            raise TypeError(f"{prefix}: a state leaf must be a tensor, not {type(x).__name__}")

    for name in ("params", "opt_state", "opt_state2"):
        walk(name, getattr(state, name))
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 1, async_save: bool = False,
                 payload: str = "full", mesh=None) -> None:
        if payload not in PAYLOADS:
            raise ValueError(f"payload must be one of {PAYLOADS}: {payload}")
        if keep < 1:
            raise ValueError(f"keep must be at least 1: {keep}")
        self._payload = payload
        self._keep = keep
        self._mesh = mesh
        self._writes = mesh is None or mesh.rank == 0
        self._dir = Path(directory).absolute()
        mode_file = self._dir / "payload_mode.txt"
        if self._writes:
            self._dir.mkdir(parents=True, exist_ok=True)
            if not mode_file.exists():
                mode_file.write_text(payload)
        if mesh is not None:
            dist.barrier()  # the directory and its mode exist for every rank
        # a resume with another payload fails here, not with a missing leaf
        if mode_file.exists():
            saved = mode_file.read_text().strip()
            if saved != payload:
                raise ValueError(
                    f"checkpoint dir {self._dir} was written with "
                    f"payload={saved}; resume with --checkpoint_payload "
                    f"{saved} (got {payload})"
                )
        self._writer = (ThreadPoolExecutor(1, thread_name_prefix="checkpoint")
                        if async_save else None)
        self._pending: Optional[Future] = None
        self._host: dict[str, torch.Tensor] = {}  # pinned snapshot buffers, by leaf

    def _saved_leaves(self, state: Any, whole: bool = False) -> dict[str, torch.Tensor]:
        """The leaves this payload saves, by name (also what `restore`
        expects); with `whole` on a mesh, the row-sharded ones gathered."""
        leaves = state_leaves(state)
        if self._payload == "params_only":
            leaves = {k: v for k, v in leaves.items() if k.startswith("params/")}
        if whole and self._mesh is not None:
            from amid_tpu_torch.parallel.collectives import gather_rows
            from amid_tpu_torch.parallel.mesh import ROWS, state_layout

            m, layout = self._mesh, state_layout(state)
            leaves = {k: gather_rows(t, m.model_group, m.model_shards) if layout[k] == ROWS
                      else t for k, t in leaves.items()}
        return leaves

    def _saved_dtype(self, name: str, t: torch.Tensor) -> torch.dtype:
        if (self._payload == "bf16_moments" and not name.startswith("params/")
                and t.dtype == torch.float32):
            return torch.bfloat16
        return t.dtype

    def _snapshot(self, leaves: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Host copies of `leaves`, complete when this returns."""
        snap, devices = {}, set()
        with torch.no_grad():
            for name, t in leaves.items():
                dtype = self._saved_dtype(name, t)
                if t.device.type != "cuda":
                    snap[name] = t.detach().to(dtype=dtype, copy=True)
                    continue
                buf = self._host.get(name)
                if buf is None or buf.shape != t.shape or buf.dtype != dtype:
                    buf = self._host[name] = torch.empty(t.shape, dtype=dtype,
                                                         pin_memory=True)
                buf.copy_(t.detach().to(dtype), non_blocking=True)
                snap[name] = buf
                devices.add(t.device)
        for device in devices:  # the copies ran on the stream the steps run on
            torch.cuda.current_stream(device).synchronize()
        return snap

    def _path(self, step: int) -> Path:
        return self._dir / f"{step}.pt"

    def _write(self, step: int, snap: dict[str, torch.Tensor]) -> None:
        tmp = self._dir / f"{step}.pt.tmp"
        with open(tmp, "wb") as f:
            torch.save({"step": step, "payload": self._payload, "leaves": snap}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(step))
        fd = os.open(self._dir, os.O_RDONLY)
        try:
            os.fsync(fd)  # the rename itself
        finally:
            os.close(fd)
        for old in self.all_steps()[:-self._keep]:
            self._path(old).unlink(missing_ok=True)

    def save(self, step: int, state: Any) -> None:
        self.wait_until_finished()
        leaves = self._saved_leaves(state, whole=True)
        if not self._writes:
            return
        snap = self._snapshot(leaves)
        if self._writer is None:
            self._write(step, snap)
        else:
            self._pending = self._writer.submit(self._write, step, snap)

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """Writes the checkpoint of `step` (the latest when None) into
        `state`'s own tensors and returns `state`; None when nothing was
        saved. Moments saved as bfloat16 are widened back to float32; a
        params_only checkpoint ZEROES every moment and count of `state`."""
        self.wait_until_finished()
        if self._mesh is not None:
            dist.barrier()  # rank 0's write in flight has landed
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        saved = torch.load(self._path(step), map_location="cpu", weights_only=True)["leaves"]
        if self._mesh is not None:
            from amid_tpu_torch.parallel.distributed import shard_global
            from amid_tpu_torch.parallel.mesh import state_layout

            saved = shard_global(saved, state_layout(state), self._mesh)
        want = self._saved_leaves(state)
        if saved.keys() != want.keys():
            raise ValueError(f"checkpoint {self._path(step)} holds other leaves than the state: "
                             f"{sorted(saved.keys() ^ want.keys())[:8]}")
        with torch.no_grad():
            for name, t in state_leaves(state).items():
                if name not in saved:
                    t.zero_()
                elif saved[name].shape != t.shape:
                    raise ValueError(f"checkpoint {self._path(step)}: {name} has shape "
                                     f"{tuple(saved[name].shape)}, the state {tuple(t.shape)}")
                else:
                    t.copy_(saved[name])
        return state

    def all_steps(self) -> list[int]:
        """The complete steps on disk, oldest first."""
        return sorted(int(m.group(1)) for p in self._dir.iterdir()
                      if (m := _STEP_FILE.match(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait_until_finished(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        try:
            self.wait_until_finished()
        finally:
            if self._writer is not None:
                self._writer.shutdown()
            self._host.clear()
