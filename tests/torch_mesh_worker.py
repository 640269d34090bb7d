"""Worker of the port's multi-rank tests (tests/test_torch_parallel.py,
test_torch_mesh_trainer.py, test_torch_distributed.py): one process a rank
of a gloo world on the CPU, joined through
`amid_tpu_torch.parallel.distributed.initialize_distributed`, running one
job on what the parent test wrote to `<workdir>/inputs.pt` and saving this
rank's results to `<workdir>/out_<rank>.pt`. It imports torch and the port
only; the parent holds the results against the JAX package or against the
single-process port.

Run: python tests/torch_mesh_worker.py <rank> <world> <port> <jobs> <workdir>

`<jobs>` is one job name or several joined by "+", run in that order on the
inputs of their names, their results saved by name. `spawn(world, jobs,
inputs, workdir)` (imported by the tests; `start` and `collect` are its two
halves) starts the ranks on a free port, each with a time limit, kills them
all if one fails, and returns the ranks' results.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(world: int, jobs: str, inputs, workdir: str, env: dict | None = None):
    """Starts `jobs` on `world` ranks on a free port; `collect` waits."""
    import torch

    os.makedirs(workdir, exist_ok=True)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    port = _free_port()
    full_env = {**os.environ, "OMP_NUM_THREADS": "1", **(env or {})}
    full_env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), str(port), jobs,
         workdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=full_env, text=True)
        for r in range(world)]
    return procs, workdir


def collect(started, timeout: int = TIMEOUT_S) -> list:
    """Each rank's result, rank order; every rank killed if one fails or
    runs past `timeout` seconds."""
    import torch

    procs, workdir = started
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in out, f"rank {r} failed:\n{out}"
    return [torch.load(os.path.join(workdir, f"out_{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def spawn(world: int, jobs: str, inputs, workdir: str, env: dict | None = None,
          timeout: int = TIMEOUT_S) -> list:
    """Runs `jobs` on `world` ranks; returns each rank's result, rank order."""
    return collect(start(world, jobs, inputs, workdir, env), timeout)


# ---------------------------------------------------------------------------
# jobs: job(inputs, workdir) -> this rank's result
# ---------------------------------------------------------------------------

def _whole_state(state, mesh) -> dict:
    """Every leaf of a TrainState by its checkpoint name, the row-sharded
    ones gathered over `model`."""
    from amid_tpu_torch.parallel.collectives import gather_rows
    from amid_tpu_torch.parallel.mesh import ROWS, state_layout
    from amid_tpu_torch.train.checkpoint import state_leaves

    layout = state_layout(state)
    return {k: (gather_rows(t, mesh.model_group, mesh.model_shards) if layout[k] == ROWS
                else t).detach().clone() for k, t in state_leaves(state).items()}


def _mesh_state(case: dict, mesh):
    """The port model of `case` with this rank's table rows, and its
    TrainState (dense or lazy) cut likewise."""
    import torch

    from amid_tpu_torch.config import ModelConfig
    from amid_tpu_torch.models.amid import build_model
    from amid_tpu_torch.parallel.distributed import shard_global, shard_params_
    from amid_tpu_torch.parallel.mesh import state_layout
    from amid_tpu_torch.train.checkpoint import state_leaves
    from amid_tpu_torch.train.lazy import init_lazy_state
    from amid_tpu_torch.train.optim import Adam
    from amid_tpu_torch.train.steps import init_state

    model = build_model(ModelConfig(**case["model_kw"]), device="cpu")
    model.load_state_dict(case["params"], strict=True)
    shard_params_(model, mesh)
    lr, lr2, _ = case["lr"]
    if case["lazy"]:
        state = init_lazy_state(dict(model.named_parameters()), Adam(lr), Adam(lr2))
    else:
        state = init_state(model, Adam(lr), Adam(lr2))
    leaves = state_leaves(state)
    with torch.no_grad():
        for name, full in shard_global(case["state"], state_layout(state), mesh).items():
            if not name.startswith("params/"):
                leaves[name].copy_(full)
    return model, state


def _run_steps(case: dict, mesh, impl: str) -> dict:
    """Phase A, phase B and an evaluation batch of the case's steps on
    `mesh` (gspmd: the plain steps in the region; shard_map: parallel/spmd)."""
    import torch

    from amid_tpu_torch.parallel.context import spmd
    from amid_tpu_torch.parallel.spmd import (
        make_spmd_dr_r_step, make_spmd_eval_step, make_spmd_train_step,
    )
    from amid_tpu_torch.train import lazy, steps
    from amid_tpu_torch.train.optim import Adam

    model, state = _mesh_state(case, mesh)
    lr, lr2, dr_e_w = case["lr"]
    pools, sizes = (torch.as_tensor(x) for x in case["pools"])
    if impl == "shard_map":
        a = make_spmd_train_step(model, Adam(lr), mesh, dr_e_w=dr_e_w)
        b = make_spmd_dr_r_step(model, Adam(lr2), mesh)
        ev = make_spmd_eval_step(model, case["num_neg"], mesh)
        region = spmd(None)
    else:
        if case["lazy"]:
            a = lazy.make_lazy_train_step(model, Adam(lr), dr_e_w=dr_e_w)
            b = lazy.make_lazy_dr_r_step(model, Adam(lr2))
        else:
            a = steps.make_train_step(model, Adam(lr), dr_e_w=dr_e_w)
            b = steps.make_dr_r_step(model, Adam(lr2))
        ev = steps.make_eval_step(model, case["num_neg"])
        region = spmd(mesh.axes("gspmd"))
    out = {}
    with region:
        for name, step, (batch, neg) in (("a", a, case["a"]), ("b", b, case["b"])):
            _, m = step(state, {k: torch.as_tensor(v) for k, v in batch.items()}, pools,
                        sizes, 0, neg=neg)
            out[name] = {k: float(v) for k, v in m.items()}
        batch, neg = case["eval"]
        got = ev({k: torch.as_tensor(v) for k, v in batch.items()}, pools, sizes, 0, neg=neg)
        out["eval"] = {k: v.clone() for k, v in got.items()}
    out["state"] = _whole_state(state, mesh)
    return out


def job_steps(inputs, workdir) -> dict:
    """Each (data, model, impl) of `inputs["shapes"]` and each case."""
    from amid_tpu_torch.config import MeshConfig
    from amid_tpu_torch.parallel.mesh import make_mesh

    res = {}
    for d, m, impl in inputs["shapes"]:
        mesh = make_mesh(MeshConfig(data_axis=d, model_axis=m))
        for name, case in inputs["cases"].items():
            if impl in case["impls"]:
                res[(d, m, impl, name)] = _run_steps(case, mesh, impl)
    return res


def job_lookup(inputs, workdir) -> dict:
    """`sharded_lookup` forward and this rank's table-shard gradient for
    each model width of `inputs["model_axes"]` (the world split data x
    model), the grouped and the side-by-side forms; and the collectives'
    backward on their own."""
    import torch

    from amid_tpu_torch.config import MeshConfig
    from amid_tpu_torch.ops.embedding import embedding_gather_many_plain
    from amid_tpu_torch.parallel.collectives import all_gather_data, psum_model
    from amid_tpu_torch.parallel.distributed import shard_global
    from amid_tpu_torch.parallel.embedding import sharded_lookup
    from amid_tpu_torch.parallel.mesh import make_mesh

    res = {}
    table, ids, ids2, cot, cot2 = (inputs[k] for k in ("table", "ids", "ids2", "cot", "cot2"))
    for m in inputs["model_axes"]:
        mesh = make_mesh(MeshConfig(data_axis=-1, model_axis=m))
        axes = mesh.axes()
        local = shard_global(table, "model", mesh).clone().requires_grad_()
        rows, rows2 = sharded_lookup(local, [ids, ids2], axes, embedding_gather_many_plain)
        (g,) = torch.autograd.grad((rows * cot).sum() + (rows2 * cot2).sum(), [local])
        side = sharded_lookup(local, [ids, ids2[:, :1]], axes, embedding_gather_many_plain,
                              concat=True)
        res[m] = {"rows": rows.detach(), "rows2": rows2.detach(), "grad": g,
                  "side": side.detach(), "model_rank": mesh.model_rank,
                  "data_rank": mesh.data_rank}
    mesh = make_mesh(MeshConfig(data_axis=-1, model_axis=1))  # every rank a data shard
    axes = mesh.axes()
    x = (torch.arange(6.0).reshape(2, 3) + 10 * mesh.rank).requires_grad_()
    gathered = all_gather_data(x, axes)
    w = torch.arange(gathered.numel(), dtype=torch.float32).reshape(gathered.shape)
    (gx,) = torch.autograd.grad((gathered * w * (mesh.rank + 1)).sum(), [x])
    y = x.detach().clone().requires_grad_()
    (gy,) = torch.autograd.grad((psum_model(y, axes) * 3.0).sum(), [y])
    res["collectives"] = {"gathered": gathered.detach(), "grad_gather": gx, "grad_psum": gy}
    return res


def job_run_seed(inputs, workdir) -> dict:
    """`run_seed` for each named config of `inputs["runs"]`; a run may name
    an error it must raise instead (`expect_error`)."""
    import numpy as np

    from amid_tpu_torch.data.synthetic import synth_packed
    from amid_tpu_torch.train import loop

    res = {}
    for name, run in inputs["runs"].items():
        cfg = run["cfg"]
        rng = np.random.default_rng(run.get("data_seed", 0))
        train, val, dr = (synth_packed(cfg.model, rng, n) for n in run["rows"])
        if run.get("count_chunk_runners"):
            built = []
            orig = loop.make_resident_chunk_runner
            loop.make_resident_chunk_runner = lambda *a, **kw: built.append(1) or orig(*a, **kw)
        try:
            best = loop.run_seed(cfg, 0, train, val, dr if cfg.model.is_dr else None,
                                 device="cpu")
            if run.get("expect_error"):
                raise AssertionError(f"{name}: ran, want {run['expect_error']!r}")
            res[name] = best
        except ValueError as e:
            if run.get("expect_error") not in str(e):
                raise
            res[name] = {"error": str(e)}
        if run.get("count_chunk_runners"):
            loop.make_resident_chunk_runner = orig
            res[name]["chunk_runners"] = len(built)
    return res


def job_checkpoint(inputs, workdir) -> dict:
    """A mesh run that checkpoints (`inputs["cfg"]`), then a restore of its
    checkpoint into a fresh mesh state (this rank's restored leaves), then a
    resumed run whose epoch-1 phase B meets a NaN written into a DR head
    after the main evaluation, under nan_policy="restore"."""
    import dataclasses

    import numpy as np
    import torch

    from amid_tpu_torch.data.synthetic import synth_packed
    from amid_tpu_torch.models.amid import build_model
    from amid_tpu_torch.parallel.distributed import shard_params_
    from amid_tpu_torch.parallel.mesh import make_mesh, state_layout
    from amid_tpu_torch.train import loop
    from amid_tpu_torch.train.checkpoint import CheckpointManager, state_leaves
    from amid_tpu_torch.train.optim import Adam
    from amid_tpu_torch.train.steps import init_state

    cfg = inputs["cfg"]
    rng = np.random.default_rng(0)
    train, val, dr = (synth_packed(cfg.model, rng, n) for n in inputs["rows"])
    best = loop.run_seed(cfg, 0, train, val, dr, device="cpu")
    mesh = make_mesh(cfg.mesh)
    model = shard_params_(build_model(cfg.model, device="cpu", seed=1), mesh)  # other weights
    state = init_state(model, Adam(cfg.lr), Adam(cfg.lr * cfg.lr2))
    ckpt = CheckpointManager(f"{cfg.model_dir}/checkpoint/seed0", mesh=mesh)
    restored = ckpt.restore(state)
    ckpt.close()

    def poison(epoch, state, ev, phase):
        if epoch == 1 and phase == "main":
            with torch.no_grad():
                state.params[inputs["nan_param"]].fill_(float("nan"))

    resumed = loop.run_seed(dataclasses.replace(cfg, resume=True, epochs=2,
                                                nan_policy="restore"),
                            0, train, val, dr, device="cpu", epoch_hook=poison)
    return {"best": best, "same_object": restored is state, "layout": state_layout(state),
            "leaves": {k: t.detach().clone() for k, t in state_leaves(state).items()},
            "model_rank": mesh.model_rank, "resumed": resumed}


def job_cli(inputs, workdir) -> dict:
    """The trainer CLI with `--distributed True` and the explicit world
    flags (`inputs["argv"]`, then this rank's), which joins the world itself."""
    import torch.distributed as dist

    from amid_tpu_torch import train_sr_dr

    rank, world, port = (os.environ[k] for k in ("WORKER_RANK", "WORKER_WORLD", "WORKER_PORT"))
    argv = inputs["argv"] + ["--coordinator", f"localhost:{port}", "--num_processes", world,
                             "--process_id", rank]
    agg = train_sr_dr.main(argv)
    return {"agg": agg, "world": dist.get_world_size()}


def job_world(inputs, workdir) -> dict:
    """The node helpers: the host-aligned mesh and the node's rows."""
    from amid_tpu_torch.parallel.distributed import (
        host_local_slice, initialize_distributed, make_host_aligned_mesh,
    )

    initialize_distributed("localhost:1", 2, 0)  # joined already: a no-op
    out = {"slice": host_local_slice(inputs["rows"])}
    for m in inputs["model_axes"]:
        try:
            mesh = make_host_aligned_mesh(m)
            out[m] = {"shape": mesh.shape, "nodes": mesh.nodes,
                      "coords": (mesh.data_rank, mesh.model_rank)}
        except ValueError as e:
            out[m] = {"error": str(e)}
    return out


JOBS = {"steps": job_steps, "lookup": job_lookup, "run_seed": job_run_seed,
        "checkpoint": job_checkpoint, "cli": job_cli, "world": job_world}


def main() -> None:
    rank, world, port, job, workdir = sys.argv[1:6]
    sys.path.insert(0, os.path.dirname(HERE))
    import torch

    torch.set_num_threads(1)
    from amid_tpu_torch.parallel.distributed import initialize_distributed

    os.environ.update(WORKER_RANK=rank, WORKER_WORLD=world, WORKER_PORT=port)
    if "cli" not in job.split("+"):
        initialize_distributed(f"localhost:{port}", int(world), int(rank), device="cpu")
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    result = {j: JOBS[j](inputs[j], workdir) for j in job.split("+")}
    torch.save(result, os.path.join(workdir, f"out_{rank}.pt"))
    print(f"WORKER_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
