"""The trainer: `run` (CSVs in, seeds aggregated), `run_seed` with its
per-step path and its fast loops, and `cli_main`, the body of the two CLIs —
the counterpart of `amid_tpu/train/loop.py`.

Protocol reproduced from the reference:
* per-epoch: full pass over the train loader, then eval (train_sr.py:187-223);
  DR adds a second pass over the DR loader stepping optimizer2, then a second
  eval (train_sr_dr.py:362-403).
* best-metric tracking takes the per-metric max over epochs
  (train_sr.py:224-270).
* 5-seed protocol with mean/std aggregation (train_sr.py:439-443,549-569).

The step-key schedule keeps the JAX trainer's shape with integer keys
(`ops.rng.fold_in`): one stream per epoch, step i of phase A, 20_000 + i of
phase B, 10_000 and 30_000 for the two evaluations, batch i of an evaluation
folded into its key.

No host sync inside the step loop: every step's `nonfinite` flag is folded
into a device-side latch that the host reads at log cadence and epoch end.

The fast loops (on by default, as in the JAX package): with `fast_train` the
train and DR datasets stay on the device for the seed, each epoch uploads
only its permutation, and the steps run in log-cadence chunks
(`_run_chunked`, `steps.make_resident_chunk_runner`); with `fast_eval` (and
`eval_batch_drop_last`) the val batches are stacked on the device once and a
pass reads its losses and ranks back once (`evaluate_scanned`,
`steps.make_scanned_eval`). On `cuda` each step kind (phase A, phase B, the
evaluation batch) is a CUDA graph, captured once per seed after one eager
step and replayed from then on (`train/graphs.py`); on the CPU the same
runners run eagerly. Batch order, keys and logged metrics are the per-step
path's.

Checkpoints (`train/checkpoint.py`, as in the JAX package): with
`checkpoint` a manager under `model_dir/checkpoint/seed{seed}` saves the
state after an epoch's last evaluation when its score (mrr_d1 + mrr_d2)
beats the best and `checkpoint_every` epochs have passed, or at the last
epoch; `resume` restores the latest and starts at the epoch after it; a
non-finite loss under `nan_policy="restore"` rolls back to it. A restore
writes into the state's own tensors, which the fast loops' graphs read, so
the chunks go on replaying the same graphs after a roll-back.

`best["examples_per_s"]` is the JAX trainer's `StepTimer`
(`utils/profiler.py`): stepped once a phase-A step, the first step skipped,
the clock started after the second and read when the seed ends.
`profile_steps` > 0 traces steps 1..profile_steps of epoch 0 into
`model_dir/profile` on the per-step path (it turns `fast_train` off for the
seed, as in the JAX package).

Mesh training (`use_mesh`, `parallel/`, as `amid_tpu/train/loop.py`): the
ranks of the `torch.distributed` world (a world of one on a free local port
when there is none: NCCL on `cuda`, gloo on the CPU) form a `data x model`
mesh (`cfg.mesh`); the table parameter and its moments are cut to this
rank's rows; every rank holds the global batches and runs the steps on its
rows of them. `mesh_impl="gspmd"` (the default) runs the plain steps inside
`parallel.context.spmd`, with the fast loops (their CUDA graphs capture the
collectives); "shard_map" the steps of `parallel/spmd.py`, dense Adam only,
per step, one node only (the JAX trainer's refusals and messages). Rank 0
writes the logs and the checkpoints; every rank returns the same `best`.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from amid_tpu_torch.config import TrainConfig, parse_cli_with_device
from amid_tpu_torch.data.loader import BatchIterator
from amid_tpu_torch.data.packed import PackedDualDomainDataset, load_dual_domain_csv
from amid_tpu_torch.models.amid import build_model, resolve_device
from amid_tpu_torch.ops.rng import fold_in
from amid_tpu_torch.parallel.context import spmd
from amid_tpu_torch.train.checkpoint import CheckpointManager
from amid_tpu_torch.train.graphs import GraphPool
from amid_tpu_torch.train.metrics import RankAccumulator
from amid_tpu_torch.train.optim import Adam
from amid_tpu_torch.train.steps import (
    init_state,
    make_dr_r_step,
    make_eval_step,
    make_resident_chunk_runner,
    make_scanned_eval,
    make_train_step,
)
from amid_tpu_torch.utils.logging import AverageMeter, init_logger
from amid_tpu_torch.utils.profiler import StepTimer, trace


def _device_pools(ds: PackedDualDomainDataset, device):
    return (torch.as_tensor(ds.pools, device=device),
            torch.as_tensor(ds.pool_sizes, device=device))


def _to_device(batch: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


# the per-row arrays a step reads: what the fast loops keep on the device
STEP_KEYS = ("target", "seq_d1", "seq_d2", "domain_id", "reject", "reject_counts",
             "ob_label")


def _resident(arrays: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(arrays[k], device=device) for k in STEP_KEYS}


def evaluate(
    eval_step,
    val_iter: BatchIterator,
    pools,
    pool_sizes,
    key: int,
    overlap_eval: bool,
) -> dict[str, float]:
    acc = RankAccumulator(overlap_eval)
    val_losses = []
    for i, batch in enumerate(val_iter):
        out = eval_step(_to_device(batch, pools.device), pools, pool_sizes,
                        fold_in(key, i))
        # ranks stay on the device until finalize(): no per-batch sync
        acc.add(out["ranks_fixed"], out["ranks_raw"],
                batch["domain_id"], batch["overlap"])
        val_losses.append(out["loss_cls"])
    metrics = acc.finalize()
    metrics["val_loss"] = (
        float(torch.stack(val_losses).mean()) if val_losses else 0.0
    )
    return metrics


def evaluate_scanned(eval_all, batches_dev, dom: np.ndarray, ov: np.ndarray,
                     pools, pool_sizes, key: int, overlap_eval: bool) -> dict[str, float]:
    """Fast-eval path: the whole pass over the device-resident val batches
    (`steps.make_scanned_eval`), read back once — the same metrics as
    `evaluate` (the same per-batch fold_in(key, i) negative draws)."""
    out = eval_all(batches_dev, pools, pool_sizes, key)
    acc = RankAccumulator(overlap_eval)
    acc.add(out["ranks_fixed"].reshape(-1), out["ranks_raw"].reshape(-1),
            dom.reshape(-1), ov.reshape(-1))
    metrics = acc.finalize()
    metrics["val_loss"] = float(out["loss_cls"].mean())
    return metrics


def _run_chunked(runner, state, arrays_dev, perm_dev, nb: int, pools, pool_sizes,
                 base_key: int, idx_offset: int, log_every: int, timer, batch_size: int,
                 on_metrics, nan_cb):
    """The fast-train epoch: one `runner` call per log-cadence chunk of
    steps (`steps.make_resident_chunk_runner`). The chunk boundary is the
    per-step loop's log boundary (i % log_every == 0), so the host reads the
    device at the same cadence: the latch once a chunk, and the chunk's
    first-step metrics, which it logs. Batch order and keys are the per-step
    loop's. `timer` (phase A's; None in phase B) is stepped once a step,
    `nan_cb(state, start)` returns the state to go on with."""
    start = 0
    while start < nb:
        end = min(start + log_every, nb)
        state, m0, nf = runner(state, arrays_dev, perm_dev, pools, pool_sizes, base_key,
                               range(idx_offset + start, idx_offset + end),
                               range(start, end))
        if timer is not None:
            for _ in range(end - start):
                timer.step(batch_size)
        if float(nf) > 0.0:
            state = nan_cb(state, start)
        else:
            on_metrics(m0)
        start = end
    return state


class NonFiniteLossError(RuntimeError):
    pass


def _handle_nan(cfg, log, ckpt, state, epoch, step):
    """Failure detection: act on a non-finite train loss per cfg.nan_policy:
    "halt" raises; "restore" rolls back to the latest checkpoint where there
    is one (in place: the state returned is `state`, its tensors rewritten);
    otherwise, and under "ignore", it logs and continues."""
    msg = f"non-finite train loss at epoch {epoch} step {step}"
    if cfg.nan_policy == "halt":
        raise NonFiniteLossError(msg)
    if cfg.nan_policy == "restore" and ckpt is not None:
        restored = ckpt.restore(state)
        if restored is not None:
            log.error(f"{msg}; rolled back to checkpoint "
                      f"{ckpt.latest_step()}")
            return restored
    log.error(f"{msg}; continuing (policy={cfg.nan_policy})")
    return state


def _track_best(best: dict[str, float], cur: dict[str, float]) -> None:
    for k, v in cur.items():
        if k.startswith(("hit_", "ndcg_", "mrr")):
            best[k] = max(best.get(k, 0.0), v)


def _run_phase(step, state, batches, pools, pool_sizes, ekey, key_offset,
               cfg, log, meter, epoch, keys=None, ckpt=None, timer=None, profile_dir=None):
    """One pass over `batches` with `step`; logs the running means of `keys`
    (default: every metric) every cfg.log_every steps and checks the
    non-finite latch there and at the end (`_handle_nan`). `timer` is
    stepped once a step; with `profile_dir`, steps 1..cfg.profile_steps are
    traced into it. Returns the state."""
    device = pools.device
    latch = torch.zeros((), device=device)
    with contextlib.ExitStack() as tracing:
        for i, batch in enumerate(batches):
            if profile_dir is not None and i == 1:
                tracing.enter_context(trace(profile_dir))
            state, m = step(state, _to_device(batch, device), pools, pool_sizes,
                            fold_in(ekey, key_offset + i))
            latch = torch.maximum(latch, m.pop("nonfinite"))
            if profile_dir is not None and i == cfg.profile_steps:
                float(m["loss"])  # the traced steps have run on the device
                tracing.close()
                log.info(f"profile trace written to {profile_dir}")
            if timer is not None:
                timer.step(cfg.model.batch_size)
            if i % cfg.log_every == 0:
                if float(latch) > 0.0:
                    state = _handle_nan(cfg, log, ckpt, state, epoch, i)
                    latch = torch.zeros((), device=device)
                    continue
                _log_train(log, meter, m, keys)
    if float(latch) > 0.0:
        state = _handle_nan(cfg, log, ckpt, state, epoch, "end")
    return state


def _log_train(log, meter, m: dict, keys=None) -> None:
    shown = {k: float(v) for k, v in m.items() if keys is None or k in keys}
    meter.update(**shown)
    log.info("train " + ", ".join(f"{k}:{meter.mean(k):.5f}" for k in sorted(shown)))


def run_seed(
    cfg: TrainConfig,
    seed: int,
    train_ds: PackedDualDomainDataset,
    val_ds: PackedDualDomainDataset,
    dr_ds: Optional[PackedDualDomainDataset] = None,
    device=None,
    epoch_hook=None,
) -> dict[str, float]:
    """Train one seed; returns the best-metric dict (reference train()
    return contract, train_sr.py:352-355). Logs to the console and to
    `cfg.model_dir/log{seed}.txt`.

    epoch_hook(epoch, state, ev, phase): called after the main evaluation of
    each epoch (phase="main") and, on the DR schedule, after the post-phase-B
    one (phase="post_dr"), as in the JAX package; `state.params` holds the
    model's parameters as they are then.

    With `model.is_c2dsr`, phase A adds `cl_w` * the C2DSR infomax loss
    (`train/c2dsr.py`); it is dense Adam only (ValueError with
    `lazy_table_adam`, as in the JAX package). On `cuda`, `build_model`
    refuses, before the first step, a configuration with a shape some
    kernel does not take (`models.amid.check_kernels_fit`: a head width
    above the attention kernels' 256, a T beyond the long-sequence paths',
    a pairwise affinity row above 65,536 columns or a scoring head beyond a
    block's shared memory).

    With `use_mesh`, every rank of the world calls it with the same
    arguments (`parallel/`; the module docstring).

    Runs on `cuda` unless the caller passes a device (e.g. "cpu"), and
    raises without a card."""
    c2dsr_w = cfg.cl_w if cfg.model.is_c2dsr else None
    if cfg.lazy_table_adam and c2dsr_w is not None:
        # the lazy unique-id budget doesn't cover the corrupted-view lookups
        raise ValueError("--isC2DSR is not supported with --lazy_table_adam")
    device = resolve_device(device)
    from amid_tpu_torch.parallel.distributed import destroy_world, ensure_world

    made_world = cfg.use_mesh and ensure_world(device)
    try:
        mesh = _make_mesh(cfg) if cfg.use_mesh else None
        return _run_seed(cfg, seed, train_ds, val_ds, dr_ds, device, epoch_hook, mesh, c2dsr_w)
    finally:
        if made_world:
            destroy_world()


def _make_mesh(cfg: TrainConfig):
    """The mesh of a mesh run, after the JAX trainer's checks
    (amid_tpu/train/loop.py:308-344)."""
    from amid_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(cfg.mesh)
    if cfg.model.batch_size % mesh.data_shards:
        raise ValueError(f"batch_size {cfg.model.batch_size} not divisible by "
                         f"data axis {mesh.data_shards}")
    if cfg.model.item_table_size % mesh.model_shards:
        # the JAX package's shard_map floors the rows a shard holds and so
        # loses the table's last rows; the port refuses the layout
        raise ValueError(f"the item table's {cfg.model.item_table_size} rows do not "
                         f"split evenly over model axis {mesh.model_shards}")
    if cfg.mesh_impl == "shard_map":
        if cfg.lazy_table_adam:
            raise ValueError("mesh_impl=shard_map does not cover --lazy_table_adam; "
                             "use gspmd")
        if cfg.model.is_c2dsr:
            raise ValueError("mesh_impl=shard_map does not cover --isC2DSR; use gspmd")
    if mesh.nodes > 1 and cfg.mesh_impl != "gspmd":
        raise ValueError("multi-process runs require mesh_impl=gspmd")
    return mesh


def _run_seed(cfg, seed, train_ds, val_ds, dr_ds, device, epoch_hook, mesh, c2dsr_w):
    log = init_logger(cfg.model_dir, f"log{seed}.txt")
    model = build_model(cfg.model, device=device, seed=seed)
    is_dr = cfg.model.is_dr
    tx = Adam(cfg.lr)
    tx2 = Adam(cfg.lr * cfg.lr2) if is_dr else None
    dr_e_w = cfg.dr_e_w if is_dr else None
    shard_map = mesh is not None and cfg.mesh_impl == "shard_map"
    if mesh is not None:  # every rank built the same weights: keep this rank's rows
        from amid_tpu_torch.parallel.distributed import shard_params_

        shard_params_(model, mesh)

    if cfg.lazy_table_adam:
        from amid_tpu_torch.train.lazy import (
            init_lazy_state, make_lazy_dr_r_step, make_lazy_train_step,
        )

        state = init_lazy_state(dict(model.named_parameters()), tx, tx2)
        train_step = make_lazy_train_step(model, tx, dr_e_w=dr_e_w)
        dr_step = make_lazy_dr_r_step(model, tx2) if is_dr else None
    else:
        state = init_state(model, tx, tx2)
        train_step = make_train_step(model, tx, dr_e_w=dr_e_w, c2dsr_w=c2dsr_w)
        dr_step = make_dr_r_step(model, tx2) if is_dr else None
    n_params = sum(p.numel() for p in state.params.values())
    log.info(f"seed {seed}: params={n_params:,} device={device} "
             f"kernels={model.cfg.kernels}")
    eval_step = make_eval_step(model, cfg.data.neg_nums)
    if shard_map:
        from amid_tpu_torch.parallel.spmd import (
            make_spmd_dr_r_step, make_spmd_eval_step, make_spmd_train_step,
        )

        train_step = make_spmd_train_step(model, tx, mesh, dr_e_w=dr_e_w)
        dr_step = make_spmd_dr_r_step(model, tx2, mesh) if is_dr else None
        eval_step = make_spmd_eval_step(model, cfg.data.neg_nums, mesh)
    if mesh is not None:
        log.info(f"mesh: {mesh.shape} impl={cfg.mesh_impl} processes={mesh.nodes}")

    pools, pool_sizes = _device_pools(train_ds, device)
    # eval negatives come from the *val* split's pools (dataset_seq.py:141-142
    # — each Dataset builds pools from its own csv)
    vpools, vpool_sizes = _device_pools(val_ds, device)
    dpools, dpool_sizes = (
        _device_pools(dr_ds, device) if dr_ds is not None else (None, None)
    )

    bs = cfg.model.batch_size
    train_iter = BatchIterator(train_ds, bs, shuffle=True, seed=seed, drop_last=True)
    val_iter = BatchIterator(val_ds, bs, shuffle=False, seed=seed,
                             drop_last=cfg.eval_batch_drop_last)
    dr_iter = (
        BatchIterator(dr_ds, bs, shuffle=True, seed=seed + 1000)
        if dr_ds is not None else None
    )

    # the fast loops: step kinds as CUDA graphs in one pool on the card,
    # released when the seed ends; the same runners run eagerly on the CPU
    # shard_map keeps the per-step loops, as in the JAX package
    fast_eval = (cfg.fast_eval and cfg.eval_batch_drop_last and len(val_iter) > 0
                 and not shard_map)
    fast_train = cfg.fast_train and not cfg.profile_steps and not shard_map
    graphs = (GraphPool(device) if device.type == "cuda" and (fast_train or fast_eval)
              else None)
    phases = [(train_step, train_iter, pools, pool_sizes, 0, None)]
    if is_dr and dr_iter is not None:
        phases.append((dr_step, dr_iter, dpools, dpool_sizes, 20_000, ("loss_dr_r",)))
    resident = {}  # step -> (runner, resident arrays, permutation buffer)
    if fast_train:
        for step, it, *_ in phases:
            resident[step] = (make_resident_chunk_runner(step, bs, graphs),
                              _resident(it.arrays(), device),
                              torch.zeros(len(it) * bs, dtype=torch.int32, device=device))
    if fast_eval:
        # the val loader is deterministic: its batches are stacked once
        vidx = np.arange(len(val_iter) * bs).reshape(len(val_iter), bs)
        varrays = val_ds.batch_arrays()
        val_dom, val_ov = varrays["domain_id"][vidx], varrays["overlap"][vidx]
        val_batches_dev = {k: torch.as_tensor(varrays[k][vidx], device=device)
                           for k in STEP_KEYS}
        eval_all = make_scanned_eval(model, cfg.data.neg_nums, graphs)

    def run_phase(step, it, ppools, psizes, offset, keys, ekey, meter, epoch):
        """One pass of a phase; phase A (offset 0) steps the timer."""
        phase_timer = timer if offset == 0 else None
        if step not in resident:
            profile_dir = (f"{cfg.model_dir}/profile"
                           if cfg.profile_steps and epoch == 0 and offset == 0 else None)
            return _run_phase(step, state, it, ppools, psizes, ekey, offset, cfg, log,
                              meter, epoch, keys, ckpt, phase_timer, profile_dir)
        runner, arrays_dev, perm_dev = resident[step]
        perm_dev.copy_(torch.from_numpy(it.epoch_perm()))
        return _run_chunked(runner, state, arrays_dev, perm_dev, len(it), ppools, psizes,
                            ekey, offset, cfg.log_every, phase_timer, bs,
                            lambda m0: _log_train(log, meter, m0, keys),
                            lambda s, i: _handle_nan(cfg, log, ckpt, s, epoch, i))

    def run_eval(key):
        if fast_eval:
            return evaluate_scanned(eval_all, val_batches_dev, val_dom, val_ov, vpools,
                                    vpool_sizes, key, cfg.overlap_eval)
        return evaluate(eval_step, val_iter, vpools, vpool_sizes, key, cfg.overlap_eval)

    root_key = fold_in(seed, 0)
    best: dict[str, float] = {}
    best_score = -1.0
    timer = StepTimer()
    ckpt = last_saved = None
    start_epoch = 0
    region = contextlib.ExitStack()
    try:
        if mesh is not None and not shard_map:  # the plain steps, on the mesh
            region.enter_context(spmd(mesh.axes("gspmd")))
        if cfg.checkpoint:
            ckpt = CheckpointManager(
                f"{cfg.model_dir}/checkpoint/seed{seed}", keep=cfg.checkpoint_keep,
                async_save=cfg.checkpoint_async, payload=cfg.checkpoint_payload, mesh=mesh)
            if cfg.resume and ckpt.restore(state) is not None:
                # latest_step() can be 0: no `or`-default
                start_epoch = ckpt.latest_step() + 1
                log.info(f"resumed from checkpoint at epoch {start_epoch - 1}")
            # the newest step, one in flight included (latest_step() reports
            # complete steps only)
            last_saved = ckpt.latest_step()

        for epoch in range(start_epoch, cfg.epochs):
            meter = AverageMeter()
            ekey = fold_in(root_key, epoch)
            state = run_phase(*phases[0], ekey, meter, epoch)

            ev = run_eval(fold_in(ekey, 10_000))
            _track_best(best, ev)
            log.info(
                f"epoch {epoch}/{cfg.epochs} val_loss={ev['val_loss']:.4f} "
                f"HR@10 d1={ev['hit_10_d1']:.4f} d2={ev['hit_10_d2']:.4f} "
                f"NDCG@10 d1={ev['ndcg_10_d1']:.4f} d2={ev['ndcg_10_d2']:.4f} "
                f"MRR d1={ev['mrr_d1']:.4f} d2={ev['mrr_d2']:.4f}"
            )
            if epoch_hook is not None:
                epoch_hook(epoch, state, ev, phase="main")

            if len(phases) > 1:
                state = run_phase(*phases[1], ekey, meter, epoch)
                ev = run_eval(fold_in(ekey, 30_000))
                _track_best(best, ev)
                log.info(
                    f"epoch {epoch} (post-DR) HR@10 d1={ev['hit_10_d1']:.4f} "
                    f"d2={ev['hit_10_d2']:.4f} MRR d1={ev['mrr_d1']:.4f} "
                    f"d2={ev['mrr_d2']:.4f}"
                )
                if epoch_hook is not None:
                    epoch_hook(epoch, state, ev, phase="post_dr")

            score = ev["mrr_d1"] + ev["mrr_d2"]
            if score > best_score:
                if ckpt is not None and (
                        last_saved is None or epoch - last_saved >= cfg.checkpoint_every
                        or epoch == cfg.epochs - 1):
                    ckpt.save(epoch, state)
                    last_saved = epoch
                best_score = score
        # read before close() waits for a save in flight, as in the JAX package
        best["examples_per_s"] = timer.examples_per_s
        if mesh is not None:  # every rank returns rank 0's clock
            best["examples_per_s"] = _rank0_value(best["examples_per_s"], device)
    finally:
        try:
            if ckpt is not None:
                ckpt.close()
        finally:
            region.close()
            if graphs is not None:
                graphs.close()

    best["start_epoch"] = float(start_epoch)
    return best


def _rank0_value(x: float, device) -> float:
    import torch.distributed as dist

    t = torch.tensor([x], dtype=torch.float64, device=device)
    dist.broadcast(t, src=0)
    return float(t)


def aggregate_seeds(per_seed: list[dict[str, float]], log) -> dict[str, dict]:
    """5-seed mean/std block (train_sr.py:549-569)."""
    keys = sorted({k for d in per_seed for k in d})
    agg = {}
    for k in keys:
        vals = [d[k] for d in per_seed if k in d]
        agg[k] = {"mean": float(np.mean(vals)), "std": float(np.std(vals))}
        log.info(f"{k}: {agg[k]['mean']:.4f}/{agg[k]['std']:.4f}")
    return agg


def run(cfg: TrainConfig, device=None) -> dict[str, dict]:
    """Full multi-seed run (reference __main__, train_sr.py:357-626): the
    split's CSVs are packed once, every seed trains on them, and the
    per-metric mean/std goes to `cfg.model_dir/log_all.txt`.

    Runs on `cuda` unless the caller passes a device (e.g. "cpu"), and
    raises without a card."""
    device = resolve_device(device)
    log = init_logger(cfg.model_dir, "log_all.txt")
    log.info(cfg.to_json())

    sub = cfg.subdomain if cfg.subdomain >= 0 else None
    train_ds = load_dual_domain_csv(
        cfg.data.train_csv(), cfg.model.seq_len, cfg.model.pad_id,
        cfg.data.long_length, subdomain=sub,
    )
    val_ds = load_dual_domain_csv(
        cfg.data.test_csv(), cfg.model.seq_len, cfg.model.pad_id,
        cfg.data.long_length, subdomain=sub,
    )
    dr_ds = (
        load_dual_domain_csv(
            cfg.data.train_dr_csv(), cfg.model.seq_len, cfg.model.pad_id,
            cfg.data.long_length, with_ob_label=True,
        )
        if cfg.model.is_dr
        else None
    )

    per_seed = [
        run_seed(cfg, seed, train_ds, val_ds, dr_ds, device=device)
        for seed in range(cfg.seed_offset, cfg.seed_offset + cfg.seeds)
    ]
    log = init_logger(cfg.model_dir, "log_all.txt")
    return aggregate_seeds(per_seed, log)


def cli_main(argv: Optional[list[str]] = None, is_dr: bool = False) -> dict[str, dict]:
    """The body of `python3 -m amid_tpu_torch.train_sr_dr` (is_dr=True) and
    `train_sr` (is_dr=False): flags -> TrainConfig -> `run`.

    The flags' defaults are the JAX CLI's: checkpoints on (async, under
    `model_dir/checkpoint/seed{seed}`), the fast loops on; `--mesh` trains
    on the mesh, `--distributed` joins the world first
    (`config.parse_cli_with_device`)."""
    cfg, device = parse_cli_with_device(argv, is_dr=is_dr)
    cfg.model.is_dr = is_dr
    return run(cfg, device=device)
