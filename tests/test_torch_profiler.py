"""The port's profiler (`amid_tpu_torch/utils/profiler.py`) against the JAX
package's (`amid_tpu/utils/profiler.py`) on the CPU: `StepTimer`'s
arithmetic under a patched clock, `Roofline` on the same inputs and peaks,
the trainer stepping its timer as the JAX trainer steps its own, and
`profile_steps` writing a trace in both."""

import itertools
import time

import pytest

from amid_tpu.train import loop as jax_loop
from amid_tpu.utils import profiler as jax_profiler
from amid_tpu_torch.train import loop
from amid_tpu_torch.utils import profiler
from test_torch_checkpoint import _cfgs, _data


def _timer_reads(cls, monkeypatch, sizes, reads_after):
    """examples_per_s read after each step in `reads_after` (and at the
    end), on a clock that advances 0.25 s a reading."""
    clock = itertools.count(start=100.0, step=0.25)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    timer, out = cls(), []
    for i, bs in enumerate(sizes):
        timer.step(bs)
        if i in reads_after:
            out.append(timer.examples_per_s)
    out.append(timer.examples_per_s)
    return out


@pytest.mark.parametrize("sizes,reads_after", [
    ([], ()), ([8], (0,)), ([8, 8], (0, 1)), ([8, 8, 8, 4], (2,)), ([16] * 9, (3, 5))])
def test_step_timer_equals_the_jax_package_s(monkeypatch, sizes, reads_after):
    """The first step skipped, the clock started at the second, examples
    from the third on, read on demand: the JAX class's numbers."""
    ours = _timer_reads(profiler.StepTimer, monkeypatch, sizes, reads_after)
    theirs = _timer_reads(jax_profiler.StepTimer, monkeypatch, sizes, reads_after)
    assert ours == theirs
    if len(sizes) >= 3:
        assert ours[-1] == sum(sizes[2:]) / (0.25 * (1 + len(reads_after)))


@pytest.mark.parametrize("flops,nbytes,seconds", [(10**12, 10**9, 0.01), (10**9, 10**10, 0.5),
                                                  (0, 0, 1.0)])
def test_roofline_equals_the_jax_package_s(flops, nbytes, seconds):
    """The same fields, properties and report on the same inputs and peaks;
    the port's default peaks are the H100's (989 TFLOP/s bf16, 3.35 TB/s)."""
    peaks = dict(peak_tflops=profiler.H100_BF16_TFLOPS, peak_gbs=profiler.H100_HBM_GBS)
    ours = profiler.Roofline(flops, nbytes, seconds)
    theirs = jax_profiler.Roofline(flops, nbytes, seconds, **peaks)
    assert (ours.peak_tflops, ours.peak_gbs) == (989.0, 3350.0)
    for name in ("achieved_tflops", "achieved_gbs", "compute_bound", "fraction_of_sol"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.report("op") == theirs.report("op")


def _recording(cls, calls):
    class Recording(cls):
        def step(self, batch_size):
            calls.append(batch_size)
            super().step(batch_size)

    return Recording


@pytest.mark.parametrize("fast", [False, True], ids=["per_step", "fast"])
def test_run_seed_steps_its_timer_as_the_jax_trainer_does(tmp_path, monkeypatch, fast):
    """Two epochs of the DR schedule in both packages: the timer is stepped
    once a phase-A step with the batch size (phase B not at all), on the
    per-step path and on the chunked one, and `examples_per_s` is its
    reading."""
    (train, val), (jtrain, jval) = _data((40, 16))
    ours, theirs = _cfgs(tmp_path, is_dr=True, epochs=2, checkpoint=False,
                         fast_train=fast, fast_eval=fast)
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(loop, "StepTimer", _recording(profiler.StepTimer, calls["port"]))
    monkeypatch.setattr(jax_profiler, "StepTimer",
                        _recording(jax_profiler.StepTimer, calls["jax"]))
    best = loop.run_seed(ours, 0, train, val, train, device="cpu")
    jax_loop.run_seed(theirs, 0, jtrain, jval, jtrain)
    assert calls["port"] == calls["jax"] == [8] * (2 * 40 // 8)
    assert best["examples_per_s"] > 0.0


def test_profile_steps_writes_a_trace_as_the_jax_trainer_does(tmp_path):
    """profile_steps=2: steps 1 and 2 of epoch 0 traced into
    model_dir/profile on the per-step path (fast_train is turned off for
    the seed), the same log line in both packages; the port's trace is a
    Chrome trace of torch's operators."""
    (train, val), (jtrain, jval) = _data()
    ours, theirs = _cfgs(tmp_path, profile_steps=2, checkpoint=False)
    assert ours.fast_train and theirs.fast_train
    loop.run_seed(ours, 0, train, val, device="cpu")
    jax_loop.run_seed(theirs, 0, jtrain, jval)
    for side in ("port", "jax"):
        log = (tmp_path / side / "log0.txt").read_text()
        assert f"profile trace written to {tmp_path / side}/profile" in log
    assert list((tmp_path / "jax/profile/plugins/profile").iterdir())
    traces = list((tmp_path / "port/profile").glob("*.pt.trace.json"))
    assert len(traces) == 1 and '"aten::' in traces[0].read_text()
