"""The port stands alone: amid_tpu_torch and chip_smoke.py import neither
JAX (nor flax/optax) nor the JAX package, its entry points never fall back to
the CPU unasked, and a CPU run launches no kernel."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from amid_tpu_torch.config import ModelConfig
from amid_tpu_torch.models.amid import build_model
from amid_tpu_torch.ops.affinity import max_affinity_blocked, max_affinity_smalln
from amid_tpu_torch.ops.attention import fused_attention
from amid_tpu_torch.ops.embedding import embedding_gather
from amid_tpu_torch.ops.scatter import scatter_set_unique, scatter_set_unique3
from amid_tpu_torch.ops.scoring import scoring_head
from amid_tpu_torch.serve import full_catalog_topk, user_representations
from amid_tpu_torch.train import lazy
from amid_tpu_torch.train.optim import Adam

REPO = Path(__file__).resolve().parent.parent
BANNED = ("jax", "flax", "optax", "amid_tpu")
PORT_FILES = sorted((REPO / "amid_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
SMALL = dict(emb_dim=16, hid_dim=4, seq_len=6, batch_size=4, is_itc=True, is_dr=True,
             item_length=20, user_length=20, sasrec_heads=2)


def _banned(module: str) -> bool:
    return module.split(".")[0] in BANNED


NEW_MODULES = {"ops/embedding.py", "ops/scoring.py", "ops/affinity.py", "train_sr.py",
               "train/checkpoint.py", "utils/profiler.py", "data/native.py",
               "train_sr_dr.py", "train/loop.py", "config.py", "data/synthetic.py",
               "ops/precision.py"}


def test_no_import_line_names_jax_or_the_jax_package():
    assert len(PORT_FILES) > 29
    listed = {str(p.relative_to(REPO / "amid_tpu_torch")) for p in PORT_FILES[:-1]}
    assert NEW_MODULES <= listed and PORT_FILES[-1].name == "chip_smoke.py"
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(map(_banned, names)), (path, node.lineno, names)


def test_importing_the_port_loads_no_jax():
    """A fresh interpreter imports every module of the port and chip_smoke;
    none of jax, flax, optax or amid_tpu enters sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import amid_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(amid_tpu_torch.__path__, 'amid_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {BANNED!r})\n"
        "print(len([m for m in sys.modules if m.startswith('amid_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 32, proc.stdout


def test_build_model_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(ModelConfig(**SMALL))


@pytest.mark.parametrize("kernels,exc", [("cuda", ValueError), ("xla", ValueError),
                                         ("pallas", ValueError)])
def test_build_model_refuses_kernels_it_cannot_run_on_cpu(kernels, exc):
    with pytest.raises(exc, match="kernels"):
        build_model(ModelConfig(**SMALL, kernels=kernels), device="cpu")


def test_cpu_run_launches_no_kernel():
    before = fused_attention.launches
    model = build_model(ModelConfig(**SMALL), device="cpu")
    assert model.cfg.kernels == "torch"
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, 40, (4, 6)) for k in ("seq_d1", "seq_d2")}
    u1, _ = user_representations(model, batch)
    full_catalog_topk(u1, model.item_embedding.detach(), model.predict.state_dict(), k=5)
    q = torch.zeros(2, 6, 16)
    fused_attention(q, q, q, torch.zeros(1, 1, 1, 6), 0, 2, 0.0)
    assert fused_attention.launches == before


def test_cpu_lazy_step_launches_no_kernel():
    """A whole lazy step on the CPU, through the dispatching wrappers as a
    kernels='cuda' model would call them: plain attention through autograd,
    plain scatters, and not one launch counted."""
    counts = lambda: (fused_attention.launches, fused_attention.backward_launches,  # noqa: E731
                      fused_attention.long_forward_launches,
                      fused_attention.long_backward_launches,
                      scatter_set_unique.launches, scatter_set_unique3.launches,
                      embedding_gather.launches, scoring_head.launches,
                      max_affinity_blocked.launches, max_affinity_smalln.launches)
    before = counts()
    model = build_model(ModelConfig(**SMALL), device="cpu")
    model.cfg = dataclasses.replace(model.cfg, kernels="cuda")  # lazy step: wrappers
    rng = np.random.default_rng(0)
    batch = {"target": rng.integers(0, 40, 4), "seq_d1": rng.integers(0, 40, (4, 6)),
             "seq_d2": rng.integers(0, 40, (4, 6)), "domain_id": rng.integers(0, 2, 4),
             "reject": np.full((4, 1), 40), "reject_counts": np.zeros(4, np.int64),
             "ob_label": np.ones(4, np.int64)}
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    pools = torch.arange(40).repeat(2, 1)
    for fused in (True, False):
        state = lazy.init_lazy_state(dict(model.named_parameters()), Adam(1e-3))
        step = lazy.make_lazy_train_step(model, Adam(1e-3), dr_e_w=0.1,
                                         fused_scatter=fused)
        _, m = step(state, batch, pools, torch.tensor([40, 40]), 3)
        assert torch.isfinite(m["loss"])
    assert counts() == before


def test_cpu_attention_keeps_autograd():
    """On CPU tensors the wrapper is the plain version, gradients included."""
    q = torch.randn(2, 6, 16, requires_grad=True, generator=torch.Generator().manual_seed(0))
    fused_attention(q, q, q, torch.zeros(1, 1, 6, 6), 0, 2, 0.0).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_the_port_ships_every_kernel_source():
    """Twelve CUDA sources under csrc/, each named by a wrapper's `_build.load`
    (the attention wrapper's four through its `_SOURCES`, the bf16 mode's
    four, native bf16 kernels of the one-head pair and of the long paths,
    through its `_LIBRARIES`, not as variants of another source; the bf16
    long paths' template width 256 as variants of theirs), and the
    packaging glob that ships them."""
    from amid_tpu_torch.ops import _build
    from amid_tpu_torch.ops import attention as attention_ops

    sources = sorted(p.stem for p in (REPO / "amid_tpu_torch" / "csrc").glob("*.cu"))
    assert sources == ["affinity", "attention_bwd", "attention_bwd_bf16", "attention_bwd_long",
                       "attention_bwd_long_bf16", "attention_fwd", "attention_fwd_bf16",
                       "attention_fwd_long", "attention_fwd_long_bf16", "gather_rows",
                       "scatter_rows", "scoring_head"]
    ops = "".join(p.read_text() for p in (REPO / "amid_tpu_torch" / "ops").glob("*.py"))
    for name in ("affinity", "gather_rows", "scatter_rows", "scoring_head"):
        assert f'_build.load("{name}")' in ops, name
    assert attention_ops._SOURCES == ["attention_fwd", "attention_fwd_long", "attention_bwd",
                                      "attention_bwd_long"]
    for name in ("attention_fwd_bf16", "attention_fwd_long_bf16", "attention_bwd_bf16",
                 "attention_bwd_long_bf16"):
        assert name in attention_ops._LIBRARIES and name not in _build.VARIANTS, name
        assert _build._source(name) == (REPO / "amid_tpu_torch" / "csrc" / f"{name}.cu", ())
    # the bf16 long paths' template width 256: builds of their own sources
    for name in ("attention_fwd_long", "attention_bwd_long"):
        wide = f"{name}_bf16_dh256"
        assert wide in attention_ops._LIBRARIES, wide
        assert _build._source(wide) == (REPO / "amid_tpu_torch" / "csrc" / f"{name}_bf16.cu",
                                        ("-DAMID_BF16_WIDE=1",))
    assert 'amid_tpu_torch = ["csrc/*.cu"]' in (REPO / "pyproject.toml").read_text()
    for name in sources:  # a __global__ kernel in each
        assert "__global__" in (REPO / "amid_tpu_torch" / "csrc" / f"{name}.cu").read_text()
