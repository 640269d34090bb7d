"""Builds the port's CUDA kernels from `amid_tpu_torch/csrc/` and loads them.

Each `csrc/<name>.cu` exposes a plain C entry point and is compiled by `nvcc`
into its own shared library, loaded with `ctypes` (no PyTorch headers, so a
build takes seconds); sources may include the shared headers `csrc/*.cuh`.
Libraries go to `amid_tpu_torch/_build/` (git-ignored), named by a hash of
the source, the headers and the flags, so an edited source or header is
rebuilt on its next use and an unchanged one is loaded as it is. `build()`
starts one `nvcc` per library at once and waits for all of them. A
variant (`VARIANTS`) is a source compiled once more with a define, into a
library of its own: the fp32 long attention paths' builds for padded head
widths (`attention_fwd_long_pad`, `attention_bwd_long_pad`,
`-DAMID_ATTN_PAD=1`), whose instances read dh at run time, so that the
other build keeps each template width's own code and the second set of
instances compiles beside the first instead of after it; and the bf16 long
attention paths' builds at template width 256
(`attention_fwd_long_bf16_dh256`, `attention_bwd_long_bf16_dh256`,
`-DAMID_BF16_WIDE=1`), whose instances alone take dh 129 to 256, so that
their `nvcc` runs beside the other widths' instead of adding to it. The bf16 mode of
the attention kernels has sources of its own, built as any other source:
the one-head pair (`csrc/attention_fwd_bf16.cu`, `csrc/attention_bwd_bf16.cu`:
`mma.sync` k16 bf16) and the long paths (`csrc/attention_fwd_long_bf16.cu`,
`csrc/attention_bwd_long_bf16.cu`: `wgmma` k16 bf16).

Nothing is built at import: the first kernel call builds what it needs.

`python3 -m amid_tpu_torch.ops._build affinity [...]` compiles the named
sources once more with `-Xptxas -v` into a temporary directory, prints
ptxas's report and, per kernel instance, its registers and spill bytes, and
exits non-zero if any instance spills or has its `wgmma` serialised (ptxas's
C7512/C7518 infos). `python3 -m amid_tpu_torch.ops._build --seconds [...]`
compiles each named library (all of them if none is named) alone, one after
another, into a temporary directory and prints each one's seconds: what
one `nvcc` of the parallel build takes with the machine to itself.

The launch path every wrapper shares is kept thin. `bind` types one C entry
point; a wrapper binds its functions at its first launch and keeps them in
module-level names, so a later launch looks nothing up. `raw_stream(index)`
gives the current CUDA stream's handle as an integer by the cheapest call the
installed torch has; which one is decided once, at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90 (227 KB)

# library name -> (the source it compiles, extra nvcc flags): the fp32 long
# attention paths' builds for head widths below their template width
# (csrc/attention_common.cuh), and the bf16 long paths' builds at template
# width 256
VARIANTS = {
    **{f"{n}_pad": (n, ("-DAMID_ATTN_PAD=1",)) for n in (
        "attention_fwd_long", "attention_bwd_long")},
    **{f"{n}_bf16_dh256": (f"{n}_bf16", ("-DAMID_BF16_WIDE=1",)) for n in (
        "attention_fwd_long", "attention_bwd_long")},
}

_loaded: dict[str, ctypes.CDLL] = {}


def _source(name: str) -> tuple[Path, tuple[str, ...]]:
    """The source file of library `name` and the flags it adds."""
    stem, flags = VARIANTS.get(name, (name, ()))
    return CSRC / f"{stem}.cu", flags


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels of amid_tpu_torch are built from source at first use"
    )


def _lib_path(name: str) -> Path:
    # the shared headers are part of every source's key: a header edit rebuilds
    source, flags = _source(name)
    src = b"".join(p.read_bytes() for p in [source, *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS + flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str]) -> dict[str, Path]:
    """Compiles every named source whose library is missing, all at once.

    Returns each name's library path. Raises with nvcc's output if a build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for n, p in todo.items():
        # unique temp name per process, renamed into place when complete
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        source, flags = _source(n)
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(source)]
        procs[n] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name` (`csrc/<name>.cu` or a variant), built
    first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib


def bind(fn, argtypes, restype=ctypes.c_int):
    """Types the C entry point `fn` of a loaded library and returns it."""
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def _stream_getter():
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:  # one C call, no Stream object
        return raw
    if not hasattr(torch.cuda, "current_stream"):
        raise ImportError(
            "this torch has neither torch._C._cuda_getCurrentRawStream nor "
            "torch.cuda.current_stream; the kernels launch on torch's current stream"
        )
    return lambda index: torch.cuda.current_stream(index).cuda_stream


raw_stream = _stream_getter()  # raw_stream(device_index) -> cudaStream_t as an int


def ptxas_report(name: str) -> tuple[str, list[tuple[str, int, int]], bool]:
    """nvcc's output for library `name` (`csrc/<name>.cu` or a variant) with
    `-Xptxas -v`, then (kernel, registers, spill bytes) for each compiled
    function and whether ptxas serialised any `wgmma` (C7512/C7518)."""
    source, flags = _source(name)
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "x.so"), str(source)], capture_output=True, text=True)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    rows, kernel, spill = [], None, 0
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            rows.append((kernel, int(m.group(1)), spill))
            kernel, spill = None, 0
    return out, rows, bool(re.search(r"C75(12|18)", out))


def build_seconds(names: list[str]) -> dict[str, float]:
    """Each named library compiled alone into a temporary directory, one
    after another: name -> seconds of its `nvcc`."""
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            source, flags = _source(name)
            t0 = time.perf_counter()
            subprocess.run([nvcc_path(), *NVCC_FLAGS, *flags, "-o",
                            os.path.join(tmp, f"{name}.so"), str(source)], check=True)
            seconds[name] = time.perf_counter() - t0
    return seconds


def _main(names: list[str]) -> int:
    if names[:1] == ["--seconds"]:
        every = sorted({p.stem for p in CSRC.glob("*.cu")} | set(VARIANTS))
        for name, s in build_seconds(names[1:] or every).items():
            print(f"{name}: {s:.1f} s", flush=True)
        return 0
    bad = False
    for name in names:
        out, rows, serialised = ptxas_report(name)
        print(out)
        for kernel, regs, spill in rows:
            print(f"{name}.cu {kernel}: {regs} registers, {spill} bytes spilled")
        spills = sum(s for _, _, s in rows)
        print(f"{name}.cu: {len(rows)} functions, {spills} bytes spilled, "
              f"wgmma serialised: {serialised}")
        bad |= spills > 0 or serialised
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:] or ["affinity"]))
