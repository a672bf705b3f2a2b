"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C entry point and compiles on its own
with `nvcc -gencode arch=compute_90a,code=sm_90a` into
`build/lib<name>-<hash>.so` at the repository root (listed in
`.gitignore`). The hash covers the sources, the shared header and the
flags, so an edited kernel rebuilds and a stale library is never loaded.
No PyTorch headers are compiled, so a build takes seconds
(`torch.utils.cpp_extension.load` takes minutes).

Nothing here runs at import time: the CPU tests import every module, and
`nvcc` is needed only when a kernel is first launched on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("flash_prefill", "flash_backward", "paged_attention",
           "paged_prefill", "rmsnorm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named kernel that has no up-to-date library, one
    `nvcc` per source, all started together. Returns build seconds per
    kernel (0.0 when already built). The compiler's resource report
    (`-Xptxas -v`) lands in `build/<name>.log`. Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    secs: Dict[str, float] = {}
    for name in names:
        out = _target(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, log, tmp, out, t0) in procs.items():
        rc = proc.wait()
        secs[name] = time.perf_counter() - t0
        log.close()
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)   # atomic: concurrent builders never see half
    if failed:
        logs = "\n".join((BUILD_DIR / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return secs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _libs[name] = lib
    return lib


def sass_counts(name: str, ops=("HGMMA", "HMMA")) -> Dict[str, int]:
    """How many instructions of each opcode in `ops` the built library
    of kernel `name` holds, from `cuobjdump -sass` (the toolkit's
    disassembler beside nvcc): the proof that a kernel's products run on
    the tensor cores (HGMMA is wgmma, HMMA is mma.sync)."""
    lib = _target(name)
    if not lib.exists():
        raise RuntimeError(f"{lib} is not built")
    tool = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    words = [ln.split() for ln in sass.splitlines() if "/*" in ln]
    return {op: sum(1 for w in words for t in w if t.split(".")[0] == op)
            for op in ops}


def log_text(name: str) -> str:
    """The last build's compiler report for `name` ('' if none)."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""
