"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ``ctypes``. Libraries land in
``paddle_tpu_torch/_build/`` under a name that carries a digest of the
source and of the ``csrc/*.cuh`` headers it includes, so an edited
kernel or header is rebuilt and an unchanged one is reused.
Nothing here runs at import: the first CUDA launch of a wrapper calls
:func:`load`, and ``chip_smoke.py`` calls :func:`build` up front to
compile every source in parallel."""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = ["KERNEL_SOURCES", "build", "lib_path", "load", "nvcc_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# kernel name -> source file under csrc/
KERNEL_SOURCES = {
    "rms_norm": "rms_norm.cu",
    "paged_attention": "paged_attention.cu",
    "flash_attention": "flash_attention.cu",
    "rope": "rope.cu",
    "adamw": "adamw.cu",
    "xent": "xent.cu",
    "moe_gather": "moe_gather.cu",
    "decode_layer": "decode_layer.cu",
    "weight_only_gemm": "weight_only_gemm.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin``, else the toolkit's
    standard install prefix; raises if none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/ at first CUDA use")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> List[Path]:
    """The source of kernel ``name`` and every ``csrc/`` header it
    includes, directly or through another header."""
    seen, todo = [], [CSRC / KERNEL_SOURCES[name]]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())
                 if (CSRC / inc).exists()]
    return seen


def lib_path(name: str) -> Path:
    """The library's path, named by a digest of the source, the headers
    it includes and the flags: an edited header rebuilds every source
    that includes it."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None,
          ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile the named kernels (all by default) that are not built
    yet: one ``nvcc`` process per source, all started together. Returns
    ``{name: compiler output}`` for the sources compiled in this call
    (the register/shared-memory report when ``ptxas_verbose``). Raises
    with the compiler's output if any build fails."""
    names = list(KERNEL_SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS]
        if ptxas_verbose:
            cmd.append("-Xptxas=-v")
        cmd += ["-o", str(tmp), str(CSRC / KERNEL_SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if
    needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
