"""Build the package's CUDA sources into shared libraries with ``nvcc``.

Each library has a plain C interface and is loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Builds go to
``beamforming_lk_tpu_torch/_build/`` keyed by a hash of the sources and
flags, happen at first use, and are written under a temporary name and
renamed, so concurrent builders never load a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false keeps every multiply and add separately rounded, as the
# tensor ops of the plain twins are, so the row-level arithmetic (probe
# geometry, discriminants, merge tests) rounds at the same places.
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-fmad=false", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str, sources):
    """(library path, temporary path, nvcc command) of one build, keyed by
    the sources and flags."""
    digest = hashlib.sha256()
    for flag in ARCH_FLAGS + FLAGS:
        digest.update(flag.encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    tmp = f"{out}.{os.getpid()}.tmp"
    return out, tmp, [_nvcc(), *ARCH_FLAGS, *FLAGS, "-o", tmp, *sources]


def build_all(specs) -> list:
    """Paths of the shared libraries of ``specs`` [(name, sources), ...].
    Every missing library is compiled, all at once (one ``nvcc`` process
    each).  The compiler's output (register and shared-memory use from
    ``-Xptxas -v``) is kept beside each library as ``<library>.log``."""
    targets = [_target(name, sources) for name, sources in specs]
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = [
        (name, out, tmp, cmd,
         subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True))
        for (name, _), (out, tmp, cmd) in zip(specs, targets)
        if not os.path.exists(out)
    ]
    failed = []
    for name, out, tmp, cmd, proc in running:
        log, _ = proc.communicate()
        with open(out + ".log", "w") as f:
            f.write(" ".join(cmd) + "\n" + log)
        if proc.returncode:
            failed.append(f"nvcc failed building {name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [out for out, _, _ in targets]


def build(name: str, sources) -> str:
    """Path of the shared library built from ``sources`` (see
    :func:`build_all`)."""
    return build_all([(name, sources)])[0]
