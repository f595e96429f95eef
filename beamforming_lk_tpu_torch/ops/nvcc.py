"""Build the package's CUDA sources into shared libraries with ``nvcc``,
and the repository's host C source (``csrc/ingest.c``) with ``cc``.

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
# The flags of csrc/Makefile, for the host C sources.
CC_FLAGS = ["-O3", "-Wall", "-Wextra", "-fPIC", "-shared", "-lpthread"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def nvcc_command() -> list:
    """The compiler and flags of the CUDA sources."""
    return [_nvcc(), *ARCH_FLAGS, *FLAGS]


def cc_command() -> list:
    """The compiler and flags of the host C sources."""
    found = shutil.which("cc")
    if not found:
        raise RuntimeError("cc not found: the native ingest needs a C compiler")
    return [found, *CC_FLAGS]


def _target(name: str, sources, command):
    """(library path, temporary path, compiler command) of one build, keyed
    by the sources and flags."""
    digest = hashlib.sha256()
    for flag in command[1:]:
        digest.update(flag.encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    tmp = f"{out}.{os.getpid()}.tmp"
    return out, tmp, [*command, "-o", tmp, *sources]


def build_all(specs, command=None) -> list:
    """Paths of the shared libraries of ``specs`` [(name, sources), ...],
    compiled by ``command`` (:func:`nvcc_command` unless given).  Every
    missing library is compiled, all at once (one compiler process each).
    The compiler's output (register and shared-memory use from ``-Xptxas
    -v``) is kept beside each library as ``<library>.log``."""
    command = nvcc_command() if command is None else command
    targets = [_target(name, sources, command) for name, sources in specs]
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
            failed.append(f"{cmd[0]} failed building {name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [out for out, _, _ in targets]


def build(name: str, sources, command=None) -> str:
    """Path of the shared library built from ``sources`` (see
    :func:`build_all`)."""
    return build_all([(name, sources)], command)[0]
