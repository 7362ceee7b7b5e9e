"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Every `.cu` under `brax_torch/csrc/` has a plain C interface.  It is
compiled for sm_90a at first use into `build/brax_torch/` beside the
package, keyed by a hash of its source and the flags, and loaded with
ctypes.  A source may add flags of its own on a line
`// nvcc-flags: ...`.  nvcc's ptxas report (registers, spills) is kept
beside each library as `<name>.ptxas.txt`.  `build(*sources)` starts one nvcc for every
source that has no build yet, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "brax_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def toolkit(name: str) -> str:
    """The path of a CUDA toolkit program (nvcc, cuobjdump)."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found: the CUDA toolkit is needed to build brax_torch/csrc")
    return path


def sass_count(library: Path, opcode: str) -> int:
    """How many SASS instructions of `opcode` (e.g. HGMMA) a built library
    holds, by cuobjdump --dump-sass."""
    out = subprocess.run([toolkit("cuobjdump"), "--dump-sass", str(library)],
                         capture_output=True, text=True, check=True).stdout
    return sum(opcode in line for line in out.splitlines())


def source_flags(source: Path) -> list:
    """The flags a source asks for on its `// nvcc-flags:` lines."""
    return [flag for line in source.read_text().splitlines()
            if line.startswith("// nvcc-flags:") for flag in line.split(":", 1)[1].split()]


def library_path(source: Path) -> Path:
    """Where the build of `source` (as it is now) lives."""
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{key}.so"


def build(*sources: Path) -> Dict[Path, Path]:
    """Compiles every source that has no build of its present text.

    The nvcc processes run in parallel.  Returns {source: library path}.
    """
    outs = {src: library_path(src) for src in sources}
    todo = [src for src, out in outs.items() if not out.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [toolkit("nvcc"), *NVCC_FLAGS, *source_flags(src), "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append((src, tmp, proc))
    errors = []
    for src, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        try:
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {src}:\n{stdout}\n{stderr}")
                continue
            outs[src].with_suffix(".ptxas.txt").write_text(stdout + stderr)
            os.replace(tmp, outs[src])
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip()


class Library:
    """One compiled source, built and loaded at first use.

    `setup(lib)` declares the C functions' argument types and checks the
    library's compile-time limits against the Python side's.
    """

    def __init__(self, source: Path, setup: Callable[[ctypes.CDLL, Path], None]):
        self.source = source
        self._setup = setup
        self._lib = None
        self.ptxas = ""

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            path = build(self.source)[self.source]
            lib = ctypes.CDLL(str(path))
            self._setup(lib, path)
            self.ptxas = path.with_suffix(".ptxas.txt").read_text()
            self._lib = lib
        return self._lib

    def ptxas_report(self) -> str:
        """nvcc's ptxas output for the loaded library (registers, spills)."""
        self.get()
        return self.ptxas
