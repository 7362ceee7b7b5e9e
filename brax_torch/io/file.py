"""File open/exists/glob seam.

Counterpart of `brax_tpu/io/file.py`: a plain-filesystem implementation of
a gfile-style interface, so that cloud-storage backends can be slotted in
without touching callers.
"""

import glob as _glob
import os


def File(path: str, mode: str = "r"):
    """Opens a file, creating parent directories for write modes."""
    if "w" in mode or "a" in mode or "x" in mode:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
    return open(path, mode)


def Exists(path: str) -> bool:
    return os.path.exists(path)


def MakeDirs(path: str):
    os.makedirs(path, exist_ok=True)


def Glob(pattern: str):
    return _glob.glob(pattern)
