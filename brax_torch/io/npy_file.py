"""Trajectory dump as .npy.

Counterpart of `brax_tpu/io/npy_file.py`: a dict of four arrays, "pos",
"rot", "vel" and "ang", each stacked over the trajectory's frames, so
(frames, bodies, 3) / (frames, bodies, 4) for QPs of one env.
"""

import io as _io
from typing import List

import numpy as onp

from brax_torch.io import file
from brax_torch.sim.types import QP


def save(path: str, qps: List[QP]):
    """Saves a trajectory of QP states as a dict-of-arrays npy."""
    frames = [qp.numpy() for qp in qps]
    data = {key: onp.stack([f[i] for f in frames])
            for i, key in enumerate(("pos", "rot", "vel", "ang"))}
    buf = _io.BytesIO()
    onp.save(buf, data, allow_pickle=True)
    with file.File(path, "wb") as fout:
        fout.write(buf.getvalue())


def load(path: str):
    with file.File(path, "rb") as fin:
        return onp.load(_io.BytesIO(fin.read()), allow_pickle=True).item()
