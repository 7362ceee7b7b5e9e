"""Static index plans over the link axis.

Counterpart of `brax_tpu/v2/scan.py`.  The JAX package scans a function
over link types one group at a time.  The port keeps the plans (which
links, q and qd columns belong to each type group, where each link's
columns start) and lets each caller gather, compute batch-first and scatter
back with them.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

from brax_torch.v2.base import Q_WIDTHS, QD_WIDTHS


class Group(NamedTuple):
    """One link type: its links and their q, qd columns."""

    typ: str
    links: Tuple[int, ...]
    q: Tuple[int, ...]
    qd: Tuple[int, ...]


@functools.lru_cache(maxsize=None)
def link_types(link_types: str) -> List[Group]:
    """Links grouped by type, in order of first appearance."""
    q_off, qd_off = offsets(link_types)
    groups = []
    for typ in sorted(set(link_types), key=link_types.index):
        links = [i for i, t in enumerate(link_types) if t == typ]
        groups.append(Group(
            typ, tuple(links),
            tuple(c for i in links for c in range(q_off[i], q_off[i] + Q_WIDTHS[typ])),
            tuple(c for i in links for c in range(qd_off[i], qd_off[i] + QD_WIDTHS[typ]))))
    return groups


@functools.lru_cache(maxsize=None)
def offsets(link_types: str) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Each link's first q column and first qd column."""
    q_off, qd_off, qo, do = [], [], 0, 0
    for t in link_types:
        q_off.append(qo)
        qd_off.append(do)
        qo += Q_WIDTHS[t]
        do += QD_WIDTHS[t]
    return tuple(q_off), tuple(qd_off)
