"""Precomputed kinematic-tree structure masks (a copy of brax_tpu/v2/masks.py).

Tree *summations* (ancestor-chain accumulation down the tree, subtree
accumulation up the tree) are linear operators, so instead of unrolling them
level-by-level with gathers and concats (scan.tree), they lower to a single
masked matmul with a 0/1 structure matrix computed once per System topology.
This is the TPU-first formulation of the reference's scan.tree reductions
(reference brax/v2/scan.py:53-134 used by dynamics.py:76-148, mass.py:27-52,
constraint.py:28-58): one MXU-shaped op per reduction instead of O(depth)
gather/concat chains, which is what makes the generalized pipeline's op count
small enough to be launch-efficient at large env batches.

Masks depend only on the System's static fields (link_parents, link_types),
so they are cached per-topology and folded into the program as constants.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from brax_torch.v2.base import QD_WIDTHS


@functools.lru_cache(maxsize=None)
def _structure(
    link_parents: Tuple[int, ...], link_types: str
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (anc_link, subtree, dof_anc, dof_pair) structure matrices.

    anc_link[l, j] = 1 iff link j is an ancestor-or-self of link l   (nl, nl)
    subtree[l, j]  = 1 iff link j is in the subtree-or-self of l     (nl, nl)
    dof_anc[l, d]  = 1 iff dof d belongs to an ancestor-or-self of l (nl, nd)
    dof_pair[i, j] = 1 iff dof j's link is an ancestor-or-self of
                     dof i's link                                    (nd, nd)
    """
    nl = len(link_parents)
    anc = np.zeros((nl, nl), dtype=np.float32)
    for i in range(nl):
        j = i
        while j != -1:
            anc[i, j] = 1.0
            j = link_parents[j]

    dof_link = []
    for i, t in enumerate(link_types):
        dof_link.extend([i] * QD_WIDTHS[t])
    nd = len(dof_link)
    dof_anc = anc[:, dof_link] if nd else np.zeros((nl, 0), dtype=np.float32)

    link_of = np.asarray(dof_link, dtype=np.int64)
    if nd:
        dof_pair = anc[np.ix_(link_of, link_of)]
    else:
        dof_pair = np.zeros((0, 0), dtype=np.float32)

    return anc, anc.T.copy(), dof_anc, dof_pair


def ancestor_links(sys) -> np.ndarray:
    """(nl, nl) ancestor-or-self indicator: out[l, j]=1 iff j ∈ anc*(l)."""
    return _structure(tuple(sys.link_parents), sys.link_types)[0]


def subtree_links(sys) -> np.ndarray:
    """(nl, nl) subtree-or-self indicator: out[l, j]=1 iff j ∈ sub*(l)."""
    return _structure(tuple(sys.link_parents), sys.link_types)[1]


def ancestor_dofs(sys) -> np.ndarray:
    """(nl, nd) indicator of dofs on the ancestor-or-self chain of each link."""
    return _structure(tuple(sys.link_parents), sys.link_types)[2]


def dof_pairs(sys) -> np.ndarray:
    """(nd, nd) indicator: dof j's link is ancestor-or-self of dof i's link.

    This is exactly the sparsity pattern the reference's nested tree walk
    builds for the CRB mass matrix (reference mass.py:40-49), as a constant.
    """
    return _structure(tuple(sys.link_parents), sys.link_types)[3]
