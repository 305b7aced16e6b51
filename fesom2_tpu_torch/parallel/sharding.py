"""Contiguous-block placement of the model state over ranks (horizontal
domain decomposition).

The port of ``fesom2_tpu/parallel/sharding.py``.  The JAX package shards
the last (entity) axis of every field over a 1-D device mesh in contiguous
index blocks and lets GSPMD insert the halo collectives.  The port's ranks
take that placement through ``parallel/dist.py``: node ``i`` goes to rank
``i // (N / S)`` on a mesh whose entity counts are padded to a multiple of
``S`` (``setup_pi_model(..., pad_to=S)``, ``setup_soufflet_model(...,
pad_to=S)``); ``build_layout(part=block_partition(mesh, S))`` builds the
local meshes and exchanges of that partition, and ``shard_state`` /
``shard_forcing`` cut a global tree into its stacked per-rank pieces
(``dist.localize_tree``; ``dist.gather_tree`` puts them back).

Which placement each path uses:

- ``dist.build_layout`` / ``dist_layout_for_model`` without ``part``:
  ``partition.partition_nodes``, the weighted bisection with
  Kernighan-Lin sweeps (the JAX package's default, the smallest halo);
  with ``n_part``, the two-level partition;
- with ``part=block_partition(mesh, S)``: the contiguous blocks of this
  module, JAX's GSPMD placement (a larger halo on a mesh numbered without
  locality);
- the SSH preconditioner's blocks (``core/ssh.py``): the plain bisection
  ``partition._partition_numpy``.
"""
from __future__ import annotations

import numpy as np

from . import dist


def block_partition(mesh, S: int) -> np.ndarray:
    """Part id per node [N] (int32): node ``i`` on rank ``i // (N / S)``;
    N must be a multiple of S (pad the mesh to S)."""
    N = mesh.n_nodes
    if N % S:
        raise ValueError(f"{N} nodes are not a multiple of {S}: pad the "
                         f"mesh (pad_to={S})")
    return (np.arange(N) // (N // S)).astype(np.int32)


def block_layout(model, S: int) -> dist.DistLayout:
    """The layout of ``model`` over S ranks under the block placement."""
    return dist.dist_layout_for_model(model, S,
                                      part=block_partition(model.mesh, S))


def shard_state(layout: dist.DistLayout, state):
    """A global state (or any tree of fields) as its stacked per-rank
    pieces [S, ...] under ``layout``."""
    return dist.localize_tree(state, layout)


def shard_forcing(layout: dist.DistLayout, forcing):
    """A global forcing as its stacked per-rank pieces [S, ...]."""
    return dist.localize_tree(forcing, layout)
