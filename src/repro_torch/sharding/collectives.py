"""EDRA dissemination tree as collectives over the entries of a mesh axis
(the port of ``repro.sharding.collectives``; DESIGN.md §2, level 2).

EDRA's rules map 1:1 onto a recursive-doubling schedule over a ring of
n peers:

  Rule 7  (send M(l) to succ(p, 2^l))      -> peer i's buffer goes to
                                              (i + 2^l) % n in round l
  Rule 3  (aggregate everything acked)     -> concatenate accumulated blocks
  Rule 8  (discharge past the reporter)    -> stop at n (log2 n rounds)
  Theorem 1 (exactly-once, log time)       -> each block moves exactly once
                                              per round, rho = log2(n) rounds

There is no ``shard_map`` in one process, so each function takes the
peers' tensors as a list in ring order, each on its peer's entry, and
returns such a list; a round is n explicit sends, each a ``.to()`` onto
the receiver's entry (a no-op where two peers share an entry, as the
shards of one card do).  Every step is a torch op, so autograd
differentiates through the collectives.  ``repro``'s ``shard_map_compat``
and ``_axis_size`` exist for jax's version differences and have no
counterpart here.

Each function charges an active cost counter (``launch.hlo_cost``) with
what ``repro``'s compiled collective would show, summed over the peers:
every round's sends as ``collective-permute`` bytes (``repro`` runs them
as ``ppermute``), and ``edra_allreduce``'s reduction half as a
``reduce-scatter`` of the padded input; the sends' own copies are hidden
from the counter.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence

import numpy as np
import torch

from ..kernels.backend import charged


def _rounds(n: int) -> int:
    r = int(math.log2(n)) if n >= 1 else -1
    if 2 ** r != n:
        raise ValueError(f"EDRA collective needs a power-of-two axis, got {n}")
    return r


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def edra_allgather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-gather over the ring of peers via the EDRA tree: peer i's
    result is (n, *x.shape) on its entry, block j = peer j's tensor."""
    n = len(xs)
    rho = _rounds(n)
    # round l: every peer sends its 2^l blocks
    sent = sum(_nbytes(x) for x in xs) * ((1 << rho) - 1)
    with charged("edra_allgather", {"collective": "collective-permute",
                                    "bytes": sent}):
        return _allgather(xs, n, rho)


def _allgather(xs: Sequence[torch.Tensor], n: int,
               rho: int) -> List[torch.Tensor]:
    bufs = [x[None] for x in xs]                    # blocks [i]
    for l in range(rho):
        m = 1 << l
        # Rule 7: every peer ships its acknowledged set to succ(p, 2^l)
        recv = [None] * n
        for i in range(n):
            dst = (i + m) % n
            recv[dst] = bufs[i].to(xs[dst].device)
        # Rule 3 aggregation: prepend the predecessor's older blocks
        bufs = [torch.cat([recv[i], bufs[i]], dim=0) for i in range(n)]
    # bufs[i][j] = block of peer (i - n + 1 + j) mod n; rotate to ring order
    return [torch.roll(b, shifts=i + 1, dims=0) for i, b in enumerate(bufs)]


def edra_broadcast(xs: Sequence[torch.Tensor],
                   source: int = 0) -> List[torch.Tensor]:
    """Figure-1 dissemination: the reporter's tensor reaches all n peers
    in log2(n) rounds.  In round l the peers at offsets 0 .. 2^l - 1 from
    the reporter send to those at 2^l .. 2^(l+1) - 1 (exactly once, per
    Theorem 1); a peer outside the frontier holds zeros until it
    receives."""
    n = len(xs)
    rho = _rounds(n)
    # round l: 2^l peers send the reporter's tensor
    with charged("edra_broadcast", {"collective": "collective-permute",
                                    "bytes": _nbytes(xs[source])
                                    * ((1 << rho) - 1)}):
        val = [x if (i - source) % n == 0 else torch.zeros_like(x)
               for i, x in enumerate(xs)]
        for l in range(rho):
            m = 1 << l
            for i in range(m):
                src, dst = (source + i) % n, (source + i + m) % n
                val[dst] = val[src].to(xs[dst].device)
    return val


def edra_allreduce(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-reduce over the ring: a reduce-scatter (each peer p sums the
    peers' p-th pieces of the flattened, zero-padded tensors on its
    entry, in peer order 0 .. n-1, a fixed order; the reduction half has
    no analogue in the paper) and the EDRA-tree all-gather of the sums."""
    n = len(xs)
    _rounds(n)
    shape = xs[0].shape
    pad = (-xs[0].numel()) % n
    # the reduce-scatter's result: one 1/n piece of the padded input a peer
    with charged("edra_allreduce", {"collective": "reduce-scatter",
                                    "bytes": (xs[0].numel() + pad)
                                    * xs[0].element_size()}):
        flat = [torch.nn.functional.pad(x.reshape(-1), (0, pad))
                .reshape(n, -1) for x in xs]
        shards = []
        for p in range(n):
            dev = xs[p].device
            acc = flat[0][p].to(dev)
            for q in range(1, n):
                acc = acc + flat[q][p].to(dev)
            shards.append(acc)
    full = edra_allgather(shards)
    return [f.reshape(-1)[:f.numel() - pad].reshape(shape) for f in full]


def _map_peers(fn: Callable[[List[torch.Tensor]], List[torch.Tensor]],
               trees: List[Any]) -> List[Any]:
    """``fn`` on each leaf position of the peers' parallel dict trees."""
    if isinstance(trees[0], dict):
        out: List[dict] = [{} for _ in trees]
        for k in trees[0]:
            for o, r in zip(out, _map_peers(fn, [t[k] for t in trees])):
                o[k] = r
        return out
    return fn(trees)


def make_edra_allreduce(mesh, axis_name: str = "data"):
    """A pytree all-reduce over one axis of ``mesh`` (a
    ``launch.mesh.DeviceMesh``), usable as a gradient synchronizer: it
    takes one tree a mesh entry, in the mesh's row-major order, each on
    its entry, and returns the trees each leaf of which is summed over
    the peers along ``axis_name`` (``edra_allreduce``), per ring of that
    axis."""
    axis = mesh.axis_names.index(axis_name)
    dims = [len(mesh.devices), len(mesh.devices[0])]
    rings = np.moveaxis(np.arange(dims[0] * dims[1]).reshape(dims), axis,
                        -1).reshape(-1, dims[axis])

    def tree_allreduce(trees: Sequence[Any]) -> List[Any]:
        if len(trees) != len(rings) * dims[axis]:
            raise ValueError(f"{len(trees)} trees for a mesh of "
                             f"{len(rings) * dims[axis]} entries")
        out: List[Any] = [None] * len(trees)
        for ring in rings:
            res = _map_peers(edra_allreduce, [trees[e] for e in ring])
            for e, r in zip(ring, res):
                out[e] = r
        return out
    return tree_allreduce
