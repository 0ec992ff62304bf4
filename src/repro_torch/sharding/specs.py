"""Logical-axis sharding rules, the installed mesh and the tensor-parallel
context (the parts of ``repro.sharding.specs`` that the port's model code
reads).

Model code names the logical axes of each parameter ("heads", "ff",
"vocab", ...) in its spec tuples (``transformer.param_pspecs``).  A rule
set maps logical axes to mesh axes; ``logical_spec`` resolves a tuple to
one mesh axis or None per dimension under the rules installed by
``rules_context`` or ``mesh_context``, so a replica group derives each
weight's split axis from the model's own specs.

``mesh_context`` (and ``set_mesh``) install a ``launch.mesh.DeviceMesh``
with the rules filtered to its axes, as ``repro``'s do; ``current_mesh``
is what the expert-parallel MoE (``models.moe_ep``) reads.  Outside one
the model runs on one device, as ``repro`` does without a mesh.

``tp_context`` marks the calling thread as one shard of a tensor-parallel
group: the layers then run on the shard's local heads / ff / vocab slice,
and ``psum_tp`` (called after every row-parallel product: attention and
MLA ``wo``, MLP ``w2``, the MoE output, the vocab-sharded embedding)
sums the shards' partials through the group's reduction.  Outside a
context ``psum_tp`` is the identity, ``tp_axis()`` is None and
``tp_index()`` is 0, so single-device execution is untouched.  All three
states are thread-local: each shard of a group runs in its own thread,
and so sees no mesh, as a ``repro`` shard body sees none.  The autograd
engine runs a card's backward in a thread of its own too, so a
recomputation under remat reinstalls the forward's state
(``snapshot`` / ``installed``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]

# Logical tensor axes used by the model code (``repro``'s table).
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "moe_ff": None,
    "moe_embed": "data",
    "embed": "data",
    "act_embed": "model",
    "vocab": "model",
    "layers": None,
    "state": None,
}


class _State(threading.local):
    def __init__(self) -> None:
        self.mesh: Optional[Any] = None
        self.rules: Dict[str, MeshAxes] = dict(DEFAULT_RULES)


_STATE = _State()


def _rules(rules: Optional[Dict[str, MeshAxes]],
           mesh_axes: Optional[Sequence[str]]) -> Dict[str, MeshAxes]:
    """``DEFAULT_RULES`` updated with ``rules``, keeping only the mesh
    axes in ``mesh_axes`` where it is given (``repro``'s ``set_mesh``
    filter)."""
    base = dict(DEFAULT_RULES)
    if rules:
        base.update(rules)
    if mesh_axes is None:
        return base
    names = set(mesh_axes)

    def filt(v: MeshAxes) -> MeshAxes:
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in names else None
        kept = tuple(a for a in v if a in names)
        return kept if kept else None

    return {k: filt(v) for k, v in base.items()}


def set_mesh(mesh, rules: Optional[Dict[str, MeshAxes]] = None) -> None:
    """Install ``mesh`` (a ``launch.mesh.DeviceMesh`` or None) and the
    rules, filtered to its axes, in the calling thread."""
    _STATE.mesh, _STATE.rules = mesh, _rules(
        rules, None if mesh is None else mesh.axis_names)


def current_mesh():
    """The calling thread's mesh, or None."""
    return _STATE.mesh


def snapshot() -> Tuple[Any, Dict[str, MeshAxes]]:
    """The calling thread's (mesh, rules), for ``installed``."""
    return _STATE.mesh, _STATE.rules


@contextlib.contextmanager
def installed(state: Tuple[Any, Dict[str, MeshAxes]]):
    """Run the block under a (mesh, rules) ``snapshot``, then restore the
    calling thread's."""
    prev = snapshot()
    _STATE.mesh, _STATE.rules = state
    try:
        yield
    finally:
        _STATE.mesh, _STATE.rules = prev


def mesh_context(mesh, rules: Optional[Dict[str, MeshAxes]] = None):
    """``set_mesh`` for the block, then the previous mesh and rules."""
    return installed((mesh, _rules(
        rules, None if mesh is None else mesh.axis_names)))


def rules_context(mesh_axes: Sequence[str],
                  rules: Optional[Dict[str, MeshAxes]] = None):
    """Install ``DEFAULT_RULES`` updated with ``rules``, keeping only the
    mesh axes in ``mesh_axes`` (``repro``'s ``mesh_context`` filter),
    with no mesh change."""
    return installed((_STATE.mesh, _rules(rules, mesh_axes)))


def logical_spec(*axes: Optional[str]) -> Tuple[MeshAxes, ...]:
    """Mesh axes of a tensor whose dims carry the given logical axes (a
    mesh axis is used at most once).  Unknown logical axes raise."""
    rules = _STATE.rules
    used: set = set()

    def resolve(a: Optional[str]) -> MeshAxes:
        if a is None:
            return None
        if a not in rules:
            raise KeyError(
                f"unknown logical axis {a!r}; known axes: {sorted(rules)}")
        v = rules[a]
        if v is None:
            return None
        vs = (v,) if isinstance(v, str) else tuple(v)
        kept = tuple(x for x in vs if x not in used)
        used.update(kept)
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else kept

    return tuple(resolve(a) for a in axes)


# ---------------------------------------------------------------------------
# Tensor-parallel execution context (models/tp.py)
# ---------------------------------------------------------------------------

class _TPState(threading.local):
    def __init__(self) -> None:
        self.axis: Optional[str] = None
        self.index = 0
        self.reduce: Optional[Callable] = None


_TP = _TPState()


def tp_axis() -> Optional[str]:
    """The group's axis name while this thread runs a TP shard, else
    None."""
    return _TP.axis


def tp_index() -> int:
    """This thread's shard position in its group (0 outside one)."""
    return _TP.index


@contextlib.contextmanager
def tp_context(axis: str, index: int, reduce: Callable):
    """Run the block as shard ``index`` of a group whose ``reduce(index,
    x)`` returns the sum of every shard's ``x``."""
    prev = (_TP.axis, _TP.index, _TP.reduce)
    _TP.axis, _TP.index, _TP.reduce = axis, index, reduce
    try:
        yield
    finally:
        _TP.axis, _TP.index, _TP.reduce = prev


def psum_tp(x):
    """Sum ``x`` over the TP group inside a TP context (the row-parallel
    combine: each shard holds a partial sum over its slice of the
    contracted dimension); the identity outside one.  Inside one it
    charges an active cost counter (``launch.hlo_cost``) with an
    ``all-reduce`` of ``x``'s bytes, as ``repro``'s ``psum`` shows."""
    if _TP.reduce is None:
        return x
    from ..kernels.backend import charged
    with charged("psum_tp", {"collective": "all-reduce",
                             "bytes": x.numel() * x.element_size()}):
        return _TP.reduce(_TP.index, x)
