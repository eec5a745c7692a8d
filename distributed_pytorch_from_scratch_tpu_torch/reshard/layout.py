"""Checkpoint layout records and the `__layout__` stamp — the stamp's part
of the JAX `reshard/layout.py` (the redistribution planner and its
executor are not ported: ROADMAP Queue 1 item 7).

A `Layout` says where a checkpoint's tree lived: the mesh axes larger than
1, as (name, size) pairs in the JAX mesh's axis order (dp, pp, cp, ep,
tp), the per-leaf canonical spec, flat-keyed like the checkpoint's npz
members (``param/layers/wq/weight``), and the ZeRO stage. A spec is a
tuple with one entry per dim of the JAX leaf: an axis name, None, or a
tuple of names (the JAX `PartitionSpec`, without jax).

`save_checkpoint` writes `Layout.to_json()` into every rank file under
``__layout__``; the string is the one the JAX trainer writes for the same
mesh and family (`make_layout(mesh, model.canonical_specs()).to_json()`),
so the JAX reader takes a port checkpoint as stamped, not as a legacy
tp-only layout.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np

from ..parallel.layout import tp_dim

LAYOUT_KEY = "__layout__"
LAYOUT_VERSION = 1
# the JAX mesh's axes, in its order (`runtime/mesh.make_mesh`)
MESH_AXES = ("dp", "pp", "cp", "ep", "tp")
# per-layer modules whose "weight" the JAX tree keeps as (idim, odim)
_LINEARS = ("wq", "wk", "wv", "wo", "gate_proj", "up_proj", "down_proj",
            "fc", "proj")

Spec = Tuple[Any, ...]


def jax_key(key: str) -> Tuple[str, bool]:
    """(flat JAX key, stacked) of a port state-dict key: the per-layer
    leaves ``layers.{i}.{name}.{leaf}`` share one key, stacked on a leading
    num_layers axis; every other key maps one to one."""
    parts = key.split(".")
    if parts[0] == "layers":
        return "param/layers/" + "/".join(parts[2:]), True
    return "param/" + "/".join(parts), False


def transposed(key: str) -> bool:
    """Whether the JAX leaf of `key` is the transpose of the port's: the
    linear weights (torch (odim, idim), JAX (idim, odim)) and the llama
    head's weight."""
    name, leaf = key.split(".")[-2:]
    return leaf == "weight" and (name in _LINEARS or key == "lm_head.weight")


def canonical_specs(shapes: Dict[str, Iterable[int]]) -> Dict[str, Spec]:
    """{flat JAX key: spec} of a port state dict (any mapping of its keys to
    their shapes): the JAX `canonical_specs()` flattened. Each leaf takes
    'tp' on the dim `parallel.layout.tp_dim` names, seen in the JAX layout
    (transposed weights swap their dims; stacked leaves gain a leading
    None), and None elsewhere."""
    specs: Dict[str, Spec] = {}
    for key, shape in shapes.items():
        ndim = len(tuple(shape))
        spec = [None] * ndim
        dim = tp_dim(key)
        if dim is not None:
            spec[ndim - 1 - dim if transposed(key) else dim] = "tp"
        jkey, stacked = jax_key(key)
        specs[jkey] = (None, *spec) if stacked else tuple(spec)
    return specs


def _spec_to_jsonable(spec: Spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _spec_from_jsonable(entries: list) -> Spec:
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Mesh axes of size > 1, flat canonical specs and the ZeRO stage."""

    mesh_axes: Tuple[Tuple[str, int], ...]
    specs: Dict[str, Spec]
    zero_stage: int = 0

    def describe(self) -> str:
        axes = "x".join(f"{a}{s}" for a, s in self.mesh_axes) or "single"
        return f"{axes} zero{self.zero_stage}"

    def signature(self) -> tuple:
        """Order-independent comparable form (the mesh axis order is a
        construction detail, not a layout difference)."""
        return (tuple(sorted(self.mesh_axes)), int(self.zero_stage),
                tuple(sorted((k, tuple(_spec_to_jsonable(s)))
                             for k, s in self.specs.items())))

    def to_json(self) -> str:
        return json.dumps({
            "version": LAYOUT_VERSION,
            "mesh_axes": [[a, s] for a, s in self.mesh_axes],
            "zero_stage": int(self.zero_stage),
            "specs": {k: _spec_to_jsonable(s)
                      for k, s in sorted(self.specs.items())},
        })

    @classmethod
    def from_json(cls, text: str) -> "Layout":
        d = json.loads(text)
        if d.get("version", 0) > LAYOUT_VERSION:
            raise ValueError(
                f"checkpoint layout stamp is version {d['version']}; this "
                f"reader understands <= {LAYOUT_VERSION} — update before "
                f"resharding")
        return cls(mesh_axes=tuple((a, int(s)) for a, s in d["mesh_axes"]),
                   specs={k: _spec_from_jsonable(v)
                          for k, v in d["specs"].items()},
                   zero_stage=int(d["zero_stage"]))


def layouts_equal(a: Layout, b: Layout) -> bool:
    return a.signature() == b.signature()


def make_layout(mesh_axes, specs: Dict[str, Spec],
                zero_stage: int = 0) -> Layout:
    """A Layout from (axis, size) pairs (or a dict axis -> size), put in
    the JAX mesh's axis order with the size-1 axes dropped, and flat
    specs (`canonical_specs`)."""
    sizes = dict(mesh_axes)
    unknown = sorted(set(sizes) - set(MESH_AXES))
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; the JAX mesh has "
                         f"{MESH_AXES}")
    axes = tuple((a, int(sizes[a])) for a in MESH_AXES
                 if int(sizes.get(a, 1)) > 1)
    return Layout(mesh_axes=axes, specs=dict(specs),
                  zero_stage=int(zero_stage))


def stamp(shard: Dict[str, Any], layout: Layout) -> None:
    """Add the stamp to one rank file's members, about to be written."""
    shard[LAYOUT_KEY] = np.asarray(layout.to_json())


def read_stamp(npz) -> Optional[Layout]:
    """The Layout stamped into an open NpzFile (or a dict of members), None
    for a file written before the stamp."""
    try:
        member = npz[LAYOUT_KEY]
    except KeyError:
        return None
    return Layout.from_json(str(member.item() if hasattr(member, "item")
                                else member))
