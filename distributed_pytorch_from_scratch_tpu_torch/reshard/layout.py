"""Checkpoint layout records and the `__layout__` stamp — the port of the
JAX `reshard/layout.py`, which the redistribution planner (`plan.py`) and
its executors (`apply.py`) read.

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
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from ..parallel.layout import is_expert, tp_dim

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


def canonical_specs(shapes: Dict[str, Iterable[int]],
                    pp: int = 1) -> Dict[str, Spec]:
    """{flat JAX key: spec} of a port state dict (any mapping of its keys to
    their shapes): the JAX `canonical_specs()` flattened. Each leaf takes
    'tp' on the dim `parallel.layout.tp_dim` names, seen in the JAX layout
    (transposed weights swap their dims; stacked leaves gain a leading
    num_layers dim, 'pp' at pp > 1 and None otherwise, whatever the
    schedule: JAX stamps the gpipe specs), an expert leaf 'ep' on its
    expert dim, and None elsewhere."""
    specs: Dict[str, Spec] = {}
    for key, shape in shapes.items():
        ndim = len(tuple(shape))
        spec = [None] * ndim
        dim = tp_dim(key)
        if dim is not None:
            spec[ndim - 1 - dim if transposed(key) else dim] = "tp"
        if is_expert(key):
            spec[0] = "ep"
        jkey, stacked = jax_key(key)
        specs[jkey] = ((("pp" if pp > 1 else None), *spec) if stacked
                       else tuple(spec))
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

    def axis_size(self, name: str) -> int:
        return dict(self.mesh_axes).get(name, 1)

    @property
    def tp(self) -> int:
        return self.axis_size("tp")

    @property
    def dp(self) -> int:
        return self.axis_size("dp")

    def spec_for(self, key: str) -> Spec:
        """The spec of any flat key: the moments ride their param's spec
        (mu/nu shard exactly like the param)."""
        kind, _, rest = key.partition("/")
        pkey = "param/" + rest if kind in ("mu", "nu") else key
        try:
            return self.specs[pkey]
        except KeyError:
            raise KeyError(f"no spec for checkpoint key {key!r} "
                           f"(looked up {pkey!r})") from None

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


def spec_tp_dim(spec: Spec) -> Optional[int]:
    """The dim of a JAX-layout spec that names 'tp' (the one dim a rank file
    slices), or None."""
    for i, axis in enumerate(spec):
        if axis == "tp" or (isinstance(axis, tuple) and "tp" in axis):
            return i
    return None


def spec_zero_dim(spec: Sequence, shape: Sequence[int], dp: int,
                  start: int = 0) -> int:
    """The JAX `_zero_dim` on a JAX-layout spec and shape: the first dim at
    or after `start` that the spec leaves free and whose size dp divides,
    or -1. The one rule ZeRO's shards
    (`training/zero.zero_dim`) and the reshard planner share."""
    if dp == 1:
        return -1
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for i, (s, d) in enumerate(zip(spec, shape)):
        if i >= start and s is None and d > 0 and d % dp == 0:
            return i
    return -1


def mesh_axes_of(mesh) -> Tuple[Tuple[str, int], ...]:
    """(axis, size) pairs of a port `runtime.mesh.Mesh`, in the JAX mesh's
    order, the size-1 axes dropped."""
    sizes = {"dp": mesh.dp, "pp": mesh.pp, "cp": mesh.cp, "ep": mesh.ep,
             "tp": mesh.tp}
    return tuple((a, sizes[a]) for a in MESH_AXES if sizes[a] > 1)


def resolve_source_layout(ckpt_dir: str, step: int,
                          specs: Optional[Dict[str, Spec]] = None,
                          ext: str = "npz",
                          echo=print) -> Tuple[Layout, bool]:
    """(source Layout, is_legacy) of a checkpoint on disk, the JAX
    function. A stamped npz returns its stamp. Anything else — an npz
    from before the stamp, or a `.pth` rank span, which has no place for
    one — is legacy: the tp width comes from the file names (or
    `__tp_size__`), the ZeRO stage from `__zero_stage__` when present, the
    specs from the caller (`canonical_specs` of the model), with a loud
    note; a legacy source without specs raises, naming the fix."""
    from ..training.checkpoint import validate_checkpoint

    tp_size, rank_files = validate_checkpoint(ckpt_dir, step, ext=ext)
    zero_stage = 0
    if ext == "npz":
        with np.load(rank_files[min(rank_files)]) as npz:
            stamped = read_stamp(npz)
            if stamped is not None:
                return stamped, False
            try:
                zero_stage = int(npz["__zero_stage__"])
            except KeyError:
                pass
    if specs is None:
        raise ValueError(
            f"legacy checkpoint (no {LAYOUT_KEY} stamp) at {ckpt_dir} "
            f"iter {step}: pass the model's canonical_specs() (CLI: "
            f"--model <preset>) so the layout can be inferred")
    echo(f"note: legacy checkpoint at {ckpt_dir} iter {step} — layout "
         f"inferred from filenames (tp{tp_size}, zero{zero_stage}); "
         f"re-save to stamp it")
    return make_layout((("tp", tp_size),), specs,
                       zero_stage=zero_stage), True
