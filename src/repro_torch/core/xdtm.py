"""XDTM: two-level dataset typing & mapping (paper §3.2, §3.5).

Logical datasets are typed structures independent of physical layout;
*mappers* resolve logical structure -> physical members at runtime, which is
what enables dynamic workflow expansion (`foreach` over data whose members
are only known after an upstream task ran — the Montage overlap table).

Mappers provided (mirroring the paper's run_mapper / csv_mapper / file
mapper, plus the TPU-framework addition):

  * FileSystemMapper — groups files in a directory by prefix + suffix set
    (the fMRI `run_mapper`: volume = .img + .hdr pair)
  * CSVMapper — maps a delimited table into a list of typed records
    (the Montage `csv_mapper` for the overlap list)
  * ShardMapper — maps a logical global array to physical .npz shard files
    (the XDTM idea applied to checkpoints / data-parallel arrays: logical
    type = global shape, mapping = shard layout)
"""
from __future__ import annotations

import dataclasses
import os
import re
import sys
from typing import Any, Callable

# numpy is imported lazily: it is only needed by `ShardMapper` and by
# typechecks against numpy scalars, and a pure-scheduler process (the
# streaming-expansion benchmarks, DESIGN.md §9) should not pay ~35 MB of
# RSS for an import it never uses.


# ---------------------------------------------------------------------------
# logical type system (C-style syntax for XML-Schema-backed types, §3.2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Primitive:
    name: str  # int | float | string | boolean | file


@dataclasses.dataclass(frozen=True)
class Struct:
    name: str
    fields: tuple[tuple[str, Any], ...]  # (field name, type)


@dataclasses.dataclass(frozen=True)
class ArrayOf:
    item: Any


INT = Primitive("int")
FLOAT = Primitive("float")
STRING = Primitive("string")
FILE = Primitive("file")


def typecheck(value: Any, t: Any) -> bool:
    if isinstance(t, Primitive):
        # numpy scalars only exist if numpy is already imported, so the
        # fallback probe via sys.modules never triggers the import itself
        if t.name == "int":
            if isinstance(value, int):
                return True
            np = sys.modules.get("numpy")
            return np is not None and isinstance(value, np.integer)
        if t.name == "float":
            if isinstance(value, (int, float)):
                return True
            np = sys.modules.get("numpy")
            return np is not None and isinstance(value, np.floating)
        if t.name == "string":
            return isinstance(value, str)
        if t.name == "file":
            return isinstance(value, (str, PhysicalRef))
        return True
    if isinstance(t, Struct):
        if not isinstance(value, dict):
            return False
        return all(f in value and typecheck(value[f], ft)
                   for f, ft in t.fields)
    if isinstance(t, ArrayOf):
        return isinstance(value, (list, tuple)) and all(
            typecheck(v, t.item) for v in value)
    return True


@dataclasses.dataclass(frozen=True)
class PhysicalRef:
    """Pointer to physical data (file path + optional slice metadata)."""
    path: str
    meta: tuple = ()

    def exists(self) -> bool:
        return os.path.exists(self.path)


# ---------------------------------------------------------------------------
# mappers
# ---------------------------------------------------------------------------

class Mapper:
    """Resolve logical dataset -> physical members.  Called at *runtime*
    (dynamic workflow expansion, §3.6)."""

    logical_type: Any = None

    def members(self) -> list[Any]:
        raise NotImplementedError


class ListMapper(Mapper):
    """Map a logical dataset onto an in-memory list::

        ds = Dataset(ArrayOf(INT), ListMapper([1, 2, 3]))
        wf.foreach(ds, body)           # members resolved at expansion time
    """

    def __init__(self, items: list, logical_type: Any = None):
        self._items = list(items)
        self.logical_type = logical_type or ArrayOf(None)

    def members(self) -> list[Any]:
        return list(self._items)


class FileSystemMapper(Mapper):
    """Paper's run_mapper: group files sharing a prefix by suffix set.

    members() -> list of dicts {suffix: PhysicalRef} (e.g. volume =
    {"img": ..., "hdr": ...}), ordered by the trailing index in the name.
    """

    def __init__(self, location: str, prefix: str,
                 suffixes: tuple[str, ...] = ("img", "hdr")):
        self.location = location
        self.prefix = prefix
        self.suffixes = suffixes
        self.logical_type = ArrayOf(Struct("Volume", tuple(
            (s, FILE) for s in suffixes)))

    def members(self) -> list[dict]:
        rx = re.compile(re.escape(self.prefix) + r"[._-]?(\d+)\.(\w+)$")
        groups: dict[str, dict] = {}
        if not os.path.isdir(self.location):
            return []
        for fn in sorted(os.listdir(self.location)):
            m = rx.match(fn)
            if not m or m.group(2) not in self.suffixes:
                continue
            groups.setdefault(m.group(1), {})[m.group(2)] = PhysicalRef(
                os.path.join(self.location, fn))
        return [groups[k] for k in sorted(groups, key=int)
                if len(groups[k]) == len(self.suffixes)]


class CSVMapper(Mapper):
    """Paper's csv_mapper (Montage overlap table, Fig 2/3)."""

    def __init__(self, file: str, header: bool = True, hdelim: str = "|",
                 skip: int = 0, types: Struct | None = None):
        self.file = file
        self.header = header
        self.hdelim = hdelim
        self.skip = skip
        self.types = types
        self.logical_type = ArrayOf(types)

    def members(self) -> list[dict]:
        path = self.file.path if isinstance(self.file, PhysicalRef) else self.file
        with open(path) as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
        cols = None
        out = []
        body = lines
        if self.header:
            cols = [c.strip() for c in body[0].split(self.hdelim)]
            body = body[1 + self.skip:]
        for ln in body:
            vals = [v.strip() for v in ln.split(self.hdelim)]
            if cols is None:
                cols = [f"c{i}" for i in range(len(vals))]
            rec = dict(zip(cols, vals))
            if self.types is not None:
                for fname, ftype in self.types.fields:
                    if fname in rec and isinstance(ftype, Primitive):
                        if ftype.name == "int":
                            rec[fname] = int(rec[fname])
                        elif ftype.name == "float":
                            rec[fname] = float(rec[fname])
            out.append(rec)
        return out


class ShardMapper(Mapper):
    """Logical global array <-> physical .npz shards (XDTM for the TPU
    framework: the logical type is the global shape/dtype; the mapping is the
    shard layout).  Used by the checkpointer."""

    def __init__(self, directory: str, name: str, global_shape: tuple,
                 dtype: str, n_shards: int, shard_axis: int = 0):
        self.directory = directory
        self.name = name
        self.global_shape = tuple(global_shape)
        self.dtype = dtype
        self.n_shards = n_shards
        self.shard_axis = shard_axis

    def shard_path(self, i: int) -> str:
        return os.path.join(self.directory,
                            f"{self.name}.shard{i:04d}of{self.n_shards:04d}.npz")

    def members(self) -> list[PhysicalRef]:
        return [PhysicalRef(self.shard_path(i), meta=("shard", i))
                for i in range(self.n_shards)]

    def save(self, array) -> list[PhysicalRef]:
        import numpy as np
        os.makedirs(self.directory, exist_ok=True)
        parts = np.array_split(array, self.n_shards, axis=self.shard_axis)
        refs = []
        for i, part in enumerate(parts):
            np.savez(self.shard_path(i), data=part)
            refs.append(PhysicalRef(self.shard_path(i), meta=("shard", i)))
        return refs

    def load(self):
        import numpy as np
        parts = [np.load(self.shard_path(i))["data"]
                 for i in range(self.n_shards)]
        return np.concatenate(parts, axis=self.shard_axis)


# ---------------------------------------------------------------------------
# logical dataset handle
# ---------------------------------------------------------------------------

class Dataset:
    """A logical dataset bound to a mapper (paper line 26-27:
    ``Run bold1<run_mapper; location=..., prefix=...>``)."""

    def __init__(self, mapper: Mapper, name: str = ""):
        self.mapper = mapper
        self.name = name

    def members(self) -> list[Any]:
        return self.mapper.members()

    def __repr__(self):
        return f"<Dataset {self.name} via {type(self.mapper).__name__}>"
