"""Built-in CRAFT-checkpointable data types (paper §2.2) + extension registry.

Paper default types → PyTorch analogs:

    POD               → ``Box`` holding int/float/complex/bool/str
    POD array         → ``np.ndarray`` (restored in place)
    POD multi-array   → ``np.ndarray`` (any rank; optional column selection)
    MPI derived type  → pytree of tensors (``PytreeCp``: state dicts, nested
                        dicts/lists/tuples) — snapshot (``update``) plays the
                        role of MPI_Pack
    CpBase derived    → any user subclass of :class:`repro_torch.core.cpbase.CpBase`

Additionally ``TorchTensorCp`` checkpoints a tensor held in a Box.  Both
tensor types write the reference package's file layout and JSON manifests
(``shard-<r>-<i>.bin`` + ``array-<r>.json``; ``leaf<i>-shard-<r>-<j>.bin``
+ ``tree-<r>.json``), so a version written by either package restores in
the other.  A tensor is one unsharded shard whose index spans the whole
array.  A ``DTensor`` (a tensor sharded over a ``DeviceMesh``) is its
rank's local shard, written under its global index (replicas included, as
the reference writes every addressable shard); a restore into a live
DTensor assembles only the rank's own extent from the shard files of any
topology and copies it into the local shard (``DTensor.from_local`` on the
live placements where it cannot copy in place).  Restores copy into the
live tensors in place when shape and dtype match (the tensor keeps its
identity and device), else they hand back a new tensor on the live
tensor's device.

The extension mechanism of paper §2.3 (Listing 6's "interface function") is
the :func:`register_adapter` registry: library authors map their type to a
wrapper factory once, after which ``Checkpoint.add()`` works directly on
objects of that type.
"""
from __future__ import annotations

import collections
from pathlib import Path
from typing import Any, Callable, Generic, Optional, TypeVar

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.core.cpbase import CheckpointError, CpBase, IOContext
from repro_torch.core import reshard, storage, tiers, trace
from repro_torch.core.device_snapshot import DeviceSnapshotter, host_copies
from repro_torch.sharding.activations import is_dtensor

T = TypeVar("T")

# Manifest kind of a device-array leaf; the reference package names it
# "jax", and the name is part of the shared file format.
_TENSOR_KIND = "jax"


class Box(Generic[T]):
    """Mutable holder — the Python analog of the paper's ``&variable``.

    Python scalars are immutable and a restore may hand back a new tensor
    or tree, so the library takes a box whose ``.value`` the application
    reads/writes; ``restart_if_needed`` restores into the box.
    """

    __slots__ = ("value",)

    def __init__(self, value: T):
        self.value = value

    def __repr__(self) -> str:  # pragma: no cover
        return f"Box({self.value!r})"


# --------------------------------------------------------------------------
# POD
# --------------------------------------------------------------------------
_POD_TYPES = (int, float, complex, bool, str)


class PodCp(CpBase):
    """A single plain-old-data element held in a :class:`Box`."""

    def __init__(self, box: Box):
        if not isinstance(box, Box):
            raise TypeError("PodCp expects a Box")
        self.box = box
        self._buf = box.value

    def update(self) -> None:
        self._buf = self.box.value

    def write(self, dir_path: Path, ctx: IOContext) -> None:
        val = self._buf
        kind = type(val).__name__
        if isinstance(val, complex):
            payload = {"kind": "complex", "re": val.real, "im": val.imag}
        elif isinstance(val, _POD_TYPES):
            payload = {"kind": kind, "value": val}
        else:
            raise CheckpointError(f"not a POD: {type(val)}")
        storage.write_json(dir_path / "pod.json", payload)

    def read(self, dir_path: Path, ctx: IOContext) -> None:
        p = dir_path / "pod.json"
        if not p.exists():
            raise CheckpointError(f"missing {p}")
        payload = storage.read_json(p)
        if payload["kind"] == "complex":
            self.box.value = complex(payload["re"], payload["im"])
        else:
            caster = {"int": int, "float": float, "bool": bool, "str": str}[
                payload["kind"]
            ]
            self.box.value = caster(payload["value"])
        self._buf = self.box.value

    def nbytes(self) -> int:
        return 16


# --------------------------------------------------------------------------
# numpy arrays (POD array / multi-array) — restored IN PLACE like the paper's
# pointer-to-array semantics.
# --------------------------------------------------------------------------
class NdArrayCp(CpBase):
    def __init__(self, arr: np.ndarray, to_cp_col: Optional[int] = None):
        if not isinstance(arr, np.ndarray):
            raise TypeError("NdArrayCp expects np.ndarray")
        self.arr = arr
        self.to_cp_col = to_cp_col  # paper's POD multi-array column selection
        self._buf = self._select().copy()

    def _select(self) -> np.ndarray:
        if self.to_cp_col is None:
            return self.arr
        return self.arr[:, self.to_cp_col]

    def update(self) -> None:
        np.copyto(self._buf, self._select())

    def write(self, dir_path: Path, ctx: IOContext) -> None:
        storage.write_array(dir_path / "array.bin", self._buf, ctx)

    def read(self, dir_path: Path, ctx: IOContext) -> None:
        path = dir_path / "array.bin"
        loaded = storage.read_array(path, ctx)
        target = self._select()
        if loaded.shape != target.shape:
            raise CheckpointError(
                f"shape mismatch: stored {loaded.shape} vs live {target.shape}"
            )
        if storage.read_dtype_name(path, ctx) == target.dtype.name:
            # same stored dtype: copy the bits (a bfloat16 file arrives as
            # its uint16 view, which a value cast would mangle)
            loaded = loaded.view(target.dtype)
        # no _buf sync here: every write path calls update() first, so the
        # extra copy would only slow the restore hot path down
        target[...] = loaded.astype(target.dtype, copy=False)

    def nbytes(self) -> int:
        return self._buf.nbytes


# --------------------------------------------------------------------------
# tensors — shared helpers
# --------------------------------------------------------------------------
def _assign_shard(out: np.ndarray, idx, arr: np.ndarray) -> None:
    """Write a loaded shard into the assembly buffer (rank-0 safe)."""
    if out.ndim == 0:
        out[...] = np.asarray(arr, dtype=out.dtype).reshape(())
    else:
        out[idx] = arr


def _full_index(ndim: int) -> list:
    """Stored index of an unsharded array: every dimension whole — what
    the reference writes for a single-device array's only shard."""
    return [[0, None] for _ in range(ndim)]


def _local_shard(t: torch.Tensor):
    """(index, local tensor): a DTensor's local shard and its global index
    ``[[start, stop], ...]``; a plain tensor whole."""
    if not is_dtensor(t):
        return _full_index(t.dim()), t
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    index = [[int(o), int(o) + int(s)] for o, s in zip(offset, shape)]
    return index, t.to_local()


def _restored_dtensor(ctx: IOContext, meta: dict, sources, live, where):
    """Restore into a live DTensor: assemble this rank's extent from the
    stored shards (the range path) and copy it into the local shard, in
    place when the dtype matches, else a new DTensor on the live
    placements."""
    from torch.distributed.tensor import DTensor

    gshape = tuple(int(s) for s in meta["global_shape"])
    if tuple(live.shape) != gshape:
        raise CheckpointError(
            f"shape mismatch: stored {gshape} vs live {tuple(live.shape)} "
            f"({where})")
    index, local = _local_shard(live)
    ext = tuple((lo, hi) for lo, hi in index)
    block = _read_global_leaf(ctx, gshape,
                              storage._dtype_from_name(meta["dtype"]),
                              sources, where, extent=ext)
    t = storage.as_tensor(block, meta["dtype"])
    with trace.TRACER.span("craft::cp.h2d", bytes=block.nbytes):
        if local.dtype == t.dtype:
            with torch.no_grad():
                local.copy_(t)
            return live
        return DTensor.from_local(t.to(local.device), live.device_mesh,
                                  live.placements, run_check=False,
                                  shape=live.shape, stride=live.stride())


def _restored_tensor(host: np.ndarray, dtype_name: str, live,
                     ctx: IOContext):
    """Move a restored host array onto the live tensor: copied in place when
    shape and dtype match, else a new tensor on the live tensor's device
    (``ctx.device`` when there is no live tensor).  A read-only host array
    (the memory tier's resident copy) is never aliased by the result.
    Span ``craft::cp.h2d``: the copy."""
    t = storage.as_tensor(host, dtype_name)
    if isinstance(live, torch.Tensor) \
            and tuple(live.shape) != tuple(t.shape):
        raise CheckpointError(
            f"shape mismatch: stored {tuple(t.shape)} vs live "
            f"{tuple(live.shape)}")
    with trace.TRACER.span("craft::cp.h2d", bytes=host.nbytes):
        if isinstance(live, torch.Tensor) and live.dtype == t.dtype:
            with torch.no_grad():
                live.copy_(t)
            return live
        if not host.flags.writeable:
            t = t.clone()
        return t.to(live.device if isinstance(live, torch.Tensor)
                    else ctx.device)


# --------------------------------------------------------------------------
# elastic N→M assembly (shared by TorchTensorCp / PytreeCp / ShardCp reads)
# --------------------------------------------------------------------------
def _aux_item_dirs(dir_path: Path, ctx: IOContext) -> list:
    """This item's directory inside each peer version root (``ctx.aux_dirs``),
    as ``[(item_dir, root), ...]`` — only roots where the item exists."""
    if not ctx.aux_dirs or ctx.rel_root is None:
        return []
    try:
        rel = dir_path.relative_to(ctx.rel_root)
    except ValueError:
        return []
    out = []
    for root in ctx.aux_dirs:
        d = Path(root) / rel
        if d.is_dir():
            out.append((d, Path(root)))
    return out


def _collect_manifests(dir_path: Path, ctx: IOContext, pattern: str) -> list:
    """Union of writer manifests across the materialized dir and peer roots.

    Returns ``[(manifest, dir, root), ...]`` ordered by manifest filename;
    ``root`` is None for the main dir.  A manifest present in both (the
    restoring rank's own file, mirrored on a peer) is taken from the main
    dir — its delta refs resolve against ``ctx.base_dirs`` directly.
    """
    found = {}
    for mp in dir_path.glob(pattern):
        found[mp.name] = (storage.read_json(mp), dir_path, None)
    for d, root in _aux_item_dirs(dir_path, ctx):
        for mp in d.glob(pattern):
            if mp.name not in found:
                found[mp.name] = (storage.read_json(mp), d, root)
    return [found[k] for k in sorted(found)]


def _open_range_reader(path: Path, ctx: IOContext, root: Optional[Path]):
    """A :class:`storage.ChunkRangeReader` for a shard file — delta refs in a
    peer-root file resolve against *that* tree's sibling ``v-<B>`` dirs."""
    if root is None:
        return storage.ChunkRangeReader(path, ctx)
    rel = path.relative_to(root)
    bases = None
    if ctx.base_dirs:
        bases = {int(v): Path(root).parent / tiers.version_dir_name(int(v))
                 for v in ctx.base_dirs}
    return storage.ChunkRangeReader(path, ctx, rel=rel, base_dirs=bases)


def _read_aux_array(path: Path, ctx: IOContext, root: Path) -> np.ndarray:
    """Whole-array read of a peer-root file (full-span range read, so v2
    refs chase the peer's base chain instead of ``ctx.base_dirs``)."""
    rdr = _open_range_reader(path, ctx, root)
    payload = bytes(rdr.read(0, rdr.nbytes))
    return storage._restore_shape(payload, rdr.header, path)


def _read_global_leaf(ctx: IOContext, gshape, dtype, sources, where: str,
                      extent=None) -> np.ndarray:
    """Assemble one global array from shard files written on any topology.

    ``sources`` is ``[(index_spec, path, root), ...]`` — one entry per shard
    file across every writer's manifest (``root`` None = materialized main
    dir, else the peer version root the file lives under).  A single file
    covering the whole array is read as it is; otherwise ``ctx.reshard``
    picks the strategy: whole-file assembly into a global buffer, or range
    assembly that maps the global extent onto the writers' extents
    (:func:`reshard.overlap_runs`) and fetches only the overlapping chunk
    ranges ("range", or any shard living in a peer root).  Returns the
    global host array (``dtype`` is the host dtype of the stored name).
    With ``extent`` (``((lo, hi), ...)``, a live DTensor's local extent)
    only that block is assembled, always on the range path (the
    reference's ``dst_exts``).
    """
    gshape = tuple(int(s) for s in gshape)
    dtype = np.dtype(dtype)
    exts = [(reshard.resolve_index(spec, gshape), Path(path), root)
            for spec, path, root in sources]
    full_ext = tuple((0, s) for s in gshape)
    has_aux = any(root is not None for _, _, root in exts)
    mode = getattr(ctx, "reshard", "auto")
    use_range = mode == "range" or has_aux or extent is not None
    if not use_range and len(exts) == 1 and exts[0][0] == full_ext:
        arr = storage.read_array(exts[0][1], ctx)
        if arr.size != int(np.prod(gshape, dtype=np.int64)):
            raise CheckpointError(
                f"shard shape {tuple(arr.shape)} does not match global "
                f"{gshape} under {where}")
        return arr.reshape(gshape)      # v0 stores a 0-d array as (1,)
    if not use_range:
        out = np.empty(gshape, dtype=dtype)
        filled = np.zeros(gshape, dtype=bool) if out.size else None
        for ext, path, _root in exts:
            arr = storage.read_array(path, ctx)
            idx = tuple(slice(lo, hi) for lo, hi in ext)
            _assign_shard(out, idx, arr)
            if filled is not None:
                filled[idx] = True
        if filled is not None and not filled.all():
            raise CheckpointError(
                f"incomplete shard coverage under {where} "
                f"({int(filled.sum())}/{filled.size} elements)"
            )
        return out
    rdr_cache: dict = {}

    def open_reader(key):
        r = rdr_cache.get(key[0])
        if r is None:
            r = _open_range_reader(key[1], ctx, key[2])
            rdr_cache[key[0]] = r
        return r

    srcs = [(e, (str(p), p, root)) for e, p, root in exts]
    dst = full_ext if extent is None else tuple(extent)
    block, covered = reshard.assemble_extent(dst, dtype, srcs, open_reader)
    if covered is not None and not covered.all():
        raise CheckpointError(
            f"incomplete shard coverage for extent {dst} under {where} "
            f"({int(covered.sum())}/{covered.size} elements)"
        )
    return block


class TorchTensorCp(CpBase):
    """Checkpoint a tensor held in a Box.

    Write: the tensor goes to ``shard-<r>-0.bin`` (r = process rank —
    paper's process-local file naming) plus ``array-<r>.json`` recording the
    global shape/dtype and the shard's index (the whole array).  Read: the
    shard files of every writer are assembled into the global array and
    copied into the live tensor (in place when shape and dtype match).
    """

    def __init__(self, box: Box, *, device_snapshot: bool = False,
                 chunk_bytes: Optional[int] = None,
                 device_hist: bool = True, double_buffer: bool = True):
        if not isinstance(box, Box):
            raise TypeError("TorchTensorCp expects a Box holding a tensor")
        self.box = box
        self._buf: list = []     # [(index, host tensor, device_meta | None)]
        self._meta: dict = {}
        self._snap = (
            DeviceSnapshotter(chunk_bytes or IOContext.chunk_bytes,
                              with_hist=device_hist,
                              double_buffer=double_buffer)
            if device_snapshot else None
        )
        self.update()

    def update(self) -> None:
        arr = self.box.value
        if not isinstance(arr, torch.Tensor):
            raise CheckpointError(f"Box no longer holds a tensor: {type(arr)}")
        index, local = _local_shard(arr)
        if self._snap is not None:
            # fused device pass: digest + dirty mask + entropy on the card,
            # then only the dirty chunks cross to the host mirror
            host, dmeta = self._snap.snapshot(0, local)
            self._buf = [(index, host, dmeta)]
        else:
            self._buf = [(index, host_copies([local])[0], None)]
        self._meta = {
            "global_shape": list(arr.shape),
            "dtype": storage._dtype_to_name(arr.dtype),
        }

    def write(self, dir_path: Path, ctx: IOContext) -> None:
        shards_meta = []
        for i, (index, host, dmeta) in enumerate(self._buf):
            fname = f"shard-{ctx.proc_rank}-{i}.bin"
            if dmeta is not None:
                ctx.record_device_meta(
                    storage._manifest_name(dir_path / fname, ctx), dmeta)
            storage.write_array(dir_path / fname, host, ctx)
            shards_meta.append({"file": fname, "index": index})
        storage.write_json(
            dir_path / f"array-{ctx.proc_rank}.json",
            {**self._meta, "shards": shards_meta},
        )

    def read(self, dir_path: Path, ctx: IOContext) -> None:
        manifests = _collect_manifests(dir_path, ctx, "array-*.json")
        if not manifests:
            raise CheckpointError(f"no array manifest under {dir_path}")
        meta0 = manifests[0][0]
        sources = [
            (sh["index"], d / sh["file"], root)
            for m, d, root in manifests
            for sh in m["shards"]
        ]
        if is_dtensor(self.box.value):
            self.box.value = _restored_dtensor(
                ctx, meta0, sources, self.box.value, str(dir_path))
            return
        host = _read_global_leaf(
            ctx, meta0["global_shape"],
            storage._dtype_from_name(meta0["dtype"]), sources, str(dir_path))
        self.box.value = _restored_tensor(host, meta0["dtype"],
                                          self.box.value, ctx)

    def nbytes(self) -> int:
        return sum(h.numel() * h.element_size() for _, h, _ in self._buf)


# --------------------------------------------------------------------------
# pytree of tensors (state dicts, optimizer states, KV caches, ...)
# --------------------------------------------------------------------------
def _canonical(tree):
    """``tree`` with every plain dict rebuilt in sorted key order.

    Leaves are stored by flattened position, and the reference flattens a
    plain dict in sorted key order where ``torch.utils._pytree`` keeps
    insertion order; sorting first makes both packages number the leaves
    alike.  Ordered dicts keep their order in both."""
    if type(tree) is dict:
        return {k: _canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, collections.OrderedDict):
        return type(tree)((k, _canonical(v)) for k, v in tree.items())
    if type(tree) in (list, tuple):
        return type(tree)(_canonical(v) for v in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_canonical(v) for v in tree))
    return tree


def _flatten(tree):
    """``(leaves, positions, spec)``: the reference's leaves of ``tree``
    (``None`` is an empty subtree there, not a leaf) and each one's
    position among the torch pytree leaves, for :func:`_unflatten`."""
    all_leaves, spec = pytree.tree_flatten(_canonical(tree))
    pos = [i for i, leaf in enumerate(all_leaves) if leaf is not None]
    return [all_leaves[i] for i in pos], (pos, len(all_leaves)), spec


def _unflatten(leaves, where, spec):
    pos, n = where
    full = [None] * n
    for i, leaf in zip(pos, leaves):
        full[i] = leaf
    return pytree.tree_unflatten(full, spec)


class PytreeCp(CpBase):
    """Checkpoint a pytree of tensors held in a Box (a state dict, nested
    dicts/lists/tuples of tensors, numpy arrays and POD leaves).

    The tree structure comes from the *live* value at read time (CRAFT
    semantics: state is constructed first, then restored into), so leaves
    are stored by flattened position — the reference's order — with
    shape/dtype validation.  Tensor leaves are restored into the live
    tensors in place where shape and dtype match.
    """

    def __init__(self, box: Box, *, device_snapshot: bool = False,
                 chunk_bytes: Optional[int] = None,
                 device_hist: bool = True, double_buffer: bool = True):
        self.box = box
        self._buf: list = []
        self._snap = (
            DeviceSnapshotter(chunk_bytes or IOContext.chunk_bytes,
                              with_hist=device_hist,
                              double_buffer=double_buffer)
            if device_snapshot else None
        )
        self.update()

    def update(self) -> None:
        leaves, _, _ = _flatten(self.box.value)
        buf = []
        copy_items = []      # (buf_item, tensor) for one batched D2H
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, torch.Tensor):
                item = {
                    "kind": _TENSOR_KIND,
                    "global_shape": list(leaf.shape),
                    "dtype": storage._dtype_to_name(leaf.dtype),
                    "shards": [],
                }
                index, local = _local_shard(leaf)
                if self._snap is not None:
                    host, dmeta = self._snap.snapshot((i, 0), local)
                    item["shards"].append((index, host, dmeta))
                else:
                    copy_items.append((item, index, local))
                buf.append(item)
            elif isinstance(leaf, np.ndarray):
                buf.append({"kind": "np", "data": leaf.copy()})
            else:
                buf.append({"kind": "pod", "data": leaf})
        hosts = host_copies([t for _, _, t in copy_items])
        for (item, index, _), h in zip(copy_items, hosts):
            item["shards"].append((index, h, None))
        self._buf = buf

    def write(self, dir_path: Path, ctx: IOContext) -> None:
        manifest = {"n_leaves": len(self._buf), "leaves": []}
        for i, item in enumerate(self._buf):
            if item["kind"] == _TENSOR_KIND:
                shards_meta = []
                for j, (index, host, dmeta) in enumerate(item["shards"]):
                    fname = f"leaf{i}-shard-{ctx.proc_rank}-{j}.bin"
                    if dmeta is not None:
                        ctx.record_device_meta(
                            storage._manifest_name(dir_path / fname, ctx),
                            dmeta)
                    storage.write_array(dir_path / fname, host, ctx)
                    shards_meta.append({"file": fname, "index": index})
                manifest["leaves"].append(
                    {
                        "kind": _TENSOR_KIND,
                        "global_shape": item["global_shape"],
                        "dtype": item["dtype"],
                        "shards": shards_meta,
                    }
                )
            elif item["kind"] == "np":
                fname = f"leaf{i}.bin"
                storage.write_array(dir_path / fname, item["data"], ctx)
                manifest["leaves"].append({"kind": "np", "file": fname})
            else:
                manifest["leaves"].append(
                    {"kind": "pod", "value": _pod_json(item["data"])}
                )
        storage.write_json(dir_path / f"tree-{ctx.proc_rank}.json", manifest)

    def read(self, dir_path: Path, ctx: IOContext) -> None:
        # parse every writer's manifest once up front; peer version roots
        # (elastic N→M node-tier restores) contribute theirs alongside the
        # materialized dir's
        parsed = _collect_manifests(dir_path, ctx, "tree-*.json")
        if not parsed:
            raise CheckpointError(f"no pytree manifest under {dir_path}")
        manifest = parsed[0][0]
        live_leaves, where, spec = _flatten(self.box.value)
        if manifest["n_leaves"] != len(live_leaves):
            raise CheckpointError(
                f"pytree leaf count mismatch: stored {manifest['n_leaves']} "
                f"vs live {len(live_leaves)}"
            )
        new_leaves = []
        for i, (lspec, live) in enumerate(zip(manifest["leaves"],
                                              live_leaves)):
            if lspec["kind"] == _TENSOR_KIND:
                sources = [    # merge shard sets from all writer procs
                    (sh["index"], d / sh["file"], root)
                    for m, d, root in parsed
                    for sh in m["leaves"][i].get("shards", [])
                ]
                if is_dtensor(live):
                    new_leaves.append(_restored_dtensor(
                        ctx, lspec, sources, live, f"{dir_path} (leaf {i})"))
                    continue
                host = _read_global_leaf(
                    ctx, lspec["global_shape"],
                    storage._dtype_from_name(lspec["dtype"]), sources,
                    f"{dir_path} (leaf {i})")
                new_leaves.append(
                    _restored_tensor(host, lspec["dtype"], live, ctx))
            elif lspec["kind"] == "np":
                # every writer stores an identical copy — prefer the
                # materialized dir's, fall back to any peer root's
                _m, d, root = next(
                    (e for e in parsed if e[2] is None), parsed[0])
                if root is None:
                    arr = storage.read_array(d / lspec["file"], ctx)
                else:   # replicated leaf only present in a peer's tree
                    arr = _read_aux_array(d / lspec["file"], ctx, root)
                new_leaves.append(arr if arr.flags.writeable else arr.copy())
            else:
                new_leaves.append(_pod_unjson(lspec["value"]))
        self.box.value = _unflatten(new_leaves, where, spec)

    def nbytes(self) -> int:
        total = 0
        for item in self._buf:
            if item["kind"] == _TENSOR_KIND:
                total += sum(h.numel() * h.element_size()
                             for _, h, _ in item["shards"])
            elif item["kind"] == "np":
                total += item["data"].nbytes
        return total


# --------------------------------------------------------------------------
# one rank's rectangular slice of a global array (host-side domain
# decomposition — the paper's redistributable-domain case)
# --------------------------------------------------------------------------
class ShardCp(CpBase):
    """Checkpoint one rank's block of a global array, held as a host ndarray.

    The on-disk format is :class:`TorchTensorCp`'s (``shard-<rank>-<i>.bin``
    + ``array-<rank>.json``), so the file set is topology independent: a
    checkpoint written by N ``ShardCp`` ranks restores onto M ranks with any
    other block decomposition — each restoring rank range-reads exactly its
    own extent out of the writers' chunk grids, never assembling the global
    array in memory.  ``box.value`` holds the writable block.
    """

    def __init__(self, box: Box, global_shape, index):
        if not isinstance(box, Box):
            raise TypeError("ShardCp expects a Box holding an ndarray block")
        self.box = box
        self.global_shape = tuple(int(s) for s in global_shape)
        self.index = reshard.resolve_index(index, self.global_shape)
        block = np.asarray(box.value)
        want = tuple(hi - lo for lo, hi in self.index)
        if self.global_shape and tuple(block.shape) != want:
            raise CheckpointError(
                f"block shape {tuple(block.shape)} does not match extent "
                f"{self.index} of global {self.global_shape}"
            )
        self._buf = block.copy()

    def update(self) -> None:
        self._buf = np.asarray(self.box.value).copy()

    def write(self, dir_path: Path, ctx: IOContext) -> None:
        fname = f"shard-{ctx.proc_rank}-0.bin"
        storage.write_array(dir_path / fname, self._buf, ctx)
        storage.write_json(
            dir_path / f"array-{ctx.proc_rank}.json",
            {
                "global_shape": list(self.global_shape),
                "dtype": storage._dtype_to_name(self._buf.dtype),
                "shards": [{
                    "file": fname,
                    "index": [[lo, hi] for lo, hi in self.index],
                }],
            },
        )

    def read(self, dir_path: Path, ctx: IOContext) -> None:
        manifests = _collect_manifests(dir_path, ctx, "array-*.json")
        if not manifests:
            raise CheckpointError(f"no array manifest under {dir_path}")
        meta0 = manifests[0][0]
        gshape = tuple(meta0["global_shape"])
        if gshape != self.global_shape:
            raise CheckpointError(
                f"global shape mismatch: stored {gshape} vs live "
                f"{self.global_shape}"
            )
        dtype = storage._dtype_from_name(meta0["dtype"])
        srcs = [
            (reshard.resolve_index(sh["index"], gshape),
             (str(d / sh["file"]), d / sh["file"], root))
            for m, d, root in manifests
            for sh in m["shards"]
        ]
        rdr_cache: dict = {}

        def open_reader(key):
            r = rdr_cache.get(key[0])
            if r is None:
                r = _open_range_reader(key[1], ctx, key[2])
                rdr_cache[key[0]] = r
            return r

        block, covered = reshard.assemble_extent(
            self.index, dtype, srcs, open_reader)
        if covered is not None and not covered.all():
            raise CheckpointError(
                f"incomplete shard coverage for extent {self.index} under "
                f"{dir_path} ({int(covered.sum())}/{covered.size} elements)"
            )
        self.box.value = block
        self._buf = block.copy()

    def nbytes(self) -> int:
        return self._buf.nbytes


def _pod_json(v):
    if isinstance(v, complex):
        return {"kind": "complex", "re": v.real, "im": v.imag}
    return {"kind": type(v).__name__, "value": v}


def _pod_unjson(d):
    if d["kind"] == "complex":
        return complex(d["re"], d["im"])
    return {"int": int, "float": float, "bool": bool, "str": str, "NoneType": lambda v: None}[
        d["kind"]
    ](d.get("value"))


# --------------------------------------------------------------------------
# getter/setter adapter (for data not reachable via a Box, e.g. an object
# attribute or a library handle)
# --------------------------------------------------------------------------
class FuncCp(CpBase):
    def __init__(self, get: Callable[[], Any], set_: Callable[[Any], None]):
        self._get, self._set = get, set_
        self._inner: Optional[CpBase] = None
        self._box = Box(None)
        self.update()

    def _wrap(self, value) -> CpBase:
        self._box.value = value
        if isinstance(value, torch.Tensor):
            return TorchTensorCp(self._box)
        if isinstance(value, np.ndarray):
            return NdArrayCp(value)
        if isinstance(value, _POD_TYPES):
            return PodCp(self._box)
        return PytreeCp(self._box)

    def update(self) -> None:
        self._inner = self._wrap(self._get())
        self._inner.update()

    def write(self, dir_path: Path, ctx: IOContext) -> None:
        if self._inner is None:
            raise CheckpointError("FuncCp.write before update()")
        self._inner.write(dir_path, ctx)

    def read(self, dir_path: Path, ctx: IOContext) -> None:
        if self._inner is None:
            raise CheckpointError("FuncCp.read before update()")
        self._inner.read(dir_path, ctx)
        self._set(self._box.value)

    def nbytes(self) -> int:
        return self._inner.nbytes() if self._inner else 0


# --------------------------------------------------------------------------
# extension registry (paper §2.3, Listing 6)
# --------------------------------------------------------------------------
_ADAPTERS: list = []   # [(predicate, factory)]


def register_adapter(predicate: Callable[[Any], bool],
                     factory: Callable[[Any], CpBase]) -> None:
    """Register an ``add()`` adapter for a user/library data type.

    ``predicate(obj)`` decides applicability; ``factory(obj)`` returns the
    checkpointable wrapper.  This is the paper's "interface function inside
    CRAFT" (Listing 6) — after registration, end users can pass their objects
    straight to ``Checkpoint.add()``.
    """
    _ADAPTERS.append((predicate, factory))


def wrap(obj: Any, **kw) -> CpBase:
    """Dispatch an ``add()`` argument to a checkpointable (paper's overloads)."""
    if isinstance(obj, CpBase):
        return obj
    for predicate, factory in _ADAPTERS:
        if predicate(obj):
            return factory(obj)
    if isinstance(obj, Box):
        v = obj.value
        # the snapshot options as the caller gave them (Checkpoint.add
        # decides each); the checkpointables hold the defaults
        snap_kw = {k: kw[k] for k in ("device_snapshot", "chunk_bytes",
                                      "device_hist", "double_buffer")
                   if k in kw}
        if isinstance(v, torch.Tensor):
            return TorchTensorCp(obj, **snap_kw)
        if isinstance(v, _POD_TYPES):
            return PodCp(obj)
        return PytreeCp(obj, **snap_kw)
    if isinstance(obj, np.ndarray):
        return NdArrayCp(obj, to_cp_col=kw.get("to_cp_col"))
    if isinstance(obj, torch.Tensor):
        raise TypeError(
            "a restore may hand back a new tensor — wrap it in "
            "repro_torch.core.Box(t) so the restored value can be handed "
            "back (paper's &ptr analog)"
        )
    if isinstance(obj, _POD_TYPES):
        raise TypeError(
            f"{type(obj).__name__} is immutable — wrap it in repro_torch.core.Box(x)"
        )
    raise TypeError(
        f"don't know how to checkpoint {type(obj)}; subclass CpBase or "
        "register_adapter() it (paper §2.3)"
    )
