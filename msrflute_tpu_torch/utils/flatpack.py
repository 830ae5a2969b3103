"""Dtype-grouped flattening of a tree for the dispatch boundary — the port's
own copy of ``msrflute_tpu/utils/flatpack.py`` over numpy arrays and torch
tensors.

A tree (dicts, taken in sorted key order as ``jax.tree.flatten`` takes
them, lists and tuples in order) is packed into ONE 1-D buffer per
distinct dtype: leaves are grouped by dtype, never promoted, and raveled
into their group in flatten order, so the round trip is bit-exact for
every dtype.  The slot table, ``(dtype, offset, size, shape)`` per leaf,
is the JAX packer's for the same numpy tree.

- :class:`FlatPacker`: pack / unpack tensors, unpack fetched numpy
  buffers (``unpack_np``) — the round stats cross the device boundary
  this way, one buffer per dtype group for a whole chunk (the tree is the
  chunk's list of rounds);
- :class:`AxisPacker`: host arrays that share leading axes into one
  ``[*lead, total]`` buffer per dtype (``pack_np``, optionally straight
  into a pinned staging buffer), and the inverse as views of the device
  buffer (``unpack``) — the round inputs cross this way;
- :class:`ScalarStager`: scalar operands, one tiny 1-D buffer per dtype.

:func:`canonical_np` is the dtype a host value keeps on the device, which
in the port is what ``torch.as_tensor`` gives (Python floats become
float32, Python ints int64, numpy arrays keep theirs), where the JAX
package's narrows 64-bit types as ``jax.device_put`` does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Slot = Tuple[str, int, int, Tuple[int, ...]]


def _flatten(tree: Any) -> Tuple[list, Any]:
    """``(leaves, structure)``: dict keys sorted, lists and tuples in
    order, anything else a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([leaf for p in parts for leaf in p[0]],
                ("dict", tuple(keys), tuple(p[1] for p in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(t) for t in tree]
        return ([leaf for p in parts for leaf in p[0]],
                (type(tree).__name__, len(tree), tuple(p[1] for p in parts)))
    return [tree], "leaf"


def _unflatten(structure: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(s):
        if s == "leaf":
            return next(it)
        kind, meta, children = s
        if kind == "dict":
            return {k: build(c) for k, c in zip(meta, children)}
        built = [build(c) for c in children]
        return tuple(built) if kind == "tuple" else built

    return build(structure)


def dtype_name(x) -> str:
    """``"float32"``, ``"int32"``, ``"bool"``, ... of a tensor or array."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(x.dtype)


def canonical_np(x) -> np.ndarray:
    """``x`` as the numpy array whose dtype ``torch.as_tensor(x)`` keeps:
    a tensor's own, an array's own, float32 for a Python float, int64 for
    a Python int."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, (bool, np.bool_)):
        return np.asarray(x, np.bool_)
    arr = np.asarray(x)
    if arr.dtype == np.float64 and not isinstance(x, np.floating):
        return arr.astype(np.float32)
    return arr


def _slot_table(leaves, lead_ndim: int = 0, align_bytes: int = 1):
    slots: List[Slot] = []
    sizes: Dict[str, int] = {}
    for leaf in leaves:
        trailing = tuple(leaf.shape[lead_ndim:])
        size = int(np.prod(trailing)) if trailing else 1
        dt = dtype_name(leaf)
        step = max(align_bytes // leaf.itemsize, 1) if align_bytes > 1 else 1
        off = -(-sizes.get(dt, 0) // step) * step
        slots.append((dt, off, size, trailing))
        sizes[dt] = off + size
    return slots, sizes


class FlatPacker:
    """Pack / unpack a fixed-structure tree into one 1-D buffer per
    dtype."""

    def __init__(self, template: Any):
        leaves, self.structure = _flatten(template)
        leaves = [leaf if hasattr(leaf, "dtype") else canonical_np(leaf)
                  for leaf in leaves]
        #: per-leaf ``(dtype, offset, size, shape)`` in flatten order
        self.slots, self.sizes = _slot_table(leaves)

    def _leaves(self, tree: Any) -> list:
        leaves, structure = _flatten(tree)
        if len(leaves) != len(self.slots):
            raise ValueError(f"tree has {len(leaves)} leaves, packer built "
                             f"for {len(self.slots)}")
        if structure != self.structure:
            raise ValueError(f"tree structure {structure} != packer "
                             f"template {self.structure}")
        for leaf, (dt, _, _, shape) in zip(leaves, self.slots):
            if tuple(leaf.shape) != shape:
                raise ValueError(f"leaf shape {tuple(leaf.shape)} != packer "
                                 f"template shape {shape}")
            if dtype_name(leaf) != dt:
                # a drifted dtype would promote its whole group
                raise ValueError(f"leaf dtype {dtype_name(leaf)} != packer "
                                 f"template dtype {dt}")
        return leaves

    def pack(self, tree: Any) -> Dict[str, torch.Tensor]:
        """One 1-D tensor per dtype, the leaves raveled in flatten
        order."""
        groups: Dict[str, list] = {}
        for leaf, (dt, _, _, _) in zip(self._leaves(tree), self.slots):
            groups.setdefault(dt, []).append(leaf.reshape(-1))
        return {dt: torch.cat(parts) if len(parts) > 1 else parts[0]
                for dt, parts in groups.items()}

    def pack_np(self, tree: Any) -> Dict[str, np.ndarray]:
        """:meth:`pack` over numpy leaves."""
        groups: Dict[str, list] = {}
        for leaf, (dt, _, _, _) in zip(self._leaves(tree), self.slots):
            groups.setdefault(dt, []).append(np.asarray(leaf).ravel())
        return {dt: np.concatenate(parts) if len(parts) > 1 else parts[0]
                for dt, parts in groups.items()}

    def unpack(self, vecs: Dict[str, Any]) -> Any:
        """Inverse of :meth:`pack`: bit-identical leaves (views of
        ``vecs``), the template's structure.  Works on tensors and numpy
        arrays alike."""
        return _unflatten(self.structure, [
            vecs[dt][off:off + size].reshape(shape)
            for dt, off, size, shape in self.slots])

    def unpack_np(self, vecs: Dict[str, Any]) -> Any:
        """:meth:`unpack` over fetched host buffers, as numpy views."""
        return self.unpack({dt: np.asarray(v) for dt, v in vecs.items()})


class AxisPacker:
    """Pack a fixed-structure tree of host arrays that share their
    ``lead_ndim`` leading axes into one ``[*lead, total]`` buffer per
    dtype; the inverse gives each leaf back as a view of that buffer.
    ``lead_ndim`` 0 packs whole leaves (each leaf's shape is its own).
    ``align_bytes`` > 1 starts every leaf's slot on that boundary of its
    group (the gaps are left unwritten); 1 is the JAX packer's layout."""

    def __init__(self, template: Any, lead_ndim: int, align_bytes: int = 1):
        self.lead_ndim = int(lead_ndim)
        leaves, self.structure = _flatten(template)
        leaves = [canonical_np(leaf) for leaf in leaves]
        self.lead_shape: Optional[Tuple[int, ...]] = None
        for arr in leaves:
            if arr.ndim < self.lead_ndim:
                raise ValueError(
                    f"AxisPacker leaf has {arr.ndim} dims, needs the "
                    f"{self.lead_ndim} shared leading axes")
            lead = tuple(arr.shape[:self.lead_ndim])
            if self.lead_shape is None:
                self.lead_shape = lead
            elif lead != self.lead_shape:
                raise ValueError(f"AxisPacker leaves disagree on leading "
                                 f"axes: {lead} != {self.lead_shape}")
        if self.lead_shape is None:
            self.lead_shape = ()
        #: per-leaf ``(dtype, offset, trailing size, trailing shape)``
        self.slots, self.sizes = _slot_table(leaves, self.lead_ndim,
                                             int(align_bytes))

    def buffer_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Each dtype group's packed shape, ``[*lead, total]``."""
        return {dt: self.lead_shape + (n,) for dt, n in self.sizes.items()}

    def pack_np(self, tree: Any,
                out: Optional[Dict[str, np.ndarray]] = None
                ) -> Dict[str, np.ndarray]:
        """One ``[*lead, total]`` numpy buffer per dtype.  With ``out``
        (a buffer of :meth:`buffer_shapes` per dtype, e.g. numpy views of
        pinned memory), each leaf is written straight into its slot."""
        leaves, structure = _flatten(tree)
        if structure != self.structure or len(leaves) != len(self.slots):
            raise ValueError(f"tree structure {structure} != packer "
                             f"template {self.structure}")
        if out is None:
            out = {dt: np.empty(shape, np.dtype(dt))
                   for dt, shape in self.buffer_shapes().items()}
        for leaf, (dt, off, size, trailing) in zip(leaves, self.slots):
            arr = canonical_np(leaf)
            if tuple(arr.shape) != self.lead_shape + trailing:
                raise ValueError(f"leaf shape {arr.shape} != packer "
                                 f"template {self.lead_shape}+{trailing}")
            if str(arr.dtype) != dt:
                raise ValueError(f"leaf dtype {arr.dtype} != packer "
                                 f"template dtype {dt}")
            out[dt][..., off:off + size] = arr.reshape(
                self.lead_shape + (size,))
        return out

    def unpack(self, vecs: Dict[str, Any]) -> Any:
        """Inverse of :meth:`pack_np`: each leaf a view of its group's
        buffer (a tensor on the device, or numpy)."""
        return _unflatten(self.structure, [
            vecs[dt][..., off:off + size].reshape(self.lead_shape + trailing)
            for dt, off, size, trailing in self.slots])


class ScalarStager:
    """:class:`FlatPacker` plus a host-side pack for scalar operands: one
    tiny 1-D buffer per dtype."""

    def __init__(self, template: Any):
        leaves, structure = _flatten(template)
        self.packer = FlatPacker(_unflatten(
            structure, [canonical_np(leaf) for leaf in leaves]))

    def pack_np(self, tree: Any) -> Dict[str, np.ndarray]:
        leaves, structure = _flatten(tree)
        if structure != self.packer.structure:
            raise ValueError(f"tree structure {structure} != stager "
                             f"template {self.packer.structure}")
        groups: Dict[str, list] = {}
        for leaf, (dt, _, _, shape) in zip(leaves, self.packer.slots):
            arr = canonical_np(leaf)
            if str(arr.dtype) != dt or tuple(arr.shape) != shape:
                raise ValueError(f"leaf {arr.dtype}{tuple(arr.shape)} != "
                                 f"template {dt}{shape}")
            groups.setdefault(dt, []).append(arr.ravel())
        return {dt: np.concatenate(parts) if len(parts) > 1 else parts[0]
                for dt, parts in groups.items()}

    def unpack(self, vecs: Dict[str, Any]) -> Any:
        return self.packer.unpack(vecs)
