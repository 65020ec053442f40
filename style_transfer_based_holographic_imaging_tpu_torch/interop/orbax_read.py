"""Restore an orbax checkpoint without orbax: ``restore(path)`` is the
port's ``ocp.StandardCheckpointer().restore(path)`` with no target (the JAX
command's ``_load_params``), for the checkpoints orbax writes with OCDBT and
zarr v2 (``use_ocdbt``, not ``use_zarr3``): the releases under
``checkpoints/`` and a training run's ``iter_<n>`` snapshots.

The tree comes from ``_METADATA``'s ``tree_metadata``: each leaf's
``key_metadata`` names its path, a dict key (``key_type`` 2) or a sequence
index (``key_type`` 1; an optax state tuple comes back as a list, as orbax
returns it), and its ``value_type`` says whether it holds an array or
``None`` (an optax ``EmptyState``). A leaf's arrays live in the OCDBT store
(``ocdbt.py``) under its path joined by dots: ``<name>/.zarray``, the zarr
v2 array's description (dtype, shape, chunks, order, fill value,
compressor), and one key a chunk (``<name>/0.0.0.0``; ``<name>/0`` for a
0-d array). Chunks are zstd frames (``zstd.py``) or uncompressed; an array
of several chunks is assembled, a missing chunk takes the fill value. A
scalar such as a snapshot's ``step`` comes back as a 0-d array. A device
sharding saved with the array (``_sharding``) is not needed to read it.
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import Any, Dict, Iterable, Optional

import numpy as np

from style_transfer_based_holographic_imaging_tpu_torch.interop import ocdbt, zstd

__all__ = ["restore", "is_orbax_checkpoint", "OrbaxError"]

_ARRAY_TYPES = ("np.ndarray", "jax.Array")
_DICT_KEY, _SEQUENCE_KEY = 2, 1


class OrbaxError(ValueError):
    """A checkpoint this reader cannot restore."""


def is_orbax_checkpoint(path: str) -> bool:
    """Whether ``path`` is an orbax OCDBT checkpoint: a directory holding
    ``manifest.ocdbt``."""
    return os.path.isfile(os.path.join(path, "manifest.ocdbt"))


def _fill(dtype: np.dtype, fill_value) -> Any:
    if fill_value is None:
        return 0
    if isinstance(fill_value, str):  # "NaN", "Infinity", "-Infinity"
        return float(fill_value.replace("Infinity", "inf"))
    return fill_value


def _read_array(store: ocdbt.Store, name: str) -> np.ndarray:
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise OrbaxError(f"{name}: zarr format {meta.get('zarr_format')}, only 2 is read")
    if meta.get("filters"):
        raise OrbaxError(f"{name}: zarr filters {meta['filters']}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OrbaxError(f"{name}: compressor {compressor.get('id')!r}, only zstd or none is read")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError:
        raise OrbaxError(f"{name}: dtype {meta['dtype']!r}") from None
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    if len(chunks) != len(shape) or order not in ("C", "F"):
        raise OrbaxError(f"{name}: chunks {chunks} of shape {shape}, order {order!r}")
    fill = _fill(dtype, meta.get("fill_value"))
    grid = [range(math.ceil(s / c)) if c else range(1) for s, c in zip(shape, chunks)]
    keys = store.entries()
    if chunks == shape and order == "C" and compressor is not None:
        # one chunk, the whole array: decoded in place
        out = np.empty(shape, dtype=dtype)
        key = f"{name}/{sep.join('0' * len(shape)) if shape else '0'}"
        if key.encode() in keys:
            zstd.decompress_into(store.read(key), out)
        else:
            out[...] = fill
        return out.astype(dtype.newbyteorder("="), copy=False)
    out = np.full(shape, fill, dtype=dtype)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    for index in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}"
        if key.encode() not in keys:
            continue
        raw = store.read(key)
        if compressor is not None:
            raw = zstd.decompress(raw, chunk_bytes)
        elif len(raw) != chunk_bytes:
            raise OrbaxError(f"{key}: {len(raw)} bytes, a chunk is {chunk_bytes}")
        chunk = np.frombuffer(raw, dtype=dtype).reshape(chunks, order=order)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out.astype(dtype.newbyteorder("="), copy=False)


def _insert(tree: Dict, keys, value) -> None:
    """Put ``value`` at the path ``keys`` ((key, key_type) pairs), making the
    containers on the way: a dict before a dict key, a list before an
    index."""
    node: Any = tree
    for depth, (key, _) in enumerate(keys):
        last = depth == len(keys) - 1
        if not last:
            make = list if keys[depth + 1][1] == _SEQUENCE_KEY else dict
        if isinstance(node, list):
            i = int(key)
            node.extend([None] * (i + 1 - len(node)))
            if last:
                node[i] = value
            elif node[i] is None:
                node[i] = make()
            node = node[i]
        else:
            if last:
                node[key] = value
            else:
                node = node.setdefault(key, make())


def restore(path: str, keys: Optional[Iterable[str]] = None, *,
            store: Optional[ocdbt.Store] = None) -> Dict[str, Any]:
    """The checkpoint at ``path`` as nested dicts (and lists) of numpy
    arrays; ``keys`` restricts it to those top-level keys. ``store``, an
    ``ocdbt.Store`` of ``path``, is read through when given (it keeps the
    files it read, and counts their bytes)."""
    path = os.path.abspath(path)
    try:
        with open(os.path.join(path, "_METADATA")) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise OrbaxError(f"{path}: no _METADATA, not an orbax checkpoint") from None
    if not meta.get("use_ocdbt", True) or meta.get("use_zarr3", False):
        raise OrbaxError(f"{path}: only OCDBT with zarr v2 is read")
    wanted = None if keys is None else set(keys)
    store = store or ocdbt.Store(path)
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        path_keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        if any(t not in (_DICT_KEY, _SEQUENCE_KEY) for _, t in path_keys):
            raise OrbaxError(f"{path}: key type other than a dict key or an index in {path_keys}")
        if wanted is not None and path_keys[0][0] not in wanted:
            continue
        value_type = entry["value_metadata"]["value_type"]
        if value_type == "None":
            value = None
        elif value_type in _ARRAY_TYPES:
            value = _read_array(store, ".".join(k for k, _ in path_keys))
        else:
            raise OrbaxError(f"{path}: leaf {path_keys} of type {value_type!r}")
        _insert(tree, path_keys, value)
    return tree
