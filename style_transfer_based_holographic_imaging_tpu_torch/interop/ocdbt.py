"""Read an OCDBT key-value store (TensorStore's format, which orbax writes)
without TensorStore.

An orbax checkpoint directory holds ``manifest.ocdbt`` and the files it
names: B-tree nodes and the values too large to sit inline in them. Every
manifest and node is a file (or a range of one) of this form:

    magic (u32, big-endian: 0x0cdb3a2a a manifest, 0x0cdb20de a node)
    length (u64, little-endian: the whole, footer included)
    version (varint, 0)  compression (varint: 0 none, 1 zstd)
    body (a zstd frame when compressed)
    CRC-32C of everything before it (u32, little-endian)

The body's integers are varints (LEB128) unless said otherwise. A
manifest's body: the config (a 16-byte uuid, the manifest kind, the largest
inline value, the largest decoded node, the version tree's arity log2 as
one byte, the compression method and, for zstd, its level as an i32),
then, for a single-file manifest, a data-file table and the newest entries
of the version tree: per version its generation, the root's height (u8),
data file, offset, length and statistics, and the commit time (u64).

A data-file table: the count; for each file after the first, the length of
the path it shares with the previous one; each path's remaining length;
each base path's length; the remaining bytes. A file is read at
``<directory>/<base path><relative path>``: the top-level manifest of a
multi-process orbax checkpoint names files under ``ocdbt.process_0/``.

A B-tree node's body: its height (u8), a data-file table, the entry count,
each key's length shared with the previous key (from the second key on),
each key's remaining length, and then

* a leaf (height 0): the key bytes, each value's length and kind (0 inline,
  1 in a data file), the data file and offset of each value of kind 1, and
  the inline values' bytes;
* an interior node: each child's common key prefix length, the key bytes,
  each child's data file, offset and length, and its statistics. A
  child's keys omit the common prefix its entry names.

``list_keys(path)`` and ``read(path, key)`` are the interface; ``Store``
keeps the files it has read (``bytes_read``). Every manifest's and node's
checksum is verified; a mismatch, a bad magic number, a version or kind
this reader does not know, or a truncated body raises ``OcdbtError``.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from style_transfer_based_holographic_imaging_tpu_torch.interop import zstd

__all__ = ["Store", "list_keys", "read", "OcdbtError"]

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1


class OcdbtError(ValueError):
    """A store this reader cannot read, or one that is corrupt."""


class _Body:
    """A cursor over a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated body")

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            self._need(1)
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if byte < 0x80:
                return value
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def raw(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]


@dataclass(frozen=True)
class _Ref:
    """Where a node or a value lies: a data file's path, an offset, a length."""
    path: str
    offset: int
    length: int


def _prefixed(body: _Body, n: int, columns: int = 0) -> Tuple[List[bytes], List[List[int]]]:
    """``n`` byte strings stored as the length each shares with the
    previous one (from the second on) and its remaining length, then
    ``columns`` more arrays of ``n`` varints, then the remaining bytes.
    Returns the strings and the columns."""
    shared = [0] + body.varints(n - 1) if n else []
    suffix = body.varints(n)
    extra = [body.varints(n) for _ in range(columns)]
    out: List[bytes] = []
    for i in range(n):
        if i and shared[i] > len(out[-1]):
            raise OcdbtError(f"{body.what}: shared prefix longer than the previous string")
        out.append((out[-1][:shared[i]] if i else b"") + body.raw(suffix[i]))
    return out, extra


def _data_files(body: _Body) -> List[str]:
    """A data-file table: each file's path (base path and relative path
    joined); the base paths' lengths are not needed to open them."""
    paths, _ = _prefixed(body, body.varint(), columns=1)
    return [p.decode() for p in paths]


class Store:
    """An OCDBT store at a directory, read through its newest version."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._files: Dict[str, bytes] = {}
        self._entries: Optional[Dict[bytes, Tuple[str, object]]] = None
        self.max_decoded_node_bytes = 1 << 31
        self.generation, self.root, self.height = self._read_manifest()

    # -- files ---------------------------------------------------------------

    @property
    def bytes_read(self) -> int:
        """The bytes of the files this store has read."""
        return sum(len(b) for b in self._files.values())

    def _file(self, rel: str) -> bytes:
        blob = self._files.get(rel)
        if blob is None:
            full = os.path.normpath(os.path.join(self.path, rel))
            if not full.startswith(self.path + os.sep):
                raise OcdbtError(f"data file {rel!r} lies outside {self.path}")
            with open(full, "rb") as f:
                blob = f.read()
            self._files[rel] = blob
        return blob

    def _range(self, ref: _Ref) -> bytes:
        blob = self._file(ref.path)
        if ref.offset + ref.length > len(blob):
            raise OcdbtError(f"{ref.path}: range {ref.offset}+{ref.length} beyond its {len(blob)} bytes")
        return blob[ref.offset:ref.offset + ref.length]

    def _decode(self, blob: bytes, magic: int, what: str) -> _Body:
        """The checked, decompressed body of a manifest or node."""
        if len(blob) < 18:
            raise OcdbtError(f"{what}: {len(blob)} bytes, too short")
        got_magic, length = struct.unpack_from(">I", blob)[0], struct.unpack_from("<Q", blob, 4)[0]
        if got_magic != magic:
            raise OcdbtError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
        if length != len(blob):
            raise OcdbtError(f"{what}: header says {length} bytes, found {len(blob)}")
        want = struct.unpack_from("<I", blob, len(blob) - 4)[0]
        got = zstd.crc32c(blob[:-4])
        if got != want:
            raise OcdbtError(f"{what}: checksum mismatch (CRC-32C {got:#010x}, footer {want:#010x})")
        head = _Body(blob[:-4], what)
        head.pos = 12
        version, compression = head.varint(), head.varint()
        if version != 0:
            raise OcdbtError(f"{what}: format version {version}")
        body = blob[head.pos:-4]
        if compression == 1:
            try:
                body = zstd.decompress(body, max_size=self.max_decoded_node_bytes)
            except zstd.ZstdError as e:
                raise OcdbtError(f"{what}: {e}") from None
        elif compression != 0:
            raise OcdbtError(f"{what}: compression {compression}")
        return _Body(body, what)

    # -- manifest and nodes ----------------------------------------------------

    def _read_manifest(self):
        what = os.path.join(self.path, "manifest.ocdbt")
        body = self._decode(self._file("manifest.ocdbt"), MANIFEST_MAGIC, what)
        body.raw(16)  # uuid
        kind = body.varint()
        body.varint()  # max_inline_value_bytes
        self.max_decoded_node_bytes = body.varint()
        body.u8()  # version_tree_arity_log2
        if body.varint() == 1:
            body.raw(4)  # zstd level
        if kind != 0:
            raise OcdbtError(f"{what}: manifest kind {kind} (only a single-file manifest is read)")
        files = _data_files(body)
        n = body.varint()
        if n == 0:
            raise OcdbtError(f"{what}: no version")
        generation = body.varints(n)
        height = [body.u8() for _ in range(n)]
        file_id, offset, length = body.varints(n), body.varints(n), body.varints(n)
        num_keys = body.varints(n)
        body.varints(2 * n)  # num_tree_bytes, num_indirect_value_bytes
        body.raw(8 * n)  # commit times
        i = max(range(n), key=generation.__getitem__)
        if num_keys[i] == 0 or offset[i] == _NO_ROOT:
            return generation[i], None, 0
        return generation[i], self._ref(files, file_id[i], offset[i], length[i], what), height[i]

    def _ref(self, files: List[str], file_id: int, offset: int, length: int, what: str) -> _Ref:
        if file_id >= len(files):
            raise OcdbtError(f"{what}: data file {file_id} of {len(files)}")
        return _Ref(files[file_id], offset, length)

    def _walk(self, ref: _Ref, height: int, prefix: bytes, out: Dict[bytes, Tuple[str, object]]) -> None:
        what = f"{os.path.join(self.path, ref.path)}@{ref.offset}"
        body = self._decode(self._range(ref), NODE_MAGIC, what)
        if body.u8() != height:
            raise OcdbtError(f"{what}: node height differs from its parent's entry")
        files = _data_files(body)
        n = body.varint()
        if height == 0:
            keys, _ = _prefixed(body, n)
            lengths = body.varints(n)
            kinds = body.varints(n)
            if any(k not in (0, 1) for k in kinds):
                raise OcdbtError(f"{what}: value kind not 0 or 1")
            indirect = [i for i in range(n) if kinds[i] == 1]
            file_id, offset = body.varints(len(indirect)), body.varints(len(indirect))
            where = dict(zip(indirect, zip(file_id, offset)))
            for i, key in enumerate(keys):
                if kinds[i] == 0:
                    out[prefix + key] = ("inline", body.raw(lengths[i]))
                else:
                    fid, off = where[i]
                    out[prefix + key] = ("ref", self._ref(files, fid, off, lengths[i], what))
        else:
            keys, (common,) = _prefixed(body, n, columns=1)
            file_id, offset, length = body.varints(n), body.varints(n), body.varints(n)
            body.varints(3 * n)  # statistics
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise OcdbtError(f"{what}: subtree prefix longer than its key")
                child = self._ref(files, file_id[i], offset[i], length[i], what)
                self._walk(child, height - 1, prefix + keys[i][:common[i]], out)
        if body.pos != len(body.data):
            raise OcdbtError(f"{what}: {len(body.data) - body.pos} bytes after the node's entries")

    def entries(self) -> Dict[bytes, Tuple[str, object]]:
        """Every key of the newest version and where its value lies."""
        if self._entries is None:
            out: Dict[bytes, Tuple[str, object]] = {}
            if self.root is not None:
                self._walk(self.root, self.height, b"", out)
            self._entries = out
        return self._entries

    def list_keys(self) -> List[str]:
        return sorted(k.decode() for k in self.entries())

    def read(self, key: str) -> bytes:
        """The value of ``key``; KeyError when the store has none."""
        kind, value = self.entries()[key.encode()]
        return value if kind == "inline" else self._range(value)


def list_keys(path: str) -> List[str]:
    """Every key of the OCDBT store at ``path``, sorted."""
    return Store(path).list_keys()


def read(path: str, key: str) -> bytes:
    """The value of ``key`` in the OCDBT store at ``path``."""
    return Store(path).read(key)
