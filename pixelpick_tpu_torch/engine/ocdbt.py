"""A read-only OCDBT key-value store: the database tensorstore writes under
an orbax step directory (``manifest.ocdbt``, ``d/*``,
``ocdbt.process_N/``).

The on-disk format, as tensorstore writes it:

- Every manifest and node file starts with a header: the magic number
  (``0x0cdb3a2a`` for a manifest, ``0x0cdb20de`` for a B+tree node,
  ``0x0cdb1234`` for a version-tree node; big-endian), the encoded length
  (uint64 LE), the format version (varint, 0) and the compression method
  (varint: 0 none, 1 zstd). The body follows, a zstd frame when compressed,
  and last a CRC32C (uint32 LE) of everything before it.
- Fields are columnar: a list of entries stores each field for all
  entries in turn. Integers are LEB128 varints unless said otherwise.
- A data file table (``num_files``; the prefix length, shared with the
  previous path, of files 1..n-1; each suffix length; each base-path
  length; the suffixes) names the files that a node's references point
  into. A path is relative to the directory of the database; a node read
  from a file whose base path is ``B`` resolves its own paths under ``B``.
- The manifest holds the config (uuid, manifest kind, max inline value
  bytes, max decoded node bytes, version-tree arity log2, compression),
  then the version tree's leaf entries inline (generation, root height,
  root reference, root statistics, commit time) and the references to
  version-tree nodes for older generations.
- A B+tree node holds its height, its data file table and its entries. A
  leaf's are prefix-compressed keys and their values, inline or indirect
  (a data file, an offset and a length); an interior node's are keys,
  each child's common key prefix length, and each child's reference and
  statistics. A child's keys continue its parent entry's key from the
  common prefix on.

``OcdbtStore(path)`` reads the newest version. ``list()`` gives its keys in
order, ``read(key)`` a value. A file whose CRC32C does not match raises
:class:`OcdbtError` naming the file.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

from pixelpick_tpu_torch.engine.zstd import decompress

MANIFEST_MAGIC, BTREE_MAGIC, VERSION_TREE_MAGIC = \
    0x0CDB3A2A, 0x0CDB20DE, 0x0CDB1234
_HEADER = 4 + 8


class OcdbtError(ValueError):
    pass


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            if self.pos >= len(self.data):
                raise OcdbtError(f"{self.where}: truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.where}: varint over 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.where}: truncated ({n} bytes wanted "
                             f"at {self.pos} of {len(self.data)})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8s(self, n: int) -> List[int]:
        return list(self.take(n))

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def done(self) -> None:
        if self.pos != len(self.data):
            raise OcdbtError(f"{self.where}: {len(self.data) - self.pos} "
                             f"bytes left over")


def _decode_file(data: bytes, magic: int, where: str) -> bytes:
    """Check a manifest or node's header and CRC32C; its body, inflated."""
    if len(data) < _HEADER + 4:
        raise OcdbtError(f"{where}: {len(data)} bytes is too short")
    got_magic, length = struct.unpack_from(">I", data)[0], \
        struct.unpack_from("<Q", data, 4)[0]
    if got_magic != magic:
        raise OcdbtError(f"{where}: magic 0x{got_magic:08x}, want "
                         f"0x{magic:08x}")
    if length != len(data):
        raise OcdbtError(f"{where}: header says {length} bytes, "
                         f"{len(data)} read")
    want = struct.unpack_from("<I", data, len(data) - 4)[0]
    if crc32c(data[:-4]) != want:
        raise OcdbtError(f"{where}: CRC32C mismatch (the file is corrupt)")
    r = _Reader(data[_HEADER:-4], where)
    version = r.varint()
    if version != 0:
        raise OcdbtError(f"{where}: format version {version}")
    method = r.varint()
    body = data[_HEADER + r.pos:-4]
    if method == 0:
        return body
    if method == 1:
        return decompress(body)
    raise OcdbtError(f"{where}: compression method {method}")


def _data_file_table(r: _Reader, base: str) -> List[Tuple[str, str]]:
    """Each file's ``(path, base path)`` under the database directory: a
    node read from the file resolves its own paths under its base path."""
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for p, s, bl in zip(prefix, suffix, base_len):
        if p > len(prev) or bl > p + s:
            raise OcdbtError(f"{r.where}: corrupt data file table")
        prev = prev[:p] + r.take(s)
        path = prev.decode("utf-8")
        files.append((base + path, base + path[:bl]))
    return files


Ref = Tuple[Tuple[str, str], int, int]  # (file, base path), offset, length


def _refs(r: _Reader, files, n: int) -> List[Ref]:
    """``n`` indirect references: file ids, offsets, lengths."""
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    for i in ids:
        if i >= len(files):
            raise OcdbtError(f"{r.where}: data file id {i} of "
                             f"{len(files)}")
    return [(files[i], o, m) for i, o, m in zip(ids, offsets, lengths)]


def _keys(r: _Reader, n: int, interior: bool):
    """Prefix-compressed keys; an interior node stores each child's common
    prefix length between the lengths and the key bytes."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise OcdbtError(f"{r.where}: corrupt key prefix length")
        prev = prev[:p] + r.take(s)
        keys.append(prev)
    return keys, common


_EMPTY = (1 << 64) - 1  # the offset and length of an empty tree's root


class OcdbtStore:
    """The newest version of the OCDBT database at directory ``root``."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._files: Dict[str, bytes] = {}
        where = os.path.join(self.root, "manifest.ocdbt")
        r = _Reader(_decode_file(self._file("manifest.ocdbt"),
                                 MANIFEST_MAGIC, where), where)
        self.config = {"uuid": r.take(16).hex()}
        kind = r.varint()
        if kind != 0:
            raise OcdbtError(f"{where}: numbered manifests (kind {kind}) "
                             f"are not supported")
        self.config.update(max_inline_value_bytes=r.varint(),
                           max_decoded_node_bytes=r.varint(),
                           version_tree_arity_log2=r.u8s(1)[0])
        method = r.varint()
        if method == 1:
            self.config["compression"] = {
                "id": "zstd", "level": struct.unpack("<i", r.take(4))[0]}
        elif method == 0:
            self.config["compression"] = None
        else:
            raise OcdbtError(f"{where}: compression method {method}")
        files = _data_file_table(r, "")
        versions = self._version_leaves(r, files)
        n = r.varint()
        generation = r.varints(n)
        nodes = _refs(r, files, n)
        r.varints(n)  # num_generations
        r.u64s(n)     # commit times
        heights = r.u8s(n)
        r.done()
        if not versions:
            raise OcdbtError(f"{where}: no version")
        # the older generations, in version-tree nodes: walked for their
        # checksums and structure; the newest is among the manifest's own
        self.generations = [v[0] for v in versions]
        for g, ref, h in zip(generation, nodes, heights):
            under = self._version_node(ref, h)
            if not under or max(under) != g:
                raise OcdbtError(f"{where}: the version node of generation "
                                 f"{g} holds {sorted(under)[-3:]}")
            self.generations += under
        self.generation, self.height, self._root_ref = max(
            versions, key=lambda v: v[0])
        if self.generation != max(self.generations):
            raise OcdbtError(f"{where}: generation {max(self.generations)} "
                             f"is newer than the manifest's newest")
        self._entries: Optional[Dict[bytes, tuple]] = None

    @staticmethod
    def _version_leaves(r: _Reader, files):
        n = r.varint()
        generation = r.varints(n)
        height = r.u8s(n)
        roots = _refs(r, files, n)
        for _ in range(3):  # num_keys, num_tree_bytes, indirect bytes
            r.varints(n)
        r.u64s(n)  # commit times
        return list(zip(generation, height, roots))

    def _version_node(self, ref: Ref, height: int) -> List[int]:
        """The generations under a version-tree node."""
        where = f"{os.path.join(self.root, ref[0][0])}@{ref[1]}"
        r = _Reader(_decode_file(self._fetch(ref), VERSION_TREE_MAGIC,
                                 where), where)
        r.u8s(1)  # arity log2
        node_height = r.u8s(1)[0]
        if node_height != height:
            raise OcdbtError(f"{where}: height {node_height}, want {height}")
        files = _data_file_table(r, ref[0][1])
        if height == 0:
            out = [v[0] for v in self._version_leaves(r, files)]
            r.done()
            return out
        n = r.varint()
        r.varints(n)  # generation
        children = _refs(r, files, n)
        r.varints(n)  # num_generations
        r.u64s(n)     # commit times
        r.done()
        out = []
        for child in children:
            out += self._version_node(child, height - 1)
        return out

    def _file(self, rel: str) -> bytes:
        if rel not in self._files:
            with open(os.path.join(self.root, rel), "rb") as f:
                self._files[rel] = f.read()
        return self._files[rel]

    def _fetch(self, ref: Ref) -> bytes:
        (rel, _), offset, length = ref
        data = self._file(rel)
        if offset + length > len(data):
            raise OcdbtError(f"{os.path.join(self.root, rel)}: "
                             f"[{offset}, {offset + length}) past its "
                             f"{len(data)} bytes")
        return data[offset:offset + length]

    def _walk(self, ref: Ref, height: int, prefix: bytes, out: dict) -> None:
        where = f"{os.path.join(self.root, ref[0][0])}@{ref[1]}"
        r = _Reader(_decode_file(self._fetch(ref), BTREE_MAGIC, where), where)
        node_height = r.u8s(1)[0]
        if node_height != height:
            raise OcdbtError(f"{where}: height {node_height}, want {height}")
        files = _data_file_table(r, ref[0][1])
        n = r.varint()
        keys, common = _keys(r, n, interior=height > 0)
        if height == 0:
            lengths = r.varints(n)
            kinds = r.u8s(n)
            if any(k > 1 for k in kinds):
                raise OcdbtError(f"{where}: value kind {max(kinds)}")
            n_ind = sum(kinds)
            ids, offsets = r.varints(n_ind), r.varints(n_ind)
            indirect = iter(zip(ids, offsets))
            for key, length, kind in zip(keys, lengths, kinds):
                if kind:
                    i, o = next(indirect)
                    if i >= len(files):
                        raise OcdbtError(f"{where}: data file id {i}")
                    out[prefix + key] = (files[i], o, length)
                else:
                    out[prefix + key] = r.take(length)
            r.done()
            return
        children = _refs(r, files, n)
        for _ in range(3):  # num_keys, num_tree_bytes, indirect bytes
            r.varints(n)
        r.done()
        for key, c, child in zip(keys, common, children):
            self._walk(child, height - 1, prefix + key[:c], out)

    def _index(self) -> Dict[bytes, tuple]:
        if self._entries is None:
            out: Dict[bytes, tuple] = {}
            if self._root_ref[1] != _EMPTY:
                self._walk(self._root_ref, self.height, b"", out)
            self._entries = out
        return self._entries

    def list(self) -> List[bytes]:
        return sorted(self._index())

    def read(self, key: bytes) -> bytes:
        value = self._index()[key]
        return value if isinstance(value, bytes) else self._fetch(value)
