"""A Zstandard decoder (RFC 8878) in Python and NumPy, and the smallest
valid encoder.

JAX's orbax checkpoints compress everything with zstd: each OCDBT file of
the store and each zarr chunk of an array. The port reads them with neither
``zstandard`` nor ``tensorstore`` installed, so it decodes the format here:

- frames: the header (single segment, window size, content size, the
  checksum flag; a dictionary ID other than 0 is refused), XXH64 checked
  when the flag is set, several frames in a row, skippable frames;
- blocks: raw, RLE and compressed;
- literals: raw, RLE, Huffman-compressed in 1 or 4 streams, and treeless
  (the frame's previous Huffman table reused);
- sequences: predefined, RLE, FSE-compressed and repeat modes for the three
  codes, and the repeat-offset rules.

Speed: a best model holds millions of f32 parameters, whose literals are
Huffman-coded. ``decompress`` first parses every block of the input (the
headers, the tables and the sequences) and then decodes all literal streams
of all blocks together, one table lookup per symbol for every stream at
once in NumPy, before it replays the sequences block by block.

``compress_raw(data)`` writes one frame of raw blocks (no compression), the
least a zstd reader must accept.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE_MASK, SKIPPABLE_MAGIC = 0xFFFFFFF0, 0x184D2A50
BLOCK_MAX = 128 * 1024


class ZstdError(ValueError):
    pass


# ----------------------------------------------------------------- XXH64

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, \
    1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    i = 0
    if n >= 32:
        v1, v2 = (seed + _P1 + _P2) & _M64, (seed + _P2) & _M64
        v3, v4 = seed & _M64, (seed - _P1) & _M64
        lanes = struct.unpack_from(f"<{(n // 32) * 4}Q", data)
        for j in range(0, len(lanes), 4):
            v1 = _round(v1, lanes[j])
            v2 = _round(v2, lanes[j + 1])
            v3 = _round(v3, lanes[j + 2])
            v4 = _round(v4, lanes[j + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) \
            & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        i = (n // 32) * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, struct.unpack_from("<Q", data, i)[0])
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (struct.unpack_from("<I", data, i)[0] * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ------------------------------------------------------------ bit readers

class _Forward:
    """Little-endian bits, read from the start (FSE table headers)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.bit = data, pos * 8

    def read(self, n: int) -> int:
        i = self.bit >> 3
        v = int.from_bytes(self.data[i:i + 4], "little") >> (self.bit & 7)
        self.bit += n
        return v & ((1 << n) - 1)

    def byte_end(self) -> int:
        return (self.bit + 7) >> 3


class _Backward:
    """A zstd backward bitstream: read from the end toward the start, the
    last byte's highest set bit the start marker. Reading past the start
    gives zeros; ``pos`` going below 0 says how far."""

    PAD = 8

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("bitstream without its end marker")
        self.data = bytes(self.PAD) + bytes(data)
        self.pos = len(data) * 8 - (8 - data[-1].bit_length() + 1)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        p = self.pos + self.PAD * 8
        if p < 0:
            raise ZstdError("bitstream read past its start")
        i = p >> 3
        v = int.from_bytes(self.data[i:i + 8], "little") >> (p & 7)
        return v & ((1 << n) - 1)


# ------------------------------------------------------------------- FSE

def _read_fse_header(data: bytes, pos: int, max_al: int,
                     max_symbols: int) -> Tuple[List[int], int, int]:
    """A normalized distribution (RFC 8878 4.1.1): ``(counts, accuracy
    log, position after the header)``."""
    r = _Forward(data, pos)
    al = r.read(4) + 5
    if al > max_al:
        raise ZstdError(f"FSE accuracy log {al} over {max_al}")
    remaining = 1 << al
    counts: List[int] = []
    while remaining > 0 and len(counts) < max_symbols:
        bits = (remaining + 1).bit_length()
        val = r.read(bits)
        lower = (1 << (bits - 1)) - 1
        threshold = (1 << bits) - 1 - (remaining + 1)
        if (val & lower) < threshold:
            r.bit -= 1
            val &= lower
        elif val > lower:
            val -= threshold
        proba = val - 1
        remaining -= -proba if proba < 0 else proba
        counts.append(proba)
        if proba == 0:
            while True:
                rep = r.read(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
    if remaining != 0 or len(counts) > max_symbols:
        raise ZstdError("corrupt FSE table header")
    return counts, al, r.byte_end()


class _FSE:
    """A decoding table: per state its symbol, bit count and next base."""

    def __init__(self, counts: List[int], al: int):
        size = 1 << al
        sym = [0] * size
        high = size
        desc = [0] * len(counts)
        for s, c in enumerate(counts):
            if c == -1:
                high -= 1
                sym[high] = s
                desc[s] = 1
        step = (size >> 1) + (size >> 3) + 3
        mask, pos = size - 1, 0
        for s, c in enumerate(counts):
            if c <= 0:
                continue
            desc[s] = c
            for _ in range(c):
                sym[pos] = s
                pos = (pos + step) & mask
                while pos >= high:
                    pos = (pos + step) & mask
        if pos != 0:
            raise ZstdError("corrupt FSE distribution")
        nbits = [0] * size
        base = [0] * size
        for i in range(size):
            d = desc[sym[i]]
            desc[sym[i]] += 1
            nb = al - (d.bit_length() - 1)
            nbits[i] = nb
            base[i] = (d << nb) - size
        self.al, self.sym, self.nbits, self.base = al, sym, nbits, base

    @classmethod
    def rle(cls, symbol: int) -> "_FSE":
        t = cls.__new__(cls)
        t.al, t.sym, t.nbits, t.base = 0, [symbol], [0], [0]
        return t


_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
                2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, -1, -1, -1, -1, -1], 5)
_PREDEFINED = {}

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BASE = [i + 3 for i in range(32)] + [35, 37, 39, 41, 43, 47, 51, 59,
                                         67, 83, 99, 131, 259, 515, 1027,
                                         2051, 4099, 8195, 16387, 32771,
                                         65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
                       12, 13, 14, 15, 16]
# (name, predefined distribution, max accuracy log, max symbol)
_CODES = (("ll", _LL_DEFAULT, 9, 35), ("of", _OF_DEFAULT, 8, 31),
          ("ml", _ML_DEFAULT, 9, 52))


def _predefined(name: str, dist) -> _FSE:
    if name not in _PREDEFINED:
        _PREDEFINED[name] = _FSE(*dist)
    return _PREDEFINED[name]


# --------------------------------------------------------------- Huffman

class _Huffman:
    """A literals decoding table of ``2 ** max_bits`` entries, indexed by
    the next ``max_bits`` bits of a stream (the code in the top bits)."""

    def __init__(self, weights: List[int]):
        total = sum(1 << (w - 1) for w in weights if w)
        if total == 0:
            raise ZstdError("Huffman weights all zero")
        max_bits = total.bit_length()
        left = (1 << max_bits) - total
        if left & (left - 1):
            raise ZstdError("Huffman weights do not sum to a power of 2")
        weights = list(weights) + [left.bit_length()]
        if max_bits > 11:
            raise ZstdError(f"Huffman code of {max_bits} bits")
        size = 1 << max_bits
        sym = np.zeros(size, np.uint8)
        nbits = np.zeros(size, np.uint8)
        pos = 0
        for w in range(1, max_bits + 1):
            for s, ws in enumerate(weights):
                if ws == w:
                    n = 1 << (w - 1)
                    sym[pos:pos + n] = s
                    nbits[pos:pos + n] = max_bits + 1 - w
                    pos += n
        if pos != size:
            raise ZstdError("Huffman table does not fill its range")
        self.max_bits, self.sym, self.nbits = max_bits, sym, nbits


def _read_huffman(data: bytes, pos: int) -> Tuple[_Huffman, int]:
    head = data[pos]
    pos += 1
    if head >= 128:
        n = head - 127
        raw = data[pos:pos + (n + 1) // 2]
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return _Huffman(weights[:n]), pos + (n + 1) // 2
    end = pos + head
    counts, al, p = _read_fse_header(data, pos, 6, 256)
    table = _FSE(counts, al)
    r = _Backward(data[p:end])
    s1, s2 = r.read(al), r.read(al)
    weights = []
    states = [s1, s2]
    # two interleaved states until the stream runs out (RFC 4.2.1.3)
    while True:
        for k in (0, 1):
            st = states[k]
            weights.append(table.sym[st])
            states[k] = table.base[st] + r.read(table.nbits[st])
            if r.pos < 0:
                weights.append(table.sym[states[1 - k]])
                if len(weights) > 255:
                    raise ZstdError("too many Huffman weights")
                return _Huffman(weights), end
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")


def _decode_huffman_streams(jobs) -> List[bytes]:
    """Decode every Huffman stream of ``jobs`` (``(stream bytes, symbol
    count, _Huffman)``) together: each step looks one symbol up for every
    stream at once.

    Every table is widened to 11 bits (the format's longest code): a lane
    reads the 11 bits that end where its ``max_bits`` window ends, and the
    widened entry ignores the low ``11 - max_bits`` of them. An entry packs
    the symbol (low byte) and its bit count."""
    if not jobs:
        return []
    order = sorted(range(len(jobs)), key=lambda i: -jobs[i][1])
    pad = 4  # zero bytes before each stream: reads below its start
    chunks, first, pos, tables, toff = [], [], [], [], []
    at, tab_at, table_ids = 0, 0, {}
    for i in order:
        data, n, huf = jobs[i]
        if not data or data[-1] == 0:
            raise ZstdError("Huffman stream without its end marker")
        chunks.append(bytes(pad) + data)
        first.append((at + pad) * 8)
        # the lane's position: its window's low bit, moved down to 11 bits
        pos.append((at + pad) * 8 + len(data) * 8
                   - (9 - data[-1].bit_length()) - 11)
        at += pad + len(data)
        if id(huf) not in table_ids:
            table_ids[id(huf)] = tab_at
            wide = np.arange(1 << 11) >> (11 - huf.max_bits)
            tables.append(huf.sym[wide].astype(np.int64)
                          | (huf.nbits[wide].astype(np.int64) << 8))
            tab_at += 1 << 11
        toff.append(table_ids[id(huf)])
    buf = np.frombuffer(b"".join(chunks) + bytes(4), np.uint8).astype(
        np.int64)
    w24 = buf[:-2] | (buf[1:-1] << 8) | (buf[2:] << 16)
    packed = np.concatenate(tables)
    gp = np.asarray(pos, np.int64)
    toff = np.asarray(toff, np.int64)
    counts = [jobs[i][1] for i in order]
    out = np.zeros((counts[0], len(order)), np.uint8)
    ends = np.zeros(len(order), np.int64)
    active = len(order)
    for k in range(counts[0]):
        while counts[active - 1] <= k:
            active -= 1
            ends[active] = gp[active]
        g = gp[:active]
        e = packed[((w24[g >> 3] >> (g & 7)) & 0x7FF) + toff[:active]]
        out[k, :active] = e
        g -= e >> 8
    ends[:active] = gp[:active]
    # a stream that ends where it should has consumed all its bits: its
    # max_bits window sits just below its first byte
    if not np.array_equal(ends, np.asarray(first, np.int64) - 11):
        raise ZstdError("Huffman stream does not end where it should")
    result: List[Optional[bytes]] = [None] * len(jobs)
    for lane, i in enumerate(order):
        result[i] = out[:counts[lane], lane].tobytes()
    return result


# ---------------------------------------------------------------- blocks

class _Frame:
    """A frame's state carried from block to block."""

    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.tables = {"ll": None, "of": None, "ml": None}


class _Literals:
    """A literals section whose streams wait for the batch decode."""

    def __init__(self, parts: int):
        self.parts: List[Optional[bytes]] = [None] * parts

    def value(self) -> bytes:
        return b"".join(self.parts)


def _literals(data: bytes, pos: int, frame: _Frame, jobs: list):
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12)
            pos += 3
        if kind == 0:
            if pos + size > len(data):
                raise ZstdError("raw literals run past the block")
            return data[pos:pos + size], pos + size
        return bytes([data[pos]]) * size, pos + 1
    n_head, bits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    head = int.from_bytes(data[pos:pos + n_head], "little")
    mask = (1 << bits) - 1
    regen, comp = (head >> 4) & mask, (head >> (4 + bits)) & mask
    pos += n_head
    end = pos + comp
    if end > len(data):
        raise ZstdError("compressed literals run past the block")
    if kind == 2:
        frame.huffman, pos = _read_huffman(data, pos)
    elif frame.huffman is None:
        raise ZstdError("treeless literals with no earlier Huffman table")
    huf = frame.huffman
    if fmt == 0:
        lit = _Literals(1)
        jobs.append((data[pos:end], regen, huf, lit, 0))
        return lit, end
    sizes = struct.unpack_from("<3H", data, pos)
    pos += 6
    last = end - pos - sum(sizes)
    if last < 0:
        raise ZstdError("literal streams larger than their section")
    each = (regen + 3) // 4
    lit = _Literals(4)
    for j, (sz, n) in enumerate(zip(list(sizes) + [last],
                                    [each] * 3 + [regen - 3 * each])):
        if n < 0:
            raise ZstdError("literal stream sizes are corrupt")
        jobs.append((data[pos:pos + sz], n, huf, lit, j))
        pos += sz
    return lit, end


def _sequences(data: bytes, pos: int, end: int, frame: _Frame):
    """Decode a sequences section to ``(literal length, match length,
    offset value)`` triples."""
    b0 = data[pos]
    if b0 == 0:
        return [], pos + 1
    if b0 < 128:
        n, pos = b0, pos + 1
    elif b0 < 255:
        n, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        n, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    tabs = {}
    for (name, dist, max_al, max_sym), shift in zip(_CODES, (6, 4, 2)):
        mode = (modes >> shift) & 3
        if mode == 0:
            tabs[name] = _predefined(name, dist)
        elif mode == 1:
            if data[pos] > max_sym:
                raise ZstdError(f"RLE {name} code {data[pos]}")
            tabs[name] = _FSE.rle(data[pos])
            pos += 1
        elif mode == 2:
            counts, al, pos = _read_fse_header(data, pos, max_al,
                                               max_sym + 1)
            tabs[name] = _FSE(counts, al)
        else:
            if frame.tables[name] is None:
                raise ZstdError(f"repeat {name} table with none before")
            tabs[name] = frame.tables[name]
    frame.tables.update(tabs)
    ll_t, of_t, ml_t = tabs["ll"], tabs["of"], tabs["ml"]
    r = _Backward(data[pos:end])
    s_ll, s_of, s_ml = r.read(ll_t.al), r.read(of_t.al), r.read(ml_t.al)
    seqs = []
    for i in range(n):
        of_code, ml_code, ll_code = of_t.sym[s_of], ml_t.sym[s_ml], \
            ll_t.sym[s_ll]
        if of_code > 31 or ml_code > 52 or ll_code > 35:
            raise ZstdError("sequence code out of range")
        offset = (1 << of_code) + r.read(of_code)
        ml = _ML_BASE[ml_code] + r.read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + r.read(_LL_BITS[ll_code])
        seqs.append((ll, ml, offset))
        if i + 1 < n:
            s_ll = ll_t.base[s_ll] + r.read(ll_t.nbits[s_ll])
            s_ml = ml_t.base[s_ml] + r.read(ml_t.nbits[s_ml])
            s_of = of_t.base[s_of] + r.read(of_t.nbits[s_of])
    if r.pos != 0:
        raise ZstdError("sequence bitstream does not end where it should")
    return seqs, end


def _parse_frame(data: bytes, pos: int, jobs: list):
    """One frame's header and blocks: ``(plan, end position)``, the plan
    what ``_run_frame`` replays once the literals are decoded."""
    fhd = data[pos + 4]
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, \
        (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    pos += 5
    window = None
    if not single:
        wd = data[pos]
        pos += 1
        exp, mant = wd >> 3, wd & 7
        window = (1 << (10 + exp)) + ((1 << (10 + exp)) // 8) * mant
    n_dict = (0, 1, 2, 4)[dict_flag]
    if n_dict and int.from_bytes(data[pos:pos + n_dict], "little"):
        raise ZstdError("frame needs a dictionary")
    pos += n_dict
    n_fcs = (1 if single else 0, 2, 4, 8)[fcs_flag]
    size = None
    if n_fcs:
        size = int.from_bytes(data[pos:pos + n_fcs], "little")
        size += 256 if n_fcs == 2 else 0
        pos += n_fcs
    block_max = min(BLOCK_MAX, window if window is not None else size)
    frame = _Frame()
    blocks = []
    while True:
        if pos + 3 > len(data):
            raise ZstdError("truncated block header")
        bh = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        if btype == 1:
            if bsize > block_max:
                raise ZstdError("RLE block over the block size limit")
            blocks.append(data[pos:pos + 1] * bsize)
            pos += 1
        else:
            if bsize > block_max or pos + bsize > len(data):
                raise ZstdError("block over its limit or past the input")
            if btype == 0:
                blocks.append(data[pos:pos + bsize])
            elif btype == 2:
                block = data[pos:pos + bsize]
                lit, p = _literals(block, 0, frame, jobs)
                seqs, _ = _sequences(block, p, bsize, frame)
                blocks.append((lit, seqs))
            else:
                raise ZstdError("reserved block type")
            pos += bsize
        if last:
            break
    digest = None
    if checksum:
        digest = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
    return (blocks, size, digest), pos


def _run_frame(plan) -> bytes:
    blocks, size, digest = plan
    out = bytearray()
    rep = [1, 4, 8]
    for block in blocks:
        if not isinstance(block, tuple):
            out += block
            continue
        lit, seqs = block
        lits = lit if isinstance(lit, bytes) else lit.value()
        at = 0
        for ll, ml, ov in seqs:
            if at + ll > len(lits):
                raise ZstdError("sequence takes more literals than exist")
            out += lits[at:at + ll]
            at += ll
            if ov > 3:
                off = ov - 3
                rep = [off, rep[0], rep[1]]
            else:
                idx = ov - 1 + (ll == 0)
                if idx == 0:
                    off = rep[0]
                else:
                    off = rep[idx] if idx < 3 else rep[0] - 1
                    rep = [off, rep[0], rep[2] if idx == 1 else rep[1]]
            if off == 0 or off > len(out):
                raise ZstdError(f"match offset {off} beyond the output")
            start = len(out) - off
            if off >= ml:
                out += out[start:start + ml]
            else:  # the match overlaps what it writes: repeat the period
                period = bytes(out[start:])
                out += (period * (ml // off + 1))[:ml]
        out += lits[at:]
    if size is not None and len(out) != size:
        raise ZstdError(f"frame decoded to {len(out)} bytes, its header "
                        f"says {size}")
    if digest is not None and xxh64(bytes(out)) & 0xFFFFFFFF != digest:
        raise ZstdError("content checksum mismatch")
    return bytes(out)


def decompress_many(blobs) -> List[bytes]:
    """``decompress`` of each of ``blobs``, the literal streams of all of
    them decoded in one batch."""
    per_blob, jobs = [], []
    for data in blobs:
        data = bytes(data)
        plans, pos = [], 0
        while pos < len(data):
            if pos + 4 > len(data):
                raise ZstdError("truncated frame magic")
            magic = int.from_bytes(data[pos:pos + 4], "little")
            if magic & SKIPPABLE_MASK == SKIPPABLE_MAGIC:
                n = int.from_bytes(data[pos + 4:pos + 8], "little")
                pos += 8 + n
                if pos > len(data):
                    raise ZstdError("truncated skippable frame")
                continue
            if magic != MAGIC:
                raise ZstdError(f"not a zstd frame (magic 0x{magic:08x} at "
                                f"byte {pos})")
            plan, pos = _parse_frame(data, pos, jobs)
            plans.append(plan)
        per_blob.append(plans)
    for (_, _, _, lit, j), part in zip(
            jobs, _decode_huffman_streams([j[:3] for j in jobs])):
        lit.parts[j] = part
    return [b"".join(_run_frame(p) for p in plans) for plans in per_blob]


def decompress(data: bytes) -> bytes:
    """Every frame of ``data`` decoded and joined; skippable frames are
    passed over."""
    return decompress_many([data])[0]


def compress_raw(data: bytes) -> bytes:
    """One single-segment frame of raw blocks, its content size stated."""
    n = len(data)
    if n < 256:
        fhd, fcs = 0x20, bytes([n])
    elif n < 65536 + 256:
        fhd, fcs = 0x60, struct.pack("<H", n - 256)
    elif n < 1 << 32:
        fhd, fcs = 0xA0, struct.pack("<I", n)
    else:
        fhd, fcs = 0xE0, struct.pack("<Q", n)
    out = [struct.pack("<I", MAGIC), bytes([fhd]), fcs]
    starts = list(range(0, n, BLOCK_MAX)) or [0]
    for s in starts:
        chunk = data[s:s + BLOCK_MAX]
        last = int(s == starts[-1])
        out.append((last | (len(chunk) << 3)).to_bytes(3, "little"))
        out.append(chunk)
    return b"".join(out)
