"""The port's Zstandard decoder (``pixelpick_tpu_torch/engine/zstd.py``)
against the frames tensorstore writes for orbax's zarr chunks, and against
``zstandard`` for the parts of the format tensorstore does not reach.

- Frames from tensorstore's zarr ``zstd`` compressor at levels 1, 3, 9 and
  19, over random f32, zeros, ``arange``, repeated text, an empty payload
  (tensorstore writes no chunk for it, so ``zstandard`` makes that frame)
  and a 384 KiB payload (several blocks): each decodes to the bytes written,
  exactly, and the raw-block encoder's frame of the same bytes decodes to
  them too, in the port and in ``zstandard``.
- Frames with the content checksum (XXH64 checked; a flipped checksum
  raises), several frames in a row with a skippable frame between them,
  and a frame that names a dictionary (refused).
"""

import os

import numpy as np
import pytest
import tensorstore as ts
import zstandard

from pixelpick_tpu_torch.engine import zstd

LEVELS = (1, 3, 9, 19)


def _payloads():
    rng = np.random.default_rng(0)
    return {
        "normal_f32": rng.standard_normal(5000).astype(np.float32).tobytes(),
        "zeros": bytes(20000),
        "arange": np.arange(30000, dtype=np.float32).tobytes(),
        "text": b"pixel-wise active learning; " * 900,
        "empty": b"",
        "big": np.concatenate([
            rng.standard_normal(64 * 1024).astype(np.float32),
            np.repeat(rng.standard_normal(256).astype(np.float32), 128),
        ]).tobytes(),
    }


PAYLOADS = _payloads()


def _tensorstore_frame(root, name, level, data):
    """The chunk tensorstore writes for ``data`` as a 1-D uint8 zarr v2
    array with the zstd compressor at ``level``."""
    path = os.path.join(root, f"{name}_{level}")
    arr = ts.open({"driver": "zarr", "kvstore": {"driver": "file",
                                                 "path": path},
                   "metadata": {"compressor": {"id": "zstd", "level": level},
                                "dtype": "|u1", "shape": [len(data)],
                                "chunks": [len(data)]}},
                  create=True).result()
    arr.write(np.frombuffer(data, np.uint8)).result()
    with open(os.path.join(path, "0"), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zstd"))
    out = {}
    for level in LEVELS:
        for name, data in PAYLOADS.items():
            out[level, name] = zstandard.ZstdCompressor(level=level) \
                .compress(data) if not data \
                else _tensorstore_frame(root, name, level, data)
    return out


@pytest.mark.parametrize("name", list(PAYLOADS))
@pytest.mark.parametrize("level", LEVELS)
def test_decodes_tensorstore_frames(frames, level, name):
    data = PAYLOADS[name]
    frame = frames[level, name]
    assert frame[:4] == b"\x28\xb5\x2f\xfd"
    assert zstd.decompress(frame) == data
    raw = zstd.compress_raw(data)
    assert zstd.decompress(raw) == data
    assert zstandard.ZstdDecompressor().decompress(
        raw, max_output_size=len(data) + 1) == data
    if name == "big":  # more than one block, both ways
        assert len(data) > 2 * zstd.BLOCK_MAX
        assert len(raw) > len(data) + 8


def test_checksum_skippable_and_several_frames():
    data = PAYLOADS["text"] + PAYLOADS["normal_f32"]
    with_sum = zstandard.ZstdCompressor(level=5, write_checksum=True) \
        .compress(data)
    assert with_sum[4] & 4  # the checksum flag
    assert zstd.decompress(with_sum) == data
    bad = with_sum[:-1] + bytes([with_sum[-1] ^ 1])
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bad)
    skippable = b"\x5a\x2a\x4d\x18" + (7).to_bytes(4, "little") + b"ignored"
    second = zstandard.ZstdCompressor(level=1).compress(PAYLOADS["arange"])
    assert zstd.decompress(with_sum + skippable + second) \
        == data + PAYLOADS["arange"]
    assert zstd.decompress_many([second, with_sum]) \
        == [PAYLOADS["arange"], data]


def test_xxh64_and_dictionary_refused():
    import xxhash

    for n in (0, 1, 7, 31, 32, 33, 100, 1000):
        data = os.urandom(n)
        assert zstd.xxh64(data) == xxhash.xxh64(data).intdigest()
    samples = [os.urandom(8) + b"common dictionary text %d" % i
               for i in range(200)]
    d = zstandard.train_dictionary(1024, samples)
    frame = zstandard.ZstdCompressor(dict_data=d).compress(samples[0])
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(frame)
