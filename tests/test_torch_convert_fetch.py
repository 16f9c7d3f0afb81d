"""The convert CLI's ``--fetch`` in the port (``pixelpick_tpu_torch/models/
convert.py``; ``pixelpick_tpu/models/convert.py:176-211, 236-253``), with
``FETCH_URLS`` pointed at local ``file://`` URLs (no network is touched):

- ``--fetch mobilenet_v2`` downloads the file into
  ``~/.cache/pixelpick_tpu_torch`` under the URL's file name, infers
  ``--kind``, and writes the same bytes as converting the file by path;
- a second run uses the cached file and fetches nothing (its source is
  gone by then);
- a URL that cannot be fetched exits with the JAX package's message and
  leaves nothing behind: no output, no partial download.
"""

import os

import pytest
import torch

from pixelpick_tpu.models import convert as jax_convert
from pixelpick_tpu_torch.models import convert
from pixelpick_tpu_torch.models.deeplab import DeepLab
from pixelpick_tpu_torch.models.factory import init_model


@pytest.fixture
def mobilenet_file(tmp_path):
    """An ImageNet-layout MobileNetV2 file (``features.*``) at the file name
    the upstream URL has."""
    model = init_model(DeepLab(11, width_mult=0.5), 1)
    state = {k[len("backbone."):]: v for k, v in model.state_dict().items()
             if k.startswith("backbone.")}
    name = convert.FETCH_URLS["mobilenet_v2"].rsplit("/", 1)[-1]
    path = tmp_path / "upstream" / name
    path.parent.mkdir()
    torch.save(state, path)
    return path


def test_fetch_caches_and_converts(tmp_path, monkeypatch, capsys,
                                   mobilenet_file):
    assert convert.FETCH_URLS == jax_convert.FETCH_URLS
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setitem(convert.FETCH_URLS, "mobilenet_v2",
                        mobilenet_file.as_uri())
    fetched = str(tmp_path / "fetched.ckpt")
    convert.main(["--fetch", "mobilenet_v2", fetched])
    cache = tmp_path / "home" / ".cache" / "pixelpick_tpu_torch"
    assert os.listdir(cache) == [mobilenet_file.name]
    assert "fetching" in capsys.readouterr().out

    by_path = str(tmp_path / "by_path.ckpt")
    convert.main([str(mobilenet_file), by_path, "--kind", "mobilenet_v2"])
    with open(fetched, "rb") as a, open(by_path, "rb") as b:
        assert a.read() == b.read()

    os.remove(mobilenet_file)  # the second run must not need the source
    again = str(tmp_path / "again.ckpt")
    convert.main(["--fetch", "mobilenet_v2", again])
    assert "using cached" in capsys.readouterr().out
    with open(again, "rb") as a, open(by_path, "rb") as b:
        assert a.read() == b.read()


def test_fetch_fails_cleanly(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    missing = (tmp_path / "nowhere" / "resnet18-5c106cde.pth").as_uri()
    monkeypatch.setitem(convert.FETCH_URLS, "resnet18", missing)
    dst = tmp_path / "out.ckpt"
    with pytest.raises(SystemExit, match="(?s)could not fetch .*no egress"):
        convert.main(["--fetch", "resnet18", str(dst)])
    assert not dst.exists()
    cache = tmp_path / "home" / ".cache" / "pixelpick_tpu_torch"
    assert not cache.exists() or os.listdir(cache) == []
    with pytest.raises(SystemExit):  # neither SRC nor --fetch
        convert.main([str(dst)])
