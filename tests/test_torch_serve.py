"""The port's serving entry points on the CPU: ``data.image.imdecode``,
``python -m odtpu_torch.serve`` (the counterpart of ``tools/serve.py``)
and ``python -m odtpu_torch.infer --quant int8``, at full width
(SSD300-VGG16, seeded weights, float32 off the card, batch 1).

Held exactly: every ``/detect`` response equals ``build_engine``'s
``infer`` called directly on the same decoded bytes (the same weights,
the same batch-1 call, the same rounding); ``imdecode`` equals
``cv2.imdecode``. ``build_engine`` on the flagship checkpoint in float32
is held to ``tools/serve.py``'s: the same detections, their scores
within 1e-4 and their boxes within 0.1 px, one unit of each rounding
(measured: equal).
"""

import importlib.util
import io
import json
import os.path as osp
import sys
import threading
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from odtpu_torch import infer as infer_cli
from odtpu_torch import serve
from odtpu_torch.data import image
from odtpu_torch.ops import quant
from odtpu_torch.utils.config import load_cfg

import torch_family_parity as fp
from test_torch_model import FLAGSHIP

torch.set_num_threads(2)


def _ppm_bytes(img):
    buf = io.BytesIO()
    h, w, _ = img.shape
    buf.write(b"P6\n%d %d\n255\n" % (w, h))
    buf.write(np.ascontiguousarray(img[:, :, ::-1]).tobytes())
    return buf.getvalue()


def _image(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3),
                                               dtype=np.uint8)


def test_imdecode_ppm_garbage_and_empty(monkeypatch):
    img = _image(37, 53, 1)
    data = _ppm_bytes(img)
    np.testing.assert_array_equal(image.imdecode(data), img)
    np.testing.assert_array_equal(
        image.imdecode(data),
        cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    ok, png = cv2.imencode(".png", img)
    np.testing.assert_array_equal(image.imdecode(png.tobytes()), img)
    garbage = np.random.RandomState(2).bytes(300)
    assert image.imdecode(garbage) is None
    assert image.imdecode(data[:40]) is None  # a short PPM
    assert image.imdecode(b"") is None
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 fails
    np.testing.assert_array_equal(image.imdecode(data), img)
    assert image.imdecode(garbage) is None
    with pytest.raises(ImportError, match="PNG"):
        image.imdecode(png.tobytes())


@pytest.fixture(scope="module", params=["", "int8"])
def server(request):
    """A server of seeded SSD300 in a thread on a free port, in float32
    or in int8 convs, its engine beside it."""
    engine, names = serve.build_engine(load_cfg("ssd_vgg16_voc"),
                                       quant=request.param, device="cpu")
    srv = serve.make_server(engine, host="127.0.0.1", port=0, conf=0.02)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield {"engine": engine, "names": names, "quant": request.param,
           "url": "http://127.0.0.1:{}".format(srv.server_address[1])}
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)


def _request(url, data=None):
    """(status, decoded JSON) of a GET, or a POST of ``data``."""
    req = urllib.request.Request(url, data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_answers_as_infer_does(server, monkeypatch):
    url = server["url"]
    assert _request(url + "/healthz") == (200, {"ok": True})
    img = _image(375, 500, 3)
    calls = quant.INT_MM_CALLS
    status, body = _request(url + "/detect", _ppm_bytes(img))
    assert status == 200 and body["latency_ms"] > 0
    assert (quant.INT_MM_CALLS > calls) == (server["quant"] == "int8")
    dets = body["detections"]
    assert dets and dets == server["engine"](img, 0.02)
    assert all(d["score"] >= 0.02 and d["class"] in server["names"]
               for d in dets)
    assert all(len(d["box"]) == 4 and np.isfinite(d["box"]).all()
               for d in dets)

    assert _request(url + "/nothing")[0] == 404
    assert _request(url + "/other", b"x")[0] == 404
    assert _request(url + "/detect", b"") == (
        400, {"error": "bad content length"})
    assert _request(url + "/detect", b"not an image") == (
        400, {"error": "undecodable image"})
    ok, jpg = cv2.imencode(".jpg", img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    status, body = _request(url + "/detect", jpg.tobytes())
    assert status == 400 and "JPEG" in body["error"]


def test_infer_command_line_in_int8(capsys):
    infer_cli.main(["--batch", "1", "--batches", "1", "--quant", "int8",
                    "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["quant"] == "int8" and line["rows_shape"] == [1, 200, 6]
    assert line["device"] == "cpu" and line["images_per_s"] > 0
    assert "max_memory_allocated" in line


def _tools_serve():
    """``tools/serve.py``, the JAX package's server, as a module."""
    spec = importlib.util.spec_from_file_location(
        "odtpu_tools_serve",
        osp.join(osp.dirname(__file__), "..", "tools", "serve.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_engine_answers_as_tools_serve_does():
    """The flagship checkpoint served in float32 (the compute dtype of
    both off their accelerator) by this package's ``build_engine`` and by
    ``tools/serve.py``'s, on VOC-sized images of both orientations: the
    same detections in the same order (class, class_id), scores within
    1e-4 and pixel boxes within 0.1 px, one unit of each rounding.

    int8 is not held to ``tools/serve.py``: under its jit XLA turns
    odtpu's ``s_x / 127`` into a product by 1/127, which moves some
    scales by an ulp and whole layers' integers with them (measured on
    two such images: scores up to 0.009 apart, a box edge 25 px, two
    near-tied rows swapped), and its int8 convs take ~17 s an image
    here. The port's int8 forward is held to odtpu's eager int8 apply in
    tests/test_torch_quant.py; the code around the forward is the same
    in both modes."""
    want_infer, want_names = _tools_serve().build_engine("", FLAGSHIP)
    got_infer, got_names = serve.build_engine(
        load_cfg("ssd_vgg16_voc"), FLAGSHIP, device="cpu")
    assert got_names == want_names
    for size, seed in (((375, 500), 0), ((500, 375), 1)):
        img = fp.synth_image(size, seed)[0]
        want, got = want_infer(img, 0.1), got_infer(img, 0.1)
        assert len(want) >= 5 and len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            assert (g["class"], g["class_id"]) == (w["class"],
                                                   w["class_id"]), (g, w)
            assert abs(g["score"] - w["score"]) <= 1e-4 + 1e-9, (g, w)
            np.testing.assert_allclose(g["box"], w["box"], rtol=0,
                                       atol=0.1 + 1e-6)
