"""The port's server: its `--random-init` presets and the device they may
run on, and the free-form flow.

'tiny' is an f32 CPU smoke at head_dim 16; the CUDA attention kernels take
bf16 at head_dim 128, and no wrapper falls back to its plain version on a
CUDA tensor. So `random_init_engines` refuses 'tiny' on a CUDA device,
before anything is allocated there, and the server reports that when it
parses its arguments. These run on the CPU: the refusal needs no card.

A request without options runs the free-form flow (answer, search,
focused re-answer): with tests/test_serve.py's stub engines its record is
the JAX SealService's, directly and over HTTP.
"""

import base64
import io
import json
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from vstar_tpu.serve.server import SealService as JaxSealService
from vstar_tpu_torch.serve import server


@pytest.mark.parametrize("device", ["cuda", "cuda:0", torch.device("cuda")])
def test_tiny_refused_on_cuda_before_touching_the_device(device):
    was_initialized = torch.cuda.is_initialized()
    with pytest.raises(ValueError, match="--device cpu") as err:
        server.random_init_engines("tiny", device)
    assert "head_dim 128" in str(err.value) and "'7b'" in str(err.value)
    assert torch.cuda.is_initialized() == was_initialized


def test_tiny_still_builds_on_cpu():
    vqa, vsm = server.random_init_engines("tiny", "cpu")
    assert vqa.cfg.llama.head_dim == 16

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            yield tree
        elif isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                yield from leaves(v)

    for engine in (vqa, vsm):
        tensors = list(leaves(engine.params))
        assert tensors and all(t.device.type == "cpu" for t in tensors)
        assert {t.dtype for t in tensors if t.is_floating_point()} \
            == {torch.float32}


def test_server_main_reports_tiny_on_cuda(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["server", "--random-init", "tiny"])
    monkeypatch.setattr(server, "serve", lambda *a, **k: pytest.fail(
        "served a preset the card cannot run"))
    with pytest.raises(SystemExit) as exc:
        server.main()
    assert exc.value.code == 2
    assert "--device cpu" in capsys.readouterr().err


class StubVQA:
    """tests/test_serve.py's stub: asks for a tiny cup, then answers."""

    def free_form(self, image, question, **kw):
        if "focus" in question or "Additional visual" in question:
            return "it is red"
        return ("Sorry, I can not answer the question. Some visual "
                "information about the following objects is missing or "
                "unclear: tiny cup.")

    def multiple_choice(self, image, question, options, object_crops=None,
                        **kw):
        return 1

    def get_object_crop(self, image, bbox, patch_scale):
        return np.zeros((28, 28, 3), np.float32)


class StubVSM:
    def detect(self, patch, name):
        boxes = np.zeros((4, 4), np.float32)
        boxes[0] = [0.5, 0.5, 0.25, 0.25]
        return boxes, np.asarray([0.9, 0, 0, 0], np.float32), \
            np.ones((patch.height, patch.width), np.float32)

    def vqa(self, patch, q):
        return "most likely to appear on the table."

    def segment(self, patch, phrase):
        return np.ones((patch.height, patch.width), np.float32)


class FailingVSM(StubVSM):
    """Never confident: the search fails and keeps its fallback box."""

    def detect(self, patch, name):
        boxes, _, heat = super().detect(patch, name)
        return boxes, np.asarray([0.2, 0, 0, 0], np.float32), heat


def _without_latency(rec):
    return {k: v for k, v in rec.items() if k != "latency_s"}


@pytest.mark.parametrize("vsm", [StubVSM, FailingVSM],
                         ids=["found", "failed"])
def test_free_form_flow_gives_the_jax_record(vsm):
    img = Image.fromarray(np.zeros((80, 120, 3), np.uint8))
    want = JaxSealService(StubVQA(), vsm(), minimum_size=224).answer(
        img, "what color is the tiny cup?")
    got = server.SealService(StubVQA(), vsm(), minimum_size=224).answer(
        img, "what color is the tiny cup?")
    assert _without_latency(got) == _without_latency(want)
    assert set(got) == {"freeform", "answer", "missing_objects",
                        "failed_objects", "search_result", "latency_s"}
    assert got["missing_objects"] == ["tiny cup"]
    assert len(got["search_result"]) == 1
    assert got["failed_objects"] == ([] if vsm is StubVSM else ["tiny cup"])


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/answer",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize("engines", ["stubs", "tiny"])
def test_http_request_without_options_answers_200(engines):
    """Over HTTP with the stubs (JAX's record) and with the tiny random
    engines on the CPU (the record's keys)."""
    if engines == "stubs":
        svc = server.SealService(StubVQA(), StubVSM())
    else:
        svc = server.SealService(*server.random_init_engines("tiny", "cpu"))
    img = Image.fromarray((np.random.RandomState(0).rand(64, 96, 3)
                           * 255).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    httpd = server.make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        status, rec = _post(httpd.server_address[1], {
            "image": base64.b64encode(buf.getvalue()).decode(),
            "question": "what color is the tiny cup?"})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert status == 200, rec
    assert {"freeform", "answer", "missing_objects", "failed_objects",
            "search_result", "latency_s"} <= set(rec)
    if engines == "stubs":
        want = JaxSealService(StubVQA(), StubVSM()).answer(
            Image.open(io.BytesIO(buf.getvalue())).convert("RGB"),
            "what color is the tiny cup?")
        assert _without_latency(rec) == _without_latency(want)


def test_server_main_compiled_serves_a_compiled_vsm(monkeypatch):
    """--compiled builds a device-preprocess VSM engine and serves it
    wrapped in CompiledVSMSearch."""
    from vstar_tpu_torch.search.compiled import CompiledVSMSearch
    served = []
    monkeypatch.setattr(sys, "argv", ["server", "--random-init", "tiny",
                                      "--device", "cpu", "--compiled"])
    monkeypatch.setattr(server, "serve",
                        lambda service, *a, **k: served.append(service))
    server.main()
    vsm = served[0].vsm
    assert isinstance(vsm, CompiledVSMSearch)
    assert vsm.engine.device_preprocess
