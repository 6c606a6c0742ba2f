"""The port's `--random-init` presets and the device they may run on.

'tiny' is an f32 CPU smoke at head_dim 16; the CUDA attention kernels take
bf16 at head_dim 128, and no wrapper falls back to its plain version on a
CUDA tensor. So `random_init_engines` refuses 'tiny' on a CUDA device,
before anything is allocated there, and the server reports that when it
parses its arguments. These run on the CPU: the refusal needs no card.
"""

import sys

import pytest
import torch

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
