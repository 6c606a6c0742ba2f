"""The port's canvas path (vstar_tpu_torch/kernels/image_ops.py) against
vstar_tpu/kernels/image_ops.py on the CPU, in f32 on seeded numpy
images: every function, with windows that downscale (the antialiased
kernel), upscale, reach past the canvas's edge and carry a mask_bbox.
Outputs are CLIP-normalized (|x| <= 2.7); they agree within ATOL = 1e-4
(the two sides contract in other orders; measured <= 2e-5). Then JAX's
content-level check of the production path against host PIL
preprocessing (tests/test_batched_search.py), on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vstar_tpu.kernels import image_ops as jops
from vstar_tpu_torch.data.preprocess import (clip_preprocess, expand2square,
                                             owlvit_preprocess)
from vstar_tpu_torch.kernels import image_ops as tops
from vstar_tpu_torch.multimodal.constants import CLIP_MEAN, CLIP_STD
from vstar_tpu_torch.search.policy import PatchRef

ATOL = 1e-4


def _rand_img(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def canvas():
    """A 300x420 image's canvas, both sides: (port f32, JAX f32)."""
    img = Image.fromarray(_rand_img(300, 420, 0))
    c8, (h, w) = tops.u8_canvas(img)
    j8, jhw = jops.u8_canvas(img)
    np.testing.assert_array_equal(c8, j8)
    assert c8.shape == (512, 512, 3) and (h, w) == jhw == (300, 420)
    return (tops.normalize_canvas_device(torch.from_numpy(c8), h, w),
            jops.normalize_canvas_device(jnp.asarray(j8), h, w))


@pytest.mark.parametrize("out", [48, 200], ids=["down", "up"])
def test_device_preprocess(out):
    arr = _rand_img(96, 128, 1)
    _close(tops.device_preprocess(torch.from_numpy(arr), out),
           jops.device_preprocess(jnp.asarray(arr), out))


def test_device_preprocess_keeps_an_unchanged_axis():
    arr = _rand_img(48, 128, 2)
    _close(tops.device_preprocess(torch.from_numpy(arr), 48),
           jops.device_preprocess(jnp.asarray(arr), 48))


def test_expand2square_device():
    for h, w in ((60, 100), (100, 60), (50, 50)):
        arr = _rand_img(h, w, 3)
        got = tops.expand2square_device(torch.from_numpy(arr)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jops.expand2square_device(jnp.asarray(arr))))
        np.testing.assert_array_equal(
            got, np.asarray(expand2square(Image.fromarray(arr))[0]))


@pytest.mark.parametrize("bbox", [[30, 20, 64, 80], [-10, 5, 40, 30],
                                  [100, 70, 50, 60], [2, 3, 7, 5]],
                         ids=["inside", "left_edge", "bottom_edge", "up"])
def test_crop_resize_normalize(bbox):
    arr = _rand_img(120, 150, 4)
    _close(tops.crop_resize_normalize(torch.from_numpy(arr), bbox, 32),
           jops.crop_resize_normalize(jnp.asarray(arr),
                                      jnp.asarray(bbox, jnp.float32), 32))


def test_batched_crop_preprocess():
    arr = _rand_img(100, 100, 5)
    boxes = [[0, 0, 50, 50], [25, 25, 50, 50], [80, 80, 40, 10]]
    got = tops.batched_crop_preprocess(torch.from_numpy(arr), boxes, 24)
    _close(got, jops.batched_crop_preprocess(
        jnp.asarray(arr), jnp.asarray(boxes, jnp.float32), 24))
    assert not torch.allclose(got[0], got[1])


def test_normalize_canvas_device(canvas):
    got, want = canvas
    _close(got, want)
    assert bool((got[300:] == 0).all()) and bool((got[:, 420:] == 0).all())


@pytest.mark.parametrize("case", [
    ([37, 22, 180, 120], None),                     # downscale
    ([300, 200, 400, 400], [5, 5, 100, 50]),        # past the edge, masked
    ([10, 10, 20, 30], [12, 12, 10, 20]),           # upscale, masked
    ([-40, -30, 90, 90], [0, 0, 40, 50])],          # before the origin
    ids=["down", "edge_masked", "up_masked", "origin_masked"])
def test_window_resize(canvas, case):
    bbox, mask = case
    got, want = canvas
    _close(tops.window_resize(got, bbox, 64, mask_bbox=mask),
           jops.window_resize(want, jnp.asarray(bbox, jnp.float32), 64,
                              mask_bbox=None if mask is None else
                              jnp.asarray(mask, jnp.float32)))


def test_square_window_and_buckets():
    for bbox in ([37, 22, 180, 120], [5, 9, 31, 70], [0, 0, 8, 8]):
        assert tops.square_window(bbox) == jops.square_window(bbox)
    for hw in ((1, 1), (512, 513), (1536, 2048), (2049, 700)):
        assert tops.canvas_bucket_hw(*hw) == jops.canvas_bucket_hw(*hw)
    assert tops.CANVAS_BUCKET == jops.CANVAS_BUCKET


def test_pair_windows(canvas):
    got, want = canvas
    crops = [[37, 22, 180, 120], [0, 0, 420, 300], [400, 280, 20, 20]]
    sqs = [tops.square_window(c) for c in crops]
    clip, owl = tops.pair_windows(got, sqs, crops, 28, 48)
    jclip, jowl = jops.pair_windows(want, jnp.asarray(sqs, jnp.float32),
                                    jnp.asarray(crops, jnp.float32), 28, 48)
    _close(clip, jclip)
    _close(owl, jowl)


def test_normalize_u8_images():
    arr = _rand_img(7, 9, 6)
    got = tops.normalize_u8_images(torch.from_numpy(arr)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.normalize_u8_images(jnp.asarray(arr))))
    host = ((arr.astype(np.float32) / 255.0
             - np.asarray(CLIP_MEAN, np.float32))
            / np.asarray(CLIP_STD, np.float32))
    np.testing.assert_array_equal(got, host)


def test_canvas_windows_close_to_host_preprocessing():
    """The production path (uint8 canvas, normalize on the device, the
    paired windows with the crop mask) against host PIL crop,
    expand2square and resize: the same content within the resampler's
    tolerance (cubic a = -0.5 against PIL's bicubic; noise images are
    the worst case), JAX's bounds."""
    img = Image.fromarray(_rand_img(300, 420, 0))
    ref = PatchRef(img, [37, 22, 180, 120])
    c8, (h, w) = tops.u8_canvas(img)
    canvas = tops.normalize_canvas_device(torch.from_numpy(c8), h, w)
    clip, owl = tops.pair_windows(canvas, [tops.square_window(ref.bbox)],
                                  [ref.bbox], 28, 48)
    crop = ref.pil()
    clip_host = clip_preprocess(expand2square(crop)[0], 28)
    owl_host = owlvit_preprocess(crop, 48)
    clip_d = np.abs(clip[0].numpy() - clip_host)
    owl_d = np.abs(owl[0].numpy() - owl_host)
    assert clip_d.mean() < 0.04 and clip_d.max() < 0.6
    assert owl_d.mean() < 0.03 and owl_d.max() < 0.5
