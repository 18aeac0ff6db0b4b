"""The image transforms (bigdl_tpu_torch/dataset/image.py) and the vision
pipeline (dataset/vision.py) against the JAX package's, on seeded
synthetic images: every transformer's output equals the JAX package's
bit for bit (both are numpy with the same seeded draws in the same
order; `Resize` runs both packages' C++ planes when they build, and
their numpy paths otherwise). Then an ImageFrame through a transformer
chain and `ImageFrameToSample` trains LeNet-5 for 2 Optimizer steps in
both packages (fp32, losses within 1e-5 relative).
"""

import contextlib
import unittest.mock as mock

import jax
import numpy as np
import pytest

from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset import native as jnative
from bigdl_tpu.dataset import vision as jvision
from bigdl_tpu_torch.dataset import image as timage
from bigdl_tpu_torch.dataset import native as tnative
from bigdl_tpu_torch.dataset import vision as tvision

LOSS_RTOL = 1e-5


def _images(n=6, h=20, w=24, c=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, h, w, c) * 255).astype(np.float32), \
        rng.randint(0, 10, n).astype(np.int32)


def _samples(mod, images, labels):
    from bigdl_tpu.dataset import Sample as JSample
    from bigdl_tpu_torch.dataset import Sample as TSample

    cls = JSample if mod is jimage else TSample
    return [cls(x.copy(), int(y)) for x, y in zip(images, labels)]


IMAGE_CASES = {
    "grey_normalizer": lambda m: m.GreyImgNormalizer(100.0, 50.0),
    "bgr_normalizer": lambda m: m.BGRImgNormalizer([100.0, 110.0, 120.0],
                                                   [50.0, 60.0, 70.0]),
    "hflip": lambda m: m.HFlip(0.5, seed=3),
    "center_crop": lambda m: m.CenterCrop(12, 16),
    "random_crop": lambda m: m.RandomCrop(16, 16, padding=2, seed=4),
    "random_resized_crop": lambda m: m.RandomResizedCrop(14, seed=5),
    "color_jitter": lambda m: m.ColorJitter(0.4, 0.4, 0.4, seed=6),
    "lighting": lambda m: m.Lighting(0.1, seed=7),
    "chain": lambda m: (m.RandomCrop(16, 16, padding=2, seed=1)
                        >> m.HFlip(seed=2)
                        >> m.BGRImgNormalizer([1.0, 2.0, 3.0],
                                              [4.0, 5.0, 6.0])),
}


@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
def test_image_transformer_bitwise(case):
    images, labels = _images()
    if case == "grey_normalizer":
        images = images[..., :1]
    outs = {}
    for mod in (jimage, timage):
        t = IMAGE_CASES[case](mod)
        outs[mod] = list(t(iter(_samples(mod, images, labels))))
    assert len(outs[jimage]) == len(outs[timage]) == len(images)
    for a, b in zip(outs[jimage], outs[timage]):
        np.testing.assert_array_equal(b.feature, a.feature)
        np.testing.assert_array_equal(b.label, a.label)
        assert b.feature.dtype == a.feature.dtype


def _features(mod, images, labels):
    return [mod.ImageFeature(x.copy(), label=int(y), uri=f"img{i}")
            for i, (x, y) in enumerate(zip(images, labels))]


VISION_CASES = {
    "resize": lambda m: m.Resize(15, 17),
    "aspect_scale": lambda m: m.AspectScale(12, 30),
    "center_crop": lambda m: m.CenterCrop(10, 12),
    "random_crop": lambda m: m.RandomCrop(10, 12, seed=3),
    "hflip": lambda m: m.HFlip(),
    "random_transformer": lambda m: m.RandomTransformer(m.HFlip(), 0.5,
                                                        seed=4),
    "brightness": lambda m: m.Brightness(-20.0, 20.0, seed=5),
    "contrast": lambda m: m.Contrast(0.5, 1.5, seed=6),
    "saturation": lambda m: m.Saturation(0.5, 1.5, seed=7),
    "channel_normalize": lambda m: m.ChannelNormalize([100.0, 110.0, 120.0],
                                                      [50.0, 60.0, 70.0]),
    "pixel_normalizer": lambda m: m.PixelNormalizer(
        np.full((20, 24, 3), 7.5, np.float32)),
    "mat_to_tensor": lambda m: m.MatToTensor(to_chw=True),
    "chain": lambda m: (m.Resize(18, 18) >> m.RandomCrop(16, 16, seed=1)
                        >> m.RandomTransformer(m.HFlip(), 0.5, seed=2)
                        >> m.Brightness(-5.0, 5.0, seed=3)
                        >> m.ChannelNormalize([1.0, 2.0, 3.0],
                                              [4.0, 5.0, 6.0])),
}


# the geometric cases run twice: on both packages' C++ planes and, with
# both masked, on their numpy paths
VISION_RUNS = [(c, False) for c in sorted(VISION_CASES)] + [
    (c, True) for c in ("aspect_scale", "chain", "resize")]


@pytest.mark.parametrize("case, numpy_path", VISION_RUNS,
                         ids=[f"{c}-{'numpy' if p else 'plane'}"
                              for c, p in VISION_RUNS])
def test_vision_transformer_bitwise(case, numpy_path):
    images, labels = _images()
    frames = {}
    with contextlib.ExitStack() as stack:
        if numpy_path:
            for nat in (jnative, tnative):
                stack.enter_context(mock.patch.object(nat, "_load",
                                                      return_value=None))
        for mod in (jvision, tvision):
            frame = mod.ImageFrame(_features(mod, images, labels))
            frames[mod] = frame.transform(VISION_CASES[case](mod))
    assert len(frames[jvision]) == len(frames[tvision]) == len(images)
    for a, b in zip(frames[jvision], frames[tvision]):
        assert a.is_valid and b.is_valid
        np.testing.assert_array_equal(b.image, a.image)
        assert b.image.dtype == a.image.dtype
        assert b.get("label") == a.get("label") and b["uri"] == a["uri"]


def test_invalid_feature_is_isolated_as_in_jax():
    images, labels = _images(n=3)
    out = {}
    for mod in (jvision, tvision):
        feats = _features(mod, images, labels)
        feats[1][mod.ImageFeature.IMAGE] = np.zeros((4, 4, 3), np.float32)
        frame = mod.ImageFrame(feats).transform(mod.CenterCrop(10, 12))
        out[mod] = [f.is_valid for f in frame]
        samples = mod.ImageFrame(feats).transform(
            mod.CenterCrop(10, 12)).to_samples()
        assert len(samples) == 2
    assert out[jvision] == out[tvision] == [True, False, True]


def test_image_frame_to_sample_trains_lenet_as_jax():
    from bigdl_tpu import nn as jnn
    from bigdl_tpu import optim as jopt
    from bigdl_tpu.dataset import DataSet as JDataSet
    from bigdl_tpu.models import lenet as jlenet
    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch import optim as topt
    from bigdl_tpu_torch.dataset import DataSet as TDataSet
    from bigdl_tpu_torch.models import lenet as tlenet
    from bigdl_tpu_torch.models.convert import variables_from_jax

    rng = np.random.RandomState(3)
    images = (rng.rand(16, 32, 32, 1) * 255).astype(np.float32)
    labels = rng.randint(0, 10, 16).astype(np.int32)
    jm = jlenet.build(10)
    jm.build(jax.random.PRNGKey(0))
    tm = tlenet.build(10)
    tm.variables = variables_from_jax(jm.variables, device="cpu")
    losses = {}
    for mod, nn, opt, ds, m in ((jvision, jnn, jopt, JDataSet, jm),
                                (tvision, tnn, topt, TDataSet, tm)):
        chain = (mod.RandomCrop(28, 28, seed=1)
                 >> mod.RandomTransformer(mod.HFlip(), 0.5, seed=2)
                 >> mod.ChannelNormalize([127.5], [127.5]))
        frame = mod.ImageFrame(_features(mod, images, labels))
        samples = list(mod.ImageFrameToSample()(iter(frame.transform(chain))))
        assert len(samples) == 16 and samples[0].feature.shape == (28, 28, 1)
        seen = []

        def end_when(state, seen=seen):
            if state["loss"] is not None:
                seen.append(float(state["loss"]))
            return state["neval"] >= 2

        opt.Optimizer(m, ds.array(samples), nn.ClassNLLCriterion(),
                      batch_size=8).set_optim_method(opt.SGD(0.05)) \
            .set_end_when(opt.Trigger(end_when)).optimize()
        losses[mod] = seen
    assert len(losses[tvision]) == 2
    np.testing.assert_allclose(losses[tvision], losses[jvision],
                               rtol=LOSS_RTOL)
    assert all(np.isfinite(losses[tvision]))


def test_dataset_exports_equal_jax_but_spark_adapter():
    import bigdl_tpu.dataset as jd
    import bigdl_tpu_torch.dataset as td

    jnames = {n for n in dir(jd) if not n.startswith("_")}
    tnames = {n for n in dir(td) if not n.startswith("_")}
    assert jnames <= tnames, sorted(jnames - tnames)
