"""Vision image pipeline — ImageFrame / ImageFeature.

Ports bigdl_tpu/dataset/vision.py, a numpy-only module, line for line
over the port's `Sample` and `Transformer` (the same `RandomState` draws
in the same order, so outputs equal the JAX package's bit for bit);
`_bilinear_resize` runs the port's C++ plane (dataset/native.py) when it
builds, as the JAX package runs its own.

Reference parity: transform/vision/image/ — `ImageFrame` (collection
abstraction over images), `ImageFeature` (per-image dict of image +
metadata + label), `FeatureTransformer` (per-image transform with error
isolation), and the OpenCV-backed augmentation set (`Resize`,
`CenterCrop`, `RandomCrop`, `HFlip`/`RandomTransformer`, `Brightness`,
`Contrast`, `Saturation`, `ChannelNormalize`, `MatToTensor`,
`ImageFrameToSample`).

Host-side redesign: images are numpy `float32` HWC arrays on the host
(no OpenCV `Mat` — numpy *is* the host tensor type here), transforms are
pure per-feature functions lifted over iterators, and the terminal
`ImageFrameToSample` hands off to the same `Sample`/`MiniBatch` batcher
the rest of the data plane uses, so device transfer happens once per
batch, in the training loop.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer


class ImageFeature(dict):
    """Per-image record (reference: transform/vision/image/ImageFeature.scala).

    Keys mirror the reference's conventions: ``image`` (HWC float32),
    ``bytes`` (raw encoded/packed bytes), ``label``, ``uri``,
    ``original_size``, ``is_valid``.
    """

    IMAGE = "image"
    BYTES = "bytes"
    LABEL = "label"
    URI = "uri"
    ORIGINAL_SIZE = "original_size"
    VALID = "is_valid"

    def __init__(self, image=None, label=None, uri: Optional[str] = None,
                 **kw):
        super().__init__(**kw)
        if image is not None:
            img = np.asarray(image)
            self[self.IMAGE] = img
            self[self.ORIGINAL_SIZE] = img.shape
        if label is not None:
            self[self.LABEL] = label
        if uri is not None:
            self[self.URI] = uri
        self.setdefault(self.VALID, True)

    @property
    def image(self) -> np.ndarray:
        return self[self.IMAGE]

    @property
    def is_valid(self) -> bool:
        return bool(self.get(self.VALID, False))

    def get_size(self):
        """(height, width, channels) of the current image."""
        return self[self.IMAGE].shape

    def to_sample(self) -> Sample:
        return Sample(self[self.IMAGE], self.get(self.LABEL))


class FeatureTransformer(Transformer):
    """Per-image transform with error isolation
    (reference: vision/image/FeatureTransformer.scala — a failing
    transform marks the feature invalid instead of killing the job).

    Subclasses override ``transform_image`` (ndarray → ndarray) or, for
    transforms touching metadata, ``transform_feature``.
    """

    def transform_image(self, img: np.ndarray) -> np.ndarray:
        return img

    def transform_feature(self, feature: ImageFeature) -> ImageFeature:
        feature[ImageFeature.IMAGE] = self.transform_image(feature.image)
        return feature

    def apply(self, it: Iterator) -> Iterator:
        for feature in it:
            try:
                yield self.transform_feature(feature)
            except Exception as e:
                # isolate the bad feature but leave a trail — a systematic
                # misconfiguration would otherwise silently empty the set
                # (reference: FeatureTransformer logs on invalidation)
                feature[ImageFeature.VALID] = False
                feature["error"] = f"{type(self).__name__}: {e}"
                logging.getLogger(__name__).warning(
                    "%s failed on feature %s: %s", type(self).__name__,
                    feature.get(ImageFeature.URI, "<in-memory>"), e)
                yield feature

    # `a -> b` composition of the reference keeps working via `>>`
    # (inherited from Transformer).


# ------------------------------------------------------------- geometric

def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize, align_corners=False convention — native (C++)
    when the dataplane is available (12x the numpy path per core),
    numpy otherwise; both produce identical values."""
    h, w = img.shape[:2]
    if img.ndim == 2:
        img = img[:, :, None]
    if (h, w) == (out_h, out_w):
        return img.astype(np.float32, copy=False)
    from bigdl_tpu_torch.dataset import native as _native

    fast = _native.resize_bilinear(img, out_h, out_w)
    if fast is not None:
        return fast
    ys = (np.arange(out_h, dtype=np.float32) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w, dtype=np.float32) + 0.5) * (w / out_w) - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    img = img.astype(np.float32, copy=False)
    row0, row1 = img[y0], img[y1]
    top = row0[:, x0] * (1 - wx) + row0[:, x1] * wx
    bot = row1[:, x0] * (1 - wx) + row1[:, x1] * wx
    return top * (1 - wy) + bot * wy


class Resize(FeatureTransformer):
    """(reference: vision/image/augmentation/Resize.scala)"""

    def __init__(self, resize_h: int, resize_w: int):
        self.h, self.w = resize_h, resize_w

    def transform_image(self, img):
        return _bilinear_resize(img, self.h, self.w)


class AspectScale(FeatureTransformer):
    """Scale the short side to `min_size`, cap the long side
    (reference: vision/image/augmentation/AspectScale.scala)."""

    def __init__(self, min_size: int, max_size: int = 1000):
        self.min_size, self.max_size = min_size, max_size

    def transform_image(self, img):
        h, w = img.shape[:2]
        short, long = min(h, w), max(h, w)
        scale = min(self.min_size / short, self.max_size / long)
        return _bilinear_resize(img, int(round(h * scale)),
                                int(round(w * scale)))


class CenterCrop(FeatureTransformer):
    """(reference: vision/image/augmentation/CenterCrop.scala)"""

    def __init__(self, crop_h: int, crop_w: int):
        self.h, self.w = crop_h, crop_w

    def transform_image(self, img):
        h, w = img.shape[:2]
        if h < self.h or w < self.w:
            raise ValueError(
                f"CenterCrop({self.h}, {self.w}): image {h}x{w} is smaller "
                f"than the crop — Resize/AspectScale first")
        y = (h - self.h) // 2
        x = (w - self.w) // 2
        return img[y:y + self.h, x:x + self.w]


class RandomCrop(FeatureTransformer):
    """(reference: vision/image/augmentation/RandomCrop.scala)"""

    def __init__(self, crop_h: int, crop_w: int, seed: Optional[int] = None):
        self.h, self.w = crop_h, crop_w
        self.rng = np.random.default_rng(seed)

    def transform_image(self, img):
        h, w = img.shape[:2]
        if h < self.h or w < self.w:
            raise ValueError(
                f"RandomCrop({self.h}, {self.w}): image {h}x{w} is smaller "
                f"than the crop — Resize/AspectScale first")
        y = int(self.rng.integers(0, h - self.h + 1))
        x = int(self.rng.integers(0, w - self.w + 1))
        return img[y:y + self.h, x:x + self.w]


class HFlip(FeatureTransformer):
    """(reference: vision/image/augmentation/HFlip.scala)"""

    def transform_image(self, img):
        return img[:, ::-1]


class RandomTransformer(FeatureTransformer):
    """Apply `inner` with probability p
    (reference: vision/image/augmentation/RandomTransformer.scala)."""

    def __init__(self, inner: FeatureTransformer, prob: float,
                 seed: Optional[int] = None):
        self.inner, self.prob = inner, prob
        self.rng = np.random.default_rng(seed)

    def transform_feature(self, feature):
        if self.rng.random() < self.prob:
            return self.inner.transform_feature(feature)
        return feature


# ------------------------------------------------------------ photometric

class Brightness(FeatureTransformer):
    """Add a uniform delta (reference: augmentation/Brightness.scala)."""

    def __init__(self, delta_low: float, delta_high: float,
                 seed: Optional[int] = None):
        self.low, self.high = delta_low, delta_high
        self.rng = np.random.default_rng(seed)

    def transform_image(self, img):
        return img + np.float32(self.rng.uniform(self.low, self.high))


class Contrast(FeatureTransformer):
    """Scale around zero (reference: augmentation/Contrast.scala)."""

    def __init__(self, delta_low: float, delta_high: float,
                 seed: Optional[int] = None):
        self.low, self.high = delta_low, delta_high
        self.rng = np.random.default_rng(seed)

    def transform_image(self, img):
        return img * np.float32(self.rng.uniform(self.low, self.high))


class Saturation(FeatureTransformer):
    """Blend with per-pixel grey (reference: augmentation/Saturation.scala)."""

    def __init__(self, delta_low: float, delta_high: float,
                 seed: Optional[int] = None):
        self.low, self.high = delta_low, delta_high
        self.rng = np.random.default_rng(seed)

    def transform_image(self, img):
        alpha = np.float32(self.rng.uniform(self.low, self.high))
        grey = img.mean(axis=2, keepdims=True)
        return grey + alpha * (img - grey)


class ChannelNormalize(FeatureTransformer):
    """(reference: augmentation/ChannelNormalize.scala)"""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def transform_image(self, img):
        return (img - self.mean) / self.std


class PixelNormalizer(FeatureTransformer):
    """Subtract a full per-pixel mean image
    (reference: augmentation/PixelNormalizer.scala)."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def transform_image(self, img):
        return img - self.means.reshape(img.shape)


class MatToTensor(FeatureTransformer):
    """Finalize dtype/layout (reference: vision/image/MatToTensor.scala —
    there it converts OpenCV Mat → Tensor; here it pins float32 HWC,
    optionally transposing to CHW for torch-convention consumers)."""

    def __init__(self, to_chw: bool = False):
        self.to_chw = to_chw

    def transform_image(self, img):
        img = np.ascontiguousarray(img, np.float32)
        return img.transpose(2, 0, 1) if self.to_chw else img


class ImageFrameToSample(Transformer):
    """Terminal stage: ImageFeature → Sample, dropping invalid features
    (reference: vision/image/ImageFrameToSample.scala)."""

    def apply(self, it: Iterator) -> Iterator:
        for feature in it:
            if feature.is_valid:
                yield feature.to_sample()


# -------------------------------------------------------------- ImageFrame

class ImageFrame:
    """Collection of ImageFeatures
    (reference: transform/vision/image/ImageFrame.scala).

    `LocalImageFrame` holds a list; the distributed variant of the
    reference (RDD-backed) maps to per-host sharded loading in this
    framework (dataset/dataset.py DistributedDataSet) — an ImageFrame is
    always process-local, the mesh dimension lives in the DataSet layer.
    """

    def __init__(self, features: List[ImageFeature]):
        self.features = list(features)

    # reference: ImageFrame.read(path, ...)
    @staticmethod
    def read(path: str, with_label: bool = False) -> "ImageFrame":
        """Read `.npy` images (and `<name>.label` ints) from a directory.

        The reference reads JPEGs via OpenCV; this image has no JPEG
        codec, so the on-disk interchange format is npy (the native data
        plane covers IDX/CIFAR binary formats)."""
        feats = []
        for fname in sorted(os.listdir(path)):
            if not fname.endswith(".npy"):
                continue
            img = np.load(os.path.join(path, fname)).astype(np.float32)
            label = None
            lpath = os.path.join(path, fname[:-4] + ".label")
            if with_label and os.path.exists(lpath):
                with open(lpath) as f:
                    label = int(f.read().strip())
            feats.append(ImageFeature(img, label=label, uri=fname))
        return ImageFrame(feats)

    @staticmethod
    def from_arrays(images: np.ndarray,
                    labels: Optional[np.ndarray] = None) -> "ImageFrame":
        feats = [ImageFeature(images[i],
                              label=None if labels is None else labels[i])
                 for i in range(len(images))]
        return ImageFrame(feats)

    def transform(self, transformer: Transformer) -> "ImageFrame":
        """Apply a (chain of) FeatureTransformer(s), materialized
        (reference: ImageFrame.transform)."""
        out = list(transformer(iter(self.features)))
        return ImageFrame(out)

    # reference alias: frame -> transformer
    __rshift__ = transform

    def to_samples(self) -> List[Sample]:
        return [f.to_sample() for f in self.features if f.is_valid]

    def __len__(self):
        return len(self.features)

    def __iter__(self):
        return iter(self.features)
