"""Image pipeline transforms.

Ports bigdl_tpu/dataset/image.py, a numpy-only module, line for line
over the port's `Sample` and `Transformer`: every `RandomState` draw is
made in the same order, so each transform's output equals the JAX
package's bit for bit (reference parity: dataset/image/ — `BytesToGreyImg`, `GreyImgNormalizer`,
`GreyImgToSample`, `BGRImgNormalizer`, `BGRImgCropper`, `HFlip`,
`ColorJitter`, `Lighting`, `BGRImgRdmCropper`, `BGRImgToSample`.

All transforms operate on `Sample`s whose feature is an HWC float numpy
array (Host-side: channels-last throughout; the reference is HWC on the
wire and CHW at the tensor layer).
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer


class GreyImgNormalizer(Transformer):
    """(x - mean) / std on single-channel images
    (reference: dataset/image/GreyImgNormalizer.scala)."""

    def __init__(self, mean: float, std: float):
        self.mean, self.std = float(mean), float(std)

    def apply(self, it):
        for s in it:
            yield Sample((s.feature - self.mean) / self.std, s.label)


class BGRImgNormalizer(Transformer):
    """Per-channel normalize (reference: dataset/image/BGRImgNormalizer.scala)."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def apply(self, it):
        for s in it:
            yield Sample((s.feature - self.mean) / self.std, s.label)


class HFlip(Transformer):
    """Random horizontal flip (reference: dataset/image/HFlip.scala)."""

    def __init__(self, threshold: float = 0.5, seed: int = 1):
        self.threshold = threshold
        self._rng = np.random.RandomState(seed)

    def apply(self, it):
        for s in it:
            if self._rng.rand() < self.threshold:
                yield Sample(np.ascontiguousarray(s.feature[:, ::-1]), s.label)
            else:
                yield s


class CenterCrop(Transformer):
    """Deterministic center crop (reference: BGRImgCropper CropCenter)."""

    def __init__(self, crop_h: int, crop_w: int):
        self.crop_h, self.crop_w = crop_h, crop_w

    def apply(self, it):
        for s in it:
            h, w = s.feature.shape[:2]
            y0 = (h - self.crop_h) // 2
            x0 = (w - self.crop_w) // 2
            yield Sample(s.feature[y0:y0 + self.crop_h, x0:x0 + self.crop_w],
                         s.label)


class RandomCrop(Transformer):
    """Random crop, optional zero padding first
    (reference: BGRImgRdmCropper; CIFAR recipe pads 4 then crops 32)."""

    def __init__(self, crop_h: int, crop_w: int, padding: int = 0, seed: int = 1):
        self.crop_h, self.crop_w, self.padding = crop_h, crop_w, padding
        self._rng = np.random.RandomState(seed)

    def apply(self, it):
        for s in it:
            img = s.feature
            if self.padding:
                p = self.padding
                img = np.pad(img, ((p, p), (p, p), (0, 0)))
            h, w = img.shape[:2]
            y0 = self._rng.randint(0, h - self.crop_h + 1)
            x0 = self._rng.randint(0, w - self.crop_w + 1)
            yield Sample(img[y0:y0 + self.crop_h, x0:x0 + self.crop_w], s.label)


class RandomResizedCrop(Transformer):
    """Scale-and-aspect-jittered crop resized to a fixed size — the
    reference's Inception/ResNet ImageNet augmentation
    (dataset/image/BGRImgRdmCropper + resize)."""

    def __init__(self, size: int, min_area: float = 0.08, seed: int = 1):
        self.size = size
        self.min_area = min_area
        self._rng = np.random.RandomState(seed)

    def _resize(self, img, size):
        # nearest-neighbor resize in pure numpy (no cv2 in the image)
        h, w = img.shape[:2]
        ys = (np.arange(size) * (h / size)).astype(np.int64).clip(0, h - 1)
        xs = (np.arange(size) * (w / size)).astype(np.int64).clip(0, w - 1)
        return img[ys][:, xs]

    def apply(self, it):
        for s in it:
            img = s.feature
            h, w = img.shape[:2]
            area = h * w
            for _ in range(10):
                target = self._rng.uniform(self.min_area, 1.0) * area
                ratio = self._rng.uniform(3.0 / 4.0, 4.0 / 3.0)
                ch = int(round(np.sqrt(target / ratio)))
                cw = int(round(np.sqrt(target * ratio)))
                if ch <= h and cw <= w:
                    y0 = self._rng.randint(0, h - ch + 1)
                    x0 = self._rng.randint(0, w - cw + 1)
                    crop = img[y0:y0 + ch, x0:x0 + cw]
                    break
            else:
                m = min(h, w)
                crop = img[(h - m) // 2:(h + m) // 2, (w - m) // 2:(w + m) // 2]
            yield Sample(self._resize(crop, self.size), s.label)


class ColorJitter(Transformer):
    """Random brightness/contrast/saturation in random order
    (reference: dataset/image/ColorJitter.scala)."""

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, seed: int = 1):
        self.brightness, self.contrast, self.saturation = brightness, contrast, saturation
        self._rng = np.random.RandomState(seed)

    def _jitter(self, img):
        ops = []
        if self.brightness:
            a = 1.0 + self._rng.uniform(-self.brightness, self.brightness)
            ops.append(lambda x: x * a)
        if self.contrast:
            c = 1.0 + self._rng.uniform(-self.contrast, self.contrast)
            ops.append(lambda x: (x - x.mean()) * c + x.mean())
        if self.saturation:
            sa = 1.0 + self._rng.uniform(-self.saturation, self.saturation)

            def sat(x, sa=sa):
                grey = x.mean(axis=-1, keepdims=True)
                return grey + (x - grey) * sa

            ops.append(sat)
        self._rng.shuffle(ops)
        for op in ops:
            img = op(img)
        return img

    def apply(self, it):
        for s in it:
            yield Sample(self._jitter(s.feature.astype(np.float32)), s.label)


class Lighting(Transformer):
    """AlexNet-style PCA lighting noise (reference: dataset/image/Lighting.scala).
    Eigen-decomposition values are the standard ImageNet RGB ones."""

    EIGVAL = np.asarray([0.2175, 0.0188, 0.0045], np.float32)
    EIGVEC = np.asarray([
        [-0.5675, 0.7192, 0.4009],
        [-0.5808, -0.0045, -0.8140],
        [-0.5836, -0.6948, 0.4203],
    ], np.float32)

    def __init__(self, alphastd: float = 0.1, seed: int = 1):
        self.alphastd = alphastd
        self._rng = np.random.RandomState(seed)

    def apply(self, it):
        for s in it:
            alpha = self._rng.normal(0, self.alphastd, 3).astype(np.float32)
            shift = (self.EIGVEC * alpha * self.EIGVAL).sum(axis=1)
            yield Sample(s.feature + shift, s.label)
