"""Vision transforms (counterpart of ``paddle_tpu/vision/transforms.py``, a
copy): numpy CHW float32 arrays in, numpy CHW float32 arrays out, on the
host (in a DataLoader worker when there are workers).  ``ToTensor``
returns the CHW float32 array, which ``io.default_collate_fn`` and the
workers' collate stack into a batch.  ``Resize`` (and
``RandomResizedCrop``) interpolate with torch's bilinear
``interpolate(..., antialias=True)`` on the CPU where JAX calls
``jax.image.resize(method="linear")``: the same half-pixel-centred
triangle filter, widened by the scale when shrinking.  The rotations,
affine and perspective maps use ``scipy.ndimage``, as in JAX."""

from __future__ import annotations

from typing import Callable, List

import numpy as np

from ..tensor.tensor import Tensor

__all__ = ["BaseTransform", "Compose", "ToTensor", "Normalize", "Resize", "RandomCrop",
           "CenterCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
           "Transpose", "BrightnessTransform", "ContrastTransform",
           "SaturationTransform", "HueTransform", "ColorJitter",
           "Grayscale", "RandomResizedCrop", "RandomErasing",
           "RandomAffine", "RandomPerspective", "Pad", "RandomRotation",
           "to_tensor", "normalize", "resize", "hflip", "vflip",
           "pad", "crop", "center_crop", "affine", "perspective",
           "adjust_brightness", "adjust_contrast", "adjust_saturation",
           "adjust_hue", "to_grayscale", "rotate", "erase"]


def _chw(img) -> np.ndarray:
    a = img.numpy() if isinstance(img, Tensor) else np.asarray(img)
    if a.ndim == 2:
        a = a[None]
    elif a.ndim == 3 and a.shape[-1] in (1, 3, 4) and a.shape[0] not in (
            1, 3, 4):
        a = a.transpose(2, 0, 1)
    return a.astype("float32")


class Compose:
    def __init__(self, transforms: List[Callable]):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor:
    def __init__(self, data_format="CHW", keys=None):
        self.data_format = data_format

    def __call__(self, img):
        raw = img.numpy() if isinstance(img, Tensor) else np.asarray(img)
        a = _chw(img)
        if raw.dtype == np.uint8:  # keyed on dtype, not value range
            a = a / 255.0
        return a


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW",
                 to_rgb=False, keys=None):
        self.mean = np.asarray(mean, dtype="float32").reshape(-1, 1, 1)
        self.std = np.asarray(std, dtype="float32").reshape(-1, 1, 1)

    def __call__(self, img):
        a = _chw(img)
        return (a - self.mean) / self.std


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std)(img)


def _resize_np(a: np.ndarray, size) -> np.ndarray:
    import torch
    import torch.nn.functional as TF
    if isinstance(size, int):
        size = (size, size)
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))[None]
    out = TF.interpolate(t, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)
    return out[0].numpy()


class Resize:
    def __init__(self, size, interpolation="bilinear", keys=None):
        self.size = size

    def __call__(self, img):
        return _resize_np(_chw(img), self.size)


def resize(img, size, interpolation="bilinear"):
    return Resize(size)(img)


class CenterCrop:
    def __init__(self, size, keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        a = _chw(img)
        h, w = a.shape[-2:]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return a[:, i:i + th, j:j + tw]


class RandomCrop:
    def __init__(self, size, padding=None, pad_if_needed=False, keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        a = _chw(img)
        if self.padding:
            p = self.padding
            if isinstance(p, int):
                p = (p, p, p, p)
            a = np.pad(a, ((0, 0), (p[1], p[3]), (p[0], p[2])))
        h, w = a.shape[-2:]
        th, tw = self.size
        i = np.random.randint(0, max(h - th, 0) + 1)
        j = np.random.randint(0, max(w - tw, 0) + 1)
        return a[:, i:i + th, j:j + tw]


def hflip(img):
    return _chw(img)[:, :, ::-1].copy()


def vflip(img):
    return _chw(img)[:, ::-1, :].copy()


class RandomHorizontalFlip:
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return hflip(img)
        return _chw(img)


class RandomVerticalFlip:
    def __init__(self, prob=0.5, keys=None):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return vflip(img)
        return _chw(img)


class Transpose:
    def __init__(self, order=(2, 0, 1), keys=None):
        self.order = order

    def __call__(self, img):
        a = img.numpy() if isinstance(img, Tensor) else np.asarray(img)
        return a.transpose(self.order)


class BrightnessTransform:
    def __init__(self, value, keys=None):
        self.value = value

    def __call__(self, img):
        return adjust_brightness(img, np.random.uniform(
            max(0.0, 1 - self.value), 1 + self.value))


class Pad:
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        self.padding = padding
        self.fill = fill

    def __call__(self, img):
        a = _chw(img)
        p = self.padding
        if isinstance(p, int):
            p = (p, p, p, p)
        return np.pad(a, ((0, 0), (p[1], p[3]), (p[0], p[2])),
                      constant_values=self.fill)


class RandomRotation:
    def __init__(self, degrees, keys=None):
        self.degrees = (-degrees, degrees) if isinstance(
            degrees, (int, float)) else degrees

    def __call__(self, img):
        a = _chw(img)
        k = np.random.randint(0, 4)
        return np.rot90(a, k, axes=(-2, -1)).copy()


# ---------------------------------------------------------------------------
# photometric transforms (reference: vision/transforms/functional.py
# adjust_brightness/adjust_contrast/adjust_saturation/adjust_hue)
# ---------------------------------------------------------------------------
def _chw_ranged(img):
    """CHW float array + its value ceiling so photometric math clips in
    the right range.  uint8 input is 0-255; float input is judged by its
    values (a chained transform hands the next one a float array still in
    0-255) — floats entirely within [0, 1] use ceiling 1."""
    raw = img.numpy() if isinstance(img, Tensor) else np.asarray(img)
    a = _chw(img)
    hi = 255.0 if (raw.dtype == np.uint8 or (a.size and a.max() > 1.0)) \
        else 1.0
    return a, hi


def adjust_brightness(img, factor):
    a, hi = _chw_ranged(img)
    return np.clip(a * factor, 0, hi)


def adjust_contrast(img, factor):
    a, hi = _chw_ranged(img)
    mean = a.mean(axis=(-2, -1), keepdims=True)
    return np.clip(mean + factor * (a - mean), 0, hi)


def _rgb_to_hsv(a):
    r, g, b = a[0], a[1], a[2]
    maxc = np.max(a, axis=0)
    minc = np.min(a, axis=0)
    v = maxc
    diff = maxc - minc
    s = np.where(maxc > 0, diff / np.maximum(maxc, 1e-12), 0.0)
    safe = np.maximum(diff, 1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(diff > 0, (h / 6.0) % 1.0, 0.0)
    return np.stack([h, s, v])


def _hsv_to_rgb(a):
    h, s, v = a[0], a[1], a[2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    choices = [np.stack([v, t, p]), np.stack([q, v, p]),
               np.stack([p, v, t]), np.stack([p, q, v]),
               np.stack([t, p, v]), np.stack([v, p, q])]
    out = np.zeros_like(a)
    for k, c in enumerate(choices):
        out = np.where(i[None] == k, c, out)
    return out


def adjust_saturation(img, factor):
    a, hi = _chw_ranged(img)
    hsv = _rgb_to_hsv(a / hi)
    hsv[1] = np.clip(hsv[1] * factor, 0, 1)
    return np.clip(_hsv_to_rgb(hsv), 0, 1) * hi


def adjust_hue(img, delta):
    """delta in [-0.5, 0.5] — fraction of the hue circle."""
    a, hi = _chw_ranged(img)
    hsv = _rgb_to_hsv(a / hi)
    hsv[0] = (hsv[0] + delta) % 1.0
    return np.clip(_hsv_to_rgb(hsv), 0, 1) * hi


def to_grayscale(img, num_output_channels=1):
    a = _chw(img)
    gray = (0.299 * a[0] + 0.587 * a[1] + 0.114 * a[2])[None]
    if num_output_channels == 3:
        gray = np.repeat(gray, 3, axis=0)
    return gray


def rotate(img, angle, interpolation="bilinear", expand=False, fill=0):
    import scipy.ndimage as ndi
    a = _chw(img)
    order = 1 if interpolation == "bilinear" else 0
    return np.stack([
        ndi.rotate(c, angle, reshape=expand, order=order, cval=fill,
                   mode="constant") for c in a])


def erase(img, i, j, h, w, v=0.0):
    a = _chw(img).copy()
    a[:, i:i + h, j:j + w] = v
    return a


class ContrastTransform:
    def __init__(self, value, keys=None):
        self.value = value

    def __call__(self, img):
        # factor never negative (reference samples max(0, 1-v)..1+v)
        return adjust_contrast(img, np.random.uniform(
            max(0.0, 1 - self.value), 1 + self.value))


class SaturationTransform:
    def __init__(self, value, keys=None):
        self.value = value

    def __call__(self, img):
        return adjust_saturation(img, np.random.uniform(
            max(0.0, 1 - self.value), 1 + self.value))


class HueTransform:
    def __init__(self, value, keys=None):
        self.value = value  # max hue shift as a fraction of the circle

    def __call__(self, img):
        return adjust_hue(img, np.random.uniform(-self.value, self.value))


class ColorJitter:
    """Random brightness/contrast/saturation/hue in random order
    (reference: transforms.ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        self.transforms = []
        if brightness:
            self.transforms.append(BrightnessTransform(brightness))
        if contrast:
            self.transforms.append(ContrastTransform(contrast))
        if saturation:
            self.transforms.append(SaturationTransform(saturation))
        if hue:
            self.transforms.append(HueTransform(hue))

    def __call__(self, img):
        order = np.random.permutation(len(self.transforms))
        for idx in order:
            img = self.transforms[idx](img)
        return img


class Grayscale:
    def __init__(self, num_output_channels=1, keys=None):
        self.num_output_channels = num_output_channels

    def __call__(self, img):
        return to_grayscale(img, self.num_output_channels)


class RandomResizedCrop:
    """Crop a random area/aspect patch, resize to ``size``
    (reference: transforms.RandomResizedCrop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def __call__(self, img):
        a = _chw(img)
        _, H, W = a.shape
        area = H * W
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            w = int(round(np.sqrt(target * ar)))
            h = int(round(np.sqrt(target / ar)))
            if 0 < w <= W and 0 < h <= H:
                i = np.random.randint(0, H - h + 1)
                j = np.random.randint(0, W - w + 1)
                patch = a[:, i:i + h, j:j + w]
                return _resize_np(patch, self.size)
        # fallback: center crop of the max fitting square
        s = min(H, W)
        i, j = (H - s) // 2, (W - s) // 2
        return _resize_np(a[:, i:i + s, j:j + s], self.size)


class RandomErasing:
    """Blank a random rectangle (reference: transforms.RandomErasing)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, keys=None):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def __call__(self, img):
        a = _chw(img)
        if np.random.rand() >= self.prob:
            return a
        _, H, W = a.shape
        area = H * W
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.random.uniform(*self.ratio)
            h = int(round(np.sqrt(target * ar)))
            w = int(round(np.sqrt(target / ar)))
            if h < H and w < W:
                i = np.random.randint(0, H - h + 1)
                j = np.random.randint(0, W - w + 1)
                return erase(a, i, j, h, w, self.value)
        return a


class RandomAffine:
    """Random rotation/translation/scale/shear via an inverse affine map
    (reference: transforms.RandomAffine)."""

    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="bilinear", fill=0, keys=None):
        self.degrees = (-degrees, degrees) if isinstance(
            degrees, (int, float)) else tuple(degrees)
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.order = 1 if interpolation == "bilinear" else 0
        self.fill = fill

    def __call__(self, img):
        a = _chw(img)
        _, H, W = a.shape
        angle = np.random.uniform(*self.degrees)
        s = np.random.uniform(*self.scale) if self.scale else 1.0
        if self.shear is None or self.shear == 0:
            shear = 0.0
        elif isinstance(self.shear, (int, float)):
            shear = np.random.uniform(-self.shear, self.shear)
        else:  # sequence [lo, hi] (degrees), the documented API shape
            shear = np.random.uniform(self.shear[0], self.shear[1])
        tx = ty = 0.0
        if self.translate:
            ty = np.random.uniform(-self.translate[1], self.translate[1]) * H
            tx = np.random.uniform(-self.translate[0], self.translate[0]) * W
        return affine(a, angle, (tx, ty), s, shear,
                      interpolation="bilinear" if self.order == 1
                      else "nearest", fill=self.fill)


class RandomPerspective:
    """Random four-point perspective warp (reference:
    transforms.RandomPerspective)."""

    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="bilinear", fill=0, keys=None):
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.order = 1 if interpolation == "bilinear" else 0
        self.fill = fill

    @staticmethod
    def _solve_homography(src, dst):
        # standard DLT: 8 equations in the 8 unknown homography params
        A, b = [], []
        for (x, y), (u, v) in zip(src, dst):
            A.append([x, y, 1, 0, 0, 0, -u * x, -u * y]); b.append(u)
            A.append([0, 0, 0, x, y, 1, -v * x, -v * y]); b.append(v)
        h = np.linalg.solve(np.asarray(A, float), np.asarray(b, float))
        return np.append(h, 1.0).reshape(3, 3)

    def __call__(self, img):
        a = _chw(img)
        if np.random.rand() >= self.prob:
            return a
        _, H, W = a.shape
        d = self.distortion_scale
        dx, dy = W * d / 2, H * d / 2
        corners = np.array([[0, 0], [W - 1, 0], [W - 1, H - 1], [0, H - 1]],
                           float)
        jitter = np.stack([np.random.uniform(-dx, dx, 4),
                           np.random.uniform(-dy, dy, 4)], axis=1)
        signs = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], float)
        dst = corners + np.abs(jitter) * signs
        return perspective(a, corners.tolist(), dst.tolist(),
                           interpolation="bilinear" if self.order == 1
                           else "nearest", fill=self.fill)


# ---------------------------------------------------------------------------
# functional forms + BaseTransform (reference: vision/transforms/
# functional.py pad/crop/center_crop/affine/perspective, transforms.py
# BaseTransform)
# ---------------------------------------------------------------------------
class BaseTransform:
    """Base class with the reference's keys/params protocol: subclasses
    implement _apply_image (and optionally _apply_{label,boxes,...});
    __call__ dispatches per input key."""

    def __init__(self, keys=None):
        self.keys = keys or ("image",)

    def _get_params(self, inputs):
        return None

    def _apply_image(self, image):
        raise NotImplementedError

    def __call__(self, inputs):
        single = not isinstance(inputs, (list, tuple))
        if single:
            inputs = (inputs,)
        self.params = self._get_params(inputs)
        outs = []
        for idx, data in enumerate(inputs):
            # inputs beyond the declared keys pass through unchanged
            fn = getattr(self, f"_apply_{self.keys[idx]}", None) \
                if idx < len(self.keys) else None
            outs.append(fn(data) if fn else data)
        return outs[0] if single else tuple(outs)


def pad(img, padding, fill=0, padding_mode="constant"):
    a = _chw(img)
    p = (padding,) * 4 if isinstance(padding, int) else tuple(padding)
    if len(p) == 2:
        p = (p[0], p[1], p[0], p[1])
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if padding_mode == "constant" else {}
    return np.pad(a, ((0, 0), (p[1], p[3]), (p[0], p[2])), mode=mode, **kw)


def crop(img, top, left, height, width):
    a = _chw(img)
    return a[:, top:top + height, left:left + width]


def center_crop(img, output_size):
    a = _chw(img)
    oh, ow = (output_size, output_size) if isinstance(output_size, int) \
        else tuple(output_size)
    _, H, W = a.shape
    top = (H - oh) // 2
    left = (W - ow) // 2
    return a[:, top:top + oh, left:left + ow]


def affine(img, angle, translate, scale, shear, interpolation="nearest",
           fill=0, center=None):
    """Functional affine with explicit parameters (reference:
    transforms/functional.py affine)."""
    import scipy.ndimage as ndi
    a = _chw(img)
    _, H, W = a.shape
    ang = np.deg2rad(angle)
    sh = shear if isinstance(shear, (list, tuple)) else (shear, 0.0)
    shx, shy = np.deg2rad(sh[0]), np.deg2rad(sh[1] if len(sh) > 1 else 0.0)
    c, si = np.cos(ang), np.sin(ang)
    R = np.array([[c, -si], [si, c]])
    Sh = np.array([[1.0, np.tan(shy)], [np.tan(shx), 1.0]])
    M = (R @ Sh) * scale
    Minv = np.linalg.inv(M)
    ctr = np.array(center[::-1]) if center is not None else \
        np.array([(H - 1) / 2, (W - 1) / 2])
    t = np.array([translate[1], translate[0]], float)
    offset = ctr - Minv @ (ctr + t)
    order = 1 if interpolation == "bilinear" else 0
    return np.stack([ndi.affine_transform(ch, Minv, offset=offset,
                                          order=order, cval=fill,
                                          mode="constant") for ch in a])


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """Four-point perspective warp with explicit correspondences
    (reference: transforms/functional.py perspective)."""
    import scipy.ndimage as ndi
    a = _chw(img)
    _, H, W = a.shape
    Hmat = RandomPerspective._solve_homography(
        np.asarray(endpoints, float), np.asarray(startpoints, float))
    ys, xs = np.mgrid[0:H, 0:W]
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(H * W)])
    src = Hmat @ pts
    sx = (src[0] / src[2]).reshape(H, W)
    sy = (src[1] / src[2]).reshape(H, W)
    order = 1 if interpolation == "bilinear" else 0
    return np.stack([ndi.map_coordinates(ch, [sy, sx], order=order,
                                         cval=fill, mode="constant")
                     for ch in a])
