"""Host-side image transforms — the rebuild of `utils/transforms.lua`
(fb.resnet.torch lineage) as numpy/PIL per-sample functions.

Images are HWC float32 numpy arrays (the layout the NHWC models
consume; the reference used CHW torch tensors). Every random transform takes an
explicit ``numpy.random.Generator`` instead of torch's global RNG, so
worker determinism is by construction (the reference seeds each donkey
with manualSeed+idx, `data.lua:26-27`).

Known reference defects NOT reproduced (SURVEY §2.8): the GammaJitter
`outptu` typo (`transforms.lua:343`) is fixed here.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

from mgtpu import native as _native

Transform = Callable[[np.ndarray, np.random.Generator], np.ndarray]

# native C++ data plane (mgtpu/native/mgdata.cpp); Pillow is the fallback
# when no C++ toolchain could build it
_HAVE_NATIVE = _native.available()


def pil_image():
    """Pillow's Image module, imported only on the fallback path: the
    main path needs numpy and the native library, not Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "this transform needs Pillow, which is not installed (the "
            "native data library, mgtpu/native/mgdata.cpp, covers resize "
            "and affine warps when it builds)"
        ) from e
    return Image


def _resize(img: np.ndarray, w: int, h: int, interpolation: str = "bicubic") -> np.ndarray:
    """Resize HWC float image to (h, w); native separable resampler when
    built, PIL per channel otherwise (bit-identical, see tests/test_native.py)."""
    if img.shape[0] == h and img.shape[1] == w:
        return img
    if _HAVE_NATIVE:
        return _native.resize(img.astype(np.float32, copy=False), h, w, interpolation)
    Image = pil_image()
    interp = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
              "nearest": Image.NEAREST}[interpolation]
    chans = [
        np.asarray(
            Image.fromarray(img[:, :, c].astype(np.float32), mode="F").resize(
                (w, h), interp
            )
        )
        for c in range(img.shape[2])
    ]
    return np.stack(chans, axis=-1)


def compose(transforms: Sequence[Transform]) -> Transform:
    def f(img, rng):
        for t in transforms:
            img = t(img, rng)
        return img

    return f


def color_normalize(mean: Sequence[float], std: Sequence[float]) -> Transform:
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)

    def f(img, rng):
        return (img - mean) / std

    return f


def scale(size: int, interpolation: str = "bicubic") -> Transform:
    """Scale the smaller edge to ``size`` (`transforms.lua:37-48`)."""

    def f(img, rng):
        h, w = img.shape[:2]
        side = min(h, w)
        return _resize(img, round(size * w / side), round(size * h / side), interpolation)

    return f


def center_crop(size: int) -> Transform:
    def f(img, rng):
        h, w = img.shape[:2]
        if h < size or w < size:
            # a negative offset would wrap to a from-the-end slice and
            # return a silently wrong-shaped crop; fail at the cause
            # (use center_crop_pad for the reference's zero-pad hook)
            raise ValueError(f"center_crop({size}) on a {h}x{w} image")
        w1 = int(math.ceil((w - size) / 2))
        h1 = int(math.ceil((h - size) / 2))
        return img[h1 : h1 + size, w1 : w1 + size]

    return f


def center_crop_pad(size: int) -> Transform:
    """Center crop that zero-pads when the crop exceeds the image: the
    available centered region lands at the TOP-LEFT of a zero canvas,
    padding bottom/right — matching the cifar100-whitened test hook
    (`dataset/cifar100-whitened/donkey.lua:167-177`)."""
    cc = center_crop(size)

    def f(img, rng):
        h, w = img.shape[:2]
        if h >= size and w >= size:
            return cc(img, rng)
        h1 = max(int(math.ceil((h - size) / 2)), 0)
        w1 = max(int(math.ceil((w - size) / 2)), 0)
        crop = img[h1 : h1 + size, w1 : w1 + size]
        out = np.zeros((size, size) + img.shape[2:], img.dtype)
        out[: crop.shape[0], : crop.shape[1]] = crop
        return out

    return f


def random_crop(size: int, padding: int = 0) -> Transform:
    """Random crop with optional zero padding (`transforms.lua:60-84`)."""

    def f(img, rng):
        if padding > 0:
            img = np.pad(img, ((padding, padding), (padding, padding), (0, 0)))
        h, w = img.shape[:2]
        if h < size or w < size:  # crop larger than image: zero-pad
            # bottom/right to fit (the reference trainHook would crash
            # here — donkey.lua:57-71 asserts; pad instead, mirroring
            # the testHook's pad branch)
            img = np.pad(
                img,
                ((0, max(size - h, 0)), (0, max(size - w, 0)), (0, 0)),
            )
            h, w = img.shape[:2]
        if h == size and w == size:
            return img
        x1 = rng.integers(0, w - size + 1)
        y1 = rng.integers(0, h - size + 1)
        return img[y1 : y1 + size, x1 : x1 + size]

    return f


def ten_crop(size: int) -> Transform:
    """Four corners + center of image and its mirror -> (10, size, size, C)
    (`transforms.lua:87-109`)."""
    cc = center_crop(size)

    def f(img, rng):
        h, w = img.shape[:2]
        if h < size or w < size:
            raise ValueError(f"ten_crop({size}) on a {h}x{w} image")
        out = []
        for im in (img, img[:, ::-1]):
            out.append(cc(im, rng))
            out.append(im[:size, :size])
            out.append(im[:size, w - size :])
            out.append(im[h - size :, :size])
            out.append(im[h - size :, w - size :])
        return np.stack(out, axis=0)

    return f


def random_scale(min_size: int, max_size: int) -> Transform:
    def f(img, rng):
        h, w = img.shape[:2]
        target = int(rng.integers(min_size, max_size + 1))
        if w < h:
            tw, th = target, round(h / w * target)
        else:
            tw, th = round(w / h * target), target
        return _resize(img, tw, th)

    return f


def random_sized_crop(size: int) -> Transform:
    """Inception-style 8%-100% area, 3/4-4/3 aspect crop
    (`transforms.lua:129-162`)."""
    fallback = compose([scale(size), center_crop(size)])

    def f(img, rng):
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = rng.uniform(0.08, 1.0) * area
            ar = rng.uniform(3 / 4, 4 / 3)
            cw = int(round(math.sqrt(target_area * ar)))
            ch = int(round(math.sqrt(target_area / ar)))
            if rng.uniform() < 0.5:
                cw, ch = ch, cw
            if ch <= h and cw <= w:
                y1 = rng.integers(0, h - ch + 1)
                x1 = rng.integers(0, w - cw + 1)
                crop = img[y1 : y1 + ch, x1 : x1 + cw]
                return _resize(crop, size, size)
        return fallback(img, rng)

    return f


def horizontal_flip(prob: float) -> Transform:
    def f(img, rng):
        if rng.uniform() < prob:
            return np.ascontiguousarray(img[:, ::-1])
        return img

    return f


def _warp_affine(img: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Apply a 2x2 linear map about the image center, bilinear (torch
    image.affinetransform semantics: output(x) = input(A @ x))."""
    h, w = img.shape[:2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    # PIL's transform uses (x, y) = (col, row); torch matrix acts on (row, col)
    a_rc = np.asarray(mat, np.float64)
    # convert row/col matrix to x/y: swap axes
    a_xy = np.array([[a_rc[1, 1], a_rc[1, 0]], [a_rc[0, 1], a_rc[0, 0]]])
    # offset so the center maps to itself
    off = np.array([cx, cy]) - a_xy @ np.array([cx, cy])
    coeffs = (a_xy[0, 0], a_xy[0, 1], off[0], a_xy[1, 0], a_xy[1, 1], off[1])
    if _HAVE_NATIVE:
        return _native.warp_affine(img.astype(np.float32, copy=False), coeffs)
    Image = pil_image()
    chans = [
        np.asarray(
            Image.fromarray(img[:, :, c].astype(np.float32), mode="F").transform(
                (w, h), Image.AFFINE, coeffs, resample=Image.BILINEAR
            )
        )
        for c in range(img.shape[2])
    ]
    return np.stack(chans, axis=-1)


def rotation(deg: float) -> Transform:
    """Rotate by U(-deg/2, deg/2) degrees, bilinear (`transforms.lua:173-181`)."""

    def f(img, rng):
        if deg == 0:
            return img
        theta = (rng.uniform() - 0.5) * deg * math.pi / 180
        c, s = math.cos(theta), math.sin(theta)
        return _warp_affine(img, np.array([[c, s], [-s, c]]))

    return f


def rotation_exact(max_rad: float) -> Transform:
    """The cifar100-whitened donkey's rotate: U(-a, a) radians via
    affine matrix (`dataset/cifar100-whitened/donkey.lua:37-45`)."""

    def f(img, rng):
        theta = rng.uniform(-max_rad, max_rad)
        c, s = math.cos(theta), math.sin(theta)
        return _warp_affine(img, np.array([[c, s], [-s, c]]))

    return f


def affine(deg: float) -> Transform:
    """Random shear along a random axis (`transforms.lua:183-196`)."""

    def f(img, rng):
        theta = math.pi / 180 * deg
        t = math.tan(rng.uniform(-theta, theta))
        diag = [t, 0.0]
        if rng.uniform() < 0.5:
            diag = [0.0, t]
        mat = np.array([[1.0, diag[0]], [diag[1], 1.0]])
        return _warp_affine(img, mat)

    return f


def brush_edge() -> Transform:
    """Edge map -> brushed edge map (`transforms.lua:198-216`)."""

    def f(img, rng):
        th = rng.uniform(0.5, 0.7) if rng.uniform() < 0.5 else rng.uniform(0.8, 0.95)
        lt = (img < th).astype(img.dtype)
        ge = (img >= th).astype(img.dtype)
        noise = rng.uniform(0, 0.3, img.shape).astype(img.dtype)
        return img * ge + lt * noise

    return f


def lighting(alphastd: float, eigval: np.ndarray, eigvec: np.ndarray) -> Transform:
    """AlexNet PCA lighting noise (`transforms.lua:219-238`)."""
    eigval = np.asarray(eigval, np.float32)
    eigvec = np.asarray(eigvec, np.float32)

    def f(img, rng):
        if alphastd == 0:
            return img
        alpha = rng.normal(0, alphastd, 3).astype(np.float32)
        rgb = (eigvec * alpha[None, :] * eigval[None, :]).sum(axis=1)
        return img + rgb

    return f


def _grayscale(img: np.ndarray) -> np.ndarray:
    g = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return np.repeat(g[..., None], 3, axis=-1)


def _blend(img1, img2, alpha):
    return img1 * alpha + (1 - alpha) * img2


def gamma_correct(gamma: float, constant: float = 1.0) -> Transform:
    def f(img, rng):
        return np.power(img, gamma) * constant

    return f


def saturation(var: float) -> Transform:
    def f(img, rng):
        alpha = 1.0 + rng.uniform(-var, var)
        return _blend(img, _grayscale(img), alpha)

    return f


def brightness(var: float) -> Transform:
    def f(img, rng):
        alpha = 1.0 + rng.uniform(-var, var)
        return _blend(img, np.zeros_like(img), alpha)

    return f


def contrast(var: float) -> Transform:
    def f(img, rng):
        gs = np.full_like(img, _grayscale(img)[..., 0].mean())
        alpha = 1.0 + rng.uniform(-var, var)
        return _blend(img, gs, alpha)

    return f


def random_order(transforms: Sequence[Transform]) -> Transform:
    def f(img, rng):
        for i in rng.permutation(len(transforms)):
            img = transforms[i](img, rng)
        return img

    return f


def color_jitter(brightness_var=0.0, contrast_var=0.0, saturation_var=0.0) -> Transform:
    ts = []
    if brightness_var:
        ts.append(brightness(brightness_var))
    if contrast_var:
        ts.append(contrast(contrast_var))
    if saturation_var:
        ts.append(saturation(saturation_var))
    if not ts:
        return lambda img, rng: img
    return random_order(ts)


def gamma_jitter(gammas: Sequence[float]) -> Transform:
    gammas = list(gammas) or [1.0]

    def f(img, rng):
        return np.stack([np.power(img, g) for g in gammas], axis=0)

    return f


def occlusion_noise(mask: np.ndarray, rng_seed: int = 0) -> np.ndarray:
    """The fixed in-mask uniform noise the occlusion transform adds —
    exposed separately so the saliency pipeline's device-side stack
    expansion (-saliencyDumpStack 0) uses the IDENTICAL values."""
    noise_rng = np.random.default_rng(rng_seed)
    return (noise_rng.uniform(size=mask.shape) * mask).astype(np.float32)


def occlusion(mask: np.ndarray, rng_seed: int = 0,
              noise: np.ndarray = None) -> Transform:
    """Expand one sample into 1+N occluded variants (`transforms.lua:
    356-378`): variant i = img * (1-mask_i) + noise_i where noise is
    fixed uniform inside the mask. mask: (N, H, W, C or 1). Pass a
    precomputed ``occlusion_noise`` to share it with a caller that also
    needs the raw values (SaliencyDataset keeps one copy, not two)."""
    assert mask.ndim == 4
    if noise is None:
        noise = occlusion_noise(mask, rng_seed)
    inv = (mask == 0).astype(np.float32)

    def f(img, rng):
        out = [img]
        for i in range(mask.shape[0]):
            out.append(inv[i] * img + noise[i])
        return np.stack(out, axis=0)

    return f


def bgr(img: np.ndarray, rng=None) -> np.ndarray:
    """RGB -> BGR channel swap (the reference default colorspace for
    cifar100-whitened! `opts.lua:29`, `donkey.lua:96-115`)."""
    return np.ascontiguousarray(img[..., ::-1])


def grayscale_y(img: np.ndarray, rng=None) -> np.ndarray:
    """rgb2y single-channel (`donkey.lua:103-111`)."""
    if img.shape[-1] == 1:
        return img
    return _grayscale(img)[..., :1]
