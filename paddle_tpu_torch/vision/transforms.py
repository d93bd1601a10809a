"""Vision transforms for the port (counterpart of
`paddle_tpu/vision/transforms.py`): numpy on the host, the same arrays as
the reference's, drawing from numpy's global random state. `ToTensor`
makes a tensor on the current place; in a `DataLoader` worker, keep to
numpy (`io/worker.py`)."""
import numbers

import numpy as np

from ..core.tensor import Tensor, to_tensor


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


def _to_hwc_array(img):
    arr = np.asarray(img)
    return arr


class ToTensor(BaseTransform):
    """HWC uint8 [0,255] -> CHW float32 [0,1]."""

    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = _to_hwc_array(img).astype(np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return to_tensor(arr)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False, keys=None):
        super().__init__(keys)
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = img.numpy() if isinstance(img, Tensor) else np.asarray(img, np.float32)
        if self.data_format == "CHW":
            m = self.mean.reshape(-1, 1, 1)
            s = self.std.reshape(-1, 1, 1)
        else:
            m = self.mean
            s = self.std
        out = (arr - m) / s
        return to_tensor(out) if isinstance(img, Tensor) else out


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        h, w = self.size
        ih, iw = arr.shape[:2]
        ys = (np.arange(h) * ih / h).astype(int).clip(0, ih - 1)
        xs = (np.arange(w) * iw / w).astype(int).clip(0, iw - 1)
        return arr[ys][:, xs]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        if self.padding:
            p = self.padding if isinstance(self.padding, (list, tuple)) \
                else (self.padding,) * 4
            arr = np.pad(arr, ((p[1], p[3]), (p[0], p[2])) + ((0, 0),) * (arr.ndim - 2))
        h, w = self.size
        ih, iw = arr.shape[:2]
        top = np.random.randint(0, max(ih - h, 0) + 1)
        left = np.random.randint(0, max(iw - w, 0) + 1)
        return arr[top:top + h, left:left + w]


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        h, w = self.size
        ih, iw = arr.shape[:2]
        top = max((ih - h) // 2, 0)
        left = max((iw - w) // 2, 0)
        return arr[top:top + h, left:left + w]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        if np.random.rand() < self.prob:
            return arr[:, ::-1].copy()
        return arr


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        if np.random.rand() < self.prob:
            return arr[::-1].copy()
        return arr


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr.transpose(self.order)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def _apply_image(self, img):
        arr = _to_hwc_array(img)
        ih, iw = arr.shape[:2]
        area = ih * iw
        for _ in range(10):
            target_area = np.random.uniform(*self.scale) * area
            aspect = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                              np.log(self.ratio[1])))
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if 0 < w <= iw and 0 < h <= ih:
                top = np.random.randint(0, ih - h + 1)
                left = np.random.randint(0, iw - w + 1)
                crop = arr[top:top + h, left:left + w]
                return Resize(self.size)._apply_image(crop)
        return Resize(self.size)._apply_image(arr)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)._apply_image(img)


def to_tensor_fn(pic, data_format="CHW"):
    return ToTensor(data_format)._apply_image(pic)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)._apply_image(img)


def hflip(img):
    return _to_hwc_array(img)[:, ::-1].copy()


def vflip(img):
    return _to_hwc_array(img)[::-1].copy()


# ------------------------------------------------- round-3 transform batch
# Color/geometry transforms (reference transforms.py). Host-side numpy:
# these run in DataLoader workers, never on the device.

def _as_float_hwc(img):
    """-> (float [0,1] HWC array, restore_fn): restore_fn converts back to
    the input's dtype and rank, so transforms preserve image format
    (reference transforms return what they were given)."""
    orig = np.asarray(img)
    arr = orig.astype(np.float32)
    # integers: 8-bit content regardless of container width (a dark uint8
    # image is still 0-255; int64 pixel arrays are 0-255 too) UNLESS the
    # values actually exceed 255 (full-range uint16 scans) — then the dtype
    # range. Floats keep the content heuristic (both conventions exist).
    if np.issubdtype(orig.dtype, np.integer):
        # 8-bit containers cannot exceed 255: skip the full-array scan
        scale = 255.0 if (orig.dtype.itemsize == 1 or arr.max() <= 255) \
            else float(np.iinfo(orig.dtype).max)
    else:
        scale = 255.0 if arr.max() > 1.5 else 1.0
    was_2d = arr.ndim == 2
    if was_2d:
        arr = arr[:, :, None]

    def restore(out):
        out = out * scale
        if was_2d:
            out = out[:, :, 0]
        if np.issubdtype(orig.dtype, np.integer):
            out = np.clip(np.round(out), np.iinfo(orig.dtype).min,
                          np.iinfo(orig.dtype).max)
        return out.astype(orig.dtype)

    return arr / scale, restore


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        arr, restore = _as_float_hwc(img)
        factor = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        return restore(np.clip(arr * factor, 0, 1))


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if value < 0:
            raise ValueError("contrast value should be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        arr, restore = _as_float_hwc(img)
        factor = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        mean = arr.mean()
        return restore(np.clip((arr - mean) * factor + mean, 0, 1))


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        arr, restore = _as_float_hwc(img)
        factor = np.random.uniform(max(0, 1 - self.value), 1 + self.value)
        gray = arr @ np.array([0.299, 0.587, 0.114], np.float32) \
            if arr.shape[-1] == 3 else arr.mean(-1)
        gray = gray[..., None]
        return restore(np.clip(gray + (arr - gray) * factor, 0, 1))


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if not 0 <= value <= 0.5:
            raise ValueError("hue value should be in [0, 0.5]")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        arr, restore = _as_float_hwc(img)
        if arr.shape[-1] != 3:
            return np.asarray(img)
        shift = np.random.uniform(-self.value, self.value)
        # RGB -> HSV hue rotation -> RGB, vectorized
        r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
        mx = arr.max(-1)
        mn = arr.min(-1)
        diff = mx - mn + 1e-12
        h = np.zeros_like(mx)
        mask = mx == r
        h[mask] = ((g - b) / diff)[mask] % 6
        mask = mx == g
        h[mask] = ((b - r) / diff + 2)[mask]
        mask = mx == b
        h[mask] = ((r - g) / diff + 4)[mask]
        h = (h / 6.0 + shift) % 1.0
        s = np.where(mx > 0, diff / (mx + 1e-12), 0)
        v = mx
        i = np.floor(h * 6).astype(np.int32)
        f = h * 6 - i
        p = v * (1 - s)
        q = v * (1 - f * s)
        t = v * (1 - (1 - f) * s)
        i = i % 6
        out = np.zeros_like(arr)
        for k, (rr, gg, bb) in enumerate(
                [(v, t, p), (q, v, p), (p, v, t),
                 (p, q, v), (t, p, v), (v, p, q)]):
            m = i == k
            out[..., 0][m] = rr[m]
            out[..., 1][m] = gg[m]
            out[..., 2][m] = bb[m]
        return restore(np.clip(out, 0, 1))


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.ts = [BrightnessTransform(brightness),
                   ContrastTransform(contrast),
                   SaturationTransform(saturation), HueTransform(hue)]

    def _apply_image(self, img):
        order = np.random.permutation(len(self.ts))
        for i in order:
            img = self.ts[i]._apply_image(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.n = num_output_channels

    def _apply_image(self, img):
        arr = np.asarray(img).astype(np.float32)
        if arr.ndim == 2:
            gray = arr
        else:
            gray = arr @ np.array([0.299, 0.587, 0.114], np.float32)
        out = np.repeat(gray[..., None], self.n, axis=-1) if self.n > 1 \
            else gray[..., None]
        return out.astype(np.asarray(img).dtype)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        if isinstance(padding, numbers.Number):
            padding = (padding,) * 4
        elif len(padding) == 2:
            padding = (padding[0], padding[1], padding[0], padding[1])
        self.padding = padding                 # (left, top, right, bottom)
        self.fill = fill
        self.mode = padding_mode

    def _apply_image(self, img):
        arr = np.asarray(img)
        l, t, r, b = self.padding
        cfg = [(t, b), (l, r)] + [(0, 0)] * (arr.ndim - 2)
        if self.mode != "constant":
            return np.pad(arr, cfg, mode={"reflect": "reflect",
                                          "edge": "edge",
                                          "symmetric": "symmetric"}[self.mode])
        if isinstance(self.fill, (list, tuple)) and arr.ndim == 3:
            # per-channel fill (reference Pad accepts int|list|tuple)
            chans = [np.pad(arr[..., c], cfg[:2], constant_values=f)
                     for c, f in zip(range(arr.shape[-1]), self.fill)]
            return np.stack(chans, axis=-1)
        return np.pad(arr, cfg, constant_values=self.fill)


class RandomRotation(BaseTransform):
    """Rotation by a random angle; nearest-neighbor inverse mapping (host
    numpy, gather-based — no scipy dependency)."""

    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-abs(degrees), abs(degrees))
        if interpolation not in ("nearest",):
            raise NotImplementedError(
                f"RandomRotation: interpolation {interpolation!r} is not "
                f"supported (nearest only)")
        self.degrees = degrees
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        arr = np.asarray(img)
        angle = np.deg2rad(np.random.uniform(*self.degrees))
        H, W = arr.shape[:2]
        if self.center is not None:
            cx, cy = self.center
        else:
            cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
        c, s = np.cos(angle), np.sin(angle)
        if self.expand:
            # canvas grows to hold the rotated corners (reference expand)
            H_out = int(np.ceil(abs(H * c) + abs(W * s)))
            W_out = int(np.ceil(abs(W * c) + abs(H * s)))
        else:
            H_out, W_out = H, W
        oy, ox = (H_out - 1) / 2.0, (W_out - 1) / 2.0
        yy, xx = np.meshgrid(np.arange(H_out), np.arange(W_out),
                             indexing="ij")
        src_x = c * (xx - ox) + s * (yy - oy) + cx
        src_y = -s * (xx - ox) + c * (yy - oy) + cy
        xi = np.round(src_x).astype(np.int64)
        yi = np.round(src_y).astype(np.int64)
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        out_shape = (H_out, W_out) + arr.shape[2:]
        out = np.full(out_shape, self.fill, dtype=arr.dtype)
        out[valid] = arr[yi[valid], xi[valid]]
        return out


class RandomErasing(BaseTransform):
    """Randomly erase a rectangle (reference RandomErasing)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def _apply_image(self, img):
        arr = np.array(img)
        if np.random.rand() > self.prob:
            return arr
        # CHW only when the leading dim is channel-like AND the trailing
        # one is not (a (3, 256, 3) HWC strip stays HWC)
        chw = (arr.ndim == 3 and arr.shape[0] in (1, 3)
               and arr.shape[2] not in (1, 3))
        if chw:
            H, W = arr.shape[1], arr.shape[2]
        else:
            H, W = arr.shape[0], arr.shape[1]
        val = np.asarray(self.value, arr.dtype)
        if val.ndim == 1:                     # per-channel fill
            val = val.reshape((-1, 1, 1) if chw else (1, 1, -1))
        area = H * W
        for _ in range(10):
            target = np.random.uniform(*self.scale) * area
            ar = np.random.uniform(*self.ratio)
            h = int(round(np.sqrt(target * ar)))
            w = int(round(np.sqrt(target / ar)))
            if h < H and w < W:
                y = np.random.randint(0, H - h + 1)
                x = np.random.randint(0, W - w + 1)
                if chw:
                    arr[:, y:y + h, x:x + w] = val
                else:
                    arr[y:y + h, x:x + w] = val
                break
        return arr


# ---------------------------------------------------------------------------
# functional API (reference: python/paddle/vision/transforms/functional.py)
# Host-side numpy image math (these run in DataLoader workers).

def _hwc(arr):
    """Detect CHW and return (HWC array, restore)."""
    arr = np.asarray(arr)
    chw = (arr.ndim == 3 and arr.shape[0] in (1, 3)
           and arr.shape[2] not in (1, 3))
    if chw:
        return np.transpose(arr, (1, 2, 0)), \
            (lambda o: np.transpose(o, (2, 0, 1)))
    return arr, (lambda o: o)


def crop(img, top, left, height, width):
    arr, back = _hwc(img)
    return back(arr[top:top + height, left:left + width])


def center_crop(img, output_size):
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    arr, back = _hwc(img)
    H, W = arr.shape[:2]
    th, tw = output_size
    top = max((H - th) // 2, 0)
    left = max((W - tw) // 2, 0)
    return back(arr[top:top + th, left:left + tw])


def pad(img, padding, fill=0, padding_mode="constant"):
    return Pad(padding, fill, padding_mode)._apply_image(img)


def _inverse_warp(arr, inv_fn, out_shape, interpolation="nearest", fill=0):
    """Generic inverse-mapped warp: inv_fn(xx, yy) -> (src_x, src_y)."""
    H, W = arr.shape[:2]
    H_out, W_out = out_shape
    yy, xx = np.meshgrid(np.arange(H_out), np.arange(W_out), indexing="ij")
    src_x, src_y = inv_fn(xx.astype(np.float64), yy.astype(np.float64))
    out = np.full((H_out, W_out) + arr.shape[2:], fill,
                  dtype=np.float64 if interpolation == "bilinear"
                  else arr.dtype)
    if interpolation == "bilinear":
        x0 = np.floor(src_x).astype(np.int64)
        y0 = np.floor(src_y).astype(np.int64)
        fx = src_x - x0
        fy = src_y - y0
        total = np.zeros((H_out, W_out) + arr.shape[2:], np.float64)
        wsum = np.zeros((H_out, W_out), np.float64)
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                w = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
                vals = np.zeros_like(total)
                vals[ok] = arr[yi[ok], xi[ok]]
                if arr.ndim == 3:
                    total += vals * w[..., None] * ok[..., None]
                else:
                    total += vals * w * ok
                wsum += w * ok
        inside = wsum > 1e-9
        if arr.ndim == 3:
            out[inside] = total[inside] / wsum[inside][..., None]
        else:
            out[inside] = total[inside] / wsum[inside]
        return out.astype(arr.dtype)
    xi = np.round(src_x).astype(np.int64)
    yi = np.round(src_y).astype(np.int64)
    ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    out[ok] = arr[yi[ok], xi[ok]]
    return out


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    arr, back = _hwc(img)
    H, W = arr.shape[:2]
    a = np.deg2rad(angle)
    c, s = np.cos(a), np.sin(a)
    cy, cx = ((H - 1) / 2.0, (W - 1) / 2.0) if center is None \
        else (center[1], center[0])
    if expand:
        H_out = int(np.ceil(abs(H * c) + abs(W * s)))
        W_out = int(np.ceil(abs(W * c) + abs(H * s)))
    else:
        H_out, W_out = H, W
    oy, ox = (H_out - 1) / 2.0, (W_out - 1) / 2.0

    def inv(xx, yy):
        return (c * (xx - ox) + s * (yy - oy) + cx,
                -s * (xx - ox) + c * (yy - oy) + cy)

    return back(_inverse_warp(arr, inv, (H_out, W_out), interpolation, fill))


def affine(img, angle, translate, scale, shear, interpolation="nearest",
           fill=0, center=None):
    """reference functional.affine: rotation+translate+scale+shear about
    the center; inverse-mapped sampling."""
    arr, back = _hwc(img)
    H, W = arr.shape[:2]
    cy, cx = ((H - 1) / 2.0, (W - 1) / 2.0) if center is None \
        else (center[1], center[0])
    a = np.deg2rad(angle)
    sx, sy = [np.deg2rad(s) for s in (shear if isinstance(
        shear, (list, tuple)) else (shear, 0.0))]
    tx, ty = translate
    # forward matrix M = T(center) R S Shear T(-center) + translate
    R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    Sh = np.array([[1, np.tan(sx)], [np.tan(sy), 1]])
    M = scale * (R @ Sh)
    Minv = np.linalg.inv(M)

    def inv(xx, yy):
        dx = xx - cx - tx
        dy = yy - cy - ty
        src_x = Minv[0, 0] * dx + Minv[0, 1] * dy + cx
        src_y = Minv[1, 0] * dx + Minv[1, 1] * dy + cy
        return src_x, src_y

    return back(_inverse_warp(arr, inv, (H, W), interpolation, fill))


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """reference functional.perspective: warp so startpoints map to
    endpoints (homography solved in least squares)."""
    arr, back = _hwc(img)
    H, W = arr.shape[:2]
    A, b = [], []
    # solve the INVERSE homography directly: end -> start
    for (sx, sy), (ex, ey) in zip(startpoints, endpoints):
        A.append([ex, ey, 1, 0, 0, 0, -sx * ex, -sx * ey])
        b.append(sx)
        A.append([0, 0, 0, ex, ey, 1, -sy * ex, -sy * ey])
        b.append(sy)
    h = np.linalg.lstsq(np.asarray(A, np.float64),
                        np.asarray(b, np.float64), rcond=None)[0]
    Hm = np.append(h, 1.0).reshape(3, 3)

    def inv(xx, yy):
        den = Hm[2, 0] * xx + Hm[2, 1] * yy + Hm[2, 2]
        den = np.where(np.abs(den) < 1e-9, 1e-9, den)
        return ((Hm[0, 0] * xx + Hm[0, 1] * yy + Hm[0, 2]) / den,
                (Hm[1, 0] * xx + Hm[1, 1] * yy + Hm[1, 2]) / den)

    return back(_inverse_warp(arr, inv, (H, W), interpolation, fill))


def adjust_brightness(img, brightness_factor):
    arr, back = _hwc(img)
    f, restore = _as_float_hwc(arr)
    return back(restore(np.clip(f * brightness_factor, 0, 1)))


def adjust_contrast(img, contrast_factor):
    arr, back = _hwc(img)
    f, restore = _as_float_hwc(arr)
    gray = f.mean()
    return back(restore(np.clip(gray + contrast_factor * (f - gray), 0, 1)))


def adjust_hue(img, hue_factor):
    """Shift hue by hue_factor (in [-0.5, 0.5] turns) through HSV."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    arr, back = _hwc(img)
    f, restore = _as_float_hwc(arr)
    import colorsys  # noqa: F401  (doc anchor: same math, vectorized)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    mx = f.max(-1)
    mn = f.min(-1)
    d = mx - mn
    h = np.zeros_like(mx)
    m = d > 1e-12
    rc = np.where(m, (mx - r) / np.where(m, d, 1), 0)
    gc = np.where(m, (mx - g) / np.where(m, d, 1), 0)
    bc = np.where(m, (mx - b) / np.where(m, d, 1), 0)
    h = np.where(mx == r, bc - gc, h)
    h = np.where(mx == g, 2.0 + rc - bc, h)
    h = np.where(mx == b, 4.0 + gc - rc, h)
    h = (h / 6.0) % 1.0
    h = (h + hue_factor) % 1.0
    s = np.where(mx > 1e-12, d / np.where(mx > 1e-12, mx, 1), 0)
    v = mx
    i = np.floor(h * 6.0)
    fr = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * fr)
    t = v * (1 - s * (1 - fr))
    i = i.astype(np.int64) % 6
    out = np.zeros_like(f)
    conds = [(i == 0, (v, t, p)), (i == 1, (q, v, p)), (i == 2, (p, v, t)),
             (i == 3, (p, q, v)), (i == 4, (t, p, v)), (i == 5, (v, p, q))]
    for cond, (rr, gg, bb) in conds:
        out[..., 0] = np.where(cond, rr, out[..., 0])
        out[..., 1] = np.where(cond, gg, out[..., 1])
        out[..., 2] = np.where(cond, bb, out[..., 2])
    return back(restore(out))


def to_grayscale(img, num_output_channels=1):
    arr, back = _hwc(img)
    f, restore = _as_float_hwc(arr)
    gray = (0.299 * f[..., 0] + 0.587 * f[..., 1]
            + 0.114 * f[..., 2])[..., None]
    gray = np.repeat(gray, num_output_channels, axis=-1)
    return back(restore(gray))


def erase(img, i, j, h, w, v, inplace=False):
    from ..core.tensor import Tensor as _T
    if isinstance(img, _T):
        d = img._data.detach().clone()
        if d.dim() == 3 and d.shape[0] in (1, 3):
            d[..., i:i + h, j:j + w] = v
        else:
            d[i:i + h, j:j + w] = v
        if inplace:
            img._rebind(lambda old: d, tracked=False)
            return img
        return _T(d)
    arr = np.asarray(img) if inplace else np.array(img)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[2] not in (1, 3):
        arr[:, i:i + h, j:j + w] = v
    else:
        arr[i:i + h, j:j + w] = v
    return arr


class RandomAffine(BaseTransform):
    """reference transforms.RandomAffine over functional.affine."""

    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-abs(degrees), abs(degrees))
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        # shear: scalar -> x range; 2 values -> x range; 4 -> x + y ranges
        if isinstance(shear, numbers.Number):
            shear = (-abs(shear), abs(shear))
        self.shear = tuple(shear) if shear is not None else None
        self.interpolation = interpolation
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        angle = np.random.uniform(*self.degrees)
        arr = np.asarray(img)
        H, W = (arr.shape[1:3] if arr.ndim == 3 and arr.shape[0] in (1, 3)
                and arr.shape[2] not in (1, 3) else arr.shape[:2])
        if self.translate is not None:
            tx = np.random.uniform(-self.translate[0], self.translate[0]) * W
            ty = np.random.uniform(-self.translate[1], self.translate[1]) * H
        else:
            tx = ty = 0.0
        sc = np.random.uniform(*self.scale) if self.scale else 1.0
        if self.shear:
            sh_x = np.random.uniform(*self.shear[:2])
            sh_y = np.random.uniform(*self.shear[2:4]) \
                if len(self.shear) >= 4 else 0.0
            sh = (sh_x, sh_y)
        else:
            sh = (0.0, 0.0)
        return affine(img, angle, (tx, ty), sc, sh, self.interpolation,
                      self.fill, self.center)


class RandomPerspective(BaseTransform):
    """reference transforms.RandomPerspective over functional.perspective."""

    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.interpolation = interpolation
        self.fill = fill

    def _apply_image(self, img):
        if np.random.rand() > self.prob:
            return np.asarray(img)
        arr = np.asarray(img)
        chw = (arr.ndim == 3 and arr.shape[0] in (1, 3)
               and arr.shape[2] not in (1, 3))
        H, W = (arr.shape[1:3] if chw else arr.shape[:2])
        d = self.distortion_scale
        half_h, half_w = int(H * d / 2), int(W * d / 2)
        tl = (np.random.randint(0, half_w + 1), np.random.randint(0, half_h + 1))
        tr = (W - 1 - np.random.randint(0, half_w + 1),
              np.random.randint(0, half_h + 1))
        br = (W - 1 - np.random.randint(0, half_w + 1),
              H - 1 - np.random.randint(0, half_h + 1))
        bl = (np.random.randint(0, half_w + 1),
              H - 1 - np.random.randint(0, half_h + 1))
        start = [(0, 0), (W - 1, 0), (W - 1, H - 1), (0, H - 1)]
        return perspective(img, start, [tl, tr, br, bl],
                           self.interpolation, self.fill)
