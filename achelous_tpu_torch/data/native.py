"""The host data pipeline's letterbox and radar-CSV parse (counterpart of
achelous_tpu/data/native.py and of native/dataio.cpp).

Each function is the C++ library's, in numpy: `letterbox_image` (bicubic,
Catmull-Rom a = -0.5 with PIL's support scaling when shrinking, gray 128
bars, ImageNet normalisation), `letterbox_mask` (nearest, clipped labels,
0 bars) and `parse_radar_csv`.  Where the repository's
`native/libdataio.so` has been built (`make -C native`), the same
functions go through it by ctypes, as the JAX package's do; so on one host
both packages letterbox with one code.  The numpy letterbox differs from
the C++ one by float32 rounding only (summation order and fused
multiply-adds), the mask and the parse not at all.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "libdataio.so")
MAX_ROWS = 4096


@functools.lru_cache(maxsize=None)
def lib() -> Optional[ctypes.CDLL]:
    """native/libdataio.so bound by ctypes, or None where it is not built."""
    if not os.path.exists(LIB_PATH):
        return None
    so = ctypes.CDLL(LIB_PATH)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    so.letterbox_bicubic_u8.argtypes = [u8p] + [ctypes.c_int] * 2 + [f32p] \
        + [ctypes.c_int] * 6
    so.letterbox_nearest_u8.argtypes = [u8p] + [ctypes.c_int] * 2 + [i32p] \
        + [ctypes.c_int] * 7
    so.letterbox_bicubic_u8.restype = so.letterbox_nearest_u8.restype = None
    so.parse_radar_csv.argtypes = [ctypes.c_char_p, i32p, ctypes.c_int,
                                   f32p, ctypes.c_int]
    so.parse_radar_csv.restype = ctypes.c_int
    return so


def geometry(h_in: int, w_in: int, res: int):
    """(new h, new w, dy, dx) of the letterbox of an h_in x w_in image."""
    scale = min(res / h_in, res / w_in)
    nh, nw = int(h_in * scale), int(w_in * scale)
    return nh, nw, (res - nh) // 2, (res - nw) // 2


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _cubic(x: np.ndarray) -> np.ndarray:
    a = np.float32(-0.5)
    x = np.abs(x)
    near = ((a + 2) * x - (a + 3)) * x * x + 1
    far = ((x - 5) * x + 8) * x * a - 4 * a
    return np.where(x < 1, near, np.where(x < 2, far, 0)).astype(np.float32)


def _bicubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float32 resampling weights, each row summing to 1, as
    dataio.cpp's two passes take them (at most 64 taps a row)."""
    f = np.float32
    scale = f(n_in) / f(n_out)
    stretch = max(scale, f(1.0))
    support = stretch * f(2.0)
    out = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        center = (f(o) + f(0.5)) * scale
        lo = max(int(np.floor(center - support)), 0)
        hi = min(int(np.ceil(center + support)), n_in - 1)
        k = np.arange(lo, lo + min(hi - lo + 1, 64))
        w = _cubic((k.astype(f) + f(0.5) - center) / stretch)
        if w.sum(dtype=f) == 0:
            w, k = np.ones(1, f), k[:1]
        out[o, k] = w / w.sum(dtype=f)
    return out


def letterbox_image(img: np.ndarray, res: int) -> np.ndarray:
    """RGB uint8 [H, W, 3] -> normalised float32 [res, res, 3]."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    nh, nw, dy, dx = geometry(h, w, res)
    so = lib()
    if so is not None:
        out = np.empty((res, res, 3), np.float32)
        so.letterbox_bicubic_u8(_ptr(img, ctypes.c_uint8), h, w,
                                _ptr(out, ctypes.c_float), res, res, nh, nw,
                                dy, dx)
        return out
    out = np.empty((res, res, 3), np.float32)
    out[:] = (np.float32(128.0 / 255.0) - IMAGENET_MEAN) / IMAGENET_STD
    if nh > 0 and nw > 0:
        rows = np.einsum("xw,hwc->hxc", _bicubic_weights(w, nw),
                         img.astype(np.float32))
        win = np.einsum("yh,hxc->yxc", _bicubic_weights(h, nh), rows)
        win = np.clip(win, 0, 255)
        out[dy:dy + nh, dx:dx + nw] = (win / np.float32(255.0)
                                       - IMAGENET_MEAN) / IMAGENET_STD
    return out


def letterbox_mask(mask: np.ndarray, res: int, clip_max: int) -> np.ndarray:
    """Label mask uint8 [H, W] -> int32 [res, res], nearest, labels >=
    clip_max set to clip_max, bars 0."""
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape[:2]
    nh, nw, dy, dx = geometry(h, w, res)
    out = np.zeros((res, res), np.int32)
    so = lib()
    if so is not None:
        so.letterbox_nearest_u8(_ptr(mask, ctypes.c_uint8), h, w,
                                _ptr(out, ctypes.c_int32), res, res, nh, nw,
                                dy, dx, clip_max)
        return out

    def src(n_out, n_in):
        at = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
            * np.float32(n_in) / np.float32(n_out)
        return np.minimum(at.astype(np.int64), n_in - 1)
    win = mask[src(nh, h)][:, src(nw, w)].astype(np.int32)
    out[dy:dy + nh, dx:dx + nw] = np.minimum(win, clip_max)
    return out


def parse_radar_csv(path: str, col_idx: Sequence[int],
                    max_rows: int = MAX_ROWS) -> np.ndarray:
    """The columns `col_idx` of a CSV of floats with a header line ->
    float32 [rows, len(col_idx)], at most `max_rows` rows; a row's missing
    columns read 0, and a line that starts with no number is skipped."""
    idx = np.asarray(col_idx, np.int32)
    so = lib()
    if so is not None:
        out = np.empty((max_rows, len(idx)), np.float32)
        n = so.parse_radar_csv(path.encode(), _ptr(idx, ctypes.c_int32),
                               len(idx), _ptr(out, ctypes.c_float), max_rows)
        if n < 0:
            raise OSError(f"cannot open {path}")
        return out[:n].copy()
    rows = []
    with open(path) as f:
        f.readline()
        for line in f:
            vals = []
            for field in line.split(",")[:int(idx.max(initial=0)) + 1]:
                try:
                    vals.append(np.float32(field))
                except ValueError:
                    break
            if vals:
                rows.append([vals[i] if i < len(vals) else 0.0 for i in idx])
            if len(rows) == max_rows:
                break
    return np.asarray(rows, np.float32).reshape(-1, len(idx))
