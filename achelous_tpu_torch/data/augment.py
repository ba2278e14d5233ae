"""Training-time augmentation: HSV jitter + modality-consistent flip.

A copy of achelous_tpu/data/augment.py (numpy, and Pillow for the HSV
conversion, imported where it is used): the same draws from the same
`np.random.RandomState` in the same order, on the same host arrays
(channels-last, as the dataset emits them).

The reference DEFINES mosaic/mixup/HSV augmentation (utils/dataloader.py:
236-487) but its effective train path never executes it (`get_random_data`
returns before the augment block, :233, and train.py:543-544 passes
train=False, mosaic=False) — almost certainly because those image-only
transforms would silently desynchronize the radar map, the point cloud and
the segmentation masks.  Here augmentation is implemented so every modality
transforms together:

  * HSV jitter (image only — label-free by construction): uniform gains on
    the H/S/V channels, same convention as the reference's dead code
    (dataloader.py:316-330, gains hue=.1 sat=0.7 val=0.4);
  * horizontal flip: image / radar map / seg / waterline flip their width
    axis, boxes mirror cx, raw radar points mirror the projected image
    column u (the splat grid input, radar_feature_map_generate.ipynb cell 6),
    and the point-cloud branch negates the lateral coordinate so per-point
    labels stay valid.

  * mosaic (`mosaic_prob > 0`): a radar-consistent rebuild of the
    reference's dead 4-image mosaic (dataloader.py:236-487).  Four samples
    are composed around a jittered center; unlike the reference — whose
    mosaic could never have worked because the radar map only exists as a
    pre-rasterized offline .npz — the raw radar points go through the SAME
    per-quadrant affine in source (u, v) coordinates and are re-splatted on
    device, so the mosaic radar map is exact rather than a resampled raster.
    See `mosaic_samples`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

SRC_W = 1920          # WaterScenes camera width the radar u column lives in
SRC_H = 1080          # camera height the radar v column lives in
U_COLUMN = 3          # index of u in SPLAT_FEATURES = [range,doppler,rcs,u,v]
V_COLUMN = 4          # index of v


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    hflip_prob: float = 0.5
    hue: float = 0.1              # reference dataloader.py:243 defaults
    sat: float = 0.7
    val: float = 0.4
    pc_lateral_axis: int = 1      # index of the lateral coord in PC_FEATURES
    mosaic_prob: float = 0.0      # 4-sample mosaic (reference default off:
                                  # train.py:543-544 passes mosaic=False)
    mosaic_center: tuple = (0.3, 0.7)   # jitter range of the mosaic center
                                  # (reference min_offset, dataloader.py:260)


def hsv_jitter(image_u8: np.ndarray, rng: np.random.RandomState,
               hue: float, sat: float, val: float) -> np.ndarray:
    """Random H/S/V gains on a uint8 RGB array (dataloader.py:316-330
    semantics: r = uniform(-1,1,3)*[h,s,v]+1; hue wraps, sat/val scale with
    clipping).

    Hue-wrap equivalence: the reference's (dead) cv2 code wraps hue as
    (h_cv * r) % 180 on cv2's 0..179 half-degree wheel; here PIL's 0..255
    wheel wraps as (h_pil * r) % 256.  Both equal (deg * r) mod 360 in
    degree space — h_cv = deg/2 and h_pil = deg*256/360 are linear
    reparameterizations, so the modulus rescales with the wheel.  The only
    residual difference is uint8 quantization granularity (180 vs 256
    levels, < 2 degrees), not the distribution."""
    if hue <= 0 and sat <= 0 and val <= 0:
        return image_u8
    from PIL import Image
    r = rng.uniform(-1, 1, 3) * [hue, sat, val] + 1
    hsv = np.asarray(Image.fromarray(image_u8).convert("HSV"),
                     np.float32)
    h = (hsv[..., 0] * r[0]) % 256
    s = np.clip(hsv[..., 1] * r[1], 0, 255)
    v = np.clip(hsv[..., 2] * r[2], 0, 255)
    out = Image.fromarray(np.stack([h, s, v], -1).astype(np.uint8),
                          mode="HSV").convert("RGB")
    return np.asarray(out)


def hflip_sample(sample: dict, resolution: int,
                 pc_lateral_axis: int = 1, src_w: int = SRC_W) -> dict:
    """Mirror EVERY modality of one (post-letterbox) sample.

    Pure function; applying it twice returns the original sample
    (tests/test_augment.py pins the involution).
    """
    out = dict(sample)
    out["image"] = sample["image"][:, ::-1].copy()
    out["seg"] = sample["seg"][:, ::-1].copy()
    out["wl"] = sample["wl"][:, ::-1].copy()
    boxes = sample["boxes"].copy()
    if len(boxes):
        boxes[:, 0] = resolution - boxes[:, 0]     # cx in cxcywh
    out["boxes"] = boxes
    if sample.get("radar_map") is not None:
        out["radar_map"] = sample["radar_map"][:, ::-1].copy()
    pts = sample.get("radar_points")
    if pts is not None:
        pts = pts.copy()
        valid = sample["radar_points_valid"]
        # continuous-coordinate mirror about the frame center (src_w/2), the
        # same convention as the image/radar_map/grid `[:, ::-1]` flips —
        # mirroring about src_w-1 instead would shift boundary points one
        # splat grid cell off the flipped pre-rasterized radar_map (the splat
        # quantizes with floor(u/6); equality pinned in test_augment.py)
        pts[valid, U_COLUMN] = src_w - pts[valid, U_COLUMN]
        out["radar_points"] = pts
    pc = sample.get("pc")
    if pc is not None:
        pc = pc.copy()
        pc[:, pc_lateral_axis] = -pc[:, pc_lateral_axis]
        out["pc"] = pc
    return out


def augment_sample(sample: dict, resolution: int,
                   acfg: Optional[AugmentConfig],
                   rng: np.random.RandomState) -> dict:
    """Flip branch of the per-sample augmentation (HSV happens earlier, on
    the raw uint8 image — see WaterScenesDataset.__getitem__)."""
    if acfg is None:
        return sample
    if rng.rand() < acfg.hflip_prob:
        sample = hflip_sample(sample, resolution, acfg.pc_lateral_axis)
    return sample


def _resize_bilinear(arr: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Half-pixel-center bilinear resize of [H, W, C] float arrays (host-side
    numpy; matches cv2.INTER_LINEAR / jax.image 'linear' conventions)."""
    h, w = arr.shape[:2]
    ys = np.clip((np.arange(oh, dtype=np.float64) + 0.5) * h / oh - 0.5,
                 0, h - 1)
    xs = np.clip((np.arange(ow, dtype=np.float64) + 0.5) * w / ow - 0.5,
                 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0).astype(arr.dtype)[:, None, None]
    wx = (xs - x0).astype(arr.dtype)[None, :, None]
    top = arr[y0][:, x0] * (1 - wx) + arr[y0][:, x1] * wx
    bot = arr[y1][:, x0] * (1 - wx) + arr[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _resize_nearest(arr: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Half-pixel-center nearest resize (labels / sparse rasters)."""
    h, w = arr.shape[:2]
    yi = np.minimum(((np.arange(oh) + 0.5) * h / oh).astype(np.int64), h - 1)
    xi = np.minimum(((np.arange(ow) + 0.5) * w / ow).astype(np.int64), w - 1)
    return arr[yi][:, xi]


def mosaic_samples(samples: List[dict], resolution: int,
                   rng: np.random.RandomState,
                   center_range: tuple = (0.3, 0.7),
                   src_w: int = SRC_W, src_h: int = SRC_H) -> dict:
    """Compose 4 post-letterbox samples into one, EVERY modality together.

    Radar-consistent rebuild of the reference's dead mosaic
    (utils/dataloader.py:236-487, center jitter :260).  Each sample is
    anisotropically squashed into one quadrant of a jittered-center 2x2
    grid:

      * image: bilinear into its quadrant (already normalized floats);
      * seg / waterline masks: nearest (label-preserving);
      * boxes (cxcywh, letterbox coords): exact per-quadrant affine —
        no crop/clip step is needed because the whole frame lands inside
        its quadrant (the reference crops because it also scale-jitters);
      * raw radar points: the SAME affine applied in source (u, v)
        coordinates — the splat grid is an axis-aligned scaling of the
        source frame (ops/radar_splat._indices: cell = floor(u·r/src_w)),
        so  u' = u·sx + x0·src_w/r  lands the point exactly in the
        quadrant cell the image content moved to; the on-device re-splat
        then yields an exact mosaic radar map (unavailable to the
        reference, whose map only existed as an offline raster);
      * pre-rasterized radar_map (npz path): nearest into the quadrant —
        the best raster-space approximation (documented lossiness; the
        points path is exact);
      * point cloud branch: the PRIMARY sample's cloud is kept unchanged —
        PointNet consumes scene-space (x, y, z, v, rcs) with per-point
        labels and never sees image geometry, and overlaying four scenes'
        clouds has no physical meaning (per-column L2 normalization is
        also per-frame, dataloader.py:137-141).

    The merged point set is subsampled without replacement back to the
    fixed per-sample capacity when the four frames exceed it.
    """
    assert len(samples) == 4
    r = resolution
    lo, hi = center_range
    cx = int(round(r * rng.uniform(lo, hi)))
    cy = int(round(r * rng.uniform(lo, hi)))
    quads = ((0, 0, cx, cy), (cx, 0, r, cy), (0, cy, cx, r), (cx, cy, r, r))

    s0 = samples[0]
    out = {"name": s0["name"] + "_mosaic", "pc": s0["pc"].copy(),
           "pc_labels": s0["pc_labels"].copy()}
    image = np.zeros_like(s0["image"])
    seg = np.zeros_like(s0["seg"])
    wl = np.zeros_like(s0["wl"])
    radar_map = (np.zeros_like(s0["radar_map"])
                 if s0.get("radar_map") is not None else None)
    boxes_all, pts_all = [], []

    for s, (x0, y0, x1, y1) in zip(samples, quads):
        qw, qh = x1 - x0, y1 - y0
        if qw <= 0 or qh <= 0:
            continue
        sx, sy = qw / r, qh / r
        image[y0:y1, x0:x1] = _resize_bilinear(s["image"], qh, qw)
        seg[y0:y1, x0:x1] = _resize_nearest(s["seg"], qh, qw)
        wl[y0:y1, x0:x1] = _resize_nearest(s["wl"], qh, qw)
        if radar_map is not None and s.get("radar_map") is not None:
            radar_map[y0:y1, x0:x1] = _resize_nearest(s["radar_map"], qh, qw)

        boxes = np.asarray(s["boxes"], np.float32).reshape(-1, 5).copy()
        if len(boxes):
            boxes[:, 0] = boxes[:, 0] * sx + x0
            boxes[:, 1] = boxes[:, 1] * sy + y0
            boxes[:, 2] *= sx
            boxes[:, 3] *= sy
            boxes = boxes[(boxes[:, 2] > 1) & (boxes[:, 3] > 1)]
            boxes_all.append(boxes)

        pts = s.get("radar_points")
        if pts is not None:
            p = pts[s["radar_points_valid"]].copy()
            if len(p):
                p[:, U_COLUMN] = p[:, U_COLUMN] * sx + x0 * (src_w / r)
                p[:, V_COLUMN] = p[:, V_COLUMN] * sy + y0 * (src_h / r)
                pts_all.append(p)

    out["image"] = image
    out["seg"] = seg
    out["wl"] = wl
    out["radar_map"] = radar_map
    out["boxes"] = (np.concatenate(boxes_all, 0) if boxes_all
                    else np.zeros((0, 5), np.float32))

    cap = s0["radar_points"].shape[0]
    merged = (np.concatenate(pts_all, 0) if pts_all
              else np.zeros((0, 5), np.float32))
    if len(merged) > cap:
        merged = merged[rng.choice(len(merged), cap, replace=False)]
    radar_points = np.zeros((cap, s0["radar_points"].shape[1]), np.float32)
    radar_points_valid = np.zeros((cap,), bool)
    radar_points[:len(merged)] = merged
    radar_points_valid[:len(merged)] = True
    out["radar_points"] = radar_points
    out["radar_points_valid"] = radar_points_valid
    return out
