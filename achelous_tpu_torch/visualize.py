"""Result rendering (a copy of achelous_tpu/visualize.py): the drawing half
of the reference's detect_image (achelous.py:324-448): alpha-blend the
drivable-area and waterline masks onto the frame, draw detection boxes
with class/score labels (skipping the 'sailor' class exactly like
achelous.py:402-403), and scatter radar points.  Pillow and matplotlib are
imported where they are used.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

# per-class box colors (hsv-spread like the reference's colors list)
_PALETTE = [(255, 56, 56), (255, 157, 151), (255, 112, 31), (255, 178, 29),
            (207, 210, 49), (72, 249, 10), (26, 147, 52), (61, 219, 134),
            (0, 212, 187), (44, 153, 168), (0, 194, 255), (52, 69, 147)]

DRIVABLE_COLOR = (0, 255, 128)     # semantic class 8 overlay
WATERLINE_COLOR = (255, 64, 64)


def render_detection(image, result: Dict, class_names: Sequence[str],
                     skip_classes: Sequence[str] = ("sailor",),
                     mask_alpha: float = 0.45):
    """PIL image + `AchelousPredictor.detect()` result -> annotated PIL
    image."""
    from PIL import Image, ImageDraw

    img = image.convert("RGB")
    arr = np.asarray(img).astype(np.float32)

    drivable = result.get("drivable")
    if drivable is not None and drivable.shape == arr.shape[:2]:
        m = (drivable == 8)[..., None]
        arr = np.where(m, arr * (1 - mask_alpha) +
                       np.asarray(DRIVABLE_COLOR, np.float32) * mask_alpha,
                       arr)
    wl = result.get("waterline")
    if wl is not None and wl.shape == arr.shape[:2]:
        m = (wl > 0)[..., None]
        arr = np.where(m, arr * (1 - mask_alpha) +
                       np.asarray(WATERLINE_COLOR, np.float32) * mask_alpha,
                       arr)
    out = Image.fromarray(arr.astype(np.uint8))
    draw = ImageDraw.Draw(out)
    thickness = max(1, int(sum(out.size) / 900))
    for box, score, cls in zip(result["boxes"], result["scores"],
                               result["classes"]):
        name = class_names[int(cls)] if int(cls) < len(class_names) else str(cls)
        if name in skip_classes:       # reference achelous.py:402-403
            continue
        y1, x1, y2, x2 = [float(v) for v in box]  # boxes are y1,x1,y2,x2
        color = _PALETTE[int(cls) % len(_PALETTE)]
        for t in range(thickness):
            draw.rectangle([x1 - t, y1 - t, x2 + t, y2 + t], outline=color)
        label = f"{name} {float(score):.2f}"
        tw = draw.textlength(label)
        draw.rectangle([x1, max(y1 - 12, 0), x1 + tw + 2, max(y1, 12)],
                       fill=color)
        draw.text((x1 + 1, max(y1 - 12, 0)), label, fill=(0, 0, 0))
    return out


PC_CLASS_COLORS = ["b", "g", "r", "m", "y", "orange", "violet", "peru"]


def scatter_pointcloud(points_uv: np.ndarray, labels: np.ndarray,
                       out_path: str, image=None):
    """Radar point-cloud scatter colored by predicted class (reference
    achelous.py:265-271 + radar_pc_cls_color, achelous.py:96)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4.5))
    if image is not None:
        ax.imshow(image)
    for c in range(len(PC_CLASS_COLORS)):
        m = labels == c
        if m.any():
            ax.scatter(points_uv[m, 0], points_uv[m, 1], s=6,
                       c=PC_CLASS_COLORS[c], label=f"class {c}")
    ax.legend(loc="upper right", fontsize=6)
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_path
