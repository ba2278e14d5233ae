"""A small WaterScenes-layout tree of random frames, for runs of the data
pipeline, `fit` and the CLI without the dataset.

    <root>/train.txt, val.txt   "<image path> x1,y1,x2,y2,cls ..." a line
    <root>/images/<name>.jpg    RGB camera frames
    <root>/semantic/<name>.png  semantic labels (9 classes, some >= 9)
    <root>/waterline/<name>.png waterline labels
    <root>/radar/<name>.csv     raw radar points: range, doppler, rcs, u, v
                                (pixels of a 1920x1080 frame), x, y, z,
                                comp_velocity and a point label

No `radar_map/` is written, so the radar map is splatted from the CSV's
points on the device.  A few points share a splat cell, and a few lie
outside the frame.  Pillow writes the images.
"""
from __future__ import annotations

import os

import numpy as np

CSV_COLUMNS = ("range", "doppler", "rcs", "u", "v", "x", "y", "z",
               "comp_velocity", "label")


def write_radar_csv(path: str, points: int,
                    rng: np.random.RandomState) -> str:
    """One frame's radar CSV of `points` rows in CSV_COLUMNS, (u, v) on
    WaterScenes' 1920x1080 camera: the first four points in one cell, one
    point left of the frame and one below it."""
    u = rng.uniform(0, 1920, points)
    v = rng.uniform(0, 1080, points)
    u[:4], v[:4] = 600.5, 300.2                    # one cell, four times
    u[4], v[5] = -12.0, 1200.0                     # outside the frame
    table = np.stack([rng.uniform(1, 80, points),
                      rng.uniform(-5, 5, points),
                      rng.uniform(-10, 20, points), u, v,
                      rng.uniform(1, 80, points),
                      rng.uniform(-20, 20, points),
                      rng.uniform(-1, 3, points),
                      rng.uniform(-5, 5, points),
                      rng.randint(0, 8, points)], 1)
    with open(path, "w") as f:
        f.write(",".join(CSV_COLUMNS) + "\n")
        for row in table:
            f.write(",".join(repr(float(x)) for x in row[:-1])
                    + f",{int(row[-1])}\n")
    return path


def write_tree(root: str, frames: int = 6, size=(128, 72), points: int = 48,
               val: int = 2, seed: int = 0) -> str:
    """Write `frames` frames of `size` (width, height) under `root`: the
    last `val` are listed in val.txt, the others in train.txt.  Returns
    root."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    w, h = size
    dirs = {d: os.path.join(root, d)
            for d in ("images", "semantic", "waterline", "radar")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    lines = []
    for i in range(frames):
        name = f"frame{i:03d}"
        img = rng.randint(0, 255, (h, w, 3), np.uint8)
        img[h // 2:] = (img[h // 2:] * 0.4
                        + np.array([12, 36, 66])).astype(np.uint8)  # water
        path = os.path.join(dirs["images"], name + ".jpg")
        Image.fromarray(img).save(path, quality=95)
        sem = rng.randint(0, 3, (h, w)).astype(np.uint8)
        sem[: h // 8] = 12                             # past num_seg: ignored
        Image.fromarray(sem).save(os.path.join(dirs["semantic"],
                                               name + ".png"))
        wl = np.zeros((h, w), np.uint8)
        wl[h // 2 - 2:h // 2 + 2] = 1
        Image.fromarray(wl).save(os.path.join(dirs["waterline"],
                                              name + ".png"))
        boxes = []
        for _ in range(1 + i % 3):
            x1, y1 = rng.randint(0, w // 2), rng.randint(0, h // 2)
            x2 = min(w - 1, x1 + rng.randint(8, w // 2))
            y2 = min(h - 1, y1 + rng.randint(6, h // 2))
            boxes.append(f"{x1},{y1},{x2},{y2},{rng.randint(0, 7)}")
        lines.append(" ".join([path] + boxes))

        write_radar_csv(os.path.join(dirs["radar"], name + ".csv"), points,
                        rng)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(lines[:frames - val]) + "\n")
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("\n".join(lines[frames - val:]) + "\n")
    return root

