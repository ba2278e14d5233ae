"""Radar point-cloud <-> image-plane projection utilities (a copy of
achelous_tpu/utils/pc_projection.py, numpy only).

reference utils_seg_pc/pc_projection.py:6-39 — calibration-file loading and
3D->2D projection used offline to build the (u, v) columns of the radar CSVs
(not in the train path, but part of the dataset-preparation surface).
"""
from __future__ import annotations

import os

import numpy as np


def get_t_camera_radar(dataset_path: str, frame: str) -> np.ndarray:
    """4x4 radar->camera extrinsic from calib/<frame>.txt line 1."""
    with open(os.path.join(dataset_path, "calib", f"{frame}.txt")) as f:
        lines = f.readlines()
    return np.array(lines[0].strip().split(" ")[1:],
                    dtype=np.float32).reshape(4, 4)


def get_camera_projection_matrix(dataset_path: str, frame: str) -> np.ndarray:
    """3x4 camera projection from calib/<frame>.txt line 2."""
    with open(os.path.join(dataset_path, "calib", f"{frame}.txt")) as f:
        lines = f.readlines()
    return np.array(lines[1].strip().split(" ")[1:],
                    dtype=np.float32).reshape(3, 4)


def project_3d_to_2d(points: np.ndarray,
                     projection_matrix: np.ndarray) -> np.ndarray:
    """Homogeneous [N, 4] camera-frame points -> rounded integer [N, 2] uv."""
    if points.shape[-1] != 4:
        raise ValueError(f"{points.shape[-1]} must be 4!")
    uvw = projection_matrix @ points.T
    uvw = uvw / uvw[2]
    return np.round(uvw[:2].T).astype(np.int32)


def project_pcl_to_image(xyz: np.ndarray, t_camera_radar: np.ndarray,
                         camera_projection_matrix: np.ndarray) -> np.ndarray:
    """Radar-frame [N, 3] xyz -> image-plane [N, 2] integer uv."""
    location = np.hstack([xyz, np.ones((xyz.shape[0], 1), xyz.dtype)])
    cam = (t_camera_radar @ location.T).T
    return project_3d_to_2d(cam, camera_projection_matrix)
