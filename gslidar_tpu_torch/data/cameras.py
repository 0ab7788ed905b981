"""Camera containers and scene-level types (the port's copy of
gslidar_tpu/data/cameras.py).

Reference: scene/cameras.py (Camera nn.Module) and scene/scene_utils.py
(CameraInfo/SceneInfo). TPU-native: a Camera is a plain dataclass holding
numpy arrays — no module machinery; the world->camera matrix is stored
row-major (p_cam = M[:3,:3] @ p + M[:3,3]), which is what the rasterizer
consumes directly (the reference stores it transposed for the CUDA kernel,
scene/cameras.py:62).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def get_world2view2(R, t, translate=np.array([0.0, 0.0, 0.0]), scale=1.0):
    """World->camera 4x4 from the COLMAP-style (R stored transposed, T)
    convention (reference utils/graphics_utils.py:30-41)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    return np.float32(np.linalg.inv(C2W))


@dataclasses.dataclass
class CameraInfo:
    """Loader-level record (reference scene/scene_utils.py:15-23)."""
    uid: int
    R: np.ndarray
    T: np.ndarray
    timestamp: float = 0.0
    pointcloud_camera: Optional[np.ndarray] = None
    intensity: Optional[np.ndarray] = None
    towards: Optional[str] = None
    sequence_id: str = "default"


@dataclasses.dataclass
class Camera:
    """Render-ready camera with projected GT panoramas
    (reference scene/cameras.py:18-68)."""
    colmap_id: int
    uid: int
    R: np.ndarray
    T: np.ndarray
    vfov: tuple
    hfov: tuple
    width: int
    height: int
    timestamp: float = 0.0
    pts_depth: Optional[np.ndarray] = None       # [1, h, w]
    pts_intensity: Optional[np.ndarray] = None   # [1, h, w]
    towards: Optional[str] = None
    sequence_id: str = "default"

    def __post_init__(self):
        self.world_view_transform = get_world2view2(self.R, self.T)
        c2w = np.linalg.inv(self.world_view_transform)
        self.camera_center = c2w[:3, 3].astype(np.float32)
        self.c2w = c2w.astype(np.float32)

    @property
    def name(self) -> str:
        return f"{self.uid}={self.sequence_id}@{self.colmap_id}:{self.towards}"

    @property
    def image_width(self):
        return self.width

    @property
    def image_height(self):
        return self.height


@dataclasses.dataclass
class SceneInfo:
    point_cloud: Optional[tuple]        # (points, colors, normals, time)
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str
    time_interval: float = 0.02
    time_duration: tuple = (-0.5, 0.5)


def get_nerfpp_norm(cam_infos):
    """Camera-extent estimate (reference scene/scene_utils.py:35-56)."""
    centers = []
    for cam in cam_infos:
        W2C = get_world2view2(cam.R, cam.T)
        centers.append(np.linalg.inv(W2C)[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    diagonal = np.max(np.linalg.norm(centers - avg, axis=0))
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}
