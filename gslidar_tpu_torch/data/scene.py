"""Scene container: per-scale camera lists with projected GT panoramas
(port of gslidar_tpu/data/scene.py; reference scene/__init__.py).

The JAX module reaches JAX through its ``ops/pano.py``; this one uses the
port's numpy ``project_points_to_pano`` and its own copies of the camera
types and the pair shuffle.
"""

from __future__ import annotations

import numpy as np

from gslidar_tpu_torch.data.cameras import Camera, CameraInfo, SceneInfo
from gslidar_tpu_torch.ops.pano import project_points_to_pano
from gslidar_tpu_torch.utils.general import shuffle_by_pairs


def load_cam(args, idx: int, info: CameraInfo, resolution_scale) -> Camera:
    """CameraInfo -> Camera with projected GT range/intensity panoramas
    (reference utils/camera_utils.py:158-235)."""
    orig_h, orig_w = args.hw
    global_down = 1 if args.resolution == -1 else orig_w / args.resolution
    scale = float(global_down) * float(resolution_scale)
    w, h = int(orig_w / scale), int(orig_h / scale)

    pts_depth = pts_intensity = None
    if info.pointcloud_camera is not None:
        intensity = info.intensity
        if intensity is None:
            intensity = np.ones_like(info.pointcloud_camera[:, 0])
        pts_depth, pts_intensity = project_points_to_pano(
            info.pointcloud_camera, intensity, h, w,
            tuple(args.vfov), tuple(args.hfov))

    return Camera(colmap_id=info.uid, uid=idx, R=info.R, T=info.T,
                  vfov=tuple(args.vfov), hfov=tuple(args.hfov),
                  width=w, height=h, timestamp=info.timestamp,
                  pts_depth=pts_depth, pts_intensity=pts_intensity,
                  towards=info.towards, sequence_id=info.sequence_id)


def camera_list_from_infos(cam_infos, resolution_scale, args):
    return [load_cam(args, i, c, resolution_scale)
            for i, c in enumerate(cam_infos)]


class Scene:
    """Reference scene/__init__.py:25-103 semantics."""

    def __init__(self, args, scene_info: SceneInfo, shuffle=True):
        self.model_path = args.model_path
        self.scene_info = scene_info
        self.time_interval = scene_info.time_interval

        if shuffle:
            shuffle_by_pairs(scene_info.train_cameras)
            shuffle_by_pairs(scene_info.test_cameras)

        self.cameras_extent = scene_info.nerf_normalization["radius"]
        self.resolution_scales = list(args.resolution_scales)
        self.scale_index = len(self.resolution_scales) - 1
        self.train_cameras = {}
        self.test_cameras = {}
        self.wh = {}
        for rs in self.resolution_scales:
            self.train_cameras[rs] = camera_list_from_infos(
                scene_info.train_cameras, rs, args)
            self.test_cameras[rs] = camera_list_from_infos(
                scene_info.test_cameras, rs, args)
            cam0 = self.train_cameras[rs][0]
            self.wh[rs] = (cam0.width, cam0.height)

    def up_scale(self):
        self.scale_index = max(0, self.scale_index - 1)

    def get_train_cameras(self):
        return self.train_cameras[self.resolution_scales[self.scale_index]]

    def get_test_cameras(self, scale=1.0):
        return self.test_cameras[scale]

    def get_wh(self):
        return self.wh[self.resolution_scales[self.scale_index]]
