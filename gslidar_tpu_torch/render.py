"""Serve a reconstructed scene as LiDAR panoramas on the GPU.

    python -m gslidar_tpu_torch.render --config configs/<scene>.yaml \
        --checkpoint <model_path>/ckpt/chkpnt<iter>.npz --out <dir> [key=val]

The port's counterpart of ``train.py --test_only`` without the metrics:
it loads a ``gslidar_tpu`` checkpoint, builds the scene's test cameras and
renders every front/back pair as one 360-degree panorama. For each pair it
writes what ``complete_eval(save_raydrop_data=True)`` writes
(gslidar_tpu/engine/evaluate.py:214-223):

    <out>/render_test/<id>.npy   [3, h, 2w] raydrop, intensity, depth mix
    <out>/gt/<id>.npy            [3, h, 2w] GT raydrop, intensity, depth
    <out>/points_test/<id>.npy   [N, 3] point cloud in meters: the mix
                                 depth, ray-dropped pixels removed

``model_path`` (default: the checkpoint's ``ckpt/`` parent) must hold the
training run's ``scale_factor.txt`` and, for KITTI-360 and OPV2V scenes,
``transform_poses_pca.npz`` and ``points3d.ply``. ``render_scene`` is the
work itself.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gslidar_tpu_torch.engine.evaluate import (make_eval_render360,
                                               render_range_map)
from gslidar_tpu_torch.models.gaussians import GaussianConfig
from gslidar_tpu_torch.ops.pano import pano_to_lidar
from gslidar_tpu_torch.raster.settings import RasterSettings


def raster_settings(args, h: int, w: int) -> RasterSettings:
    return RasterSettings(
        height=h, width=w, vfov=tuple(args.vfov), hfov=tuple(args.hfov),
        num_extra_features=4,
        tight_rects=bool(args.get("raster_tight_rects", True)))


def gaussian_config(args, no_time_split=None) -> GaussianConfig:
    """The model config of a run; ``no_time_split`` overrides the run's
    (the training loop's time-split flip, root train.py:81-92)."""
    return GaussianConfig(
        sh_degree=args.sh_degree, cycle=args.cycle,
        velocity_decay=args.velocity_decay,
        time_duration=tuple(args.time_duration), t_init=args.t_init,
        no_time_split=(args.get("no_time_split", True)
                       if no_time_split is None else no_time_split),
        t_grad=args.get("t_grad", True), contract=args.get("contract", True),
        big_point_threshold=args.get("big_point_threshold", 0.1),
        random_init_point=args.random_init_point,
        percent_dense=args.get("percent_dense", 0.01))


def render_scene(args, params, alive, prior, cameras, device):
    """Render each (front, back) camera pair of ``cameras`` as a 360-degree
    range map (one wrap_x pass per pair). Returns one dict per pair:
    colmap_id, depth [3, h, 2w] (mix, mean, median), intensity, raydrop,
    gt_depth, gt_intensity (all [1, h, 2w]), points [N, 3] in meters, and
    num_pairs (instances composited)."""
    h, w = cameras[0].height, cameras[0].width
    settings = raster_settings(args, h, w)
    cfg = gaussian_config(args)
    bg = torch.tensor([1.0, 1.0, 1.0, 1.0] if args.get("white_background")
                      else [0.0, 0.0, 0.0, 1.0], device=device)
    sh_degree = int(args.get("eval_sh_degree", args.sh_degree))
    sf = float(args.scale_factor)

    render360 = make_eval_render360(args, cfg, settings, bg)
    instances = []

    def ev360(*a):
        pkg = render360(*a)
        instances.append(pkg.num_pairs)
        return pkg

    results = []
    for i in range(len(cameras) // 2):
        front, back = cameras[2 * i], cameras[2 * i + 1]
        depth, inten, raydrop, gt_d, gt_i = render_range_map(
            args, front, back, None, params, alive, prior, sh_degree, [h, w],
            eval_render360=ev360)
        keep = np.where(raydrop > 0.5, 0.0, 1.0)
        pts, mask = pano_to_lidar(
            torch.as_tensor(depth[[0]] * keep / sf), args.vfov, (-180, 180))
        results.append(dict(
            colmap_id=front.colmap_id, depth=depth, intensity=inten,
            raydrop=raydrop, gt_depth=gt_d, gt_intensity=gt_i,
            points=pts[mask].numpy(), num_pairs=instances[-1]))
    return results


def save_outputs(outdir: str, split: str, results) -> None:
    for sub in (f"render_{split}", "gt", f"points_{split}"):
        os.makedirs(os.path.join(outdir, sub), exist_ok=True)
    for r in results:
        name = f"{r['colmap_id']:03d}.npy"
        np.save(os.path.join(outdir, f"render_{split}", name),
                np.concatenate([r["raydrop"], r["intensity"],
                                r["depth"][[0]]]))
        gt_raydrop = np.where(r["gt_depth"] > 0, 0.0, 1.0)
        np.save(os.path.join(outdir, "gt", name),
                np.concatenate([gt_raydrop, r["gt_intensity"],
                                r["gt_depth"]]).astype(np.float32))
        np.save(os.path.join(outdir, f"points_{split}", name), r["points"])


def build_scene(args, shuffle: bool = False):
    from gslidar_tpu_torch.data.kitti360 import read_kitti360_info
    from gslidar_tpu_torch.data.opv2v import (read_opv2v_info,
                                              read_opv2v_info_spoof_remove)
    from gslidar_tpu_torch.data.scene import Scene
    from gslidar_tpu_torch.data.synthetic import read_synthetic_info
    loaders = {"Kitti360": read_kitti360_info,
               "Synthetic": read_synthetic_info,
               "OPV2V": read_opv2v_info,
               "OPV2V_SR": read_opv2v_info_spoof_remove}
    if args.scene_type not in loaders:
        raise ValueError(f"unknown scene_type {args.scene_type!r} (have "
                         f"{sorted(loaders)})")
    return Scene(args, loaders[args.scene_type](args), shuffle=shuffle)


def main(argv=None):
    from gslidar_tpu_torch.config import Config, load_run_config
    from gslidar_tpu_torch.engine.checkpoint import load_checkpoint

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--base_config", default="configs/base.yaml")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default="cuda")
    known, rest = parser.parse_known_args(argv)

    args = load_run_config(known.base_config, known.config, rest)
    Config.update(args, "test_only", True)
    if not any(a.startswith("model_path=") for a in rest):
        Config.update(args, "model_path", os.path.dirname(
            os.path.dirname(os.path.abspath(known.checkpoint))))
    with open(os.path.join(args.model_path, "scale_factor.txt")) as f:
        Config.update(args, "scale_factor", float(f.read()))
    device = torch.device(known.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to render with "
                         "the plain PyTorch compositor")

    params, alive, prior, iteration = load_checkpoint(known.checkpoint,
                                                      device)
    Config.update(args, "eval_sh_degree",
                  min(iteration // args.sh_increase_interval,
                      args.sh_degree))
    # the resolution the checkpoint was trained at (train.py --test_only)
    scales = list(args.resolution_scales)
    idx = max(0, len(scales) - 1 - iteration // args.scale_increase_interval)
    Config.update(args, "resolution_scales", [scales[idx]])
    scene = build_scene(args)
    cameras = scene.get_test_cameras(scales[idx])
    results = render_scene(args, params, alive, prior, cameras, device)
    save_outputs(known.out, "test", results)
    print(f"rendered {len(results)} panoramas from {known.checkpoint} "
          f"(iteration {iteration}) into {known.out}")


if __name__ == "__main__":
    main()
