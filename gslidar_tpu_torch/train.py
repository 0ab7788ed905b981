"""Train a scene on the GPU.

    python -m gslidar_tpu_torch.train --config configs/<scene>.yaml \
        [--base_config configs/base.yaml] [--device cuda|cpu] [key=val ...]

The port's counterpart of the root ``train.py`` (``training``, train.py:
95-326), for what the port has so far: it builds the scene, initializes
the gaussians from its point cloud (``create_from_pcd``) and the ray-drop
prior, and takes ``iterations`` training steps, each on one camera picked
with the same numpy random stream and the same self-supervision time
shift as the JAX package (train.py:287-297), with the SH degree schedule
(train.py:285), printing the loss every 10 steps.

Densify and prune, opacity resets, evaluation, checkpoints and the
coarse-to-fine rescale are not ported yet, so a run that would reach the
densification window (``iterations >= densify_from_iter``) raises.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gslidar_tpu_torch.engine.train import (camera_to_batch,
                                            init_train_state,
                                            make_train_step)
from gslidar_tpu_torch.models.gaussians import GaussianAux, create_from_pcd
from gslidar_tpu_torch.models.raydrop_prior import init_raydrop_prior
from gslidar_tpu_torch.render import (build_scene, gaussian_config,
                                      raster_settings)


def training(args, device, init_params=None, on_step=None):
    """Train ``args.iterations`` steps from iteration 1.

    ``init_params`` (a params dict on ``device``) replaces the gaussians
    ``create_from_pcd`` would make; ``on_step(iteration, state, loss, log,
    grads)`` is called after each step. Returns (state, scene, losses):
    the final TrainState and the loss of every step.
    """
    if args.iterations >= args.densify_from_iter:
        raise NotImplementedError(
            f"iterations={args.iterations} reaches densify_from_iter="
            f"{args.densify_from_iter}: densification is not ported to "
            f"gslidar_tpu_torch yet")
    os.makedirs(args.model_path, exist_ok=True)
    scene = build_scene(args, shuffle=bool(args.shuffle))
    with open(os.path.join(args.model_path, "scale_factor.txt"), "w") as f:
        f.write(str(args.scale_factor))

    cfg = gaussian_config(args)
    if init_params is None:
        pts, colors, _normals, times = scene.scene_info.point_cloud
        params, aux = create_from_pcd(pts, colors, times, cfg,
                                      seed=args.seed, device=device)
    else:
        params = init_params
        aux = GaussianAux.zeros(params["xyz"].shape[0], device)
    w, h = scene.get_wh()
    state = init_train_state(params, aux, init_raydrop_prior(h, w, device))
    bg = torch.tensor([1.0, 1.0, 1.0, 1.0] if args.white_background
                      else [0.0, 0.0, 0.0, 1.0], device=device)
    train_step = make_train_step(args, cfg, raster_settings(args, h, w), bg)

    rng = np.random.default_rng(args.seed)
    viewpoint_stack = []
    losses = []
    ema = 0.0
    for iteration in range(1, args.iterations + 1):
        sh_degree = min(iteration // args.sh_increase_interval,
                        args.sh_degree)
        cams = scene.get_train_cameras()
        if not viewpoint_stack:
            viewpoint_stack = list(range(len(cams)))
        cam = cams[viewpoint_stack.pop(rng.integers(len(viewpoint_stack)))]
        if rng.random() < args.lambda_self_supervision:
            time_shift = 3 * (rng.random() - 0.5) * scene.time_interval
        else:
            time_shift = 0.0
        # the densification window (densify_from_iter, densify_until_iter)
        # is not reached, so its statistics stay off, as in the JAX loop
        state, loss, log, grads = train_step(
            state, camera_to_batch(cam, device), iteration, sh_degree,
            float(time_shift), stats_on=False)
        losses.append(loss)
        if on_step is not None:
            on_step(iteration, state, loss, log, grads)
        if iteration % 10 == 0 or iteration == 1:
            ema = 0.4 * float(loss) + 0.6 * ema
            print(f"[{iteration}/{args.iterations}] loss={ema:.5f} "
                  f"pts={params['xyz'].shape[0]} "
                  f"instances={log['num_pairs']}", flush=True)
    return state, scene, [float(x) for x in losses]


def load_args(config, base_config="configs/base.yaml", overrides=()):
    """The run's config: base_config <- config <- ``key=val`` overrides,
    merged as the root train.py merges them (t_grad off for a static
    scene)."""
    from gslidar_tpu_torch.config import Config, load_run_config
    args = load_run_config(base_config, config, list(overrides))
    if not args.dynamic:
        Config.update(args, "t_grad", False)
    return args


def main(argv=None):
    from gslidar_tpu_torch.utils.general import seed_everything

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--base_config", default="configs/base.yaml")
    parser.add_argument("--device", default="cuda")
    known, rest = parser.parse_known_args(argv)
    args = load_args(known.config, known.base_config, rest)
    device = torch.device(known.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train with "
                         "the plain PyTorch compositors")
    torch.backends.cuda.matmul.allow_tf32 = False
    seed_everything(args.seed)
    state, _, losses = training(args, device)
    print(f"trained {len(losses)} steps of {state.params['xyz'].shape[0]} "
          f"gaussians: loss {losses[0]:.5f} -> {losses[-1]:.5f}")


if __name__ == "__main__":
    main()
