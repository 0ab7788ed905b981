"""The ``refine`` kind: full-batch epochs of ``gslidar_tpu_torch``'s
ray-drop refinement U-Net, checked against the plain reference's same
epochs (``benchmark/reference/unet.py``).

``Cell`` holds the U-Net, its Adam, the batch, the box masks' generator
and the dropout generator on the card, and takes
``engine/refine.py``'s ``refine_epoch`` from epoch 0 of the one-cycle
schedule: ``call(i)`` is one epoch. The batch is made by ``batch`` from
the configuration and the seed: the GT panoramas of the train pairs
(``scene.py``) and a seeded render error standing in for a trained
model's renders. What the check needs of the program's run is kept in
``record``.

``check`` runs the reference over the same first epochs from the same
seeded weights, masks and dropout draws once the program's state is
freed, and compares:

* ``loss_gap``: epoch 1's |loss - ref| / |ref|;
* ``grad_gap``: epoch 1's gradient of each parameter tensor, the largest
  |norm - ref norm| over the larger of the tensor's reference norm and
  the median tensor's (as the train kind forms it);
* ``bn_stat_gap``: the running means and variances after the checked
  epochs, per tensor the largest |prog - ref| over the largest of the
  reference's change from the start;
* ``change_gap`` and ``descent_gap``: the parameters' change over the
  checked epochs, its norm and its dot product with the reference's
  first gradient, per tensor against the larger of the reference's and
  the median tensor's, over the tensors whose reference gradient is at
  least a thousandth of the median's (the input conv's bias feeds only
  BatchNorms: its gradient is round-off, and Adam moves it by the rate
  in a random direction);
* ``same_inputs``: the initial weights' fingerprint, the batch's, the box
  masks, the dropout generator's seed and its state after the checked
  epochs (its offset, on the card).

The reference computes in float64 (``REF_DTYPE``): the float32 program
against it reads the program's own rounding, where a float32 reference
would add its own, which train-mode BatchNorm's backward amplifies layer
by layer (PERF.md, section 2, has both readings).

The controls put the reference in the program's place, run wrong on
purpose: ``tf32`` runs it in float32 with TF32 allowed, the precision a
card uses for float32 convolutions unless told not to; ``eval_bn``
normalises by the running statistics while training and leaves them, the
shortcut of a fused inference BatchNorm.

The program is imported inside the constructor: nothing of it is loaded
until a cell is built.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from benchmark import refine_counts
from benchmark import scene as S
from benchmark.checks import fingerprint, gap
from benchmark.reference import unet as R

CONTROLS = ("tf32", "eval_bn")
REF_DTYPE = torch.float64


def pairs_layout(w: int):
    """The columns of a 2w-wide panorama that a pair's front and back
    views fill, as complete_eval lays them out."""
    front = torch.arange(w // 2, 3 * w // 2)
    back = torch.cat([torch.arange(3 * w // 2, 2 * w),
                      torch.arange(0, w // 2)])
    return front, back


def project(points, intensity, view, h: int, w: int, vfov, hfov):
    """``scene.project``'s range and intensity panoramas ([1, h, w] each)
    of one camera, with the intensity of returns tied for the nearest
    taken by their largest: ``scene.project`` writes the tied returns'
    intensities by an index assignment whose winner the card leaves open
    (about 1e-4 of the pixels here hold such a tie), and the batch must
    be the same bits in the program's run and in the reference's."""
    p = points @ view[:3, :3].T + view[:3, 3]
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    phi = torch.atan2(x, z)
    theta = torch.atan2(torch.sqrt(x * x + z * z), -y)
    r = torch.sqrt(x * x + y * y + z * z)
    vmax = math.pi / 2 - math.radians(vfov[0])
    vmin = math.pi / 2 - math.radians(vfov[1])
    hmin, hmax = math.radians(hfov[0]), math.radians(hfov[1])
    ti = (theta - vmin) * h / (vmax - vmin)
    pj = (phi - hmin) * w / (hmax - hmin)
    keep = (ti >= -0.5) & (ti < h - 0.5) & (pj >= -0.5) & (pj < w - 0.5)
    flat = torch.round(ti[keep]).long() * w + torch.round(pj[keep]).long()
    r, inten = r[keep], intensity[keep]
    depth = torch.full((h * w,), float("inf"), device=points.device)
    depth.scatter_reduce_(0, flat, r, reduce="amin")
    nearest = r == depth[flat]
    out_i = torch.zeros(h * w, device=points.device)
    out_i.scatter_reduce_(0, flat[nearest], inten[nearest], reduce="amax",
                          include_self=False)
    depth = torch.where(torch.isinf(depth), 0.0, depth)
    return depth.reshape(1, h, w), out_i.reshape(1, h, w)


def batch(config, seed: int, device):
    """(x [B, 3, H, 2W], y [B, 1, H, 2W]) float32 on ``device``: the GT
    panoramas of the configuration's train pairs (the front and back
    cameras of ``scene.train_cameras``, laid out as complete_eval lays a
    pair) and, from ``seed``, the renders that stand in for a trained
    model's (``render_error``)."""
    run = config["run"]
    scene = S.make_scene(dict(config, gaussians=config["returns"]), device)
    world = scene.points * run["scale_factor"]
    h, w = run["hw"]
    front, back = (c.to(device) for c in pairs_layout(w))
    n = len(scene.train_frames)
    depth = torch.zeros(n, 1, h, 2 * w, device=device)
    inten = torch.zeros(n, 1, h, 2 * w, device=device)
    for i, f in enumerate(scene.train_frames):
        centre = S.pose(config, f)
        for towards, cols in ((0, front), (1, back)):
            view = torch.tensor(S.viewmat(centre, towards), device=device)
            d, v = project(world, scene.intensity, view, h, w, run["vfov"],
                           run["hfov"])
            depth[i, :, :, cols] = d
            inten[i, :, :, cols] = v
    del scene, world
    e = config["render_error"]
    g = S.generator(seed, device)
    drop = (depth == 0).to(torch.float32)
    u = torch.rand(4, *drop.shape, generator=g, device=device)
    z = torch.randn(3, *drop.shape, generator=g, device=device)
    seen = torch.where(u[0] < e["raydrop_flip"], 1 - drop, drop)
    raydrop = torch.clamp(0.1 + 0.8 * seen + e["raydrop_std"] * z[0], 0, 1)
    intensity = torch.where(drop > 0, e["dropped_intensity_max"] * u[1],
                            torch.clamp(inten + e["intensity_std"] * z[1],
                                        0, 1))
    lo, hi = e["dropped_depth"]
    rdepth = torch.where(drop > 0, lo + (hi - lo) * u[2],
                         depth * (1 + e["depth_rel_std"] * z[2]))
    x = torch.cat([raydrop, intensity, rdepth], 1).contiguous()
    return x, drop


def host(named) -> dict:
    """Named tensors copied to the host (a fingerprint is summed there, as
    the reference's initial weights are)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in named}


def generator_state(g: torch.Generator) -> bytes:
    return bytes(g.get_state().numpy().tobytes())


class Cell:
    def __init__(self, config, traffic, seed: int, device):
        from gslidar_tpu_torch.engine.refine import adam, refine_epoch
        from gslidar_tpu_torch.models.unet import UNet, init_unet

        self.traffic, self.seed = traffic, seed
        self.epochs = int(config["refine_epochs"])
        self.x, self.y = batch(config, seed, device)
        b, (h, w2) = config["batch"], config["panorama"]
        if tuple(self.x.shape) != (b, 3, h, w2):
            raise ValueError(f"the batch is {tuple(self.x.shape)}, the "
                             f"configuration's {(b, 3, h, w2)}")
        self.model = init_unet(UNet(), torch.Generator().manual_seed(
            int(seed))).to(device).train()
        self.opt = adam(self.model)
        self.dropout = torch.Generator(device=device).manual_seed(int(seed))
        self.rng = np.random.default_rng(int(seed))
        self.refine_epoch = refine_epoch
        self.i = 0
        self.record = {
            "params0": fingerprint(host(self.model.named_parameters())),
            "stats0": fingerprint(host(self.model.named_buffers())),
            "inputs": fingerprint({"x": self.x, "y": self.y}),
            "shape": (b, h, w2)}

    def call(self, i=None):
        loss = self.refine_epoch(self.model, self.opt, self.x, self.y,
                                 self.rng, self.i % self.epochs,
                                 self.epochs, self.dropout)
        self.i += 1
        return loss

    def first_steps(self):
        """The checked epochs, through ``call``: each epoch's loss and box
        mask, epoch 1's gradients, and after the last the parameters, the
        running statistics and the dropout generator's state, on the
        host."""
        from gslidar_tpu_torch.engine.refine import box_mask
        n = int(self.traffic["checked_epochs"])
        ahead = np.random.default_rng(int(self.seed))
        h, w2 = self.x.shape[2:]
        losses, masks = [], []
        for k in range(n):
            masks.append(box_mask(ahead, h, w2))
            losses.append(float(self.call().detach()))
            if k == 0:
                self.record["grad1"] = {
                    name: p.grad.detach().to("cpu", copy=True)
                    for name, p in self.model.named_parameters()}
        self.record.update(
            losses=losses, masks=masks,
            params_end=host(self.model.named_parameters()),
            stats_end=host(self.model.named_buffers()),
            dropout_seed=self.dropout.initial_seed(),
            dropout_state=generator_state(self.dropout))

    traced_calls = 3

    def again(self, i):
        return self.call()

    def free(self):
        self.model = self.opt = self.x = self.y = None


def reference(config, seed: int, epochs: int, device, **kw):
    """The reference's first ``epochs`` epochs from the seeded weights on
    the seeded batch: the record ``check`` compares with the program's."""
    x, y = batch(config, seed, device)
    kw.setdefault("dtype", REF_DTYPE)
    run = R.Run(x, y, seed, int(config["refine_epochs"]), **kw)
    inputs = fingerprint({"x": x, "y": y})
    del x, y
    out = {"params0": fingerprint(run.params0),
           "stats0": fingerprint(run.stats0), "inputs": inputs,
           "losses": [], "masks": []}
    for k in range(epochs):
        loss, mask, grads = run.epoch()
        out["losses"].append(loss)
        out["masks"].append(mask)
        if k == 0:
            out["grad1"] = {n: g.detach().double().cpu()
                            for n, g in grads.items()}
        del grads
    out.update(
        params_start={k: v.double() for k, v in run.params0.items()},
        stats_start={k: v.double() for k, v in run.stats0.items()},
        params_end={k: v.detach().double().cpu() for k, v in run.p.items()},
        stats_end={k: v.double().cpu() for k, v in run.s.items()},
        dropout_seed=run.g.initial_seed(),
        dropout_state=generator_state(run.g))
    return out


def numbers(prog, ref, per_tensor=None) -> dict:
    """The five numbers compared, from the two records; ``per_tensor``, a
    dict, takes each tensor's gradient norm's gap relative to its own."""
    loss_gap = gap(prog["losses"][0], ref["losses"][0],
                   abs(ref["losses"][0]))
    g_ref = {k: float(torch.linalg.vector_norm(v))
             for k, v in ref["grad1"].items()}
    g_prog = {k: float(torch.linalg.vector_norm(v.double()))
              for k, v in prog["grad1"].items()}
    if per_tensor is not None:
        per_tensor.update({k: gap(g_prog[k], v, v) for k, v in g_ref.items()})
    g_med = statistics.median(g_ref.values())
    grad_gap = max(gap(g_prog[k], g_ref[k], max(g_ref[k], g_med))
                   for k in g_ref)
    bn_stat_gap = max(
        float((prog["stats_end"][k].double() - ref["stats_end"][k]).abs()
              .max()) / max(float((ref["stats_end"][k]
                                   - ref["stats_start"][k]).abs().max()),
                            1e-30)
        for k in ref["stats_end"])
    d_prog, d_ref, s_prog, s_ref = {}, {}, {}, {}
    for k, p0 in ref["params_start"].items():
        if g_ref[k] < 1e-3 * g_med:
            continue
        a = (prog["params_end"][k].double() - p0).flatten()
        b = (ref["params_end"][k] - p0).flatten()
        g = ref["grad1"][k].flatten()
        d_prog[k] = float(torch.linalg.vector_norm(a))
        d_ref[k] = float(torch.linalg.vector_norm(b))
        s_prog[k] = float(torch.dot(a, g))
        s_ref[k] = float(torch.dot(b, g))
    d_med = statistics.median(d_ref.values())
    s_med = statistics.median(abs(v) for v in s_ref.values())
    return {
        "loss_gap": loss_gap, "grad_gap": grad_gap,
        "bn_stat_gap": bn_stat_gap,
        "change_gap": max(gap(d_prog[k], d_ref[k], max(d_ref[k], d_med))
                          for k in d_ref),
        "descent_gap": max(gap(s_prog[k], s_ref[k], max(abs(s_ref[k]),
                                                          s_med))
                           for k in s_ref)}


def input_gaps(prog, ref) -> list:
    """The inputs the reference was handed that are not the program's:
    none when ``same_inputs`` is 0."""
    masks = (len(prog["masks"]) == len(ref["masks"])
             and all(np.array_equal(a, b)
                     for a, b in zip(prog["masks"], ref["masks"])))
    return [k for k, same in (
        ("initial weights", prog["params0"] == ref["params0"]),
        ("initial statistics", prog["stats0"] == ref["stats0"]),
        ("batch", prog["inputs"] == ref["inputs"]),
        ("box masks", masks),
        ("dropout seed", prog["dropout_seed"] == ref["dropout_seed"]),
        ("dropout state", prog["dropout_state"] == ref["dropout_state"]))
        if not same]


def check(config, traffic, seed: int, record, device):
    """(numbers, lines, extras): the numbers compared, lines for standard
    error, and ``work``, the counts of one epoch."""
    ref = reference(config, seed, len(record["losses"]), device)
    per_tensor = {}
    out = numbers(record, ref, per_tensor)
    differ = input_gaps(record, ref)
    out["same_inputs"] = 1 if differ else 0
    worst = sorted(((v, k) for k, v in per_tensor.items()), reverse=True)[:3]
    lines = [
        "loss gap of each epoch: " + ", ".join(
            f"{gap(a, b, abs(b)):.3g}"
            for a, b in zip(record["losses"], ref["losses"])),
        "gradient norms furthest from the reference's, relative to their "
        "own: " + ", ".join(f"{k} {v:.3g}" for v, k in worst),
        "inputs not the program's: " + (", ".join(differ) or "none")]
    b, h, w2 = record["shape"]
    return out, lines, {"work": refine_counts.epoch_work(b, h, w2)}


def control(name: str, config, traffic, seed: int, device) -> dict:
    """The numbers the control ``name`` reads against the reference."""
    n = int(traffic["checked_epochs"])
    kw = ({"dtype": torch.float32, "tf32": True} if name == "tf32"
          else {"eval_bn": True})
    low = reference(config, seed, n, device, **kw)
    ref = reference(config, seed, n, device)
    out = numbers(low, ref)
    out["loss_gap_of_each_epoch"] = [gap(a, b, abs(b)) for a, b in
                                     zip(low["losses"], ref["losses"])]
    return out
