"""What decides ``correct`` in a train cell: the program's outputs against
the reference's on the same seeded inputs, each number beside its limit
(``kinds/train.py``'s ``check`` compares them).

The program's first ``checked_steps`` steps went through the window's
own call from the state handed to the window; the reference
(``benchmark/reference``) takes the same steps from the same seeded
parameters. Compared, each as a gap relative to the reference:

* ``loss_gap``: the first step's |loss - ref| / |ref|. The later steps'
  losses are printed and not compared: Adam's first update is the sign
  of each element's gradient times its rate, so elements whose gradient
  is round-off on both sides move apart by twice the rate, and the later
  losses of sound runs part by 0 to 5e-4 from seed to seed (PERF.md);
* ``grad_gap``: the first gradient as Adam holds it after one step, per
  group and for the prior: the largest |norm - ref norm| over the larger
  of the group's reference norm and the median group's;
* ``change_gap``: the parameters' change over the steps, per group, in
  the same measure, over the groups whose reference gradient is at least
  a thousandth of the median group's (the others move by round-off);
* ``descent_gap``: over the same groups, the change along the
  reference's first gradient, the dot product of the two: |prog - ref|
  over the larger of |ref| and the median group's. The norms above
  cannot see a direction: Adam's first update is about the rate times the
  sign of each element's gradient, so negated gradients, gradients
  scattered to the wrong gaussians, or an update of the wrong sign keep
  every norm; they read about 2, 1 and 2 here. Elements whose gradient is
  round-off, which Adam moves a whole step in a random direction, weigh
  nothing in it (PERF.md).

The limits of a cell are in ``benchmark/limits/<workload>.json``.
"""

from __future__ import annotations

import statistics

import torch

from benchmark import scene as S

B1 = 0.9


class AttrDict(dict):
    """The run's configuration, read as the program reads its Config."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e


def run_args(config) -> AttrDict:
    return AttrDict(config["run"])


def fingerprint(params) -> dict:
    """Per group, the float64 sum and sum of squares: enough to tell two
    draws of the parameters apart."""
    return {k: (float(v.double().sum()), float((v.double() ** 2).sum()))
            for k, v in params.items()}


def leaf_norms(tensors) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def reference_train(config, traffic, seed: int, calls, device,
                    lowered=None, fault=None, sink=None):
    """The reference's steps ``calls`` from the seeded parameters: the
    same record the train kind's ``Cell.first_steps`` keeps
    (``kinds/train.py``), and the initial parameters."""
    from benchmark.reference import raster, step as R
    args = run_args(config)
    sc = S.make_scene(config, device)
    params0 = S.make_params(config, sc, seed)
    cams = S.train_cameras(config, sc)
    del sc
    model = R.model_of(args, device)
    state = R.init_state(params0, model)
    record = {"params0": fingerprint(params0), "losses": [], "terms": []}
    raster.SINK = sink
    try:
        for k, (cam, shift, it) in enumerate(calls):
            sh = min(it // args.sh_increase_interval, args.sh_degree)
            state, loss, terms = R.train_step(state, cams[cam], it, sh, shift,
                                              model, lowered=lowered,
                                              fault=fault)
            record["losses"].append(loss)
            record["terms"].append(terms)
            if k == 0:
                mu = dict(state.opt.mu)
                mu["prior"] = state.prior_opt[0]
                record["grad1"] = {key: v / (1 - B1)
                                   for key, v in leaf_norms(mu).items()}
                record["grad1_vec"] = {key: v / (1 - B1)
                                       for key, v in mu.items()}
    finally:
        raster.SINK = None
    record["params_end"] = state.params
    record["prior_end"] = state.prior
    record["params_start"] = params0
    record["prior_start"] = R.init_raydrop_prior(*args.hw, device)
    return record


def gap(x: float, ref: float, scale: float) -> float:
    return abs(x - ref) / max(scale, 1e-30)


def train_numbers(prog, ref, device, per_group=None) -> dict:
    """The four numbers of a train cell from the two records (leaves on
    the host or the device); ``per_group``, a dict, takes each group's
    ``descent_gap``."""
    loss_gap = gap(prog["losses"][0], ref["losses"][0],
                   abs(ref["losses"][0]))
    g_ref = ref["grad1"]
    g_med = statistics.median(g_ref.values())
    grad_gap = max(gap(prog["grad1"][k], g_ref[k], max(g_ref[k], g_med))
                   for k in g_ref)
    d_prog, d_ref, s_prog, s_ref = {}, {}, {}, {}
    starts = dict(ref["params_start"], prior=ref["prior_start"])
    ends_p = dict(prog["params_end"], prior=prog["prior_end"])
    ends_r = dict(ref["params_end"], prior=ref["prior_end"])
    for k, p0 in starts.items():
        if g_ref[k] < 1e-3 * g_med:
            continue
        a = (ends_p[k].to(device) - p0).double().flatten()
        b = (ends_r[k] - p0).double().flatten()
        g = ref["grad1_vec"][k].double().flatten()
        d_prog[k] = float(torch.linalg.vector_norm(a))
        d_ref[k] = float(torch.linalg.vector_norm(b))
        s_prog[k] = float(torch.dot(a, g))
        s_ref[k] = float(torch.dot(b, g))
        del a, b, g
    d_med = statistics.median(d_ref.values())
    change_gap = max(gap(d_prog[k], d_ref[k], max(d_ref[k], d_med))
                     for k in d_ref)
    s_med = statistics.median(abs(v) for v in s_ref.values())
    descents = {k: gap(s_prog[k], s_ref[k], max(abs(s_ref[k]), s_med))
                for k in s_ref}
    if per_group is not None:
        per_group.update(descents)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap,
            "descent_gap": max(descents.values())}


def step_loss_gaps(prog, ref) -> list:
    """Each checked step's relative loss gap (printed, the first compared)."""
    return [gap(a, b, abs(b)) for a, b in zip(prog["losses"], ref["losses"])]


def term_gaps(prog, ref) -> dict:
    """Per loss term, the largest relative gap over the steps: not
    compared, printed to show which term a loss gap comes from."""
    out = {}
    for a, b in zip(prog["terms"], ref["terms"]):
        for k in b:
            if k in a:
                out[k] = max(out.get(k, 0.0), gap(a[k], b[k], abs(b[k])))
    return out


def same_params(a: dict, b: dict) -> bool:
    return all(a[k] == b[k] for k in a) and set(a) == set(b)
