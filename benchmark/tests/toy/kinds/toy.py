"""A toy kind for the CPU tests: a few plain conv layers trained
full-batch by Adam on seeded inputs, each call one step, its reference
the same mathematics in float64. It has the shape of a convolutional
kind such as the ray-drop refinement U-Net, and it lives in its test
directory beside its configuration, traffic and limits: a kind is
files, found by name."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.checks import fingerprint

CONTROLS = ("bf16",)
B1, B2, EPS = 0.9, 0.999, 1e-8


def draw(config, seed: int):
    """The seeded weights, inputs and targets, in float32 on the host."""
    g = torch.Generator().manual_seed(seed)
    ch, k = config["channels"], config["kernel"]
    weights = {f"w{i}": torch.randn(co, ci, k, k, generator=g)
               / (ci * k * k) ** 0.5
               for i, (ci, co) in enumerate(zip(ch, ch[1:]))}
    b, (h, w) = config["batch"], config["hw"]
    x = torch.rand(b, ch[0], h, w, generator=g)
    y = torch.rand(b, ch[-1], h, w, generator=g)
    return weights, x, y


def loss_of(weights, x, y):
    h, last = x, len(weights) - 1
    for i, w in enumerate(weights.values()):
        h = F.conv2d(h, w, padding=w.shape[-1] // 2)
        h = torch.sigmoid(h) if i == last else torch.relu(h)
    return torch.mean((h - y) ** 2)


class Cell:
    def __init__(self, config, traffic, seed: int, device):
        self.traffic = traffic
        weights, x, y = draw(config, seed)
        self.params = {k: v.to(device, copy=True).requires_grad_()
                       for k, v in weights.items()}
        self.x, self.y = x.to(device), y.to(device)
        self.opt = torch.optim.Adam(self.params.values(), lr=config["lr"],
                                    betas=(B1, B2), eps=EPS)
        self.record = {"params0": fingerprint(weights)}

    def call(self, i=None):
        self.opt.zero_grad(set_to_none=True)
        loss = loss_of(self.params, self.x, self.y)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def first_steps(self):
        n = int(self.traffic["checked_steps"])
        self.record["losses"] = [float(self.call()) for _ in range(n)]
        self.record["params_end"] = {k: v.detach().to("cpu", copy=True)
                                     for k, v in self.params.items()}

    traced_calls = 4

    def again(self, i):
        return self.call()

    def free(self):
        self.params = self.opt = self.x = self.y = None


def reference(config, seed: int, steps: int, device, dtype=torch.float64):
    """The same steps, Adam written out, computed in ``dtype``."""
    weights, x, y = draw(config, seed)
    params = {k: v.to(device, dtype, copy=True).requires_grad_()
              for k, v in weights.items()}
    x, y = x.to(device, dtype), y.to(device, dtype)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses = []
    for t in range(1, steps + 1):
        loss = loss_of(params, x, y)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k] = B1 * m[k] + (1 - B1) * g
                v[k] = B2 * v[k] + (1 - B2) * g * g
                p -= config["lr"] * (m[k] / (1 - B1 ** t)) / (
                    (v[k] / (1 - B2 ** t)).sqrt() + EPS)
        losses.append(float(loss.detach()))
    return {"params0": fingerprint(weights), "losses": losses,
            "params_start": weights,
            "params_end": {k: p.detach().to("cpu", copy=True)
                           for k, p in params.items()}}


def numbers(prog, ref) -> dict:
    """The largest relative loss gap over the steps, and the worst leaf's
    gap between the norms of its change."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    change_gap = 0.0
    for k, p0 in ref["params_start"].items():
        a = torch.linalg.vector_norm(prog["params_end"][k].double()
                                     - p0.double())
        b = torch.linalg.vector_norm(ref["params_end"][k].double()
                                     - p0.double())
        change_gap = max(change_gap, float(abs(a - b) / b))
    return {"loss_gap": loss_gap, "change_gap": change_gap}


def check(config, traffic, seed: int, record, device):
    ref = reference(config, seed, len(record["losses"]), device)
    out = numbers(record, ref)
    out["same_inputs"] = 0 if record["params0"] == ref["params0"] else 1
    lines = ["loss gap of each step: " + ", ".join(
        f"{abs(a - b) / abs(b):.3g}"
        for a, b in zip(record["losses"], ref["losses"]))]
    return out, lines, {}


def control(name: str, config, traffic, seed: int, device) -> dict:
    steps = int(traffic["checked_steps"])
    low = reference(config, seed, steps, device, torch.bfloat16)
    return numbers(low, reference(config, seed, steps, device))
