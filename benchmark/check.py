"""The comparison that decides `correct`: what the timed path produced,
against the cell's plain reference (`benchmark/reference/<reference>.py`)
run from the same inputs and weights, once the window has closed and the
program is freed.

Serving: for each sampled request batch, the reference's answer
(`reference.answer`) and each judged output's gap map
(`reference.gaps`, whose docstring defines each map); the worst batch
counts. `<output>_q99`: the 99th percentile of the map over the batch.
`<output>_far`: the share of the map's elements beyond the limits file's
`far` threshold of that output, in the worst sample of the batch, so a
fault confined to a few rows or a tile, which a 99th percentile leaves
out, still shows.

Training: the first `check_steps` steps the set-up took through the
window's own call, against the reference's steps from the same weights and
batches: each step's final loss (`loss_gap`, relative gap, the worst
step), each leaf's first gradient (`grad_gap`; the program's from Adam's
first moment) and each leaf's change over the steps (`change_gap`). A
leaf's number is the gap between the two norms over the larger of the
reference's norm of that leaf and of the median leaf; the worst leaf
counts. `change_total`: the gap between the two whole changes' norms (all
judged leaves together) over the reference's, which a wrong step size
moves and the noise of single leaves hardly does. Leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off
alone under Adam and are left out of the change.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.optim import OPTIMIZERS

# The multiples of an output's q99 limit at which a calibration run
# records the share of elements beyond (calibrate.py reads them).
FAR_LADDER = (0.5, 1, 2, 4, 8, 16)


def quantile(t: torch.Tensor, q: float) -> float:
    flat = t.float().reshape(-1)
    return float(torch.kthvalue(flat, max(1, math.ceil(q * flat.numel()))).values)


def gap_quantile(prog: torch.Tensor, want: torch.Tensor, q: float = 0.99) -> float:
    """The q-quantile of |prog - want| over the reference's root mean square."""
    rms = float(want.float().square().mean().sqrt())
    return quantile((prog.float() - want.float()).abs(), q) / max(rms, 1e-30)


def far_share(gap: torch.Tensor, threshold: float) -> float:
    """The largest share, over the samples of a batch, of a gap map's
    elements beyond `threshold` (or not a number)."""
    return float((~(gap.reshape(gap.shape[0], -1) <= threshold)).float().mean(1).max())


def _to(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device).float() for k, v in batch.items()}


def reference_model(cell, state_dict: dict, device, precision: str | None = None, train=False):
    with torch.device("meta"):
        net = cell.reference().build(cell.config["model"], precision)
    net = net.to_empty(device=device)
    net.load_state_dict(state_dict)
    return net.train(train)


def serve_numbers(cell, state_dict: dict, kept: list, device, precision: str | None = None,
                  detail: dict | None = None) -> dict:
    """kept: [(host batch, program outputs)]. `detail`, where given,
    collects per batch and output the map's quantiles (0.5, 0.9, 0.99,
    0.999, its largest element) and its `far_share` at each multiple
    FAR_LADDER of the output's q99 limit."""
    ref = cell.reference()
    net = reference_model(cell, state_dict, device, precision)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    far = cell.limits.get("far", {})
    q99_limits = cell.limits["limits"]
    worst: dict[str, float] = {}

    def note(name, value):
        worst[name] = max(worst.get(name, 0.0), value)

    with torch.no_grad():
        for batch, got in kept:
            for name, gap in ref.gaps(ref.answer(net, _to(batch, device), got), got).items():
                if gap is None:
                    note(f"{name}_q99", math.inf)
                    if name in far:
                        note(f"{name}_far", math.inf)
                    continue
                gap = torch.nan_to_num(gap, nan=math.inf)
                note(f"{name}_q99", quantile(gap, 0.99))
                if name in far:
                    note(f"{name}_far", far_share(gap, far[name]))
                if detail is not None:
                    row = {"q": [quantile(gap, q) for q in (0.5, 0.9, 0.99, 0.999)] + [float(gap.max())]}
                    limit = q99_limits.get(f"{name}_q99")
                    if limit is not None:
                        row["far"] = [far_share(gap, m * limit) for m in FAR_LADDER]
                    detail.setdefault(name, []).append(row)
    return worst


def train_reference(cell, state_dict: dict, batches: list, device, precision: str | None = None,
                    half_batch: bool = False, lr_scale: float = 1.0) -> dict:
    """The reference's first len(batches) steps: their final losses, the
    first step's gradients and the parameters' change after the last
    step. `half_batch` and `lr_scale` plant faults for the calibration."""
    mix = cell.mix
    net = reference_model(cell, state_dict, device, precision, train=True)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    params = dict(net.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = OPTIMIZERS[mix["optim"]](params, mix["init_lr"] * lr_scale)
    out = {"losses": []}
    for i, batch in enumerate(batches):
        inputs = _to(batch, device)
        if half_batch:
            inputs = {k: v[: len(v) // 2] for k, v in inputs.items()}
        for p in params.values():
            p.grad = None
        loss = cell.reference().losses(cell.config["model"], net(inputs), inputs)["final_loss"]
        loss.backward()
        out["losses"].append(float(loss.detach()))
        if i == 0:
            out["grads"] = {k: p.grad.detach().clone() for k, p in params.items()}
        opt.step()
    out["change"] = {k: params[k].detach() - start[k] for k in params}
    return out


def _leaf_gap(got: dict, want: dict, leaves) -> float:
    norms = {k: float(want[k].norm()) for k in want}
    floor = sorted(norms.values())[len(norms) // 2]
    return max((abs(float(got[k].norm()) - norms[k]) / max(norms[k], floor, 1e-30) for k in leaves), default=0.0)


def _total_gap(got: dict, want: dict, leaves) -> float:
    a = math.sqrt(sum(float(got[k].double().square().sum()) for k in leaves))
    b = math.sqrt(sum(float(want[k].double().square().sum()) for k in leaves))
    return abs(a - b) / max(b, 1e-30)


def train_numbers(prog: dict, want: dict, detail: dict | None = None) -> dict:
    """prog, want: {"losses", "grads", "change"} of the program and the
    reference. `detail`, where given, collects the losses and the worst
    leaves of the gradient and the change: [name, program norm, reference
    norm], and the median leaf's reference norms."""
    gnorm = {k: float(g.norm()) for k, g in want["grads"].items()}
    median = sorted(gnorm.values())[len(gnorm) // 2]
    moved = [k for k in want["change"] if gnorm[k] >= 1e-3 * median]
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], want["losses"]))
    if len(prog["losses"]) != len(want["losses"]) or not all(map(math.isfinite, prog["losses"])):
        loss = math.inf
    if detail is not None:
        detail["losses"] = [prog["losses"], want["losses"]]
        for q, keys in (("grads", list(want["grads"])), ("change", moved)):
            rows = [[k, float(prog[q][k].norm()), float(want[q][k].norm())] for k in keys]
            med = sorted(r[2] for r in rows)[len(rows) // 2]
            rows.sort(key=lambda r: -abs(r[1] - r[2]) / max(r[2], med, 1e-30))
            detail[q] = {"median": med, "worst": rows[:6]}
    change = {k: prog["change"][k].to(want["change"][k].device) for k in moved}
    return {"loss_gap": loss,
            "grad_gap": _leaf_gap({k: prog["grads"][k].to(want["grads"][k].device) for k in want["grads"]},
                                  want["grads"], want["grads"]),
            "change_gap": _leaf_gap(change, want["change"], moved),
            "change_total": _total_gap(change, want["change"], moved)}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number limited and finite, and within its limit."""
    return bool(numbers) and all(k in limits and math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
