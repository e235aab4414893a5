"""Driver kind ``uv2_train_loop``: the stage-2 training loop as
texgs_torch/train/driver.py runs it, closed with one trainer.

One iteration: a view drawn from the shuffled pool (``train_loop.Pool``),
``model.compute_loss(it, num_iterations, view, None, loss_cfg)``, which in
stage 2 holds the forward, the backward and the Adam step, the loss read
to the host, ``model.optimize_step(it, num_iterations, train_cfg,
extra)``.  Set-up makes the frozen Gaussians, their cloud and the views
from the seed (``scene_uv2.py``), builds the program's ``UVMapGaussian3D``
(``program_uv2.py``), fits its UV net as ``scene.prefit_uv_net`` fits the
stage-3 cells' and its inverse net to that map on the cloud
(``scene_uv2.prefit_inverse_net``), and drives its first
``checked_steps`` iterations through that same call: the reference
(``reference/stage2.py``) follows them with the model's own draws.
Then ``warmup_steps`` more, and the window runs iterations until
``--seconds`` have passed.  ``train_step_ms`` is the window over the
iterations it completed.

The check (after the window, the program's state freed): the first
step's loss and each of its terms; the norm of each leaf's first
gradient, the program's taken from its Adam moments after one step; the
norm of each leaf's change over the checked steps; the first step's UV
net output on the inverse points and the inverse net's output on them,
pixel by pixel over the pixels both masks hold.

The traced window is reduced by ``harness.reduce_trace`` and, under
``spans``, by ``benchmark.spans.reduce`` (``gs1_train_loop.SpanTrace``).
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from benchmark import harness, quantities_uv2, scene, scene_uv2
from benchmark.drivers.gs1_train_loop import SpanTrace
from benchmark.drivers.train_loop import BETA1, Pool
from benchmark.reference import stage2 as ref2

TERMS = ("Linv", "Lchamfer", "Linv2")


def hyper(cfg: dict) -> dict:
    a = cfg["assumed"]["state_at_first_iteration"]
    return {"step_count": a["step_count"], "adam_count": a["adam_count"]}


def first_iteration(cfg: dict) -> int:
    return int(cfg["assumed"]["state_at_first_iteration"]["iteration"]) + 1


def background(cfg: dict, device):
    return torch.as_tensor(cfg["dataset_cfg"]["background"],
                           dtype=torch.float32, device=device)


def reference_readings(gauss, pcd, state, cams, order, draws, hy,
                       cfg) -> dict:
    """The reference's readings over the checked steps on views ``order``
    with the program's ``draws``: each step's loss, the first step's terms,
    gradient norms, nets' outputs and mask, each leaf's change, and which
    of its elements count (``train_loop``'s rule)."""
    opt = {k: (torch.zeros_like(v), torch.zeros_like(v),
               int(hy["adam_count"])) for k, v in state.items()}
    tr = ref2.Trainer(state, opt, hy, cfg, pcd)
    bg = background(cfg, pcd.device)
    it0 = first_iteration(cfg)
    losses, first = [], {}
    gmax = {k: torch.zeros_like(v) for k, v in state.items()}
    gsq = {k: 0.0 for k in state}
    for j, vi in enumerate(order):
        points, mask = ref2.view_points(gauss, cams[vi], bg)
        loss, terms, outs, grads = tr.step(it0 + j, points,
                                           draws[j]["sample_uvs"])
        losses.append(float(loss))
        for k, g in zip(tr.state, grads):
            if g is not None:
                torch.maximum(gmax[k], g.abs(), out=gmax[k])
                gsq[k] += float((g * g).sum())
        if j == 0:
            first = {"terms": {k: float(v) for k, v in terms.items()},
                     "g1": {k: 0.0 if g is None else float(torch.linalg.norm(g))
                            for k, g in zip(tr.state, grads)},
                     "outs": {**outs, "mask": mask}}
        del grads, outs, points
    mask = {k: gmax[k] >= 1e-3 * (gsq[k] / (len(order) * gmax[k].numel())) ** 0.5
            for k in state}
    delta = {k: tr.state[k] - state[k] for k in state}
    return {"loss": losses, **first, "delta": delta, "mask": mask}


def pixel_rows(outs: dict, mask, both):
    """The rows of ``outs``'s ``uv`` and ``inv`` at the pixels ``both``:
    rows are the pixels of ``mask`` in order, or every pixel of the frame
    (a weighted route); otherwise None (rows the check cannot place)."""
    n = outs["uv"].shape[0]
    if n == int(mask.sum()):
        sel = both[mask]
    elif n == mask.numel():
        sel = both
    else:
        return None
    return {k: outs[k][sel] for k in ("uv", "inv")}


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers compared: ``loss1``, the first step's relative loss gap,
    and that of each term; ``grad`` and ``delta`` as ``train_loop.numbers``
    takes them (the median kept leaf's first-gradient gap, the worst kept
    leaf's change gap over the elements that count); ``uv`` and ``inv``,
    the relative L1 gaps of the nets' outputs on the inverse points over
    the pixels both masks hold (infinite where the program's rows are not
    the masked pixels).  Context: the worst step's loss gap, the worst
    leaf's gradient gap, the pixels one mask holds and the other not."""
    med = statistics.median(v for v in ref["g1"].values() if v > 0)
    keep = [k for k, v in ref["g1"].items() if v >= 1e-3 * med]
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    out = {"loss1": gaps[0], "loss3": max(gaps)}
    for t in TERMS:
        out[t] = abs(prog["terms"][t] - ref["terms"][t]) / abs(ref["terms"][t])
    g = harness.leaf_gaps(prog["g1"], ref["g1"], keep)
    out["grad"] = statistics.median(g.values())
    out["grad_worst_leaf"] = max(g, key=g.get)
    out["grad_worst"] = g[out["grad_worst_leaf"]]

    def norms(d):
        return {k: float(torch.linalg.norm(d[k][ref["mask"][k]])) for k in keep}
    d = harness.leaf_gaps(norms(prog["delta"]), norms(ref["delta"]), keep)
    out["delta_leaf"] = max(d, key=d.get)
    out["delta"] = d[out["delta_leaf"]]
    pm, rm = prog["outs"]["mask"], ref["outs"]["mask"]
    both = pm & rm
    out["mask_differ"] = int((pm ^ rm).sum())
    rows = pixel_rows(prog["outs"], pm, both)
    r_rows = pixel_rows(ref["outs"], rm, both)
    for k in ("uv", "inv"):
        out[k] = math.inf if rows is None else harness.rel_l1(rows[k],
                                                              r_rows[k])
    return out


class Session:
    """The program's stage-2 model on the benchmark's frozen Gaussians,
    driven through its checked steps: ``step()`` is the window's
    iteration, ``prog`` the readings the check compares."""

    def __init__(self, cfg: dict, work: dict, seed: int, device):
        from benchmark import program_uv2
        from texgs_torch.config import Cfg
        self.cfg = cfg
        self.gauss, self.pcd, self.cams = scene_uv2.build(cfg, seed, device)
        self.hy = hyper(cfg)
        self.model = program_uv2.build_model(cfg, self.gauss, self.pcd, seed,
                                             self.hy, device)
        state = {k: v.detach().clone()
                 for k, v in program_uv2.leaves(self.model).items()}
        scene.prefit_uv_net(state, self.gauss["xyz"])
        scene_uv2.prefit_inverse_net(state, self.pcd)
        program_uv2.load_leaves(self.model, state)
        self.state0 = {k: v.detach().clone() for k, v in state.items()}
        self.loss_cfg = Cfg(cfg["loss_cfg"])
        self.train_cfg = Cfg(cfg["train_cfg"])
        self.pviews = [program_uv2.camera(c, i)
                       for i, c in enumerate(self.cams)]
        self.pool = Pool(len(self.cams), seed)
        self.it = first_iteration(cfg)
        self.end_it = int(cfg["train_cfg"]["num_iterations"])
        self.drawn, self.stats = [], {}
        self.prog = self.checked(int(work["checked_steps"]))

    def step(self) -> float:
        vi = self.pool.next()
        self.drawn.append(vi)
        loss, self.stats, extra = self.model.compute_loss(
            self.it, self.end_it, self.pviews[vi], None, self.loss_cfg)
        loss_f = float(loss)
        self.model.optimize_step(self.it, self.end_it, self.train_cfg, extra)
        self.it += 1
        return loss_f

    def checked(self, n_check: int) -> dict:
        """The first ``n_check`` steps, read: their losses and draws, the
        first step's terms, gradients (from the Adam moments), nets'
        outputs on the inverse points and mask, and each leaf's change
        over them."""
        from benchmark import program_uv2
        model, outs, draws = self.model, {}, []
        draw, uv_fwd = model.draws, model.uv_net.forward
        inv_fwd = model.inv_uv_net.forward

        def capture_draws(*a, **k):
            d = draw(*a, **k)
            draws.append({n: v.clone() for n, v in d.items()})
            return d

        def capture_uv(*a):     # its first call: the inverse points
            out = uv_fwd(*a)
            if "uv" not in outs:
                outs["uv"] = out.detach().clone()
            return out

        def capture_inv(*a):    # one call: the points' uvs, then the samples
            out = inv_fwd(*a)
            if "inv" not in outs:
                outs["inv"] = out[:len(outs["uv"])].detach().clone()
            return out
        model.draws = capture_draws
        model.uv_net.forward = capture_uv
        model.inv_uv_net.forward = capture_inv
        mu0 = {k: v.clone() for k, v in program_uv2.moments(model).items()}
        losses = [self.step()]
        del model.uv_net.forward, model.inv_uv_net.forward
        terms = {k: float(v) for k, v in self.stats.items()}
        g1 = {k: float(torch.linalg.norm((v - BETA1 * mu0[k]) / (1 - BETA1)))
              for k, v in program_uv2.moments(model).items()}
        alpha = model.depth_alpha(self.pviews[self.drawn[0]])[1]
        outs["mask"] = alpha.detach().reshape(-1) > 0.5
        losses += [self.step() for _ in range(n_check - 1)]
        del model.draws
        delta = {k: v.detach() - self.state0[k]
                 for k, v in program_uv2.leaves(model).items()}
        return {"loss": losses, "terms": terms, "g1": g1, "delta": delta,
                "outs": outs, "draws": draws, "order": list(self.drawn)}

    def reference(self) -> dict:
        return reference_readings(self.gauss, self.pcd, self.state0,
                                  self.cams, self.prog["order"],
                                  self.prog["draws"], self.hy, self.cfg)


def run(ctx) -> dict:
    """One run of the cell: set-up, the window (or the traced window), the
    check.  ``ctx``: torch, device, cell, seed, seconds, trace, t0."""
    cfg, work = ctx.cell["config"], ctx.cell["work"]["traffic_params"]
    cuda = torch.device(ctx.device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ses = Session(cfg, work, ctx.seed, ctx.device)
    for _ in range(int(work["warmup_steps"])):
        ses.step()
    sync()
    setup_s = time.perf_counter() - ctx.t0

    result = {"attempted": 0, "failed": 0}
    if ctx.trace:
        result.update(traced(ses, sync, int(work["trace_steps"])))
    else:
        mallocs = harness.device_mallocs(torch)
        n, t_start = 0, time.perf_counter()
        while time.perf_counter() - t_start < ctx.seconds:
            ses.step()
            n += 1
        sync()
        window = time.perf_counter() - t_start
        result["window_mallocs"] = harness.device_mallocs(torch) - mallocs
        result["metrics"] = {"train_step_ms": (window * 1e3 / n, "ms"),
                             "setup_s": (setup_s, "s")}
        result["attempted"] = n
    result.setdefault("memory_peak_bytes", torch.cuda.max_memory_allocated()
                      if cuda else 0)
    ses.model = ses.pviews = None       # the program's state, freed
    if cuda:
        torch.cuda.empty_cache()
    result["numbers"] = numbers(ses.prog, ses.reference())
    return result


def traced(ses: Session, sync, n_steps: int) -> dict:
    """The traced window: ``n_steps`` iterations under the profiler, each
    call into kernel K5' or K5'' in a range of its own.  After it, each
    step's inverse points are counted from the reference's own frozen
    render of its view."""
    from benchmark import program_uv2
    tr = SpanTrace(torch)
    calls, undo = harness.wrap_functions(torch,
                                         program_uv2.kernel_functions())
    first = len(ses.drawn)
    tr.start()
    with torch.profiler.record_function(harness.WINDOW):
        for _ in range(n_steps):
            ses.step()
        sync()
    red = tr.stop()
    undo()
    peak = torch.cuda.max_memory_allocated()    # before the counting renders
    bg, masked = background(ses.cfg, ses.pcd.device), {}
    per_step = []
    for vi in ses.drawn[first:first + n_steps]:
        if vi not in masked:
            masked[vi] = quantities_uv2.masked_pixels(ses.gauss, ses.cams[vi],
                                                      bg)
        per_step.append(quantities_uv2.of_call(masked[vi], ses.cfg))
    return {"trace": red, "steps": n_steps, "calls": calls,
            "per_step": per_step, "attempted": n_steps,
            "memory_peak_bytes": peak}
