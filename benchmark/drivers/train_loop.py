"""Driver kind ``train_loop``: the stage-3 training loop as
texgs_torch/train/driver.py runs it, closed with one trainer.

One iteration: a view drawn from the shuffled pool (``random.Random(seed)``
as the driver's ``random.randint``), ``model.compute_loss``, the loss read
to the host, ``model.optimize_step``.  Set-up makes the state from the
seed, builds the program's model on it and drives its first
``checked_steps`` iterations through that same call: the reference follows
them.  Then ``warmup_steps`` more, and the window runs iterations until
``--seconds`` have passed.  ``train_step_ms`` is the window over the
iterations it completed.

The check (after the window, the program's state freed): each checked
step's loss; the norm of each leaf's first gradient, the program's taken
from its Adam moments after one step; the norm of each leaf's change over
the checked steps; the render's outputs of the first step.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from benchmark import harness, quantities, scene
from benchmark.reference import stage3 as ref3

BETA1 = 0.9
RENDER_KEYS = {"image": "render", "image_no_sh": "render_no_sh",
               "depth": "depth", "norm": "norm", "alpha": "alpha"}


class Pool:
    """The driver's draw: a shuffled pass over the views, refilled when
    empty."""

    def __init__(self, n: int, seed: int):
        self.n, self.rng, self.pool = n, random.Random(seed), []

    def next(self) -> int:
        if not self.pool:
            self.pool = list(range(self.n))
        return self.pool.pop(self.rng.randint(0, len(self.pool) - 1))


def hyper(cfg: dict, cams) -> dict:
    a = cfg["assumed"]["state_at_first_iteration"]
    return {"active_sh_degree": a["active_sh_degree"],
            "uv_step_count": a["uv_step_count"],
            "adam_counts": a["adam_counts"],
            "spatial_lr_scale": scene.extent(cams)}


def build(cfg: dict, seed: int, device):
    """(state, views, hyper): the benchmark's state and training views."""
    state, sc = scene.make_state(cfg, seed, device)
    cams = scene.spiral_views(cfg["assumed"]["views"])
    views = [scene.view_targets(c, sc, device) for c in cams]
    return state, views, hyper(cfg, cams)


def reference_opt(state: dict, hy: dict) -> dict:
    c = hy["adam_counts"]
    return {k: (torch.zeros_like(v), torch.zeros_like(v),
                int(c["gauss"] if k in ref3.GAUSS_KEYS else
                    c["tex"] if k == "texture" else c["uv"]))
            for k, v in state.items()}


def reference_readings(state, views, order, hy, cfg, m) -> dict:
    """The reference's readings over the checked steps on views ``order``:
    each step's loss, the first step's gradient norms and render outputs,
    each leaf's change, and which of its elements count (``numbers``)."""
    tr = ref3.Trainer(state, reference_opt(state, hy), hy, cfg)
    bg = torch.as_tensor(cfg["model_cfg"]["background"], dtype=torch.float32,
                         device=state["xyz"].device)
    it0 = int(cfg["assumed"]["state_at_first_iteration"]["iteration"]) + 1
    losses, g1, outs = [], {}, {}
    gmax = {k: torch.zeros_like(v) for k, v in state.items()}
    gsq = {k: 0.0 for k in state}
    for j, vi in enumerate(order):
        loss, out, grads = tr.step(it0 + j, views[vi], bg, m)
        losses.append(float(loss))
        for k, g in zip(tr.state, grads):
            if g is not None:
                torch.maximum(gmax[k], g.abs(), out=gmax[k])
                gsq[k] += float((g * g).sum())
        if j == 0:
            g1_t = {k: torch.zeros_like(state[k]) if g is None else g
                    for k, g in zip(tr.state, grads)}
            g1 = {k: float(torch.linalg.norm(g)) for k, g in g1_t.items()}
            outs = out
        del grads, out
    # an element counts where some checked step's gradient reaches a
    # thousandth of its leaf's root mean square: below that it moves by
    # Adam's normalisation of round-off alone (the flat axis of a disc)
    mask = {k: gmax[k] >= 1e-3 * (gsq[k] / (len(order) * gmax[k].numel())) ** 0.5
            for k in state}
    delta = {k: tr.state[k] - state[k] for k in state}
    return {"loss": losses, "g1": g1, "g1_t": g1_t, "delta": delta,
            "mask": mask, "outs": outs}


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers compared: ``loss1``, the first step's relative loss gap;
    ``grad``, the median kept leaf's gap of first-gradient norms;
    ``delta``, the worst kept leaf's gap of change norms over the elements
    that count; each render output's relative L1 gap at the first step.  A
    leaf's gap is taken against max(its reference norm, the median kept
    leaf's), and a leaf is kept when its reference gradient is at least a
    thousandth of the median nonzero leaf's.  Context, not compared: the
    worst step's loss gap and the worst leaf's gradient gap, which carry
    the float32 round-off of a few flat discs' rows
    (benchmark/tests/witness.py)."""
    med = statistics.median(v for v in ref["g1"].values() if v > 0)
    keep = [k for k, v in ref["g1"].items() if v >= 1e-3 * med]
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    out = {"loss1": gaps[0], "loss3": max(gaps)}
    g = harness.leaf_gaps(prog["g1"], ref["g1"], keep)
    out["grad"] = statistics.median(g.values())
    out["grad_worst_leaf"] = max(g, key=g.get)
    out["grad_worst"] = g[out["grad_worst_leaf"]]

    def norms(d):
        return {k: float(torch.linalg.norm(d[k][ref["mask"][k]])) for k in keep}
    d = harness.leaf_gaps(norms(prog["delta"]), norms(ref["delta"]), keep)
    out["delta_leaf"] = max(d, key=d.get)
    out["delta"] = d[out["delta_leaf"]]
    for k in RENDER_KEYS:
        out[k] = harness.rel_l1(prog["outs"][k], ref["outs"][k])
    return out


class Session:
    """The program's model on the benchmark's state, driven through its
    checked steps: ``step()`` is the window's iteration, ``prog`` the
    readings the check compares."""

    def __init__(self, cfg: dict, work: dict, seed: int, device):
        from benchmark import program
        from texgs_torch.config import Cfg
        self.cfg, self.m = cfg, int(cfg["model_cfg"].get("uvtex_m", 32))
        self.state0, self.views, self.hy = build(cfg, seed, device)
        self.model = program.build_model(cfg, self.state0, self.hy, device,
                                         train=True)
        self.loss_cfg = Cfg(cfg["loss_cfg"])
        self.train_cfg = Cfg(cfg["train_cfg"])
        self.pviews = [program.camera(v["cam"], v) for v in self.views]
        self.pool = Pool(len(self.views), seed)
        self.it = int(cfg["assumed"]["state_at_first_iteration"]["iteration"]) + 1
        self.end_it = int(cfg["train_cfg"]["num_iterations"])
        self.drawn = []
        self.prog = self.checked(int(work["checked_steps"]))

    def step(self) -> float:
        vi = self.pool.next()
        self.drawn.append(vi)
        loss, stats, extra = self.model.compute_loss(
            self.it, self.end_it, self.pviews[vi], None, self.loss_cfg)
        loss_f = float(loss)
        self.model.optimize_step(self.it, self.end_it, self.train_cfg, extra)
        self.it += 1
        return loss_f

    def checked(self, n_check: int) -> dict:
        """The first ``n_check`` steps, read: their losses, the first
        step's render outputs and gradients (from the Adam moments), and
        each leaf's change over them."""
        from benchmark import program
        model, captured = self.model, {}
        render = model._render

        def capture(*a, **k):
            out = render(*a, **k)
            captured.update({r: out[p].detach().clone()
                             for r, p in RENDER_KEYS.items()})
            return out
        model._render = capture
        mu0 = {k: v.clone() for k, v in program.moments(model).items()}
        losses = [self.step()]
        del model._render
        g1t = {k: (v - BETA1 * mu0[k]) / (1 - BETA1)
               for k, v in program.moments(model).items()}
        g1 = {k: float(torch.linalg.norm(v)) for k, v in g1t.items()}
        losses += [self.step() for _ in range(n_check - 1)]
        delta = {k: v.detach() - self.state0[k]
                 for k, v in program.leaves(model).items()}
        return {"loss": losses, "g1": g1, "g1_t": g1t, "delta": delta,
                "outs": captured, "order": list(self.drawn)}

    def reference(self) -> dict:
        return reference_readings(self.state0, self.views, self.prog["order"],
                                  self.hy, self.cfg, self.m)


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
    call into a kernel function in a range of its own; before each, the
    leaves its counts read are copied (in a range the reduction leaves
    out).  After it, each step's pairs and M-list fill are reckoned from
    those copies by the benchmark's own plain binning and blend."""
    from benchmark import program
    tr = harness.Trace(torch)
    calls, undo = harness.wrap_functions(torch, program.kernel_functions())
    snaps, first = [], len(ses.drawn)
    lv = program.leaves(ses.model)
    keys = ["xyz", "opacity", "scaling", "rotation"] + \
        [k for k in lv if k.startswith("uv_net.") or k == "geo_emb"]
    tr.start()
    with torch.profiler.record_function(harness.WINDOW):
        for _ in range(n_steps):
            with torch.profiler.record_function(harness.SKIP):
                snaps.append({k: lv[k].detach().clone() for k in keys})
            ses.step()
        sync()
    red = tr.stop()
    undo()
    peak = torch.cuda.max_memory_allocated()    # before the counting renders
    sh = int(ses.model.active_sh_degree)
    per_step = [quantities.of_call(snap, ses.views[ses.drawn[first + j]]["cam"],
                                     ses.cfg, ses.m, sh)
                for j, snap in enumerate(snaps)]
    return {"trace": red, "steps": n_steps, "calls": calls,
            "per_step": per_step, "attempted": n_steps,
            "memory_peak_bytes": peak}
