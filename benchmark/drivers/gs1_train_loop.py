"""Driver kind ``gs1_train_loop``: the stage-1 training loop as
texgs_torch/train/driver.py runs it, closed with one trainer.

One iteration: a view drawn from the shuffled pool (``train_loop.Pool``),
``model.compute_loss(it, num_iterations, view, None, loss_cfg)``, the loss
read to the host, ``model.optimize_step(it, num_iterations, train_cfg,
extra)``, the program's surgery schedule as it stands.  Set-up makes the
state from the seed (``scene_gs1.py``), builds the program's
``Gaussian3D`` on it (``program_gs1.py``) and drives its first
``checked_steps`` iterations through that same call: the reference
(``reference/stage1.py``) follows them.  Then ``warmup_steps`` more, and
the window runs iterations until ``--seconds`` have passed.
``train_step_ms`` is the window over the iterations it completed.

The check (after the window, the program's state freed), as
``train_loop``'s: the first step's loss; the norm of each leaf's first
gradient, the program's taken from its Adam moments after one step; the
norm of each leaf's change over the checked steps; the render's image,
depth, normal and alpha of the first step.

The traced window is reduced by ``harness.reduce_trace`` and, under
``spans``, by ``benchmark.spans.reduce``.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from benchmark import harness, quantities_gs1, scene, scene_gs1, spans
from benchmark.drivers import train_loop
from benchmark.drivers.train_loop import BETA1, Pool
from benchmark.reference import stage1 as ref1

RENDER_KEYS = {"image": "render", "depth": "depth", "norm": "norm",
               "alpha": "alpha"}
GEOMETRY = ("xyz", "opacity", "scaling", "rotation")


def hyper(cfg: dict, cams) -> dict:
    a = cfg["assumed"]["state_at_first_iteration"]
    return {"active_sh_degree": a["active_sh_degree"],
            "adam_count": a["adam_count"],
            "spatial_lr_scale": scene.extent(cams)}


def build(cfg: dict, seed: int, device):
    """(state, views, hyper): the benchmark's state and training views."""
    state, sc = scene_gs1.make_state(cfg, seed, device)
    cams = scene.spiral_views(cfg["assumed"]["views"])
    views = [scene.view_targets(c, sc, device) for c in cams]
    return state, views, hyper(cfg, cams)


def first_iteration(cfg: dict) -> int:
    return int(cfg["assumed"]["state_at_first_iteration"]["iteration"]) + 1


def reference_readings(state, views, order, hy, cfg) -> dict:
    """The reference's readings over the checked steps on views ``order``,
    as ``train_loop.reference_readings`` takes them: each step's loss, the
    first step's gradient norms and render outputs, each leaf's change,
    and which of its elements count."""
    opt = {k: (torch.zeros_like(v), torch.zeros_like(v),
               int(hy["adam_count"])) for k, v in state.items()}
    tr = ref1.Trainer(state, opt, hy, cfg)
    bg = torch.as_tensor(cfg["dataset_cfg"]["background"],
                         dtype=torch.float32, device=state["xyz"].device)
    it0 = first_iteration(cfg)
    losses, g1, outs = [], {}, {}
    gmax = {k: torch.zeros_like(v) for k, v in state.items()}
    gsq = {k: 0.0 for k in state}
    for j, vi in enumerate(order):
        loss, out, grads = tr.step(it0 + j, views[vi], bg)
        losses.append(float(loss))
        for k, g in zip(tr.state, grads):
            if g is not None:
                torch.maximum(gmax[k], g.abs(), out=gmax[k])
                gsq[k] += float((g * g).sum())
        if j == 0:
            g1 = {k: 0.0 if g is None else float(torch.linalg.norm(g))
                  for k, g in zip(tr.state, grads)}
            outs = out
        del grads, out
    # an element counts where some checked step's gradient reaches a
    # thousandth of its leaf's root mean square (train_loop's rule)
    mask = {k: gmax[k] >= 1e-3 * (gsq[k] / (len(order) * gmax[k].numel())) ** 0.5
            for k in state}
    delta = {k: tr.state[k] - state[k] for k in state}
    return {"loss": losses, "g1": g1, "delta": delta, "mask": mask,
            "outs": outs}


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers compared, as ``train_loop.numbers`` computes them
    (``loss1``, ``grad``, ``delta`` and the first step's render outputs'
    relative L1 gaps, with their context), over the stage-1 render's
    image, depth, norm and alpha: stage 1 renders no no-SH image, so the
    image stands in for it and its gap is left out."""
    def with_no_sh(r):
        return {**r, "outs": {**r["outs"], "image_no_sh": r["outs"]["image"]}}
    out = train_loop.numbers(with_no_sh(prog), with_no_sh(ref))
    del out["image_no_sh"]
    return out


class Session:
    """The program's stage-1 model on the benchmark's state, driven through
    its checked steps: ``step()`` is the window's iteration, ``prog`` the
    readings the check compares."""

    def __init__(self, cfg: dict, work: dict, seed: int, device):
        from benchmark import program, program_gs1
        from texgs_torch.config import Cfg
        self.cfg = cfg
        self.state0, self.views, self.hy = build(cfg, seed, device)
        self.model = program_gs1.build_model(cfg, self.state0, self.hy,
                                             device)
        self.loss_cfg = Cfg(cfg["loss_cfg"])
        self.train_cfg = Cfg(cfg["train_cfg"])
        self.pviews = [program.camera(v["cam"], v) for v in self.views]
        self.pool = Pool(len(self.views), seed)
        self.it = first_iteration(cfg)
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
        from benchmark import program_gs1
        model, captured = self.model, {}
        render = model._render

        def capture(*a, **k):
            out = render(*a, **k)
            captured.update({r: out[p].detach().clone()
                             for r, p in RENDER_KEYS.items()})
            return out
        model._render = capture
        mu0 = {k: v.clone() for k, v in program_gs1.moments(model).items()}
        losses = [self.step()]
        del model._render
        g1 = {k: float(torch.linalg.norm((v - BETA1 * mu0[k]) / (1 - BETA1)))
              for k, v in program_gs1.moments(model).items()}
        losses += [self.step() for _ in range(n_check - 1)]
        delta = {k: v.detach() - self.state0[k]
                 for k, v in program_gs1.leaves(model).items()}
        return {"loss": losses, "g1": g1, "delta": delta, "outs": captured,
                "order": list(self.drawn)}

    def reference(self) -> dict:
        return reference_readings(self.state0, self.views, self.prog["order"],
                                  self.hy, self.cfg)


class SpanTrace(harness.Trace):
    """``harness.Trace`` whose reduction also holds the program's spans."""

    def stop(self) -> dict:
        self.torch.cuda.synchronize()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            events = harness.load_json(path)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return {**harness.reduce_trace(events), "spans": spans.reduce(events)}


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
    call into kernel 1 or 1' in a range of its own; before each, the
    geometry leaves are copied (in a range the reductions leave out).
    After it, each step's pairs and evaluated entries are reckoned from
    those copies by the benchmark's own plain binning and blend."""
    from benchmark import program_gs1
    tr = SpanTrace(torch)
    calls, undo = harness.wrap_functions(torch,
                                         program_gs1.kernel_functions())
    snaps, first = [], len(ses.drawn)
    tr.start()
    with torch.profiler.record_function(harness.WINDOW):
        for _ in range(n_steps):
            with torch.profiler.record_function(harness.SKIP):
                lv = program_gs1.leaves(ses.model)
                snaps.append({k: lv[k].detach().clone() for k in GEOMETRY})
            ses.step()
        sync()
    red = tr.stop()
    undo()
    peak = torch.cuda.max_memory_allocated()    # before the counting renders
    per_step = [quantities_gs1.of_call(
        snap, ses.views[ses.drawn[first + j]]["cam"], ses.cfg)
        for j, snap in enumerate(snaps)]
    return {"trace": red, "steps": n_steps, "calls": calls,
            "per_step": per_step, "attempted": n_steps,
            "memory_peak_bytes": peak}
