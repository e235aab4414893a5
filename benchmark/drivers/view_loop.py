"""Driver kind ``view_loop``: one viewer client in a closed loop, as
texgs_torch/tools/viewer.py serves it (its lock serialises frames).

Each request is an orbit camera ``step_deg`` further in azimuth at
``elevation_deg``, ``radius`` and ``fov_deg``; the orbit's starting point
is drawn from the seed, so every seed sends the same set of cameras in
another order.  A frame builds the camera on the host, runs
``model.visual_step`` and is done when its rgb image is on the host as
the viewer's uint8 frame.  ``view_ms`` is the window over the frames it
completed, ``view_ms_p95`` the 95th percentile of their latencies.

The check: a sample of the window's frames drawn from the seed (a
reservoir over all of them), each output of ``visual_step`` (float32
image, no-SH image, depth, normal, alpha) against the reference's render
of the same state and camera.
"""

from __future__ import annotations

import math
import random
import time

import numpy as np
import torch

from benchmark import harness, quantities, scene
from benchmark.reference import stage3 as ref3

OUT_KEYS = ("image", "image_no_sh", "depth", "norm", "alpha")


def orbit(work: dict, seed: int):
    """frame k -> the benchmark's camera of that request."""
    n_pos = int(round(360.0 / work["step_deg"]))
    start = random.Random(seed).randrange(n_pos)

    def cam(k: int):
        az = ((start + k) % n_pos) * work["step_deg"]
        return scene.look_at(scene.orbit_eye(az, work["elevation_deg"],
                                             work["radius"]),
                             work["width"], work["height"],
                             math.radians(round(work["fov_deg"])))
    return cam


def hyper(cfg: dict) -> dict:
    a = cfg["assumed"]["state_at_first_iteration"]
    return {"active_sh_degree": a["active_sh_degree"],
            "uv_step_count": a["uv_step_count"],
            "adam_counts": a["adam_counts"], "spatial_lr_scale": 1.0}


def reference_outputs(state, cam, hy, cfg, m) -> dict:
    bg = torch.as_tensor(cfg["model_cfg"]["background"], dtype=torch.float32,
                         device=state["xyz"].device)
    with torch.no_grad():
        return ref3.render_state(state, cam, hy["active_sh_degree"], bg, m)


def frame_outputs(model, cam) -> dict:
    """The program's ``visual_step`` outputs the check compares."""
    from benchmark import program
    with torch.no_grad():
        pkg = model.visual_step(0, 0, program.camera(cam), None)
    return {k: pkg[k] for k in OUT_KEYS}


def numbers(frames: list, refs: list) -> dict:
    """Each output's worst relative L1 gap over the sampled frames."""
    return {k: max(harness.rel_l1(f[k], r[k]) for f, r in zip(frames, refs))
            for k in OUT_KEYS}


def run(ctx) -> dict:
    from benchmark import program
    cfg, work = ctx.cell["config"], ctx.cell["work"]["traffic_params"]
    dev = ctx.device
    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    m = int(cfg["model_cfg"].get("uvtex_m", 32))

    state0, _ = scene.make_state(cfg, ctx.seed, dev)
    hy = hyper(cfg)
    model = program.build_model(cfg, state0, hy, dev, train=False)
    cam_of = orbit(work, ctx.seed)
    k_next = [0]

    def frame():
        cam = cam_of(k_next[0])
        k_next[0] += 1
        with torch.no_grad():
            pkg = model.visual_step(0, 0, program.camera(cam), None)
            img = pkg["image"].cpu().numpy().transpose(1, 2, 0)
        return cam, pkg, (np.clip(img, 0, 1) * 255).astype(np.uint8)

    for _ in range(int(work["warmup_frames"])):
        frame()
    sync()
    setup_s = time.perf_counter() - ctx.t0

    n_keep = int(work["sample_frames"])
    rng = random.Random(ctx.seed + 1)
    sample = []     # reservoir of (camera, outputs) over the window's frames
    result = {"failed": 0}
    if ctx.trace:
        tr = harness.Trace(torch)
        calls, undo = harness.wrap_functions(torch, program.kernel_functions())
        n, cams = int(work["trace_frames"]), []
        tr.start()
        with torch.profiler.record_function(harness.WINDOW):
            for _ in range(n):
                cam, pkg, _ = frame()
                cams.append(cam)
                if len(sample) < n_keep:
                    sample.append((cam, {k: pkg[k] for k in OUT_KEYS}))
            sync()
        red = tr.stop()
        undo()
        result["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        sh = int(hy["active_sh_degree"])
        per = [quantities.of_call(state0, c, cfg, m, sh) for c in cams]
        result.update(trace=red, steps=n, calls=calls, per_step=per,
                      attempted=n)
    else:
        mallocs = harness.device_mallocs(torch)
        lat, i, t_start = [], 0, time.perf_counter()
        while True:
            t0 = time.perf_counter()
            if t0 - t_start >= ctx.seconds:
                break
            cam, pkg, _ = frame()
            lat.append(time.perf_counter() - t0)
            outs = {k: pkg[k] for k in OUT_KEYS}
            if i < n_keep:
                sample.append((cam, outs))
            else:
                j = rng.randint(0, i)
                if j < n_keep:
                    sample[j] = (cam, outs)
            i += 1
            del pkg, outs
        sync()
        window = time.perf_counter() - t_start
        result["window_mallocs"] = harness.device_mallocs(torch) - mallocs
        result["metrics"] = {
            "view_ms": (window * 1e3 / len(lat), "ms"),
            "view_ms_p95": (float(np.percentile(np.array(lat) * 1e3, 95)), "ms"),
            "setup_s": (setup_s, "s")}
        result["attempted"] = len(lat)
    result.setdefault("memory_peak_bytes", torch.cuda.max_memory_allocated()
                      if cuda else 0)
    del model, frame
    if cuda:
        torch.cuda.empty_cache()
    refs = [reference_outputs(state0, cam, hy, cfg, m) for cam, _ in sample]
    result["numbers"] = numbers([o for _, o in sample], refs)
    return result
