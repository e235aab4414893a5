"""Named spans at the port's layer boundaries, in the profiler's own trace.

``with span("render"):`` records a ``texgs::render`` range while a
``torch.profiler`` records in this process, and is one shared null context
otherwise: running the profiler is what turns tracing on.  The ranges go
into the profiler's trace beside the device events it records, so they
share its clock; a range opened inside an autograd ``Function.backward``
is recorded on the autograd engine's thread, which carries the profiler's
state.  ``benchmark/spans.py`` reduces such a trace by span.

Spans of the stage-3 model (``train/texture_gaussian3d.py``): ``step``
(``compute_loss``), ``render`` (``_render``; inside it ``render.uv_net``,
``render.project``, ``render.binning``, ``render.blend`` and
``render.tex_term``), ``loss``, ``backward``, ``adam``, ``view``
(``visual_step``) and ``maps`` (its envmap and cross cubemap).

Spans of the stage-1 model (``train/gaussian3d.py``): ``step``
(``compute_loss``), ``render`` (the NDC offset and ``_render``; inside it
``render.sh``, the SH colours, and ``render.project`` from
``render/render.py``, ``render.binning`` and ``render.blend`` from
``kernels/tile_raster.py``'s ``rasterize_tiled``), ``loss``, ``backward``
(the densification stats too), ``adam`` (absent where surgery skips the
step) and, outside ``step``, ``surgery`` (each prune, densification and
reset of ``optimize_step``).  Any other caller of ``render`` or
``rasterize_tiled`` opens the ``render.*`` spans too.  Each kernel wrapper
with a ``.launches`` counter runs in ``kernel.<name>``.
"""

from __future__ import annotations

import contextlib
import functools

import torch

PREFIX = "texgs::"
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``texgs::<name>`` profiler range while a profiler records, else a
    shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
