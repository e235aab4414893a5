"""Render-function registry (port of texgs/render/__init__.py).

As in texgs, the package's name ``render`` is the function, which shadows
the submodule of that name as an attribute; ``from
texgs_torch.render.render import render`` still reaches the submodule.
"""

from .render import render
from .uv_tex_render import uv_tex_render

type2render_func = {
    "render": render,
    "uv_tex_render": uv_tex_render,
}


def create_render_func(render_cfg):
    """The render function that ``render_cfg.type`` names; KeyError for
    another type."""
    return type2render_func[render_cfg.type]


__all__ = ["render", "uv_tex_render", "create_render_func", "type2render_func"]
