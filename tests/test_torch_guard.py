"""The port stands alone: texgs_torch and chip_smoke.py import neither JAX
nor the texgs package, and chip_smoke.py refuses to run without a GPU."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "texgs_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_texgs_import_in_source(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "texgs"}


def test_port_never_imports_jax_or_texgs():
    """Import every module of texgs_torch and render a tiny scene in a
    process where ``jax`` and ``texgs`` cannot be imported at all."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["texgs"] = None
import importlib, pkgutil
import texgs_torch
for info in pkgutil.walk_packages(texgs_torch.__path__, "texgs_torch."):
    importlib.import_module(info.name)
import torch
from texgs_torch.config import Cfg
from texgs_torch.core.state import init_from_pcd
from texgs_torch.data.synthetic import orbit_cameras, textured_sphere_point_cloud
from texgs_torch.train.texture_gaussian3d import TextureGaussian3D
cfg = Cfg({"uv_net_cfg": {"emb_dim": 8, "pre_mlp_cfg": {"n_hidden_layers": 1,
      "n_neurons": 8}, "mlp_cfg": {"n_hidden_layers": 1, "n_neurons": 8}},
      "tex_cfg": {"resolution": 8, "max_sh_degree": 1}, "geo_emb_dim": 8})
model = TextureGaussian3D(cfg, device="cpu")
pcd = textured_sphere_point_cloud(64)
st = init_from_pcd(pcd.points, pcd.colors, 1, device="cpu")
model.gauss = dict(xyz=st.xyz, opacity=st.opacity, scaling=st.scaling,
                   rotation=st.rotation, shs=st.features_rest)
out = model.render(orbit_cameras(1, width=16, height=16)[0])
assert torch.isfinite(out["render"]).all()
assert not any(m.split(".")[0] in ("jax", "texgs")
               for m, mod in sys.modules.items() if mod is not None)
print("clean")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("clean")


def test_tf32_is_off_after_import():
    import torch

    import texgs_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_repo(alone, tmp_path):
    """chip_smoke.py must exit non-zero and print no result where there is
    no CUDA device, or where the rest of the repository is missing."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
