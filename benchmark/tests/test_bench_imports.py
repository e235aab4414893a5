"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program.  Each check runs in a
process of its own, so what another test imported does not count."""

import subprocess
import sys

from benchmark import harness

CHECK = """
import sys
{imports}
bad = sorted({{m.split(".")[0] for m in sys.modules}} & set({names!r}))
print(",".join(bad))
"""


def loaded(imports: str, names) -> list:
    out = subprocess.run([sys.executable, "-c",
                          CHECK.format(imports=imports, names=tuple(names))],
                         capture_output=True, text=True, cwd=harness.ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return [x for x in out.stdout.strip().split(",") if x]


def test_harness_and_reference_load_no_jax():
    imports = "\n".join([
        "import benchmark.run, benchmark.harness, benchmark.scene",
        "import benchmark.program, benchmark.metrics_common, benchmark.peaks",
        "import benchmark.reference.render, benchmark.reference.stage3",
        "import benchmark.drivers.train_loop, benchmark.drivers.view_loop",
        "import texgs_torch, texgs_torch.train.texture_gaussian3d",
        "from benchmark import harness",
        "for kind in ('metrics', 'counts'):",
        "    for p in (harness.HERE / kind).glob('*.py'):",
        "        harness.load_module(kind, p.stem)",
    ])
    assert loaded(imports, harness.FORBIDDEN) == []


def test_reference_imports_nothing_of_the_program():
    imports = ("import benchmark.reference.render, "
               "benchmark.reference.stage3, benchmark.scene")
    assert loaded(imports, harness.FORBIDDEN + ("texgs_torch",)) == []
