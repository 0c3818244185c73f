"""What a run loads: never JAX or the JAX package; the reference nothing
of the program either."""
import subprocess
import sys

from conftest import ROOT
from perfbench.lib.imports import FORBIDDEN, forbidden


def test_names_are_compared_whole():
    names = ["repro_torch", "repro_torch.serving", "repro", "repro.models",
             "jax", "jax.numpy", "jaxlib.xla", "flax", "jaxtyping",
             "reproduce", "numpy"]
    assert forbidden(names) == ["flax", "jax", "jax.numpy", "jaxlib.xla",
                                "repro", "repro.models"]


def _loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", "import sys\n" + code +
         "\nprint('\\n'.join(sorted(sys.modules)))"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_harness_and_program_load_no_jax():
    mods = _loaded(
        "import perfbench.lib.harness, perfbench.drivers.serve, "
        "perfbench.drivers.decode, perfbench.drivers.train\n"
        "import repro_torch.serving, repro_torch.training.trainer, "
        "repro_torch.core")
    assert "repro_torch.serving" in mods
    assert forbidden(mods) == []


def test_reference_loads_nothing_of_the_program():
    mods = _loaded("import perfbench.reference.dense, perfbench.lib.weights, "
                   "perfbench.lib.counts")
    assert forbidden(mods, FORBIDDEN | {"repro_torch"}) == []
