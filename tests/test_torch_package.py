"""The port as a package: every module imports with ``jax`` and ``repro``
blocked, its entry points refuse to fall back to the CPU, and its copied
control-plane modules are byte-identical to the JAX package's."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.configs import SMOKES

SRC = Path(__file__).resolve().parent.parent / "src"
COPIES = ([f"core/{p.name}" for p in sorted((SRC / "repro/core").glob("*.py"))]
          + [f"netsim/{n}.py" for n in ("__init__", "events", "fluid",
                                        "topology", "toy")]
          + [f"simcluster/{n}.py" for n in ("__init__", "trace", "metrics",
                                            "papermodels", "sim")]
          + ["configs/base.py", "configs/smollm_360m.py",
             "configs/mamba2_1_3b.py", "configs/recurrentgemma_9b.py",
             "configs/deepseek_moe_16b.py", "configs/minitron_8b.py",
             "configs/starcoder2_3b.py", "configs/qwen1_5_32b.py",
             "configs/deepseek_v3_671b.py", "configs/qwen2_vl_7b.py",
             "configs/seamless_m4t_medium.py"])


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    code = ("import sys, importlib; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))"
            " for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(SRC)},
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert len(_modules()) > 30


@pytest.mark.parametrize("module", ["repro_torch.training",
                                    "repro_torch.launch.train"])
def test_training_modules_import_without_jax_or_repro(module):
    """The training slice on its own, with ``jax`` and ``repro`` blocked:
    what it imports (the optimizer, the trainer, the checkpoints, the model
    and its conversions) pulls in neither."""
    assert module in _modules()
    code = ("import sys, importlib; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None\n"
            f"m = importlib.import_module({module!r})\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))"
            " for k, v in sys.modules.items() if v is not None)\n"
            "print(sorted(n for n in sys.modules if n.startswith("
            "'repro_torch.training')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(SRC)},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "'repro_torch.training.checkpoint'" in out.stdout


@pytest.mark.parametrize("module", ["repro_torch.models.sharding",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.launch.shardings"])
def test_mesh_modules_import_without_jax_or_repro(module):
    """The multi-device slice on its own, with ``jax`` and ``repro``
    blocked: the sharding context and collectives, the meshes over
    ``torch.distributed`` and the placements."""
    assert module in _modules()
    code = ("import sys, importlib; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None\n"
            f"m = importlib.import_module({module!r})\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))"
            " for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(SRC)},
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_module_imports_jax_or_repro():
    banned = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    files = list((SRC / "repro_torch").rglob("*.py")) + [SRC.parent /
                                                         "chip_smoke.py"]
    for path in files:
        for line in path.read_text().splitlines():
            assert not banned.match(line), (path, line)


@pytest.mark.parametrize("rel", COPIES)
def test_control_plane_copy_is_byte_identical(rel):
    assert (SRC / "repro_torch" / rel).read_bytes() == \
        (SRC / "repro" / rel).read_bytes()


def test_hw_copy_keeps_the_original_as_prefix():
    orig = (SRC / "repro/simcluster/hw.py").read_bytes()
    assert (SRC / "repro_torch/simcluster/hw.py").read_bytes().startswith(orig)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(SMOKES["smollm-360m"])
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_stage_profile_roofline_uses_the_port_cost():
    """The copied ``StageProfile`` lazily imports ``decode_attention_cost``
    through a relative import: it resolves to the port's module."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.stages import GroupPlan, ParallelismSpec, StageProfile
    from repro_torch.simcluster.hw import H100
    cfg = ARCHS["smollm-360m"]
    prof = StageProfile(model=cfg, hw=H100, par=ParallelismSpec(),
                        plan=GroupPlan.build(cfg.n_layers, 4))
    t = prof.decode_step_roofline(8, 512.0)
    assert t > 0 and "repro_torch.kernels.decode_attention" in sys.modules
