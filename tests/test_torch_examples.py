"""The simulator's four examples and their ports: each pair run as
subprocesses, the port with ``jax`` and ``repro`` blocked, must print the
same lines and (``telemetry_root_cause``) write the same trace JSON. The
code under both is byte-identical (``test_torch_package.py``), so the
outputs are compared exactly."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
#: runs an example as ``__main__`` with the JAX package and JAX blocked
BLOCKED = ("import runpy, sys; sys.modules['jax'] = None; "
           "sys.modules['repro'] = None; sys.argv = sys.argv[1:]; "
           "runpy.run_path(sys.argv[0], run_name='__main__')")
NAMES = ("quickstart", "simulate_cluster", "monitor_live_signals",
         "telemetry_root_cause")
CASES = [
    ("quickstart", []),
    ("simulate_cluster", ["--model", "mixtral-8x7b", "--workload",
                          "qwen-agent", "--rps", "8", "--requests", "16"]),
    ("monitor_live_signals", ["--requests", "40"]),
    ("monitor_live_signals", ["--requests", "40", "--monitor-off"]),
    # at 12 requests no tight-SLO request misses and no trace is written;
    # at 20 two do, in about the same time
    ("telemetry_root_cause", ["--requests", "20", "--trace-out", "TRACE"]),
]


def _start(argv):
    return subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=ENV,
                            cwd=ROOT)


@pytest.mark.parametrize("name,args", CASES,
                         ids=["quickstart", "simulate_cluster",
                              "monitor_live_signals",
                              "monitor_live_signals-off",
                              "telemetry_root_cause"])
def test_port_prints_what_the_jax_example_prints(name, args, tmp_path):
    traces = {side: tmp_path / f"{side}.json" for side in ("jax", "torch")}
    argv = {side: [str(traces[side]) if a == "TRACE" else a for a in args]
            for side in traces}
    # both sides run at once: each is one process of the simulator
    procs = {"jax": _start([sys.executable, str(EXAMPLES / f"{name}.py"),
                            *argv["jax"]]),
             "torch": _start([sys.executable, "-c", BLOCKED,
                              str(EXAMPLES / f"{name}_torch.py"),
                              *argv["torch"]])}
    outs = {}
    for side, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, (side, err)
        outs[side] = out.replace(str(traces[side]), "<trace>")
    assert outs["torch"] == outs["jax"]
    assert outs["jax"].strip()
    if "TRACE" in args:
        assert "wrote <trace>" in outs["jax"]
        assert json.loads(traces["torch"].read_text()) == \
            json.loads(traces["jax"].read_text())


@pytest.mark.parametrize("name", NAMES)
def test_port_imports_nothing_of_jax_or_repro(name):
    banned = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    src = (EXAMPLES / f"{name}_torch.py").read_text()
    assert not any(banned.match(line) for line in src.splitlines())
    assert "from repro_torch." in src
