"""A run with the timed path broken underneath comes out not correct, and
a sound one correct: each driver at a tiny size on the CPU (float32, so a
sound run agrees with the reference to rounding), the card's check
skipped. Each fault the cell can have: a token altered where it is
produced; a training step that returns its state unchanged; half of the
batch left out, the mean taken over the rest."""
import pytest

import conftest as C
from perfbench import faults
from perfbench.drivers import decode, serve, train
from perfbench.lib import harness

CELLS = {"serve": (serve, C.SERVE_MIX, C.SERVE_CELL),
         "decode": (decode, C.DECODE_MIX, C.DECODE_CELL),
         "train": (train, C.TRAIN_MIX, C.TRAIN_CELL)}


def _run(kind, fault=None, seed=2 ** 31 + 11):
    drv, mix, cell = CELLS[kind]
    ctx = harness.Ctx(cell=kind, cfg=dict(C.TINY), mix=mix, params=cell,
                      seed=seed, seconds=1.0, trace=False, device="cpu",
                      fault=fault)
    rec = drv.run(ctx)
    return harness.is_correct(harness.checks_of(rec, cell["limits"])), rec


@pytest.mark.parametrize("kind", ["serve", "decode", "train"])
def test_sound_run_is_correct(kind):
    ok, rec = _run(kind)
    assert ok, rec["compared"]


def test_overloaded_serve_run_is_correct():
    """Offered far above what the server sustains, the window leaves
    bursts unstarted; only the modeled SLO's bursts are served after it."""
    drv, mix, cell = CELLS["serve"]
    ctx = harness.Ctx(cell="serve", cfg=dict(C.TINY), mix=mix,
                      params=dict(cell, bursts_per_s=200.0, slo_bursts=2),
                      seed=5, seconds=0.5, trace=False, device="cpu")
    rec = drv.run(ctx)
    assert rec["serve"]["unstarted"] > 2
    assert len(rec["serve"]["met_slo"]) == 2 * mix["burst"]
    assert rec["attempted"] == 100 * mix["burst"] and rec["failed"] == 0
    assert harness.is_correct(harness.checks_of(rec, cell["limits"]))


ALTERED = faults.token_altered(C.TINY["vocab_size"])


def _only(point, fault):
    return lambda p, obj: fault(p, obj) if p == point else obj


@pytest.mark.parametrize("kind,fault", [
    ("serve", _only("prefill", ALTERED)), ("serve", _only("step", ALTERED)),
    ("decode", ALTERED), ("train", faults.state_unchanged),
    ("train", faults.half_batch)])
def test_broken_path_is_not_correct(kind, fault):
    ok, rec = _run(kind, fault)
    assert not ok, rec["compared"]
