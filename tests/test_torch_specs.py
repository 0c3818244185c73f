"""The port's ``launch/specs.py`` and its placements held to the JAX
package's on the production meshes, (16, 16) over ("data", "model") and
(2, 16, 16) over ("pod", "data", "model"), with no device: the JAX side on
a stand-in mesh (its ``make_ctx`` reads only the axis names and sizes),
the port's on a ``DryMesh``.

Held equal: ``plan_cells``, ``SKIP_REASONS``, the int8 override, the
``make_ctx`` flags, ``input_specs`` shapes and dtypes and every cell's
``model_flops`` (JAX's ``build_cell`` run with its sharding constructors
stubbed); every parameter's placement, leaf by leaf, for every arch and
kind of cell (ZeRO-3 for train), against JAX's ``param_specs``, with the
one documented difference: a GQA/MQA model's ``wk``/``wv`` (and their
biases) are whole over "model" in the port (``launch.shardings``); and
each decode cache leaf's shape on a rank against JAX's ``cache_specs``
split over the mesh, for every arch, with the one documented difference
of caches: an RG-LRU block's ``conv``/``state`` hold the rank's channels
in the port (``launch.shardings``) and are whole over "model" in JAX."""
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro.launch.shardings import cache_specs, param_specs
from repro.models.lm import build_model as jbuild
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import specs
from repro_torch.launch.mesh import DryMesh, make_production_mesh
from repro_torch.launch.shardings import param_placement
from repro_torch.models import build_model
from repro_torch.models.convert import jax_key

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
_DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
           jnp.int8: torch.int8, jnp.float32: torch.float32}


def _stand_in(mesh):
    shape, names = MESHES[mesh]
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def _entry(e):
    """A ``PartitionSpec`` entry as a tuple of axis names."""
    return () if e is None else ((e,) if isinstance(e, str) else tuple(e))


def test_plan_and_policies_match_jax():
    got, want = specs.plan_cells(), jspecs.plan_cells()
    assert [(c.arch, c.shape.name, c.kind, c.skip) for c in got] == \
        [(c.arch, c.shape.name, c.kind, c.skip) for c in want]
    assert len(got) == 40 and sum(c.skip is not None for c in got) == 8
    assert specs.SKIP_REASONS == jspecs.SKIP_REASONS
    assert {k: _DTYPES[v] for k, v in jspecs.KV_DTYPE_OVERRIDES.items()} \
        == specs.KV_DTYPE_OVERRIDES
    assert [_DTYPES[c.kv_dtype] for c in want] == [c.kv_dtype for c in got]
    assert [s.name for s in SHAPES] == [s.name for s in JSHAPES]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_make_ctx_flags_match_jax(mesh):
    shape, names = MESHES[mesh]
    dry = DryMesh(shape, names)
    assert dry.shape == _stand_in(mesh).shape
    assert make_production_mesh(multi_pod=len(shape) == 3,
                                dry=True).shape == dry.shape
    for a in ARCHS:
        for s, js in zip(SHAPES, JSHAPES):
            got = specs.make_ctx(ARCHS[a], dry, s)
            want = jspecs.make_ctx(JARCHS[a], _stand_in(mesh), js)
            for f in ("batch_axes", "model_axis", "zero3", "zero3_axes",
                      "ep_axes", "kv_seq_shard", "head_pad"):
                assert getattr(got, f) == getattr(want, f), (a, s.name, f)


def test_input_specs_and_model_flops_match_jax(monkeypatch):
    monkeypatch.setattr(jspecs, "to_shardings", lambda spec, mesh: spec)
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, spec: spec)
    mesh = _stand_in("16x16")
    for cell, jcell in zip(specs.plan_cells(), jspecs.plan_cells()):
        got = specs.input_specs(cell.arch, cell.shape.name)
        want = jspecs.input_specs(cell.arch, cell.shape.name)
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[k].shape
            assert t.dtype == _DTYPES[want[k].dtype.type]
        if cell.skip:
            continue
        jflops = jspecs.build_cell(jcell, mesh).model_flops
        cfg, shape = ARCHS[cell.arch], cell.shape
        B, T = shape.global_batch, shape.seq_len
        n = cfg.params_active()
        assert jflops == {"train": 6.0 * n * B * T, "prefill": 2.0 * n * B * T,
                          "decode": 2.0 * n * B}[cell.kind]
        if cell.arch != "deepseek-v3-671b":
            built = specs.build_cell(cell, DryMesh((16, 16)))
            assert built.model_flops == jflops


def _port_specs(arch, ctx):
    """Each port parameter's placement as a spec: per dim, the axes of
    the split on it (its TP or EP ``shard`` or its ``z3``)."""
    cfg = ARCHS[arch]
    out = {}
    for name, p in build_model(cfg, device="meta").named_parameters():
        spec = [()] * p.dim()
        for s in param_placement(name, tuple(p.shape), cfg, ctx):
            if s is not None:
                spec[s.dim] = s.axes
        out[name] = tuple(spec)
    return out


def _jax_specs(arch, ctx):
    model = jbuild(JARCHS[arch], ctx)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            spec for path, spec in jax.tree_util.tree_leaves_with_path(
                param_specs(model), is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_every_placement_matches_jax_param_specs(mesh, kind):
    """Every leaf of every arch: ZeRO-3 over the batch axes in train
    cells, none in serving ones (where decode adds only the cache
    layout)."""
    shape, names = MESHES[mesh]
    scell = next(s for s in SHAPES if s.kind == kind)
    jscell = next(s for s in JSHAPES if s.kind == kind)
    exceptions = 0
    for arch in ARCHS:
        cfg = ARCHS[arch]
        ctx = specs.make_ctx(cfg, DryMesh(shape, names), scell)
        jctx = jspecs.make_ctx(JARCHS[arch], _stand_in(mesh), jscell)
        want = _jax_specs(arch, jctx)
        got = _port_specs(arch, ctx)
        assert len(got) >= len(want)
        for name, spec in got.items():
            key, idx = jax_key(name)
            jspec = [_entry(e) for e in want[key]]
            if idx is not None:                  # the stacked count axis
                assert jspec[0] == ()
                jspec = jspec[1:]
            parent = name.split(".")[-2] if "." in name else ""
            if parent in ("wk", "wv") and cfg.n_kv != cfg.n_heads:
                # the documented difference: whole over "model"
                jspec = [() if e == ("model",) else e for e in jspec]
                exceptions += 1
            assert list(spec) == jspec, (arch, name, spec, jspec)
    assert exceptions > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_decode_caches_match_jax_cache_specs(mesh):
    """A rank's decode cache (``init_cache`` under the cell's ``make_ctx``:
    its rows over the batch axes where they divide, its slots over
    "model") has each leaf of JAX's logical cache split as JAX's
    ``cache_specs`` splits it."""
    shape, names = MESHES[mesh]
    sizes = dict(zip(names, shape))
    exceptions = 0
    for cell, jcell in zip(specs.plan_cells(), jspecs.plan_cells()):
        if cell.kind != "decode" or cell.skip:
            continue
        cfg, jcfg = ARCHS[cell.arch], JARCHS[cell.arch]
        B, S = cell.shape.global_batch, cell.shape.seq_len
        jctx = jspecs.make_ctx(jcfg, _stand_in(mesh), jcell.shape)
        jm = jbuild(jcfg, jctx)
        cache = jax.eval_shape(lambda: jm.init_cache(B, S, jcell.kv_dtype))
        jspec = cache_specs(cache, jctx)
        built = specs.build_cell(cell, DryMesh(shape, names))
        mine = built.args[0]
        leaves = jax.tree_util.tree_leaves_with_path(cache)
        specs_ = jax.tree_util.tree_leaves(
            jspec, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for (path, leaf), spec in zip(leaves, specs_):
            si, i = path[0].idx, path[1].idx
            keys = [p.key for p in path[2:]]
            t = mine[si][i]
            for k in keys:
                t = t[k]
            want = []
            for n, e in zip(leaf.shape, list(spec) + [None] * leaf.ndim):
                parts = 1
                for a in _entry(e):
                    parts *= sizes[a]
                want.append(n // parts)
            if keys[-2:] in (["mix", "conv"], ["mix", "state"]) and \
                    cfg.block_pattern:
                # the documented difference: RG-LRU's channels over "model"
                want[-1] //= sizes["model"]
                exceptions += 1
            assert tuple(t.shape) == tuple(want), (cell.arch, path)
            assert t.dtype == _DTYPES[leaf.dtype.type]
    assert exceptions > 0
