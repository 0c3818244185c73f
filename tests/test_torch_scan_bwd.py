"""The scans' backward on the CPU: the plain backward functions the Hopper
kernels implement (``ssd_chunked_bwd_plain``, ``rglru_scan_bwd_plain``),
held to ``jax.vjp`` of the JAX package's oracles (``ref.ssd_dual`` above 16
steps and ``ref.ssd_ref`` at or below, as ``repro/kernels/ops.py``
differentiates off the TPU; ``ref.rglru_ref``), the autograd Functions
(``SsdChunkedFn``, ``RglruScanFn``) against ``torch.autograd`` of the plain
forwards, the bypass under ``no_grad`` and the launch plan's counts.

Inputs come from a numpy seed and go to both sides. Tolerance: 2e-5 of each
gradient's largest value (and 2e-5 relative), float32 on both sides, as
tests/test_torch_train.py: the formulas sum in other orders than autodiff
does (by chunks, over heads), ~1e-6 relative apart."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.rglru import (RglruScanFn, rglru_bwd_cost,
                                       rglru_scan, rglru_scan_bwd,
                                       rglru_scan_bwd_plain)
from repro_torch.kernels.ssd_scan import (STATE_DIMS, SsdChunkedFn,
                                          ssd_bwd_cost, ssd_bwd_plan,
                                          ssd_chunked_bwd,
                                          ssd_chunked_bwd_plain, ssd_plain)

TOL = 2e-5


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want.detach() if isinstance(want, torch.Tensor)
                      else want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def _ssd_inputs(Bz, T, N, with_init, H=3, hd=8, seed=0):
    """x, B, C, dt, A, D, init_state, dy, dsf as the JAX kernel tests scale
    them (dt in [0.001, 0.1], A in [-2, -0.5])."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(size=(Bz, T, H, hd)).astype(f32),
            (rng.normal(size=(Bz, T, N)) * 0.5).astype(f32),
            (rng.normal(size=(Bz, T, N)) * 0.5).astype(f32),
            rng.uniform(0.001, 0.1, size=(Bz, T, H)).astype(f32),
            -rng.uniform(0.5, 2.0, size=(H,)).astype(f32),
            rng.normal(size=(H,)).astype(f32),
            rng.normal(size=(Bz, H, hd, N)).astype(f32) if with_init else None,
            rng.normal(size=(Bz, T, H, hd)).astype(f32),
            rng.normal(size=(Bz, H, hd, N)).astype(f32))


def _t(arrs):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in arrs]


def _jax_vjp(oracle, primals, cotangents):
    """The vjp of ``oracle`` at ``primals``, jitted (one compile a shape is
    cheaper than JAX's eager dispatch of every op)."""
    fn = jax.jit(lambda p, c: jax.vjp(oracle, *p)[1](c))
    return fn(tuple(map(jnp.asarray, primals)),
              tuple(map(jnp.asarray, cotangents)))


# --------------------------------------------------------------- SSD plain
@pytest.mark.parametrize("with_dsf", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("Bz", [1, 2])
@pytest.mark.parametrize("T", [1, 16, 17, 100, 130])
@pytest.mark.parametrize("N", [16, 32])
def test_ssd_bwd_plain_matches_jax_vjp(N, T, Bz, with_init, with_dsf):
    """Every gradient, the ragged last chunk (100, 130) and the initial
    state's included, against the vjp of what JAX differentiates."""
    x, B, C, dt, A, D, s0, dy, dsf = _ssd_inputs(Bz, T, N, with_init,
                                                 seed=T + N + Bz)
    if not with_dsf:
        dsf = np.zeros_like(dsf)
    oracle = jref.ssd_dual if T > 16 else jref.ssd_ref
    prim = (x, B, C, dt, A, D) + ((s0,) if with_init else ())
    want = _jax_vjp(oracle, prim, (dy, dsf))
    got = ssd_chunked_bwd_plain(*_t((x, B, C, dt, A, D, s0, dy)),
                                torch.from_numpy(dsf) if with_dsf else None)
    assert len(got) == 7 and (got[6] is None) == (not with_init)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


def test_ssd_bwd_plain_is_chunk_independent():
    """The chunk length is the kernel's tiling, not the function: 16-step
    and 64-step chunks give the same gradients."""
    args = _t(_ssd_inputs(2, 100, 16, True, seed=5))
    for a, b in zip(ssd_chunked_bwd_plain(*args, chunk=16),
                    ssd_chunked_bwd_plain(*args)):
        _close(a, b, 1e-5)


def test_ssd_bwd_plain_at_zero_steps():
    """T = 0: the final state is the initial one, so d init_state = dsf."""
    x, B, C, dt, A, D, s0, dy, dsf = _t(_ssd_inputs(2, 0, 16, True))
    got = ssd_chunked_bwd_plain(x, B, C, dt, A, D, s0, dy, dsf)
    assert torch.equal(got[6], dsf)
    assert not got[4].any() and not got[5].any()
    assert got[0].shape == x.shape and got[3].shape == dt.shape


def _tf32(t, rounded=True):
    """float32 to TF32 (10 mantissa bits): rounded to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` converts, or cut, as the tensor
    cores read the top 19 bits of an operand (tests/test_torch_ssm.py)."""
    b = t.contiguous().view(torch.int32)
    return ((b + 0x1000 if rounded else b) & ~0x1FFF).view(torch.float32)


def _tf32_mm(a, b, splits):
    """``a @ b`` as the tensor cores take it, float32 accumulation: one
    product of operands converted to TF32, or the kernels' 3xTF32 (hi = v
    cut to TF32, lo = v - hi, read cut; lo*hi' + hi*lo' + hi*hi')."""
    if splits == 1:
        return _tf32(a) @ _tf32(b)
    ah, bh = _tf32(a, False), _tf32(b, False)
    al, bl = _tf32(a - ah, False), _tf32(b - bh, False)
    return (al @ bh + ah @ bl) + ah @ bh


def _ssd_bwd_tf32(x, B, C, dt, A, D, s0, dy, dsf, splits, Q=64):
    """The CUDA backward's arithmetic on the CPU (csrc/ssd_scan_bwd.cu):
    the formulas of ``ssd_chunked_bwd_plain`` by chunks of Q steps, every
    product through ``_tf32_mm`` (the state walk's (x o w)^T B and (dy o
    exp(cs))^T C, G = C B^T, dy x^T, M^T dy, B ds^T, dy s_in, (x o w) ds,
    dG B and dG^T C; <dy, C s_in^T> as the rows of C o (dy s_in)), the
    decays, exponentials and sums in float32."""
    Bz, T, H, hd = x.shape
    N = B.shape[-1]
    nc = -(-T // Q)

    def pad(a):
        return torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2)
                                       + (0, nc * Q - T))
    x, B, C, dt, dy = map(pad, (x, B, C, dt, dy))
    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    dB, dC = torch.zeros_like(B), torch.zeros_like(C)
    dA, dD = torch.zeros(H), torch.zeros(H)
    ds0 = torch.zeros(Bz, H, hd, N)
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    for b in range(Bz):
        s_in = torch.zeros(nc, H, hd, N)
        dso = torch.zeros(nc, H, hd, N)
        for h in range(H):
            cs = torch.cumsum(dt[b, :, h].view(nc, Q) * A[h], 1)   # [nc, Q]
            cq = cs[:, -1]
            w = torch.exp(cq[:, None] - cs) * dt[b, :, h].view(nc, Q)
            s = s0[b, h].clone() if s0 is not None else torch.zeros(hd, N)
            for c in range(nc):
                q = slice(c * Q, (c + 1) * Q)
                s_in[c, h] = s
                s = torch.exp(cq[c]) * s + _tf32_mm(
                    (x[b, q, h] * w[c, :, None]).T, B[b, q], splits)
            ds = dsf[b, h].clone() if dsf is not None else torch.zeros(hd, N)
            for c in reversed(range(nc)):
                q = slice(c * Q, (c + 1) * Q)
                dso[c, h] = ds
                ds = torch.exp(cq[c]) * ds + _tf32_mm(
                    (dy[b, q, h] * torch.exp(cs[c])[:, None]).T, C[b, q],
                    splits)
            ds0[b, h] = ds
        for c in range(nc):
            q = slice(c * Q, (c + 1) * Q)
            Bc, Cc = B[b, q], C[b, q]
            G = _tf32_mm(Cc, Bc.T, splits) * causal
            dG, dCg, dBg = torch.zeros(Q, Q), torch.zeros(Q, N), \
                torch.zeros(Q, N)
            for h in range(H):
                xc, yc, dtc = x[b, q, h], dy[b, q, h], dt[b, q, h]
                cs = torch.cumsum(dtc * A[h], 0)
                cq = cs[-1]
                w, ecs = torch.exp(cq - cs) * dtc, torch.exp(cs)
                E = torch.exp((cs[:, None] - cs[None, :])
                              .masked_fill(~causal, -math.inf))
                L = E * dtc[None, :]
                M = G * L
                dM = _tf32_mm(yc, xc.T, splits) * causal
                bds = _tf32_mm(Bc, dso[c, h].T, splits)
                P = _tf32_mm(yc, s_in[c, h], splits)
                dx[b, q, h] = (_tf32_mm(M.T, yc, splits) + w[:, None] * bds
                               + D[h] * yc)
                dBg += _tf32_mm(xc * w[:, None], dso[c, h], splits)
                dCg += ecs[:, None] * P
                dG += dM * L
                dw = (xc * bds).sum(1)
                LL = dM * M
                dcs = (LL.sum(1) - LL.sum(0) + ecs * (Cc * P).sum(1)
                       - dw * w)
                dcs[-1] += (dw * w).sum() + torch.exp(cq) * (
                    dso[c, h] * s_in[c, h]).sum()
                S = torch.flip(torch.cumsum(torch.flip(dcs, [0]), 0), [0])
                ddt[b, q, h] = ((dM * G * E).sum(0)
                                + dw * torch.exp(cq - cs) + A[h] * S)
                dA[h] += (dtc * S).sum()
                dD[h] += (xc * yc).sum()
            dC[b, q] = _tf32_mm(dG, Bc, splits) + dCg
            dB[b, q] = _tf32_mm(dG.T, Cc, splits) + dBg
    return (dx[:, :T], dB[:, :T], dC[:, :T], ddt[:, :T], dA, dD,
            None if s0 is None else ds0)


def test_3xtf32_backward_holds_1e4_of_each_gradient():
    """The numerical premise of the tensor-core SSD backward, at mamba2's
    widths (hd 64, N 128), the adjoint carried over 5 chunks: with every
    product in 3xTF32 each gradient stays within the kernel's 1e-4 of its
    largest value of the plain version's and of ``jax.vjp`` of what JAX
    differentiates (~1e-6 apart); with one TF32 product every gradient
    that goes through a product misses it (1.7e-4 to 4.4e-4 apart), all
    but dD, the sum of x o dy in float32."""
    arrs = _ssd_inputs(1, 300, 128, True, H=2, hd=64, seed=13)
    x, B, C, dt, A, D, s0, dy, dsf = _t(arrs)
    want = ssd_chunked_bwd_plain(x, B, C, dt, A, D, s0, dy, dsf)
    jwant = _jax_vjp(jref.ssd_dual, arrs[:7], arrs[7:])
    got3 = _ssd_bwd_tf32(x, B, C, dt, A, D, s0, dy, dsf, splits=3)
    got1 = _ssd_bwd_tf32(x, B, C, dt, A, D, s0, dy, dsf, splits=1)
    for g3, w, jw in zip(got3, want, jwant):
        _close(g3, w, 1e-4)
        _close(g3, jw, 1e-4)
    missed = []
    for name, g1, w in zip(("dx", "dB", "dC", "ddt", "dA", "dD", "ds0"),
                           got1, want):
        try:
            _close(g1, w, 1e-4)
        except AssertionError:
            missed.append(name)
    assert missed == ["dx", "dB", "dC", "ddt", "dA", "ds0"], missed


# ------------------------------------------------------------ RG-LRU plain
def _rglru_inputs(B, T, W, with_init, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.uniform(0.7, 0.999, size=(B, T, W)).astype(f32),
            rng.normal(size=(B, T, W)).astype(f32),
            rng.normal(size=(B, W)).astype(f32) if with_init else None,
            rng.normal(size=(B, T, W)).astype(f32),
            rng.normal(size=(B, W)).astype(f32))


@pytest.mark.parametrize("with_dsf", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("T", [1, 70])
def test_rglru_bwd_plain_matches_jax_vjp(T, with_init, with_dsf):
    a, x, s0, dh, dhf = _rglru_inputs(2, T, 40, with_init, seed=T)
    if not with_dsf:
        dhf = np.zeros_like(dhf)
    prim = (a, x) + ((s0,) if with_init else ())
    h, _ = jref.rglru_ref(*map(jnp.asarray, prim))
    want = _jax_vjp(jref.rglru_ref, prim, (dh, dhf))
    got = rglru_scan_bwd_plain(*_t((a, np.asarray(h), s0, dh)),
                               torch.from_numpy(dhf) if with_dsf else None)
    assert (got[2] is None) == (not with_init)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------- autograd Functions
def _grads(fn, inputs, cotangents):
    """Gradients of <fn(*inputs), cotangents> for every input that is not
    None."""
    leaves = [None if t is None else t.clone().requires_grad_()
              for t in inputs]
    outs = fn(*leaves)
    loss = sum((o * c).sum() for o, c in zip(outs, cotangents))
    loss.backward()
    return [None if t is None else t.grad for t in leaves], outs


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("T", [5, 100])
def test_ssd_function_matches_autograd_of_the_plain_forward(T, with_init):
    """``SsdChunkedFn`` (the plain backward on the CPU) against autograd of
    the forward it runs, ``ssd_plain``, and ``ops.ssd`` routes through it."""
    x, B, C, dt, A, D, s0, dy, dsf = _t(_ssd_inputs(2, T, 32, with_init,
                                                    seed=T))
    inputs = (x, B, C, dt, A, D, s0)
    want, wout = _grads(ssd_plain, inputs, (dy, dsf))
    for fn in (SsdChunkedFn.apply, tops.ssd):
        got, gout = _grads(fn, inputs, (dy, dsf))
        assert gout[0].grad_fn.name() == "SsdChunkedFnBackward"
        for o, w in zip(gout, wout):
            assert torch.equal(o, w)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                _close(g, w)


@pytest.mark.parametrize("with_init", [False, True])
def test_rglru_function_matches_autograd_of_the_plain_forward(with_init):
    a, x, s0, dh, dhf = _t(_rglru_inputs(2, 37, 24, with_init, seed=3))
    inputs = (a, x, s0)
    want, wout = _grads(tref.rglru_ref, inputs, (dh, dhf))
    for fn in (RglruScanFn.apply, rglru_scan, tops.rglru):
        got, gout = _grads(fn, inputs, (dh, dhf))
        assert gout[0].grad_fn.name() == "RglruScanFnBackward"
        for o, w in zip(gout, wout):
            assert torch.equal(o, w)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                _close(g, w)


def test_functions_take_only_the_final_state_gradient():
    """A loss on the final state alone (dy, dh None in the backward)."""
    x, B, C, dt, A, D, s0, _, dsf = _t(_ssd_inputs(1, 20, 16, True, seed=9))
    inputs = (x, B, C, dt, A, D, s0)
    for fn in (SsdChunkedFn.apply, ssd_plain):
        leaves = [t.clone().requires_grad_() for t in inputs]
        (fn(*leaves)[1] * dsf).sum().backward()
        # autograd leaves C's gradient None (the state does not read C)
        grads = [torch.zeros_like(t) if t.grad is None else t.grad
                 for t in leaves]
        if fn is ssd_plain:
            want = grads
        else:
            got = grads
    for g, w in zip(got, want):
        _close(g, w)
    a, x, s0, _, dhf = _t(_rglru_inputs(1, 9, 8, True, seed=2))
    grads = []
    for fn in (RglruScanFn.apply, tref.rglru_ref):
        leaves = [t.clone().requires_grad_() for t in (a, x, s0)]
        (fn(*leaves)[1] * dhf).sum().backward()
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        _close(g, w)


def test_functions_are_bypassed_without_grad():
    """Under ``no_grad`` (serving) the entry points call the wrappers
    directly: no autograd node, and ``out_state`` is written in place; with
    a gradient, ``out_state`` is refused."""
    x, B, C, dt, A, D, s0, _, _ = _t(_ssd_inputs(2, 3, 16, True, seed=1))
    inputs = [t.requires_grad_() for t in (x, B, C, dt, A, D)]
    cache = s0.clone()
    with torch.no_grad():
        y, s = tops.ssd(*inputs, cache, out_state=cache)
        hy, hs = rglru_scan(torch.rand(2, 3, 4).requires_grad_(),
                            torch.rand(2, 3, 4))
    assert s is cache and y.grad_fn is None and hy.grad_fn is None
    assert torch.equal(cache, ssd_plain(*inputs, s0)[1].detach())
    with pytest.raises(ValueError, match="out_state"):
        tops.ssd(*inputs, s0, out_state=s0.clone())


# ------------------------------------------------------ wrappers and plans
def test_backward_wrappers_take_the_plain_version_on_the_cpu():
    args = _t(_ssd_inputs(1, 40, 16, True, seed=4))
    for g, w in zip(ssd_chunked_bwd(*args), ssd_chunked_bwd_plain(*args)):
        assert torch.equal(g, w)
    a, x, s0, dh, dhf = _t(_rglru_inputs(1, 9, 8, True, seed=4))
    h, _ = tref.rglru_ref(a, x, s0)
    for g, w in zip(rglru_scan_bwd(a, h, s0, dh, dhf),
                    rglru_scan_bwd_plain(a, h, s0, dh, dhf)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("N", STATE_DIMS)
def test_ssd_bwd_plan_sizes_the_scratch(N):
    """The scratch holds every chunk of mamba2-1.3b's training batch (B=8 x
    1024: 16 chunks of 64 steps, 64 heads in 8 groups of 8), a ragged last
    chunk counted whole: the chunk-entry states and their adjoints, G, the
    chunks' parts of dA and dD and the head groups' parts of dC, dB and dG
    (no per-head dG, no per-step decays: the chunk kernel keeps those on
    chip)."""
    plan = ssd_bwd_plan(8, 1024, 64, 64, N)
    assert plan._fields == ("chunks", "group", "gram", "states", "part",
                            "bcp", "dgp")
    assert plan.chunks == 16 and plan.group == 8
    assert plan.states == 8 * 16 * 64 * 64 * N
    assert plan.part == 2 * 8 * 16 * 64
    assert plan.gram == 8 * 16 * 64 * 64
    assert plan.bcp == 2 * 8 * 16 * 8 * 64 * N
    assert plan.dgp == 8 * 16 * 8 * 64 * 64
    assert ssd_bwd_plan(1, 1, 1, 64, N).chunks == 1
    # a few sequences and chunks: smaller groups, more blocks (2 chunks x
    # 32 groups of 2 heads at one ragged sequence of mamba2's 64 heads)
    small = ssd_bwd_plan(1, 100, 64, 64, N)
    assert small.group == 2 and small.dgp == 2 * 32 * 64 * 64
    assert ssd_bwd_plan(4, 1024, 64, 64, N).group == 8
    assert ssd_bwd_plan(1, 100, 3, 64, N).dgp == 2 * 2 * 64 * 64


def test_backward_costs_count_each_byte_once():
    """At mamba2-1.3b's layer (B=8, T=1024, H=64, hd=64, N=128): x, dy, dx
    and B, C, dB, dC, dt, ddt are ~424 MB; recurrentgemma-9b's (B=1,
    T=2112, W=4096): a, h, dh, dx, da ~173 MB."""
    flops, nbytes = ssd_bwd_cost(8, 1024, 64, 64, 128, with_init=False)
    assert flops == 8.0 * 8 * 1024 * 64 * 64 * 128
    assert 420e6 < nbytes < 430e6
    flops, nbytes = rglru_bwd_cost(1, 2112, 4096, False)
    assert flops == 3.0 * 2112 * 4096 and 172e6 < nbytes < 174e6
