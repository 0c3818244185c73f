"""Probe the two scan kernels on one CUDA card (H100, sm_90a).

    python3 tools/scan_probe.py [--parent DIR] [--serve] [--bwd]
                                [--bwd-ablate] [--ablate] [--timeline]
                                [--out FILE]

Times ``ssd_chunked`` and ``rglru_scan`` at the serving shapes of
mamba2-1.3b (H=64, hd=64, N=128) and recurrentgemma-9b (W=4096), float32,
each case's device time by CUDA-graph replay as ``chip_smoke.py`` times it:
  * ssd: 3 (prefill T=256), 3f (fresh T=288), 3s (suffix T=32 over a
    state), T=16 over a state, 3d (decode Bz=8 T=1, and the same writing
    the state in place where the wrapper takes ``out_state``), and both
    kernels forced at T=16, 32, 48 and 64 over a state (where the package
    has ``ssd_plan``), which sets the threshold between the recurrence and
    the dual form;
  * rglru: 4 (T=2112), 4s (T=32 over a state), 4d (B=8 T=1).
With ``--parent DIR`` (a checkout of another commit, e.g. unpacked by
``git archive``) each side runs in its own process, in the order parent,
this tree, this tree, parent, and both sides' times are printed case by
case. ``--serve`` runs chip_smoke.py's phase 3b (mamba2-1.3b served) on
each side in the same order: wall time, device busy time, the SSD
kernels', memcpys' and copy kernels' device time. ``--bwd`` times each
kernel of ``ssd_chunked_bwd`` apart at row 3bwd's shape (mamba2-1.3b's
layer in phase 5m: Bz=4, T=1024), device time a call by
``torch.profiler`` over the kernels named ``ssd_bwd_*``, with the whole
call's CUDA-graph time, on each side in the same order;
``--bwd-ablate`` the same for builds of ``csrc/ssd_scan_bwd.cu`` with one
change each (``BWD_ABLATIONS``), each checked against the plain version
first. ``--ablate`` then times
the dual form at T=256 and T=32 and rglru at T=2112 in builds of their
sources with one change each (``ABLATIONS``), ``--timeline`` the dual
form's stages in one block by ``clock64``. Prints the card's name and
power limit first. Needs the CUDA toolkit; exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

SSD_CASES = [("3 T=256", 1, 256, False), ("3f T=288", 1, 288, False),
             ("3s T=32 init", 1, 32, True), ("T=16 init", 1, 16, True),
             ("3d Bz=8 T=1", 8, 1, True)]
THRESHOLD_T = (16, 32, 48, 64)   # both SSD kernels forced, over a state
RGLRU_CASES = [("4 T=2112", 1, 2112, False), ("4s T=32 init", 1, 32, True),
               ("4d B=8 T=1", 8, 1, True)]


def child(src: Path) -> dict:
    """Times of every case with the package under ``src``."""
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.rglru import rglru_scan
    from repro_torch.kernels.ssd_scan import ssd_chunked
    torch.backends.cuda.matmul.allow_tf32 = False
    times = {}
    for name, Bz, T, init in SSD_CASES:
        args = cs.ssd_inputs(Bz, T, with_init=init, seed=Bz * 1000 + T)
        times[f"ssd {name}"] = cs.graph_ms(lambda: ssd_chunked(*args))
        if T == 1 and hasattr(ssd_scan, "ssd_plan"):
            s0 = args[6]
            times[f"ssd {name} in place"] = cs.graph_ms(
                lambda: ssd_chunked(*args[:6], s0, out_state=s0))
    if hasattr(ssd_scan, "ssd_plan"):
        for T in THRESHOLD_T:
            x, B, C, dt, A, D, s0 = cs.ssd_inputs(1, T, seed=T)
            y = torch.empty_like(x)
            sf = torch.empty_like(s0)
            for path in ("recurrence", "dual"):
                plan = ssd_scan.ssd_plan(1, T, 64, 64, 128, path=path)
                times[f"ssd T={T} init, {path}"] = cs.graph_ms(
                    lambda: ssd_scan._launch(plan, x, B, C, dt, A, D, s0, y,
                                             sf))
    for name, B, T, init in RGLRU_CASES:
        args = cs.rglru_inputs(B, T, with_init=init, seed=B * 1000 + T)
        times[f"rglru {name}"] = cs.graph_ms(lambda: rglru_scan(*args))
    return times


#: row 3bwd's shape: (Bz, T); H, hd, N are mamba2-1.3b's
BWD_SHAPE = (4, 1024)
BWD_CALLS = 5


#: rows 3bwd-r and 3bwd-s: (name, Bz, T), with an initial state and a final
#: state's adjoint
BWD_SMALL = [("3bwd-r T=100 init", 1, 100), ("3bwd-s T=16 init", 1, 16)]


def _bwd_args(Bz=BWD_SHAPE[0], T=BWD_SHAPE[1], with_state=False):
    """Inputs as chip_smoke.py's ``ssd_bwd_case`` makes them."""
    import chip_smoke as cs
    x, B, C, dt, A, D, s0 = cs.ssd_inputs(Bz, T, with_init=with_state,
                                          seed=Bz * 1000 + T + 1)
    g = torch.Generator(device="cuda").manual_seed(T + 2)
    dy = torch.randn(x.shape, generator=g, device="cuda")
    dsf = (torch.randn(s0.shape, generator=g, device="cuda") if with_state
           else None)
    return (x, B, C, dt, A, D, s0, dy, dsf)


def bwd_child(src: Path) -> dict:
    """Device ms a call of each ``ssd_bwd_*`` kernel (``torch.profiler``,
    BWD_CALLS calls) and of the whole ``ssd_chunked_bwd`` (graph replay)
    at row 3bwd's shape, and the graph time of rows 3bwd-r and 3bwd-s,
    with the package under ``src``."""
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.ssd_scan import ssd_chunked_bwd
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _bwd_args()
    out = _bwd_times(lambda: ssd_chunked_bwd(*args))
    for name, Bz, T in BWD_SMALL:
        small = _bwd_args(Bz, T, with_state=True)
        out[f"{name} (graph)"] = cs.graph_ms(lambda: ssd_chunked_bwd(*small))
    return out


def _bwd_times(call) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    out = {"ssd_chunked_bwd (graph)": cs.graph_ms(call)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(BWD_CALLS):
            call()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        m = re.search(r"ssd_bwd_\w+?_kernel", e.key)
        if e.device_type == DeviceType.CUDA and m:
            out[m.group(0)] = (out.get(m.group(0), 0.0)
                               + e.self_device_time_total / 1e3 / BWD_CALLS)
    return out


def _source(name: str) -> str:
    """``csrc/<name>.cu`` with the headers it includes from ``csrc/``
    inlined, so that a changed copy builds anywhere."""
    from repro_torch.kernels import _build
    text = (_build.CSRC / f"{name}.cu").read_text()
    for dep in _build.DEPS.get(name, ()):
        text = text.replace(f'#include "{dep}"',
                            (_build.CSRC / dep).read_text())
    return text


# Builds of csrc/ssd_scan_bwd.cu with one change each: (the text to
# replace, its replacement, the wrapper module's constants to set beside;
# no text: this tree's build with the constants). The "no ..." builds are
# timings only: their results are wrong.
BWD_ABLATIONS = {
    "states, 32 rows a block": ("constexpr int kRows = 64;",
                                "constexpr int kRows = 32;", {}),
    "states, one block an SM": (
        "__launch_bounds__(2 * N, 2) ssd_bwd_states_kernel",
        "__launch_bounds__(2 * N) ssd_bwd_states_kernel", {}),
    "chunk, (b) and (c) in two accumulator chains each": (
        "    float mdy[4] = {}, bds[4] = {};",
        "    Acc mdy, bds;\n    mdy.zero();\n    bds.zero();", {}),
    "chunk, 4 heads a block": (None, None, {"SSD_BWD_HEAD_GROUP": 4}),
    # timing only (wrong results): one part of a kernel left out
    "states, no products": (
        "for (int mt = 0; mt < kMT; ++mt) mma3(s[mt][j], af[mt], bf);", "",
        {}),
    "chunk, no (a) dy x^T": ("mma3(dM[q], af, bf);", "", {}),
    "chunk, no (b) M^T dy": ("mma3(mdy, af, bf);", "", {}),
    "chunk, no (c) B ds^T": ("mma3(bds, af, bf);", "", {}),
    "chunk, no (d) (e) dy s_in, (x o w) ds": ("""          mma3(P[j], ay, bs);
          load_b_kn(bd, &sm.dst[buf][0][0], kBs, n0, k0, lane);
          mma3(dBg[j], ax, bd);""", "", {}),
    "chunk, no head epilogue": ("    if (sl == ns - 1) {",
                                "    if (false) {", {}),
    "chunk, no exp in M": ("sm.g[t][s] * expf(sm.cs[t] - sm.cs[s]) * sm.dt[s]",
                           "sm.g[t][s] * sm.dt[s]", {}),
    "chunk, no closing warp": ("      if (warp == 0) {\n        const float cq",
                               "      if (false) {\n        const float cq",
                               {}),

}


def bwd_ablate() -> dict:
    """This tree's ``ssd_chunked_bwd`` and each build in BWD_ABLATIONS,
    all compiled at once, at row 3bwd's shape: each gradient's largest
    error against the plain version (relative to its largest value), then
    the times of ``_bwd_times``. Prints each build's registers and
    spills."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import ctypes
    from repro_torch.kernels import _build, ssd_scan
    out = _build.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    text = _source("ssd_scan_bwd")
    procs = {}
    for name, (old, new, _) in BWD_ABLATIONS.items():
        if old is None:
            continue
        if text.count(old) != 1:
            raise SystemExit(f"scan_probe: {name!r} no longer applies")
        cu = out / f"bwd_{re.sub(r'[^a-z0-9]+', '_', name)}.cu"
        cu.write_text(text.replace(old, new))
        procs[name] = (cu, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    own = _build.load("ssd_scan_bwd")
    builds = [("this tree", own, {})] + [
        (name, own, consts) for name, (old, _, consts) in BWD_ABLATIONS.items()
        if old is None]
    for name, (cu, proc) in procs.items():
        log_text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log_text}")
        for line in log_text.splitlines():
            if "registers" in line or ("spill" in line and " 0 bytes spill s"
                                       not in line):
                print(f"    {name}: {line.strip()}", flush=True)
        builds.append((name, ctypes.CDLL(str(cu.with_suffix(".so"))),
                       BWD_ABLATIONS[name][2]))
    args = _bwd_args()
    want = ssd_scan.ssd_chunked_bwd_plain(*args)
    result = {}
    try:
        for name, lib, consts in builds:
            saved = {k: getattr(ssd_scan, k) for k in consts}
            for k, v in consts.items():
                setattr(ssd_scan, k, v)
            _build._loaded["ssd_scan_bwd"] = lib
            lib.ssd_scan_bwd.argtypes = None
            ssd_scan._bwd_lib()
            got = ssd_scan.ssd_chunked_bwd(*args)
            err = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(got, want) if b is not None)
            r = {"max_rel_err": err,
                 **_bwd_times(lambda: ssd_scan.ssd_chunked_bwd(*args))}
            result[name] = r
            print(f"  3bwd, {name}: " + ", ".join(
                f"{k} {v:.4g}" for k, v in r.items()), flush=True)
            for k, v in saved.items():
                setattr(ssd_scan, k, v)
    finally:
        _build._loaded["ssd_scan_bwd"] = own
        own.ssd_scan_bwd.argtypes = None
        ssd_scan._bwd_lib()
    return result


# Builds of a source with one change each, to see what a kernel's time is
# made of: (source, text to replace, its replacement, the wrapper module's
# constants to set beside). Their numbers are timings only: "tf32 once"
# and "no fence" give wrong results.
ABLATIONS = {
    "ssd cvt split": ("ssd_scan", """  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));""", """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));""", {}),
    "ssd rounded split": ("ssd_scan", """  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));""", """  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;""",
                          {}),
    "ssd tf32 once": ("ssd_scan", """  mma(d.small, a.lo, b.hi);
  mma(d.small, a.hi, b.lo);
  mma(d.big, a.hi, b.hi);""", """  mma(d.big, a.hi, b.hi);""", {}),
    "ssd 2 staging warps": ("ssd_scan", "constexpr int kStagers = 4;",
                            "constexpr int kStagers = 2;", {}),
    "ssd 1 staging warp": ("ssd_scan", "constexpr int kStagers = 4;",
                           "constexpr int kStagers = 1;", {}),
    "rglru chunk 32": ("rglru_scan", "constexpr int kChunk = 64;",
                       "constexpr int kChunk = 32;", {"CHUNK": 32}),
    "rglru 128 channels, chunk 32": (
        "rglru_scan", """constexpr int kThreads = 64;  // channels a block
constexpr int kChunk = 64;""", """constexpr int kThreads = 128;  // channels a block
constexpr int kChunk = 32;""", {"CHUNK": 32, "THREADS": 128}),
    "rglru no fence": ("rglru_scan", """  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)""", """  __syncthreads();
  if (threadIdx.x == 0)""", {}),
}


def ablate() -> dict:
    """Times of this tree's kernels and of each build in ABLATIONS, all
    compiled at once: the dual form at T=256 and T=32, rglru at T=2112."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import ctypes
    import chip_smoke as cs
    from repro_torch.kernels import _build, rglru, ssd_scan
    out = _build.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (source, old, new, _) in ABLATIONS.items():
        text = _source(source)
        if old not in text:
            raise SystemExit(f"scan_probe: {name!r} no longer applies")
        cu = out / f"{name.replace(' ', '_').replace(',', '')}.cu"
        cu.write_text(text.replace(old, new))
        procs[name] = (cu, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    builds = [("this tree", "ssd_scan", _build.load("ssd_scan"), {}),
              ("this tree", "rglru_scan", _build.load("rglru_scan"), {})]
    for name, (cu, proc) in procs.items():
        log_text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log_text}")
        source, _, _, consts = ABLATIONS[name]
        builds.append((name, source, ctypes.CDLL(str(cu.with_suffix(".so"))),
                       consts))
    ssd_args = {T: cs.ssd_inputs(1, T, with_init=T < 256, seed=T)
                for T in (256, 32)}
    rg_args = cs.rglru_inputs(1, 2112, with_init=False, seed=1)
    times = {}
    for name, source, lib, consts in builds:
        mod = ssd_scan if source == "ssd_scan" else rglru
        saved = {k: getattr(mod, k) for k in consts}
        for k, v in consts.items():
            setattr(mod, k, v)
        _build._loaded[source] = lib
        getattr(lib, f"{source}_fwd").argtypes = None
        mod._lib()                           # sets the argument types
        if source == "ssd_scan":
            for T, (x, B, C, dt, A, D, s0) in ssd_args.items():
                y, sf = torch.empty_like(x), torch.empty((1, 64, 64, 128),
                                                         device="cuda")
                plan = ssd_scan.ssd_plan(1, T, 64, 64, 128, path="dual")
                times[f"ssd dual T={T}, {name}"] = cs.graph_ms(
                    lambda: ssd_scan._launch(plan, x, B, C, dt, A, D, s0, y,
                                             sf))
        else:
            times[f"rglru T=2112, {name}"] = cs.graph_ms(
                lambda: rglru.rglru_scan(*rg_args))
        for k, v in saved.items():
            setattr(mod, k, v)
    _build._loaded.update({s: lib for n, s, lib, _ in builds[:2]})
    return times


# Stamps for a timeline of the dual form: where each is inserted in
# csrc/ssd_scan.cu (after a line, or before it) and what it marks.
STAMPS = [
    ("    bar_sync(kFull, kThreads);  // chunk c has landed, cs and w are "
     "made\n", "after", "landed"),
    ("    const float* cs = sm.cs[buf];\n", "before", "C s^T"),
    ("    bar_sync(kProducts, kConsumers);  // G o L complete; sm.s is "
     "read\n", "after", "G o L"),
    ("    for (int i = 0; i < 4; ++i) {  // y with D x\n", "before",
     "(G o L) x, state update"),
    ("    if (c + 1 < nc) bar_arrive(kEmpty, kThreads);\n", "after",
     "y, state stored"),
]
PROBE_HEAD = """
__device__ long long g_prof[16 * 8];
__device__ unsigned long long g_span[4];
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""
PROBE_TAIL = """
extern "C" int ssd_probe_reset() {
  const unsigned long long init[4] = {~0ull, 0ull, ~0ull, 0ull};
  return cudaMemcpyToSymbol(dual::g_span, init, sizeof(init));
}
extern "C" int ssd_probe_read(void* prof, void* span) {
  cudaMemcpyFromSymbol(prof, dual::g_prof, sizeof(dual::g_prof));
  return cudaMemcpyFromSymbol(span, dual::g_span, sizeof(dual::g_span));
}
"""


def timeline() -> dict:
    """One block's clock at each stage of each chunk of the dual form
    (block 0, thread 0, SM cycles from the kernel's start) and the span of
    the kernel (globaltimer, ns, first block's start to last block's end),
    at T=256 and T=32."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import ctypes
    import chip_smoke as cs
    from repro_torch.kernels import _build, ssd_scan
    text = _source("ssd_scan")
    edits = [("namespace dual {\n", "namespace dual {\n" + PROBE_HEAD),
             ("  const int nc = (T + kQ - 1) / kQ;\n",
              "  const int nc = (T + kQ - 1) / kQ;\n"
              "  const long long t_start = clock64();\n"
              "  const unsigned long long d_start = globaltimer();\n"),
             ("          *reinterpret_cast<const float4*>(&sm.s[r][n]);\n  }\n}\n",
              "          *reinterpret_cast<const float4*>(&sm.s[r][n]);\n  }\n"
              "  if (tid == 0) { atomicMin(&g_span[2], d_start);"
              " atomicMax(&g_span[3], globaltimer()); }\n}\n")]
    for k, (line, where, _) in enumerate(STAMPS):
        stamp = (f"    if (tid == 0 && blockIdx.x == 0 && c < 16) "
                 f"g_prof[c * 8 + {k}] = clock64() - t_start;\n")
        edits.append((line, line + stamp if where == "after"
                      else stamp + line))
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"scan_probe: timeline stamp {old!r} no longer "
                             "applies")
        text = text.replace(old, new)
    out = _build.BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "ssd_timeline.cu"
    cu.write_text(text + PROBE_TAIL)
    r = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o",
                        str(cu.with_suffix(".so")), str(cu)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed for the timeline:\n{r.stdout}")
    lib = ctypes.CDLL(str(cu.with_suffix(".so")))
    saved = _build.load("ssd_scan")
    _build._loaded["ssd_scan"] = lib
    ssd_scan._lib()
    result = {}
    try:
        for T in (256, 32):
            x, B, C, dt, A, D, s0 = cs.ssd_inputs(1, T, with_init=T < 256,
                                                  seed=T)
            y, sf = torch.empty_like(x), torch.empty((1, 64, 64, 128),
                                                     device="cuda")
            plan = ssd_scan.ssd_plan(1, T, 64, 64, 128, path="dual")
            for _ in range(3):
                ssd_scan._launch(plan, x, B, C, dt, A, D, s0, y, sf)
            torch.cuda.synchronize()
            lib.ssd_probe_reset()
            ssd_scan._launch(plan, x, B, C, dt, A, D, s0, y, sf)
            torch.cuda.synchronize()
            prof = (ctypes.c_longlong * 128)()
            span = (ctypes.c_ulonglong * 4)()
            lib.ssd_probe_read(prof, span)
            chunks = []
            for c in range(-(-T // 64)):
                row = list(prof[c * 8:c * 8 + len(STAMPS)])
                chunks.append({name: row[k] for k, (_, _, name)
                               in enumerate(STAMPS)})
            result[f"T={T}"] = {"kernel_ns": span[3] - span[2],
                                 "block0_cycles": chunks}
            log_line = " | ".join(
                "c%d " % c + " ".join(f"{v}" for v in ch.values())
                for c, ch in enumerate(chunks))
            print(f"  timeline T={T}: kernel {span[3] - span[2]} ns; "
                  f"block 0 cycles at ({', '.join(n for *_, n in STAMPS)}):"
                  f" {log_line}", flush=True)
    finally:
        _build._loaded["ssd_scan"] = saved
        saved.ssd_scan_fwd.argtypes = None
        ssd_scan._lib()
    return result


def serve_child(src: Path) -> dict:
    """Phase 3b of chip_smoke.py (full-width mamba2-1.3b behind
    DisaggServer, its agent stream) with the package under ``src``: the
    warm run's wall time and, from a run under torch.profiler, device busy
    time and the device time of the SSD kernels, the memcpys and the copy
    kernels."""
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(ROOT))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from repro_torch.launch.serve import agent_requests
    torch.backends.cuda.matmul.allow_tf32 = False
    model = cs._model(cs._arch("mamba2-1.3b"), torch.bfloat16)
    reqs = agent_requests(model.cfg, 13, seed=0, prompt=256, extend=32,
                          fresh=288, max_new=8)
    cs.serve_once(model, reqs, 1024)                   # cold
    _, _, wall = cs.serve_once(model, reqs, 1024)      # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cs.serve_once(model, reqs, 1024)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    out = {"wall_s": wall, "busy_s": busy}
    for word in ("ssdscankernel", "gramkernel", "dualkernel", "reckernel",
                 "memcpy", "directcopy"):
        ms, n, _ = cs.device_share(rows, busy, word)
        out[word] = [ms, n]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the commit to compare against")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the results here as JSON")
    ap.add_argument("--ablate", action="store_true",
                    help="also time the builds in ABLATIONS")
    ap.add_argument("--timeline", action="store_true",
                    help="also stamp the dual form's stages (one block)")
    ap.add_argument("--serve", action="store_true",
                    help="also time chip_smoke's phase 3b on each side")
    ap.add_argument("--bwd", action="store_true",
                    help="also time ssd_chunked_bwd's kernels apart")
    ap.add_argument("--bwd-ablate", action="store_true",
                    help="also time the builds in BWD_ABLATIONS")
    ap.add_argument("--bwd-child", type=Path, default=None,
                    help=argparse.SUPPRESS)  # src dir of one side's --bwd
    ap.add_argument("--child", type=Path, default=None,
                    help=argparse.SUPPRESS)  # src dir of one side's run
    ap.add_argument("--serve-child", type=Path, default=None,
                    help=argparse.SUPPRESS)  # src dir of one side's 3b
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_probe: no CUDA device available", file=sys.stderr)
        return 1
    if args.child is not None:
        print(json.dumps(child(args.child)))
        return 0
    if args.serve_child is not None:
        print(json.dumps(serve_child(args.serve_child)))
        return 0
    if args.bwd_child is not None:
        print(json.dumps(bwd_child(args.bwd_child)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    sides = [("this tree", ROOT / "src")]
    if args.parent is not None:
        p = ("parent", args.parent.resolve() / "src")
        sides = [p, sides[0], sides[0], p]
    runs = {}
    for label, src in sides:
        out = subprocess.run([sys.executable, __file__, "--child", str(src)],
                             capture_output=True, text=True, check=True)
        runs.setdefault(label, []).append(
            json.loads(out.stdout.strip().splitlines()[-1]))
    cases = list(runs["this tree"][0])
    for c in cases:
        cols = [f"{label} " + " ".join(f"{r[c]:.4f}" if c in r else "-"
                                       for r in rs)
                for label, rs in runs.items()]
        print(f"  {c}: " + " | ".join(cols) + " ms", flush=True)
    serve = {}
    for label, src in (sides if args.serve else []):
        out = subprocess.run([sys.executable, __file__, "--serve-child",
                              str(src)], capture_output=True, text=True,
                             check=True)
        r = json.loads(out.stdout.strip().splitlines()[-1])
        serve.setdefault(label, []).append(r)
        print(f"  3b on {label}: wall {r['wall_s']:.3f} s, busy "
              f"{r['busy_s']:.3f} s; device ms (calls): " + ", ".join(
                  f"{k} {v[0]:.2f} ({v[1]})" for k, v in r.items()
                  if isinstance(v, list) and v[1]), flush=True)
    bwd = {}
    for label, src in (sides if args.bwd else []):
        out = subprocess.run([sys.executable, __file__, "--bwd-child",
                              str(src)], capture_output=True, text=True,
                             check=True)
        bwd.setdefault(label, []).append(
            json.loads(out.stdout.strip().splitlines()[-1]))
    for k in sorted({k for rs in bwd.values() for r in rs for k in r}):
        cols = [f"{label} " + " ".join(f"{r[k]:.4f}" if k in r else "-"
                                       for r in rs)
                for label, rs in bwd.items()]
        print(f"  3bwd {k}: " + " | ".join(cols) + " ms", flush=True)
    bwd_ablations = bwd_ablate() if args.bwd_ablate else {}
    stages = timeline() if args.timeline else {}
    ablations = ablate() if args.ablate else {}
    for c, ms in ablations.items():
        print(f"  {c}: {ms:.4f} ms", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs,
                                        "serve": serve, "bwd": bwd,
                                        "bwd_ablations": bwd_ablations,
                                        "ablations": ablations,
                                        "timeline": stages}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
