"""The routes of the port's heat update, on the CPU.

The CUDA launcher of ``csrc/heat2d.cu`` takes the route the wrapper names
(``hand.heat_route``) and refuses any other: "regs" where 1 <= steps <=
``kHeatRegsMaxSteps`` and every row of z and out starts on a word (the
widest of 16, 8 and 4 bytes that holds one: ``hand.heat_vec_bytes``),
"smem" otherwise (bfloat16 rows off 4 bytes, deeper steps). Here: the
rule for each dtype × steps with each pointer and the row pitch off 16,
8, 4 and 2 bytes in turn; the constants against the source; the counts
(``hand.route_counts()`` lists the heat update and the derivative, the
CPU wrappers count no route); a numpy emulation of the regs schedule,
built from the source's constants — warp segments of 32 lanes' vectors
(lane L holding the segment's vectors L, L + 32, ..) with a steps-deep
apron on each side, the column neighbours by "shuffle" (the segment's
first and last element taking the wrong lane's, as a shuffle does), the
runs the launcher sizes to one wave, and the k-stage pipeline of 3-row
windows down a run — held bit for bit against the plain version in
float32 and in bfloat16 with every op rounded, at steps 1-8, in 16-, 8-
and 4-byte vectors, on shapes ragged against the run and the segment,
narrower than one segment and 3×3, every output cell written exactly
once, and at one small shape against the JAX package's interpreted
``heat2d_pallas``; the A/B tool's variants and its ptxas reader;
``chip_smoke.py``'s per-path route check and its bound. The card's own
tests of both routes are in ``tests/test_torch_gpu.py``.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mpi_tests.kernels.pallas_kernels import heat2d_pallas
from tpu_mpi_tests_torch.kernels import build, hand, heat_ab

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
REPO = Path(__file__).resolve().parent.parent
HEAT_CU = build.CSRC / "heat2d.cu"
OCC_CUH = build.CSRC / "occupancy.cuh"
CX, CY = 0.13, 0.21


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def constants():
    """The regs route's compile-time choices, read from the source."""
    text = HEAT_CU.read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
            for name in ("kHeatRegsMaxSteps", "kHeatPrefetch",
                         "kHeatRunRows", "kHeatLaneVecs", "kHeatThreads",
                         "kHeatSlots")}


C = constants()


def view(shape, dtype, off_bytes=0):
    """A contiguous ``shape`` view ``off_bytes`` past a 64-byte boundary."""
    item = torch.empty((), dtype=dtype).element_size()
    n = int(np.prod(shape))
    buf = torch.zeros(n + 64, dtype=dtype)
    skip = (-buf.data_ptr() % 64) // item + off_bytes // item
    return buf[skip:skip + n].view(shape)


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

#: geometry -> (where the offset is, its bytes)
GEOMETRIES = {"aligned": (None, 0), "z8": ("z", 8), "out8": ("out", 8),
              "pitch8": ("pitch", 8), "z4": ("z", 4), "out4": ("out", 4),
              "pitch4": ("pitch", 4), "pitch2": ("pitch", 2)}


@pytest.mark.parametrize("dtype", [BF16, F32, F64])
@pytest.mark.parametrize("steps", [1, 4, 8, 9])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_heat_route_rule(dtype, steps, geometry):
    """regs up to 8 steps in the widest of 16, 8 and 4 bytes that every
    row of z and out starts on and that holds a word (bfloat16 pairs,
    one float32, one float64); a bfloat16 row off 4 bytes, or more
    steps, and smem."""
    item = torch.empty((), dtype=dtype).element_size()
    where, off = GEOMETRIES[geometry]
    if off % item:
        pytest.skip("no such offset for this dtype")
    width = 16 // item * 7 + (off // item if where == "pitch" else 0)
    z = view((40, width), dtype, off if where == "z" else 0)
    out = view((40, width), dtype, off if where == "out" else 0)
    vec = 16 if off == 0 else off if off >= max(4, item) else 0
    assert hand.heat_vec_bytes(z, out) == vec
    want = "regs" if steps <= 8 and vec else "smem"
    assert hand.heat_route(z, steps, out) == want
    # out None: a fresh allocation, on 16 bytes
    alone = 16 if where in (None, "out") else vec
    assert hand.heat_vec_bytes(z) == alone
    assert hand.heat_route(z, steps) == (
        "regs" if steps <= 8 and alone else "smem")
    assert hand.HEAT_ROUTES.index(want) == {"smem": 0, "regs": 1}[want]


def test_heat_route_constants_are_the_source():
    text = HEAT_CU.read_text()
    assert hand.HEAT_REGS_MAX_STEPS == C["kHeatRegsMaxSteps"] == 8
    assert "enum HeatRoute : int { kHeatSmem = 0, kHeatRegs = 1 };" in text
    assert hand.HEAT_ROUTES == ("smem", "regs")
    assert "const int word = itemsize == 8 ? 8 : 4;" in text
    assert "for (int b = 16; b >= word; b /= 2)" in text
    assert "rows_start_on(b, z, out, n1 * itemsize, n1 * itemsize)" in text
    assert "static constexpr int U = kVB == 16 ? 1 : kHeatLaneVecs;" in text
    assert C["kHeatPrefetch"] < C["kHeatSlots"]
    # the launcher checks the route it is given, and the gate on shared
    # memory is the smem route's alone
    assert "if (route != heat_route(steps, z, out, n1, itemsize))" in text
    assert "kHeatRegs" not in text.split("int max_steps()")[1].split(
        "}")[0]


# ---------------------------------------------------------------------------
# the counts
# ---------------------------------------------------------------------------

def test_route_counts_lists_heat_and_deriv():
    hand.reset_launch_counts()
    counts = hand.route_counts()
    assert counts["heat2d"] == {"smem": 0, "regs": 0}
    assert counts["stencil2d_deriv"] == {"scalar": 0, "regs": 0}
    hand.heat2d.launches_by_route["regs"] = 3
    hand.stencil2d_deriv.launches_by_route["scalar"] = 2
    counts = hand.route_counts()
    assert counts["heat2d"]["regs"] == 3
    assert counts["stencil2d_deriv"]["scalar"] == 2
    hand.reset_launch_counts()
    assert hand.route_counts()["heat2d"] == {"smem": 0, "regs": 0}
    assert hand.route_counts()["stencil2d_deriv"] == {"scalar": 0,
                                                       "regs": 0}


@pytest.mark.parametrize("steps", [1, 4, 9])
def test_cpu_wrappers_are_the_plain_version_and_count_no_route(steps):
    hand.reset_launch_counts()
    z = torch.from_numpy(np.random.default_rng(steps).normal(
        size=(20, 24)).astype(np.float32))
    got = hand.heat2d(z, CX, CY, steps=steps)
    assert torch.equal(got, hand.heat2d_ref(z, CX, CY, steps=steps))
    for dim in (0, 1):
        got = hand.stencil2d_deriv(z, 3.0, dim=dim)
        assert torch.equal(got, hand.stencil2d_deriv_ref(z, 3.0, dim=dim))
    for name in ("heat2d", "stencil2d_deriv"):
        assert getattr(hand, name).launches == 0
        assert sum(hand.route_counts()[name].values()) == 0


# ---------------------------------------------------------------------------
# the regs schedule, emulated
# ---------------------------------------------------------------------------

def round_bf16(x):
    """float32 values rounded to the nearest bfloat16, ties to even (what
    an eager bfloat16 op and bf16x2 give), kept as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


class Ops:
    """Each op in float32, rounded to bfloat16 after it when ``bf16``:
    bit for bit the kernel's add/sub/mul (float32 _rn, bf16x2.rn)."""

    def __init__(self, bf16):
        self.r = round_bf16 if bf16 else (lambda x: x)

    def add(self, a, b):
        return self.r(np.float32(a) + np.float32(b))

    def sub(self, a, b):
        return self.r(np.float32(a) - np.float32(b))

    def mul(self, a, b):
        return self.r(np.float32(a) * np.float32(b))


def wave_runs(resident, cols, rows, floor_rows):
    """``wave_runs`` of csrc/occupancy.cuh."""
    runs = resident // cols if cols > 0 else 1
    runs = max(1, min(runs, -(-rows // floor_rows)))
    ta = -(-rows // runs)
    return -(-rows // ta)


def heat_geometry(steps, vb, item):
    """(elements a vector, vectors a lane, apron vectors, vectors a warp
    loads, vectors it writes) of HeatGeom."""
    E = vb // item
    U = 1 if vb == 16 else C["kHeatLaneVecs"]
    Kv = -(-steps // E)
    return E, U, Kv, 32 * U, 32 * U - 2 * Kv


def emulate_heat(z, steps, vb, resident, bf16=False):
    """The regs kernel's result on ``z`` (float32 values; bfloat16 ones
    when ``bf16``), every segment and run of the launcher's grid, and the
    count of writes a cell got."""
    ops = Ops(bf16)
    item = 2 if bf16 else 4
    n0, n1 = z.shape
    E, U, Kv, load, inner = heat_geometry(steps, vb, item)
    assert n1 * item % vb == 0
    nv = n1 // E
    segs = -(-nv // inner)
    warps = C["kHeatThreads"] // 32
    runs = wave_runs(resident, -(-segs // warps), n0, C["kHeatRunRows"])
    ta = -(-n0 // runs)
    cx, cy, two = (np.float32(hand._rounded(v, BF16 if bf16 else F32))
                   for v in (CX, CY, 2.0))
    out = np.zeros_like(z)
    written = np.zeros(z.shape, np.int64)
    # the segments' loaded elements: warp position p = (vector - v0)·E + e
    # holds column v0·E + p; lane L's vector u is the segment's 32u + L
    L = load * E
    v0 = np.arange(segs)[:, None] * inner - Kv
    col = v0 * E + np.arange(L)[None, :]
    ok = (col >= 0) & (col < n1)
    upd = (col >= 1) & (col < n1 - 1)
    # the neighbours of a position: its row's next element but at the
    # lanes' edges, where a shuffle brings lane 31's vector u - 1 (lane 0,
    # u > 0) and lane 0's vector u + 1 (lane 31, u < U - 1); at the
    # segment's two ends the shuffle wraps to lane 31's / lane 0's own
    # vector u — wrong values, which the apron absorbs
    left = np.arange(L) - 1
    right = np.arange(L) + 1
    left[0] = 32 * E - 1
    right[L - 1] = 32 * (U - 1) * E
    keep_w = (np.arange(load) >= Kv) & (np.arange(load) < Kv + inner)
    keep = np.repeat(keep_w, E)[None, :] & ok

    def step(up, mid, dn):
        m2 = ops.mul(two, mid)
        d2x = ops.sub(ops.add(dn, up), m2)
        d2y = ops.sub(ops.add(mid[:, right], mid[:, left]), m2)
        new = ops.add(ops.add(mid, ops.mul(cx, d2x)), ops.mul(cy, d2y))
        return np.where(upd, new, mid)

    zeros = np.zeros((segs, L), np.float32)
    for run in range(runs):
        a0, stop = run * ta, min(run * ta + ta, n0)
        r0, r1 = a0 - steps, stop + steps
        # emitted[s][c]: row c as stage s emitted it; rows a stage never
        # emitted read as the windows' initial zeros
        emitted = [dict() for _ in range(steps)]
        for r in range(r0, r1):
            row = np.zeros((segs, L), np.float32)
            if 0 <= r < n0:
                row = np.where(ok, z[r][np.clip(col, 0, n1 - 1)], 0)
            emitted[0][r] = row.astype(np.float32)
            for s in range(1, steps + 1):
                c = r - s
                prev = emitted[s - 1]
                up, mid, dn = (prev.get(i, zeros) for i in (c - 1, c, c + 1))
                val = step(up, mid, dn) if 1 <= c < n0 - 1 else mid
                if s < steps:
                    emitted[s][c] = val
                elif a0 <= c < stop:
                    out[c, col[keep]] = val[keep]
                    np.add.at(written[c], col[keep], 1)
    return out, written


def plain(z, steps, bf16):
    t = torch.from_numpy(z)
    if bf16:
        t = t.to(BF16)
    return hand.heat2d_ref(t, CX, CY, steps=steps).float().numpy()


def field(seed, shape, bf16):
    z = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return round_bf16(z) if bf16 else z


#: (vb, bf16) -> a width ragged against the segment (3 segments and a
#: part at 4 steps); the run: 2·kHeatRunRows + 37 rows
def ragged_width(vb, bf16, steps):
    item = 2 if bf16 else 4
    E, _, _, _, inner = heat_geometry(steps, vb, item)
    return (2 * inner + 7) * E


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("steps", range(1, 9))
@pytest.mark.parametrize("vb", [16, 8, 4])
def test_regs_emulation_is_the_plain_version(bf16, steps, vb):
    shape = (2 * C["kHeatRunRows"] + 37, ragged_width(vb, bf16, steps))
    z = field(steps + vb, shape, bf16)
    resident = (1, 9, 10**6)[steps % 3]  # one run, a few, the floor's
    got, written = emulate_heat(z, steps, vb, resident, bf16)
    assert (written == 1).all()
    np.testing.assert_array_equal(got, plain(z, steps, bf16))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("steps", [1, 3, 8])
@pytest.mark.parametrize("shape", [(3, 4), (5, 20), (9, 36)])
def test_regs_emulation_narrower_than_a_segment(bf16, steps, shape):
    """A shard narrower than one segment (and than the apron), 3 rows:
    every warp an edge segment."""
    vb = 8 if bf16 else 16
    z = field(steps, shape, bf16)
    got, written = emulate_heat(z, steps, vb, 10**6, bf16)
    assert (written == 1).all()
    np.testing.assert_array_equal(got, plain(z, steps, bf16))


def test_runs_fill_one_wave_balanced():
    floor = C["kHeatRunRows"]
    assert wave_runs(100, 7, 10**6, floor) == 14
    assert wave_runs(100, 7, 100, floor) == -(-100 // floor)
    assert wave_runs(3, 7, 10**6, floor) == 1
    n0 = 8200
    for runs_wanted in (3, 29, 31):
        runs = wave_runs(runs_wanted * 5, 5, n0, floor)
        ta = -(-n0 // runs)
        assert runs <= runs_wanted and (runs - 1) * ta < n0 <= runs * ta
    text = OCC_CUH.read_text()
    assert "long long runs = cols > 0 ? resident / cols : 1;" in text
    assert "wave_runs(resident, cols, n0, kHeatRunRows)" in \
        HEAT_CU.read_text()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_regs_emulation_matches_the_jax_kernel(dtype):
    """≅ ``tests/test_torch_heat2d.py``'s Pallas check: the JAX
    ``heat2d_pallas`` in interpret mode with 16-row tiles, bf16 bit-equal,
    float32 to 1e-6 (XLA may contract a mul+add)."""
    bf16 = dtype == "bfloat16"
    steps = 2
    z = field(31, (68, 52), bf16)
    want = np.asarray(heat2d_pallas(
        jnp.asarray(z).astype(jnp.bfloat16 if bf16 else jnp.float32), CX,
        CY, steps=steps, n_bnd=2, interpret=True, tile_rows=16)).astype(
            np.float32)
    got, written = emulate_heat(z, steps, 8 if bf16 else 16, 10**6, bf16)
    assert (written == 1).all()
    if bf16:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the A/B tool and the ptxas reader
# ---------------------------------------------------------------------------

def test_heat_ab_variants_patch_one_line_each():
    """Every variant's edits find their text once in the tree and apply
    in turn; the designs the A/B lost to (float-then-round bfloat16, the
    shared-memory body and the scalar derivative as every launch's route)
    live only in those patches."""
    assert set(heat_ab.VARIANTS) == {
        "base", "smem", "scalar", "float", "p2", "p3", "p8", "l1", "l4",
        "lb4", "ta16", "ta64", "ta256", "t256", "dp4", "dta16", "dta256",
        "hrul0"}
    for name, edits in heat_ab.VARIANTS.items():
        assert bool(edits) == (name != "base"), name
        patched = {}
        for file, old, new in edits:
            text = (build.CSRC / file).read_text()
            assert text.count(old) == 1, (name, old)
            patched.setdefault(file, text)
            assert patched[file].count(old) == 1, (name, old)
            patched[file] = patched[file].replace(old, new)
            assert old != new, name
    for src in (HEAT_CU, build.CSRC / "stencil_deriv.cu"):
        regs = src.read_text().split("// the regs route")[1]
        assert "__floats2bfloat162_rn" not in regs
        assert "__shared__" not in regs


@pytest.mark.parametrize("mangled,name", [
    ("_ZN5tpumt45_GLOBAL__N__1f0a3b2c_9_heat2d_cu_8e1d7f4211heat2d_regsI"
     "fLi4ELi16EEEvPKT_PS2_iiiiNS_3EltIS2_E1CES8_S8_",
     "heat2d_regs<float, 4, 16>"),
    ("_ZN5tpumt45_GLOBAL__N__1f0a3b2c_9_heat2d_cu_8e1d7f4211heat2d_regsI"
     "13__nv_bfloat16Li1ELi4EEEvPKT_PS3_iiiiNS_3EltIS3_E1CES9_S9_",
     "heat2d_regs<bf16, 1, 4>"),
    ("_ZN5tpumt45_GLOBAL__N__1f0a3b2c_9_heat2d_cu_8e1d7f4213heat2d_kernelI"
     "dEEvPKT_PS2_xxiNS_3EltIS2_E1CES8_S8_x", "heat2d_kernel<double>"),
    ("_ZN5tpumt52_GLOBAL__N__55aa_16_stencil_deriv_cu_1b2c15deriv_regs_dim1"
     "IfLi16EEEvPKT_PS2_ixiiNS_3EltIS2_E1CES8_S8_S8_S8_",
     "deriv_regs_dim1<float, 16>"),
    ("_ZN5tpumt52_GLOBAL__N__55aa_16_stencil_deriv_cu_1b2c12deriv_kernelI"
     "13__nv_bfloat16Li0EEEvPKT_PS3_xxxNS_3EltIS3_E1CES9_S9_S9_S9_",
     "deriv_kernel<bf16, 0>")])
def test_heat_and_deriv_instances_are_named(mangled, name, monkeypatch):
    assert heat_ab.kernel_name(mangled) == name
    log = (f"ptxas info    : Compiling entry function '{mangled}' for "
           f"'sm_90a'\nptxas info    : Used 96 registers\n"
           f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           f"loads\n")
    monkeypatch.setitem(build.BUILD_LOGS, "heat2d", log)
    assert build.ptxas_summary("heat2d", heat_ab.kernel_name) == {
        name: {"registers": 96, "stack": 0, "spill_stores": 0,
               "spill_loads": 0}}


def test_both_libraries_build_at_the_default_register_level():
    """Neither library takes ptxas register-usage level 0: the heat
    walk's instances spilled there, and the derivative ran the same
    (heat_ab's hrul0 and drul0)."""
    assert "heat2d" not in build.LIBRARY_FLAGS
    assert "stencil_deriv" not in build.LIBRARY_FLAGS


# ---------------------------------------------------------------------------
# chip_smoke.py: the per-path route check and the bound
# ---------------------------------------------------------------------------

def test_check_heat_deriv_routes_wants_the_main_path_on_regs():
    cs = _chip_smoke()
    cs.ROUTE_COUNTS["p"] = {"heat2d": {"smem": 0, "regs": 50},
                            "stencil2d_deriv": {"scalar": 0, "regs": 28}}
    cs.check_heat_deriv_routes("p", {"heat2d": 50, "stencil2d_deriv": 28})
    with pytest.raises(cs.SmokeFailure, match="heat2d"):
        cs.check_heat_deriv_routes("p", {"heat2d": 51,
                                         "stencil2d_deriv": 28})
    cs.ROUTE_COUNTS["q"] = {"heat2d": {"smem": 2, "regs": 48},
                            "stencil2d_deriv": {"scalar": 0, "regs": 0}}
    with pytest.raises(cs.SmokeFailure, match="heat2d"):
        cs.check_heat_deriv_routes("q", {"heat2d": 50})
    cs.ROUTE_COUNTS["r"] = {"heat2d": {"smem": 0, "regs": 0},
                            "stencil2d_deriv": {"scalar": 3, "regs": 1}}
    with pytest.raises(cs.SmokeFailure, match="stencil2d_deriv"):
        cs.check_heat_deriv_routes("r", {"stencil2d_deriv": 4})


def test_heat_and_deriv_bounds_count_lone_ops_at_the_issue_rate():
    """The operations term of both rows divides lone mul/add/sub by the
    card's issue rate, bfloat16 two elements an instruction."""
    cs = _chip_smoke()
    rate = 33.45408e12
    b, f = cs.heat_work((2064, 2064), F32, 8)
    assert f == 9 * 2062 * 2062 * 8
    ms, by = cs.bound_ms(b, f, F32, rate)
    assert by == "bytes" and ms == pytest.approx(b / cs.HBM_BYTES_PER_S * 1e3)
    ms16, _ = cs.bound_ms(1, f, BF16, rate)
    assert ms16 == pytest.approx(f / 2 / rate * 1e3)
    _, why = cs.bound_ms(1, f, F32, rate)
    assert why == "operations"


def test_smoke_compares_every_main_path_heat_instance():
    """chip_smoke.py holds every heat instance the main path launches
    against its plain version at its own shape: the driver's three runs
    and the microbench's 16 further (n, dtype, steps), each once, each on
    regs by the rule (rows on 16, 8 or 4 bytes), naming every main-path
    instance the spill check reads."""
    cs = _chip_smoke()
    ops = cs.heat_main_operands()
    assert len({(n, dt, k) for _, n, dt, k in ops}) == len(ops) == 19
    cases = cs.heat_microbench_cases()
    assert len(cases) == 16
    named = set()
    for _, shape, dtype, k, _, _ in cases:
        z = torch.empty(shape, dtype=dtype)
        assert hand.heat_route(z, k) == "regs"
        vb = hand.heat_vec_bytes(z)
        named.add(f"heat2d_regs<{'bf16' if dtype == BF16 else 'float'}, "
                  f"{k}, {vb}>")
    assert {(2050, BF16, 1), (2064, F32, 8), (2064, BF16, 8),
            (2052, BF16, 2), (2060, BF16, 6)} <= {
        (s[0], dt, k) for _, s, dt, k, _, _ in cases}
    heat = {n for n in cs.main_heat_deriv_instances()
            if n.startswith("heat2d")}
    assert named == heat
