"""The routes of the port's dual step, on the CPU.

The CUDA launcher of ``csrc/dual_dim_step.cu`` takes the route the
wrapper names (``hand.dual_route``) and refuses any other: "regs" for
bfloat16 where every row of z starts on 4 elements (a thread walks
``kDualElems`` output columns down a run of rows, the 5-row window in
registers), "smem" otherwise (the shared-memory tile body, float32 and
float64 among them). Here: the rule by dtype,
row length and offset; the constants against the source; the regs grid
(runs sized to fill the card once, none shorter than ``kDualRunRows``)
covering every output row and column once; a numpy-driven emulation of
the regs walk, built from the source's ring of ``kDualSlots`` register
rows and ``kDualPrefetch`` rows in flight, a row's last thread owning
fewer columns where the row is not a multiple of a thread's, held bit
for bit against the plain version (derivatives) and to
``hand.RESIDUAL_RTOL`` (residual) in both bodies and both dtypes; the
counts (the CPU wrapper counts no route); ``chip_smoke.py``'s per-path
route check (bfloat16 on regs, float32 on smem); the A/B tool's variants and its ptxas reader; and the plain
version against the JAX package's ``dual_dim_step_pallas`` in interpret
mode, both bodies, every dtype, at a regs and an smem shape, with the
tolerances of ``tests/test_torch_grid.py``. The card's own tests of
both routes are in ``tests/test_torch_gpu.py``.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mpi_tests.kernels.pallas_kernels import dual_dim_step_pallas
from tpu_mpi_tests_torch.convert import array_from_jax
from tpu_mpi_tests_torch.kernels import build, dual_ab, hand
from tpu_mpi_tests_torch.kernels.stencil import STENCIL5

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
REPO = Path(__file__).resolve().parent.parent
DUAL_CU = (REPO / "tpu_mpi_tests_torch" / "kernels" / "csrc"
           / "dual_dim_step.cu")
SX, SY = 1.5, 0.75


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def constants():
    text = DUAL_CU.read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
            for name in ("kDualRowElems", "kDualElems", "kDualRegsThreads",
                         "kDualRunRows", "kDualPrefetch")}


C = constants()
#: output columns a thread of the regs route owns
ELEMS = C["kDualElems"]


def view(shape, dtype, off_elems=0):
    """A contiguous ``shape`` view ``off_elems`` past a 64-byte boundary."""
    item = torch.empty((), dtype=dtype).element_size()
    n = int(np.prod(shape))
    buf = torch.zeros(n + 64, dtype=dtype)
    skip = (-buf.data_ptr() % 64) // item + off_elems
    return buf[skip:skip + n].view(shape)


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [F32, BF16, F64])
@pytest.mark.parametrize("n1", [52, 53, 54, 8196, 8197])
@pytest.mark.parametrize("off", [0, 1, 2, 4])
def test_dual_route_rule(dtype, n1, off):
    """regs for bfloat16 whose rows start on 4 elements: z on 4 elements'
    bytes and n1 a multiple of 4; smem otherwise (float32 and float64
    whatever their rows)."""
    z = view((9, n1), dtype, off)
    regs = dtype == BF16 and n1 % 4 == 0 and off % 4 == 0
    assert hand.dual_route(z) == ("regs" if regs else "smem")


def test_dual_route_constants_are_the_source():
    text = DUAL_CU.read_text()
    assert hand.DUAL_ROW_ELEMS == C["kDualRowElems"] == 4
    assert ELEMS == 8
    assert "  if (dtype != kBF16) return kDualSmem;" in text
    assert "enum DualRoute : int { kDualSmem = 0, kDualRegs = 1 };" in text
    assert hand.DUAL_ROUTES == ("smem", "regs")
    assert "if (route != dual_route(dtype, z, n1)) return " \
           "cudaErrorInvalidValue;" in text
    assert f"constexpr int kDualSlots = 5 + kDualPrefetch;" in text
    with pytest.raises(ValueError, match="2-D"):
        hand.dual_route(torch.zeros(4))


# ---------------------------------------------------------------------------
# the regs grid and an emulation of its walk
# ---------------------------------------------------------------------------

def regs_grid(n0, n1, resident_ctas, elems):
    """``regs_grid`` of the source: (vectors a row, runs, rows a run,
    CTAs), a thread owning ``elems`` output columns."""
    threads, run_rows = C["kDualRegsThreads"], C["kDualRunRows"]
    m0, m1 = n0 - 4, n1 - 4
    v = -(-m1 // elems)
    q = resident_ctas * threads // v
    q = max(1, min(q, -(-m0 // run_rows)))
    r = -(-m0 // q)
    q = -(-m0 // r)
    return v, q, r, -(-v * q // threads)


@pytest.mark.parametrize("n0, n1", [(9, 8), (68, 52), (8196, 8196),
                                    (2060, 2056), (4108, 4104), (530, 9000),
                                    (100004, 12)])
@pytest.mark.parametrize("resident", [132, 264, 396, 1056])
def test_regs_grid_covers_every_row_once(n0, n1, resident):
    elems = ELEMS
    v, q, r, ctas = regs_grid(n0, n1, resident, elems)
    m0, m1 = n0 - 4, n1 - 4
    rows = np.zeros(m0, int)
    for run in range(q):
        rows[run * r:min((run + 1) * r, m0)] += 1
    assert (rows == 1).all()
    # every output column of a row once: full threads, then a last one
    # owning the 4 columns left where m1 is not a multiple of elems
    cols = np.zeros(m1, int)
    for j0 in range(0, v * elems, elems):
        cols[j0:min(j0 + elems, m1)] += 1
    assert (cols == 1).all() and m1 - (v - 1) * elems in (4, elems)
    # no run shorter than kDualRunRows, unless the rows split evenly
    # into fewer runs make each a little shorter
    assert r >= min(m0, C["kDualRunRows"]) or q == -(-m0 // C[
        "kDualRunRows"])
    # one wave: no more CTAs than the card holds, unless one run a
    # column of vectors already needs more
    assert ctas <= resident or q == 1
    assert ctas * C["kDualRegsThreads"] >= v * q


def emulate_regs(z, lean):
    """The regs route's walk of ``dual_regs_kernel``, every column vector
    at once: z rows enter a ring of ``kDualSlots`` slots
    ``kDualPrefetch`` rows before the window uses them; at step t dz_dy
    of output row t - 2 from z row t's E + 4 elements, dz_dx of output
    row t - 4 from the centre of slots (t - 4 .. t) % S, in the kernel's
    op order and rounding (torch's op per dtype rounds like the packed
    ops); a row's last thread, where m1 is not a multiple of E, loads no
    last piece (zeros) and keeps only its first E - 4 columns; the lean
    body's two sums of squares apart, added once."""
    n0, n1 = z.shape
    m0, m1 = n0 - 4, n1 - 4
    S, P = 5 + C["kDualPrefetch"], C["kDualPrefetch"]
    E = ELEMS
    nv = -(-m1 // E)
    if lean:
        (c0, c1), (c3, c4) = (hand._lean_coefs(s, z.dtype) for s in (SX, SY))
    else:
        c0, c1, _, c3, c4 = (hand._rounded(c, z.dtype)
                             for c in STENCIL5.tolist())
    k = {n: torch.tensor(v, dtype=z.dtype) for n, v in
         (("c0", c0), ("c1", c1), ("c3", c3), ("c4", c4),
          ("sx", hand._rounded(SX, z.dtype)),
          ("sy", hand._rounded(SY, z.dtype)))}
    cols = torch.arange(nv)[:, None] * E + torch.arange(E + 4)[None, :]
    past = cols >= n1  # the last piece a short last thread does not load
    cols = cols.clamp(max=n1 - 1)

    def load(row):
        return z[row][cols].masked_fill(past, 0)

    dx = torch.empty((m0, m1), dtype=z.dtype)
    dy = torch.empty_like(dx)
    ring = [None] * S
    n_walk = m0 + 4
    for p in range(min(P, n_walk)):
        ring[p] = load(p)
    sum_x = torch.zeros((), dtype=torch.float32)
    sum_y = torch.zeros((), dtype=torch.float32)
    for t in range(n_walk):
        if t + P < n_walk:
            ring[(t + P) % S] = load(t + P)
        if t < 4:
            continue
        r0, r1, r2, r3, r4 = (ring[(t - b) % S] for b in (4, 3, 2, 1, 0))
        x = slice(2, E + 2)  # the centre elements: column j + 2
        m2, m1_, p1, p2 = (r2[:, d:d + E] for d in (0, 1, 3, 4))
        if lean:
            vx = k["c0"] * (r3[:, x] - r1[:, x]) \
                + k["c1"] * (r4[:, x] - r0[:, x])
            vy = k["c3"] * (p1 - m1_) + k["c4"] * (p2 - m2)
            vx, vy = vx.reshape(-1)[:m1], vy.reshape(-1)[:m1]
            sum_x = sum_x + (vx.float() * vx.float()).sum()
            sum_y = sum_y + (vy.float() * vy.float()).sum()
        else:
            ax = ((k["c0"] * r0[:, x] + k["c1"] * r1[:, x])
                  + k["c3"] * r3[:, x]) + k["c4"] * r4[:, x]
            vx = (ax * k["sx"]).reshape(-1)[:m1]
            ay = ((k["c0"] * m2 + k["c1"] * m1_) + k["c3"] * p1) \
                + k["c4"] * p2
            vy = (ay * k["sy"]).reshape(-1)[:m1]
            sum_x = sum_x + (vx * vx).float().sum()
            sum_y = sum_y + (vy * vy).float().sum()
        dx[t - 4] = vx
        dy[t - 4] = vy
    res = (sum_x + sum_y).to(z.dtype) if lean else (sum_x.to(z.dtype)
                                                     + sum_y.to(z.dtype))
    return dx, dy, res


@pytest.mark.parametrize("dtype", [BF16])
@pytest.mark.parametrize("lean", [False, True])
@pytest.mark.parametrize("shape", [(9, 8), (37, 52), (70, 136), (21, 44),
                                   (133, 1028), (40, 2060)])
def test_regs_emulation_is_the_plain_version(dtype, lean, shape):
    a = np.random.default_rng(40).normal(size=shape).astype(np.float32)
    z = torch.from_numpy(a).to(dtype)
    assert hand.dual_route(z) == "regs"
    gx, gy, gr = emulate_regs(z, lean)
    wx, wy, wr = hand.dual_dim_step_ref(z, 2, SX, SY, lean=lean)
    assert torch.equal(gx, wx) and torch.equal(gy, wy)
    assert abs(float(gr) - float(wr)) <= hand.RESIDUAL_RTOL[dtype] * abs(
        float(wr))


# ---------------------------------------------------------------------------
# the counts, chip_smoke's route check, the A/B tool
# ---------------------------------------------------------------------------

def test_cpu_dual_counts_no_route():
    hand.reset_launch_counts()
    z = torch.from_numpy(np.random.default_rng(2).normal(
        size=(20, 24)).astype(np.float32))
    for lean in (False, True):
        hand.dual_dim_step(z, 2, SX, SY, lean=lean)
    assert hand.route_counts()["dual_dim_step"] == {"smem": 0, "regs": 0}
    assert hand.dual_dim_step.launches == 0


def test_check_probe_dual_routes_wants_cluster_and_regs():
    cs = _chip_smoke()
    zero = {"alu_probe": {"l2": 0, "cluster": 0},
            "dual_dim_step": {"smem": 0, "regs": 0}}
    cs.ROUTE_COUNTS["p"] = zero | {"alu_probe": {"l2": 0, "cluster": 9},
                                   "dual_dim_step": {"smem": 0, "regs": 4}}
    cs.check_probe_dual_routes("p", {"alu_probe": 9, "dual_dim_step": 4}, 4)
    # float32 blocks on smem, bfloat16 on regs
    cs.ROUTE_COUNTS["p"] = zero | {"dual_dim_step": {"smem": 1, "regs": 3}}
    cs.check_probe_dual_routes("p", {"dual_dim_step": 4}, 3)
    with pytest.raises(cs.SmokeFailure, match="dual_dim_step"):
        cs.check_probe_dual_routes("p", {"dual_dim_step": 4}, 4)
    with pytest.raises(cs.SmokeFailure, match="dual_dim_step"):
        cs.check_probe_dual_routes("p", {"dual_dim_step": 4}, 2)


def test_dual_ab_variants_patch_one_line_each():
    assert set(dual_ab.VARIANTS) == {
        "base", "smem", "e4", "cs", "ta8", "ta32", "ta64", "ta256", "t128",
        "t512", "p2", "p3", "p4", "p8", "float", "rul0", "lb3"}
    for name, edits in dual_ab.VARIANTS.items():
        assert bool(edits) == (name != "base"), name
        patched = {}
        for file, old, new in edits:
            text = (build.CSRC / file).read_text()
            assert text.count(old) == 1, (name, old)
            patched.setdefault(file, text)
            assert patched[file].count(old) == 1, (name, old)
            patched[file] = patched[file].replace(old, new)
            assert old != new and new not in text, name


@pytest.mark.parametrize("mangled, name", [
    ("_ZN5tpumt51_GLOBAL__N__1a2b3c4d_16_dual_dim_step_cu_5e6f7a8b16"
     "dual_regs_kernelIfLb0EEEvPKT_PS2_S5_Pfxxffffffiii",
     "dual_regs_kernel<float, false>"),
    ("_ZN5tpumt51_GLOBAL__N__1a2b3c4d_16_dual_dim_step_cu_5e6f7a8b11"
     "dual_kernelI13__nv_bfloat16Lb1EEEvPKT_PS3_S6_PN3AccIS3_E1AExx",
     "dual_kernel<bf16, true>"),
])
def test_dual_instances_are_named(mangled, name, monkeypatch):
    assert dual_ab.kernel_name(mangled) == name
    log = (f"ptxas info    : Compiling entry function '{mangled}' for "
           f"'sm_90a'\nptxas info    : Used 80 registers\n"
           f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           f"loads\n")
    monkeypatch.setitem(build.BUILD_LOGS, "dual_dim_step", log)
    assert build.ptxas_summary("dual_dim_step", dual_ab.kernel_name) == {
        name: {"registers": 80, "stack": 0, "spill_stores": 0,
               "spill_loads": 0}}


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------

DTYPES = {"float64": np.float64, "float32": np.float32,
          "bfloat16": jnp.bfloat16}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(40, 56), (41, 57)])
@pytest.mark.parametrize("lean", [False, True])
def test_plain_dual_matches_pallas(dtype, shape, lean):
    a = np.random.default_rng(41).normal(size=shape)
    z = a.astype(np.float32).astype(DTYPES[dtype])
    ax, ay, ar = dual_dim_step_pallas(jnp.asarray(z), 2, SX, SY,
                                      interpret=True, lean=lean)
    zt = array_from_jax(z)
    bx, by, br = hand.dual_dim_step(zt, 2, SX, SY, lean=lean)
    ax, ay = np.asarray(ax, np.float64), np.asarray(ay, np.float64)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(bx.double().numpy(), ax)
        np.testing.assert_array_equal(by.double().numpy(), ay)
        rtol = hand.RESIDUAL_RTOL[BF16] if lean else 1e-3
    else:
        np.testing.assert_allclose(bx.double().numpy(), ax, atol=1e-5)
        np.testing.assert_allclose(by.double().numpy(), ay, atol=1e-5)
        rtol = 1e-3
    assert abs(float(br) - float(ar)) <= rtol * max(1.0, abs(float(ar)))
