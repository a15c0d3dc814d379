"""The routes of the port's k-step kernels, on the CPU.

The CUDA launchers of ``csrc/stencil_iterate.cu`` and ``csrc/fused_rdma.cu``
take the route the wrapper names (``hand.kstep_route``) and refuse any
other: "regs" where 1 <= steps <= ``kRegsMaxSteps`` and every row of z and
out starts on 8 bytes (in 16-byte vectors where every row starts on 16,
``hand.kstep_vec_bytes``; the fused kernel on 16 bytes only), "smem"
otherwise. Here: the rule for each dtype × dim × steps with each pointer
and the row pitch off 16 and off 8 bytes in turn; the counts (``hand.route_counts()`` lists both kernels, the
CPU wrappers count no route); a numpy emulation of the regs schedule,
built from the constants of ``csrc/stencil_kstep.cuh`` — the dim-0 row
pipeline over balanced runs and column strips, and the dim-1 warp
segments, lanes stepping by shuffles — held bit for bit against the plain
version at steps 1-8, every static flag pair and the dynamic flags, in
16- and 8-byte vectors, on shapes ragged against the run, the strip and
the segment, every output index written exactly once, and at one small
shape per dim against the JAX package's interpreted Pallas kernel; the
fused kernel's row blocks; the A/B tool's variants and its ptxas reader;
``chip_smoke.py``'s per-path route check.
The card's own tests of both routes are in ``tests/test_torch_gpu.py``.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mpi_tests.kernels import pallas_kernels as PK
from tpu_mpi_tests_torch.kernels import build, hand, kstep_ab

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
REPO = Path(__file__).resolve().parent.parent
KSTEP_CUH = (REPO / "tpu_mpi_tests_torch" / "kernels" / "csrc"
             / "stencil_kstep.cuh")
FLAGS = [(0, 0), (0, 1), (1, 0), (1, 1), "dynamic"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def constants():
    """The regs route's compile-time choices, read from the header."""
    text = KSTEP_CUH.read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
            for name in ("kRegsMaxSteps", "kPrefetch", "kRunRows",
                         "kLaneVecs", "kRegsThreads", "kSlots")}


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

@pytest.mark.parametrize("dtype", [BF16, F32, F64])
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("steps", [1, 4, 8, 9, 12])
@pytest.mark.parametrize("off", ["none", "z", "out", "pitch"])
def test_kstep_route_rule(dtype, dim, steps, off):
    """regs at steps <= 8 with every row of z and out on 8 bytes, in
    16-byte vectors where every row is on 16; one pointer or the row pitch
    one element off 16 bytes (off 8 too, but for float64), or more steps,
    and smem."""
    item = torch.empty((), dtype=dtype).element_size()
    width = 16 // item * 7 + (1 if off == "pitch" else 0)
    shape = (40, width)
    z = view(shape, dtype, item if off == "z" else 0)
    out = view(shape, dtype, item if off == "out" else 0)
    vec = 16 if off == "none" else 8 if item == 8 else 0
    want = "regs" if steps <= 8 and vec else "smem"
    assert hand.kstep_vec_bytes(z, out) == vec
    assert hand.kstep_route(z, dim, steps, out) == want
    assert hand.kstep_route(z, dim, steps, out, fused=True) == (
        "regs" if steps <= 8 and vec == 16 else "smem")
    alone = 16 if off in ("none", "out") else 8 if item == 8 else 0
    assert hand.kstep_vec_bytes(z) == alone
    assert hand.kstep_route(z, dim, steps) == (
        "regs" if steps <= 8 and alone else "smem")
    assert hand.KSTEP_ROUTES.index(want) == {"smem": 0, "regs": 1}[want]


@pytest.mark.parametrize("dtype", [BF16, F32, F64])
@pytest.mark.parametrize("off", ["z", "out", "pitch"])
def test_kstep_route_takes_8_byte_rows(dtype, off):
    """A pointer or the row pitch 8 bytes off 16 keeps the iterate's regs
    route, in 8-byte vectors (the fused kernel's is smem); 4 bytes off 8
    (a bfloat16 or float32 array) is smem."""
    item = torch.empty((), dtype=dtype).element_size()
    width = 16 // item * 7 + (8 // item if off == "pitch" else 0)
    z = view((40, width), dtype, 8 if off == "z" else 0)
    out = view((40, width), dtype, 8 if off == "out" else 0)
    assert hand.kstep_vec_bytes(z, out) == 8
    assert hand.kstep_route(z, 1, 4, out) == "regs"
    assert hand.kstep_route(z, 1, 9, out) == "smem"
    assert hand.kstep_route(z, 0, 4, out, fused=True) == "smem"
    if item < 8:
        width = 16 // item * 7 + (4 // item if off == "pitch" else 0)
        z = view((40, width), dtype, 4 if off == "z" else 0)
        out = view((40, width), dtype, 4 if off == "out" else 0)
        assert hand.kstep_vec_bytes(z, out) == 0
        assert hand.kstep_route(z, 0, 4, out) == "smem"


def test_kstep_route_constants_are_the_headers():
    text = KSTEP_CUH.read_text()
    assert hand.KSTEP_REGS_MAX_STEPS == C["kRegsMaxSteps"] == 8
    assert "return rows_on(16) ? 16 : rows_on(8) ? 8 : 0;" in text
    for name, value in (("kIterateRowBytes", hand.KSTEP_ROW_BYTES),
                        ("kFusedRowBytes", hand.FUSED_ROW_BYTES)):
        assert f"constexpr int {name} = {value};" in text
    assert (hand.KSTEP_ROW_BYTES, hand.FUSED_ROW_BYTES) == (8, 16)
    assert "enum KStepRoute : int { kKStepSmem = 0, kKStepRegs = 1 };" \
        in text
    assert hand.KSTEP_ROUTES == ("smem", "regs")
    with pytest.raises(ValueError, match="dim"):
        hand.kstep_route(torch.zeros(8, 8), 2, 1)


# ---------------------------------------------------------------------------
# the counts
# ---------------------------------------------------------------------------

def test_route_counts_lists_both_kstep_kernels():
    hand.reset_launch_counts()
    counts = hand.route_counts()
    for name in ("stencil2d_iterate", "stencil2d_fused_rdma"):
        assert counts[name] == {"smem": 0, "regs": 0}
    hand.stencil2d_iterate.launches_by_route["regs"] = 4
    hand.stencil2d_fused_rdma.launches_by_route["smem"] = 2
    counts = hand.route_counts()
    assert counts["stencil2d_iterate"]["regs"] == 4
    assert counts["stencil2d_fused_rdma"]["smem"] == 2
    hand.reset_launch_counts()
    for name in ("stencil2d_iterate", "stencil2d_fused_rdma"):
        assert hand.route_counts()[name] == {"smem": 0, "regs": 0}


@pytest.mark.parametrize("steps", [1, 4, 9])
def test_cpu_wrappers_are_the_plain_version_and_count_no_route(steps):
    hand.reset_launch_counts()
    K = 2 * steps
    z = torch.from_numpy(np.random.default_rng(steps).normal(
        size=(4 * K, 24)).astype(np.float32))
    for dim in (0, 1):
        zz = z if dim == 0 else z.T.contiguous()
        got = hand.stencil2d_iterate(zz, 0.3, dim=dim, steps=steps,
                                     phys_static=(1, 0))
        assert torch.equal(got, hand.stencil2d_iterate_ref(
            zz, 0.3, dim=dim, steps=steps, phys_static=(1, 0)))
    got = hand.stencil2d_fused_rdma(z, 0.3, steps=steps, local_only=True,
                                    phys_static=(1, 1))
    assert torch.equal(got, hand.stencil2d_iterate_ref(
        z, 0.3, dim=0, steps=steps, phys_static=(1, 1)))
    for name in ("stencil2d_iterate", "stencil2d_fused_rdma"):
        assert getattr(hand, name).launches == 0
        assert hand.route_counts()[name] == {"smem": 0, "regs": 0}


# ---------------------------------------------------------------------------
# the regs schedule, emulated
# ---------------------------------------------------------------------------

def coefs(dtype, se):
    t = {np.float32: F32, np.float64: F64}[dtype]
    return tuple(dtype(hand._rounded(v, t)) for v in (se, hand._C1,
                                                      hand._C2))


def step5(z0, m1, p1, m2, p2, k):
    """``_step5``'s order, each op rounded in the array's dtype."""
    se, c1, c2 = k
    return z0 + se * (c1 * (p1 - m1) + c2 * (p2 - m2))


def spans(n, steps, s, plo, phi):
    K = 2 * steps
    return (K if plo else 2 * s), n - (K if phi else 2 * s)


def run_rows(n0, runs):
    """The dim-0 launcher's run length for ``runs`` wanted runs (the
    card's resident threads over the column vectors), none shorter than
    kRunRows, balanced: (rows a run, runs)."""
    runs = max(1, min(runs, -(-n0 // C["kRunRows"])))
    ta = -(-n0 // runs)
    return ta, -(-n0 // ta)


def emulate_dim0(z, steps, plo, phi, k, runs, vec):
    """The dim-0 kernel, strip by strip of kRegsThreads column vectors of
    ``vec`` bytes: runs of ``ta`` rows (:func:`run_rows`), each walked row
    by row through the k stages' windows (row t of the walk in slot t %
    kSlots, five rows a stage), stage s emitting the row 2 rows behind
    stage s - 1, the last stage's rows of its own run stored. The runs of
    a strip walk in lockstep here (one array axis), as their threads
    do."""
    n0, n1 = z.shape
    E = vec // z.itemsize
    assert n1 % E == 0
    K = 2 * steps
    out = np.zeros_like(z)
    written = np.zeros(z.shape, np.int64)
    ta, runs = run_rows(n0, runs)
    slots = C["kSlots"]
    a0 = np.arange(runs) * ta
    stop = np.minimum(a0 + ta, n0)
    nv, T = n1 // E, C["kRegsThreads"]
    for strip in range(-(-nv // T)):
        v = np.arange(strip * T, min((strip + 1) * T, nv))
        cols = (v[:, None] * E + np.arange(E)).ravel()
        zero = np.zeros((a0.size, cols.size), z.dtype)
        win = [[zero] * slots for _ in range(steps)]
        for t in range(ta + 2 * K):
            ph, r = t % slots, a0 - K + t
            ok = (r >= 0) & (r < n0)
            win[0][ph] = np.where(ok[:, None],
                                  z[np.clip(r, 0, n0 - 1)][:, cols], 0)
            for s in range(1, steps + 1):
                c = r - 2 * s
                dlo, dhi = spans(n0, steps, s, plo, phi)
                w = [win[s - 1][(ph - back) % slots] for back in range(5)]
                val = np.where(((c >= dlo) & (c < dhi))[:, None],
                               step5(w[2], w[3], w[1], w[4], w[0], k), w[2])
                if s < steps:
                    win[s][ph] = val
                    continue
                mine = (c >= a0) & (c < stop)
                out[np.ix_(c[mine], cols)] = val[mine]
                written[np.ix_(c[mine], cols)] += 1
    return out, written


def emulate_dim1(z, steps, plo, phi, k, vec):
    """The dim-1 kernel, warp by warp, in vectors of ``vec`` bytes:
    segment ``seg`` of every row loads 32 lanes' kLaneVecs vectors from
    v0 = seg·inner − Kv on (zeros outside the row); each lane's vectors
    take two elements from each neighbour lane a step (lane 0 and lane 31
    their own, as a shuffle off the warp returns), and the inner part,
    all but the Kv-vector aprons, is written."""
    n0, n1 = z.shape
    E = vec // z.itemsize
    U, K = C["kLaneVecs"], 2 * steps
    Kv = -(-K // E)
    nv = n1 // E
    load = 32 * U
    inner = 32 * U - 2 * Kv
    out = np.zeros_like(z)
    written = np.zeros(z.shape, np.int64)
    for seg in range(-(-nv // inner)):
        v0 = seg * inner - Kv
        ea = ((v0 + np.arange(load))[:, None] * E + np.arange(E)).ravel()
        ok = (ea >= 0) & (ea < n1)
        row = np.where(ok, z[:, np.clip(ea, 0, n1 - 1)], 0).astype(z.dtype)
        interior = v0 * E >= K and (v0 + load) * E <= n1 - K
        x = row.reshape(n0, 32, U * E)
        a = ea.reshape(32, U * E)
        for s in range(1, steps + 1):
            dlo, dhi = spans(n1, steps, s, plo, phi)
            upd = interior | ((a >= dlo) & (a < dhi))
            left = np.concatenate([x[:, :1, -2:], x[:, :-1, -2:]], 1)
            right = np.concatenate([x[:, 1:, :2], x[:, -1:, :2]], 1)
            e = np.concatenate([left, x, right], 2)
            new = step5(e[..., 2:-2], e[..., 1:-3], e[..., 3:-1],
                        e[..., :-4], e[..., 4:], k)
            x = np.where(upd, new, x)
        keep = ((a >= (v0 + Kv) * E) & (a < (v0 + Kv + inner) * E)
                & (a < n1))
        rows = np.broadcast_to(np.arange(n0)[:, None, None], x.shape)
        cols = np.broadcast_to(a, x.shape)
        out[rows[:, keep], cols[:, keep]] = x[:, keep]
        np.add.at(written, (rows[:, keep], cols[:, keep]), 1)
    return out, written


def emulate(z, dim, steps, plo, phi, se, runs=1, vec=16):
    """The regs kernel's result on ``z`` along ``dim`` in vectors of
    ``vec`` bytes (at dim 0 ``runs`` wanted runs)."""
    if steps == 1:  # the wrapper's rule: the spans coincide at one step
        plo = phi = 0
    k = coefs(z.dtype.type, se)
    if dim == 0:
        return emulate_dim0(z, steps, plo, phi, k, runs, vec)
    return emulate_dim1(z, steps, plo, phi, k, vec)


def _flags(flags):
    if flags == "dynamic":
        return (1, 0), {"phys": torch.tensor([1, 0], dtype=torch.int32)}
    return flags, {"phys_static": flags}


def _ragged(dim, steps, dtype, vec=16):
    """Ragged against the run (293 rows: one run, or two of 147 and 146,
    or at most three of 98, 98 and 97), the strip (131 column vectors of
    ``vec`` bytes: a full strip of kRegsThreads and 3) and the segment
    (150 vectors a row)."""
    E = vec // np.dtype(dtype).itemsize
    if dim == 0:
        return (2 * C["kRunRows"] + 37, (C["kRegsThreads"] + 3) * E)
    return (5, 150 * E)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("steps", range(1, 9))
@pytest.mark.parametrize("flags", FLAGS)
def test_regs_emulation_is_the_plain_version(dtype, dim, steps, flags):
    shape = _ragged(dim, steps, dtype)
    z = np.random.default_rng(steps + 10 * dim).normal(size=shape).astype(
        dtype)
    (plo, phi), kw = _flags(flags)
    runs = (1, 2, 1000)[steps % 3]  # one run, two, the most kRunRows allows
    got, written = emulate(z, dim, steps, plo, phi, 0.37, runs=runs)
    want = hand.stencil2d_iterate_ref(torch.from_numpy(z), 0.37, dim=dim,
                                      steps=steps, **kw).numpy()
    assert (written == 1).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("steps", [1, 4, 8])
@pytest.mark.parametrize("flags", [(1, 0), "dynamic"])
def test_regs_emulation_at_8_byte_vectors(dtype, dim, steps, flags):
    """The schedule in 8-byte vectors (rows on 8 bytes but not 16: twice
    the column vectors of a strip, half the elements of a lane): bit for
    bit the plain version, every index written once."""
    shape = _ragged(dim, steps, dtype, vec=8)
    z = np.random.default_rng(steps + 7 * dim).normal(size=shape).astype(
        dtype)
    (plo, phi), kw = _flags(flags)
    got, written = emulate(z, dim, steps, plo, phi, 0.37, runs=2, vec=8)
    want = hand.stencil2d_iterate_ref(torch.from_numpy(z), 0.37, dim=dim,
                                      steps=steps, **kw).numpy()
    assert (written == 1).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vec", [16, 8])
@pytest.mark.parametrize("steps", [1, 3, 8])
@pytest.mark.parametrize("n1", [4 * 150, 4 * 17, 4 * (2 * 8 + 1)])
def test_dim1_designs_cover_every_segment_edge(vec, steps, n1):
    """The dim-1 segments in both vector widths at rows that end inside a
    segment, narrower than one, and barely wider than the ghosts."""
    if n1 <= 4 * steps:
        pytest.skip("extent too small for the ghosts")
    z = np.random.default_rng(n1).normal(size=(3, n1)).astype(np.float32)
    got, written = emulate(z, 1, steps, 1, 0, 0.37, vec=vec)
    want = hand.stencil2d_iterate_ref(torch.from_numpy(z), 0.37, dim=1,
                                      steps=steps,
                                      phys_static=(1, 0)).numpy()
    assert (written == 1).all()
    np.testing.assert_array_equal(got, want)


def test_run_rows_are_balanced_and_bounded():
    n = 2 * C["kRunRows"] + 37
    assert run_rows(n, 1) == (n, 1)
    assert run_rows(n, 2) == (-(-n // 2), 2)
    assert run_rows(n, 1000) == (-(-n // 3), 3)
    assert run_rows(2 * C["kRunRows"], 1000) == (C["kRunRows"], 2)
    text = (build.CSRC / "stencil_iterate.cu").read_text()
    assert "const long long most = (n0 + kRunRows - 1) / kRunRows;" in text


@pytest.mark.parametrize("dim", [0, 1])
def test_regs_emulation_matches_the_jax_kernel(dim):
    """≅ ``tests/test_torch_kernels.py``'s iterate checks: the JAX
    ``stencil2d_iterate_pallas`` in interpret mode, its own tolerance
    (XLA may contract a mul+add)."""
    steps, K = 2, 4
    E = 16 // 4
    shape = (37 + 2 * K, 8 * E) if dim == 0 else (6, 37 * E)
    z = np.random.default_rng(40 + dim).normal(size=shape).astype(np.float32)
    want = np.asarray(PK.stencil2d_iterate_pallas(
        jnp.asarray(z), 0.25, dim=dim, steps=steps, interpret=True,
        phys_static=(1, 0)))
    got, written = emulate(z, dim, steps, 1, 0, 0.25)
    assert (written == 1).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the fused kernel's row blocks
# ---------------------------------------------------------------------------

def launcher_block_rows(n0, steps, fill):
    """The fused launcher's own block on the regs route (B = 0 from the
    wrapper): the shortest divisor of n0 no shorter than the seam,
    kMinBlockRows and ``fill`` rows, else n0."""
    least = max(4 * steps, FUSED_MIN_ROWS, fill)
    return min([d for d in range(1, n0 + 1) if n0 % d == 0 and d >= least]
               or [n0])


FUSED_MIN_ROWS = int(re.search(
    r"constexpr int kMinBlockRows = (\d+);",
    (build.CSRC / "fused_rdma.cu").read_text())[1])


def test_fused_block_rows_default_per_route():
    """regs: 0 (the launcher's block: the shortest divisor no shorter
    than kMinBlockRows, the rows that fill the card and the seam; 8208 =
    2^4·3^3·19: 144, and 342 and 171 at the fills of the f32 and bf16
    bench buffers, 331 and 166 rows), else the height; no shared-memory
    cap; smem: up to 64, never over 256; both raise naming the seam when
    nothing fits."""
    assert FUSED_MIN_ROWS == 128
    assert hand.fused_block_rows(8208, 4) == 0
    assert hand.fused_block_rows(8208, 4, route="regs") == 0
    assert launcher_block_rows(8208, 4, 0) == 144
    assert launcher_block_rows(8208, 4, 331) == 342
    assert launcher_block_rows(8208, 4, 166) == 171
    assert launcher_block_rows(8208, 4, 20000) == 8208
    assert launcher_block_rows(40, 4, 0) == 40
    # 526 = 2·263: only 263 and 526 hold a 16-row seam
    assert launcher_block_rows(526, 4, 0) == 263
    assert hand.fused_block_rows(526, 4) == 0
    assert hand.fused_block_rows(40, 4, route="smem") == 40
    assert hand.fused_block_rows(8208, 4, route="smem") == 57
    assert hand.fused_block_rows(8208, 4, tile_rows=456) == 456
    assert hand.fused_block_rows(8208, 4, tile_rows=456,
                                 route="smem") == 228
    with pytest.raises(ValueError, match="seam"):
        hand.fused_block_rows(526, 4, route="smem")
    with pytest.raises(ValueError, match="seam"):
        hand.fused_block_rows(34, 4, tile_rows=8)
    with pytest.raises(ValueError, match="too small"):
        hand.fused_block_rows(16, 4)
    with pytest.raises(ValueError, match="route"):
        hand.fused_block_rows(64, 1, route="tiles")


# ---------------------------------------------------------------------------
# the A/B tool and the ptxas reader
# ---------------------------------------------------------------------------

def test_kstep_ab_variants_patch_one_line_each():
    """Every variant's edits find their text once in the tree and apply
    in turn; the designs the A/B lost to (the dim-1 stage, float-then-
    round bfloat16, the old sends, a ten-slot ring) live only in those
    patches."""
    assert set(kstep_ab.VARIANTS) == {
        "base", "smem", "v8", "p1", "p2", "p6", "p8", "ta64", "ta256",
        "ta512", "u4", "stage", "float", "oldsend", "rul5"}
    for name, edits in kstep_ab.VARIANTS.items():
        assert bool(edits) == (name != "base"), name
        patched = {}
        for file, old, new in edits:
            text = (build.CSRC / file).read_text()  # ../build.py: the flags
            assert text.count(old) == 1, (name, old)
            patched.setdefault(file, text)
            assert patched[file].count(old) == 1, (name, old)
            patched[file] = patched[file].replace(old, new)
            assert old != new and new not in text, name
    kstep = KSTEP_CUH.read_text()
    fused = (build.CSRC / "fused_rdma.cu").read_text()
    for gone in ("kDim1Shuffle", "kBf16Packed", "__shared__",
                 "__floats2bfloat162_rn"):
        assert gone not in kstep.split("// the regs route")[1], gone
    assert "kSendWalk" not in fused and "__threadfence_system" not in fused
    assert "constexpr int kSlots = 5;" in kstep


@pytest.mark.parametrize("mangled,name", [
    ("_ZN5tpumt51_GLOBAL__N__4e2be680_18_stencil_iterate_cu_c629508217"
     "iterate_regs_dim0IfLi4ELi16EEEvPKT_PS2_ixiNS_3EltIS2_E1CES8_S8_iiPKi",
     "iterate_regs_dim0<float, 4, 16>"),
    ("_ZN5tpumt51_GLOBAL__N__4e2be680_18_stencil_iterate_cu_c629508217"
     "iterate_regs_dim1I13__nv_bfloat16Li8ELi8EEEvPKT_PS3_xiiNS_3EltIS3_E1"
     "CES9_S9_iiPKi", "iterate_regs_dim1<bf16, 8, 8>"),
    ("_ZN5tpumt46_GLOBAL__N__2f110d98_13_fused_rdma_cu_950ec17817"
     "fused_rdma_kernelIdLi0ELb1EEEvNS_8RingViewINS0_4WordIXstT_EE4typeEEE"
     "PS3_NS0_9FusedGeomENS_3EltIS3_E1CESD_SD_iiPKiPS7_",
     "fused_rdma_kernel<double, 0, true>"),
    ("_ZN5tpumt46_GLOBAL__N__2f110d98_13_fused_rdma_cu_950ec17817"
     "fused_rdma_kernelIfLi4ELb0EEEvNS_8RingViewINS0_4WordIXstT_EE4typeEEE"
     "PS3_NS0_9FusedGeomENS_3EltIS3_E1CESD_SD_iiPKiPS7_",
     "fused_rdma_kernel<float, 4, false>"),
    ("_ZN5tpumt51_GLOBAL__N__4e2be680_18_stencil_iterate_cu_c629508217"
     "iterate_kernelIfLi1EEEvPKT_PS2_xxiNS_3EltIS2_E1CES8_S8_iiPKix",
     "iterate_kernel<float, 1>")])
def test_kstep_instances_are_named(mangled, name, monkeypatch):
    assert kstep_ab.kernel_name(mangled) == name
    log = (f"ptxas info    : Compiling entry function '{mangled}' for "
           f"'sm_90a'\nptxas info    : Used 120 registers\n"
           f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           f"loads\n")
    monkeypatch.setitem(build.BUILD_LOGS, "stencil_iterate", log)
    assert build.ptxas_summary("stencil_iterate", kstep_ab.kernel_name) == {
        name: {"registers": 120, "stack": 0, "spill_stores": 0,
               "spill_loads": 0}}


# ---------------------------------------------------------------------------
# chip_smoke.py: the per-path route check
# ---------------------------------------------------------------------------

def test_check_kstep_routes_wants_the_main_path_on_regs():
    cs = _chip_smoke()
    zero = {"smem": 0, "regs": 0}
    cs.ROUTE_COUNTS["p"] = {"stencil2d_iterate": zero | {"regs": 7},
                            "stencil2d_fused_rdma": zero | {"regs": 3}}
    cs.check_kstep_routes("p", {"stencil2d_iterate": 7,
                                "stencil2d_fused_rdma": 3})
    with pytest.raises(cs.SmokeFailure, match="stencil2d_iterate"):
        cs.check_kstep_routes("p", {"stencil2d_iterate": 6,
                                    "stencil2d_fused_rdma": 3})
    cs.ROUTE_COUNTS["p"]["stencil2d_fused_rdma"] = zero | {"regs": 2,
                                                           "smem": 1}
    with pytest.raises(cs.SmokeFailure, match="stencil2d_fused_rdma"):
        cs.check_kstep_routes("p", {"stencil2d_iterate": 7,
                                    "stencil2d_fused_rdma": 3})
    # no main-path operand goes to smem: a launch there fails the path
    cs.ROUTE_COUNTS["q"] = {"stencil2d_iterate": {"regs": 5, "smem": 2},
                            "stencil2d_fused_rdma": dict(zero)}
    with pytest.raises(cs.SmokeFailure, match="stencil2d_iterate"):
        cs.check_kstep_routes("q", {"stencil2d_iterate": 7})
    cs.ROUTE_COUNTS["q"]["stencil2d_iterate"] = {"regs": 7, "smem": 0}
    cs.check_kstep_routes("q", {"stencil2d_iterate": 7})


# ---------------------------------------------------------------------------
# the cross-wired fused instances' plain world
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [True, False])
def test_fused_world_ref_is_the_exchange_then_the_iterate(periodic):
    """Rank r's result: its lo ghost band from rank r-1's hi edge, its hi
    ghost band from rank r+1's lo edge (where the ring sends), then the
    k-step update with the ring's ends physical; at w = 1 the self-ring's
    plain fused result."""
    steps, K = 2, 4
    rng = np.random.default_rng(5)
    shards = [torch.from_numpy(rng.normal(size=(20, 12)).astype(np.float32))
              for _ in range(3)]
    got = hand.stencil2d_fused_rdma_world_ref(shards, 0.01, steps, periodic)
    for r, g in enumerate(got):
        z = shards[r].clone()
        if periodic or r > 0:
            z[:K] = shards[(r - 1) % 3][-2 * K:-K]
        if periodic or r < 2:
            z[-K:] = shards[(r + 1) % 3][K:2 * K]
        flags = (int(not (periodic or r > 0)), int(not (periodic or r < 2)))
        assert torch.equal(g, hand.stencil2d_iterate_ref(
            z, 0.01, dim=0, steps=steps, phys_static=flags))
    one = hand.stencil2d_fused_rdma_world_ref(shards[:1], 0.01, steps, True)
    assert torch.equal(one[0], hand.stencil2d_fused_rdma_ref(
        shards[0].clone(), 0.01, steps, periodic=True, phys_static=(0, 0)))
