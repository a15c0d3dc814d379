"""The routes of the port's 5-point derivative, on the CPU.

The CUDA launcher of ``csrc/stencil_deriv.cu`` takes the route the
wrapper names (``hand.deriv_route``) and refuses any other: "regs" where
every row of z and of out starts on 16 or 8 bytes (both pointers there,
both row pitches whole vectors — out's is 4 elements shorter along dim
1: ``hand.deriv_vec_bytes``), "scalar" otherwise. Here: the rule for each
dtype × dim with each pointer and each row pitch off 16, 8 and 4 bytes in
turn; the constants against the source; a numpy emulation of the regs
schedule, built from the source's constants — along dim 0 a thread a
column vector down a run of output rows through the ring of register
rows (``kDerivSlots`` slots, ``kDerivPrefetch`` rows ahead), along dim 1
a warp a segment of 32 output vectors, each lane's right-hand taps
brought by "shuffles" from the lanes after it and past the segment's
end from the next segment's first vectors, which its first lanes load —
the runs sized to one wave of the card; held bit for bit against the
plain version in float32 and in bfloat16 with every op rounded, in 16-
and 8-byte vectors, on shapes ragged against the runs and the segment,
every output point written exactly once, and at one small shape per dim
against the JAX package's interpreted ``stencil2d_pallas``. The counts
and the A/B tool are in ``tests/test_torch_heat_route.py``; the card's
own tests of both routes in ``tests/test_torch_gpu.py``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_heat_route import round_bf16, view, wave_runs
from tpu_mpi_tests.kernels import pallas_kernels as PK
from tpu_mpi_tests_torch.kernels import build, hand
from tpu_mpi_tests_torch.kernels.stencil import STENCIL5

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
DERIV_CU = build.CSRC / "stencil_deriv.cu"
SCALE = 3.0


def constants():
    """The regs route's compile-time choices, read from the source."""
    text = DERIV_CU.read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
            for name in ("kDerivPrefetch", "kDerivRunRows",
                         "kDerivThreads", "kDerivSlots", "kTaps")}


C = constants()


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

#: geometry -> (where the offset is, its bytes)
GEOMETRIES = {"aligned": (None, 0), "z8": ("z", 8), "out8": ("out", 8),
              "pitch8": ("pitch", 8), "z4": ("z", 4), "out4": ("out", 4),
              "pitch4": ("pitch", 4)}


@pytest.mark.parametrize("dtype", [BF16, F32, F64])
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_deriv_route_rule(dtype, dim, geometry):
    """regs in 16-byte vectors where every row of z and out starts on 16
    bytes, in 8-byte ones where on 8; off 8 (4 bytes off), and scalar.
    Along dim 1 out's row is 4 elements shorter, so a bfloat16 z on 16
    bytes gives 8-byte vectors."""
    item = torch.empty((), dtype=dtype).element_size()
    where, off = GEOMETRIES[geometry]
    if off % item:
        pytest.skip("no such offset for this dtype")
    width = 16 // item * 9 + (off // item if where == "pitch" else 0)
    zshape = (24, width + (4 if dim == 1 else 0))
    oshape = (24 - (4 if dim == 0 else 0), width)
    z = view(zshape, dtype, off if where == "z" else 0)
    out = view(oshape, dtype, off if where == "out" else 0)
    # the bytes every row of both starts on, capped at 16
    pitches = [zshape[1] * item, oshape[1] * item]
    starts = [16 if where != "z" else off, 16 if where != "out" else off]
    on = max(b for b in (16, 8, 4, 2)
             if all(p % b == 0 for p in pitches + starts))
    vec = on if on >= 8 else 0
    assert hand.deriv_vec_bytes(z, dim, out) == vec
    want = "regs" if vec else "scalar"
    assert hand.deriv_route(z, dim, out) == want
    assert hand.DERIV_ROUTES.index(want) == {"scalar": 0, "regs": 1}[want]


@pytest.mark.parametrize("n1,dim0,dim1", [(1024, 16, 8), (1028, 8, 8),
                                         (1030, 0, 0)])
def test_deriv_bf16_vectors_by_dim(n1, dim0, dim1):
    """bfloat16: along dim 1 z's and out's rows differ by 8 bytes, so
    both start on 16 bytes nowhere, and on 8 where n1 is a multiple of 4;
    along dim 0 they are alike."""
    z = view((6, n1), BF16)
    assert hand.deriv_vec_bytes(z, 0) == dim0
    assert hand.deriv_vec_bytes(z, 1) == dim1
    assert hand.deriv_route(z, 1) == ("regs" if dim1 else "scalar")


def test_deriv_route_constants_are_the_source():
    text = DERIV_CU.read_text()
    assert "enum DerivRoute : int { kDerivScalar = 0, kDerivRegs = 1 };" \
        in text
    assert hand.DERIV_ROUTES == ("scalar", "regs")
    assert "for (int b = 16; b >= 8; b /= 2)" in text
    assert "rows_start_on(b, z, out, n1 * itemsize, m1 * itemsize)" in text
    assert "if (route != deriv_route(dim, z, out, n1, itemsize))" in text
    assert C["kTaps"] == 2 * hand.N_BND
    assert C["kDerivPrefetch"] < C["kDerivSlots"] >= 5
    with pytest.raises(ValueError, match="dim"):
        hand.deriv_route(torch.zeros(8, 8), 2)


# ---------------------------------------------------------------------------
# the regs schedule, emulated
# ---------------------------------------------------------------------------

def taps_of(bf16):
    """The taps of DerivTaps, each op rounded as the kernel's (float32
    _rn; bf16x2.rn, which is float-then-round)."""
    r = round_bf16 if bf16 else (lambda x: x)
    dt = BF16 if bf16 else F32
    c0, c1, _, c3, c4 = (np.float32(hand._rounded(c, dt))
                         for c in STENCIL5.tolist())
    sc = np.float32(hand._rounded(SCALE, dt))

    def taps(z0, z1, z3, z4):
        acc = r(c0 * z0)
        acc = r(acc + r(c1 * z1))
        acc = r(acc + r(c3 * z3))
        acc = r(acc + r(c4 * z4))
        return r(acc * sc)

    return taps


def emulate_dim0(z, vb, item, resident, bf16):
    """Dim 0: thread x a column vector of ``vb`` bytes, run y output rows
    y·ta .. + ta, its z rows a0 + t through the prefetch ring (slot t %
    kDerivSlots, kDerivPrefetch ahead) into the window ring, output row
    a0 + t − 4 from the window's slots t − 4 .. t."""
    taps = taps_of(bf16)
    n0, n1 = z.shape
    m0, E = n0 - 4, vb // item
    nv = n1 // E
    cols = -(-nv // C["kDerivThreads"])
    runs = wave_runs(resident, cols, m0, C["kDerivRunRows"])
    ta = -(-m0 // runs)
    S, P = C["kDerivSlots"], C["kDerivPrefetch"]
    out = np.zeros((m0, n1), np.float32)
    written = np.zeros(out.shape, np.int64)
    width = nv * E  # every column lies in a thread's vector
    for run in range(runs):
        a0 = run * ta
        rows = min(a0 + ta, m0) - a0 + 4
        pre, win = [None] * S, [None] * S

        def load(t):
            return (z[a0 + t, :width] if t < rows
                    else np.zeros(width, np.float32))

        for p in range(P):
            pre[p] = load(p)
        for t in range(rows):
            pre[(t + P) % S] = load(t + P)
            win[t % S] = pre[t % S]
            if t < 4:
                continue
            row = [win[(t % S + S - 4 + d) % S] for d in range(5)]
            out[a0 + t - 4] = taps(row[0], row[1], row[3], row[4])
            written[a0 + t - 4] += 1
    return out, written


def emulate_dim1(z, vb, item, resident, bf16):
    """Dim 1: warp ``seg`` of run y owns output vectors 32·seg + L; a lane
    holds its z vector (zeros past the row) in words of one element
    (float32) or two (bfloat16), and the first Av lanes also the next
    segment's vector L; word h right of lane L's vector comes by a
    shuffle from lane (L + q) mod 32, q = 1 + h // NW, which hands out its
    next-segment vector where it lies below q."""
    taps = taps_of(bf16)
    n0, n1 = z.shape
    m1, E = n1 - 4, vb // item
    elems = 2 if bf16 else 1          # elements a word
    NW = E // elems                   # words a vector
    H = -(-4 // elems)                # words right of a vector the taps reach
    Av = -(-4 // E)
    nv, mv = n1 // E, m1 // E
    segs = -(-mv // 32)
    warps = C["kDerivThreads"] // 32
    runs = wave_runs(resident, -(-segs // warps), n0, C["kDerivRunRows"])
    ta = -(-n0 // runs)
    out = np.zeros((n0, m1), np.float32)
    written = np.zeros(out.shape, np.int64)
    for seg in range(segs):
        v = 32 * seg + np.arange(32)

        def vectors(idx):
            cols = idx[:, None] * E + np.arange(E)[None, :]
            ok = (idx < nv)[:, None]
            return cols, ok

        own_c, own_ok = vectors(v)
        nxt_c, nxt_ok = vectors(v + 32)
        nxt_ok = nxt_ok & (np.arange(32) < Av)[:, None]
        for run in range(runs):
            for r in range(run * ta, min(run * ta + ta, n0)):
                row = z[r]
                x = np.where(own_ok, row[np.clip(own_c, 0, n1 - 1)], 0)
                y = np.where(nxt_ok, row[np.clip(nxt_c, 0, n1 - 1)], 0)
                words_x = x.reshape(32, NW, elems)
                words_y = y.reshape(32, NW, elems)
                right = np.zeros((32, H, elems), np.float32)
                for h in range(H):
                    q = 1 + h // NW
                    src = (np.arange(32) + q) % 32
                    give = np.where((np.arange(32) < q)[:, None],
                                    words_y[:, h % NW], words_x[:, h % NW])
                    right[:, h] = give[src]
                ext = np.concatenate([x, right.reshape(32, H * elems)], 1)
                o = taps(ext[:, 0:E], ext[:, 1:E + 1], ext[:, 3:E + 3],
                         ext[:, 4:E + 4])
                keep = v < mv
                cols = own_c[keep].ravel()
                out[r, cols] = o[keep].ravel()
                np.add.at(written[r], cols, 1)
    return out, written


def field(seed, shape, bf16):
    z = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return round_bf16(z) if bf16 else z


def plain(z, dim, bf16):
    t = torch.from_numpy(z)
    if bf16:
        t = t.to(BF16)
    return hand.stencil2d_deriv_ref(t, SCALE, dim=dim).float().numpy()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("vb", [16, 8])
@pytest.mark.parametrize("resident", [1, 3, 10**6])
def test_dim0_emulation_is_the_plain_version(bf16, vb, resident):
    """Ragged against the runs (2·kDerivRunRows + 37 output rows: one
    run, a few, the floor's) and the CTA's column vectors (a CTA's and
    3)."""
    item = 2 if bf16 else 4
    E = vb // item
    shape = (2 * C["kDerivRunRows"] + 37 + 4, (C["kDerivThreads"] + 3) * E)
    z = field(vb + resident % 7, shape, bf16)
    got, written = emulate_dim0(z, vb, item, resident, bf16)
    assert (written == 1).all()
    np.testing.assert_array_equal(got, plain(z, 0, bf16))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("vb", [16, 8])
@pytest.mark.parametrize("n1_vecs", [1, 31, 32, 33, 70])
def test_dim1_emulation_is_the_plain_version(bf16, vb, n1_vecs):
    """Outputs of 1, 31, 32, 33 and 70 vectors a row: narrower than a
    segment, one exactly, ragged against it; 2·kDerivRunRows + 5 rows.
    (bfloat16 in 16-byte vectors has no such operand: z's and out's rows,
    8 bytes apart, never both start on 16.)"""
    item = 2 if bf16 else 4
    E = vb // item
    if 4 % E:
        pytest.skip("z's and out's rows cannot both be whole vectors")
    shape = (2 * C["kDerivRunRows"] + 5, n1_vecs * E + 4)
    z = field(n1_vecs, shape, bf16)
    got, written = emulate_dim1(z, vb, item, 3, bf16)
    assert (written == 1).all()
    np.testing.assert_array_equal(got, plain(z, 1, bf16))


@pytest.mark.parametrize("dim", [0, 1])
def test_regs_emulation_matches_the_jax_kernel(dim):
    """≅ ``tests/test_torch_kernels.py``'s derivative check: the JAX
    ``stencil2d_pallas`` in interpret mode, float32 to 1e-6 (XLA may
    contract a mul+add)."""
    shape = (41, 36) if dim == 0 else (29, 36 + 4)
    z = field(40 + dim, shape, False)
    want = np.asarray(PK.stencil2d_pallas(jnp.asarray(z), SCALE, dim=dim,
                                          interpret=True))
    emulate = emulate_dim0 if dim == 0 else emulate_dim1
    got, written = emulate(z, 16, 4, 10**6, False)
    assert (written == 1).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
