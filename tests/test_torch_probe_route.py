"""The routes of the port's ALU probe, on the CPU.

The CUDA entry point of ``csrc/alu_probe.cu`` takes the route the
wrapper names (``hand.probe_route``) and refuses any other: "cluster"
where one thread-block cluster's shared memory holds a block's slabs in
a ping-pong (``hand.probe_cluster``: the fewest CTAs, up to 16, whose
two slabs fit a CTA's budget with at least 2 rows a slab), "l2"
otherwise. Here: the rule at blocks on clusters of 1 to 16 CTAs and at
blocks no cluster holds, in both dtypes, and its invariants over many
shapes; the constants against the source; the batch rule of the main
path (``microbench.probe_batch_rule``) as a pure function of the card's
SMs and clusters; the corrected bound (issued lone ops over the card's
issue rate, bfloat16 two elements an instruction) and the rate gate of
``chip_smoke.py``; the counts (the CPU wrapper counts no route); the
A/B tool's variants and its ptxas reader; and the plain version against
the JAX package's ``vpu_probe_pallas`` in interpret mode at shapes off
the (8, 128) tiling, every mix in both dtypes, with the tolerances of
``tests/test_torch_probe.py``. The card's own tests of both routes are in
``tests/test_torch_gpu.py``.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mpi_tests.kernels import pallas_kernels as PK
from tpu_mpi_tests_torch import microbench
from tpu_mpi_tests_torch.convert import array_from_jax
from tpu_mpi_tests_torch.kernels import build, hand, probe_ab

F32, BF16 = torch.float32, torch.bfloat16
REPO = Path(__file__).resolve().parent.parent
PROBE_CU = REPO / "tpu_mpi_tests_torch" / "kernels" / "csrc" / "alu_probe.cu"
SE = 0.05


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

#: (block shape, dtype, CTAs a cluster or None for the l2 route)
CASES = [
    ((8, 128), F32, 1), ((37, 200), F32, 1), ((3, 70, 130), BF16, 1),
    ((1000, 40), F32, 2), ((997, 100), F32, 4), ((250, 520), F32, 8),
    ((515, 500), F32, 16), ((512, 512), F32, 16), ((8, 512, 512), F32, 16),
    ((512, 512), BF16, 8), ((1023, 130), BF16, 4), ((300, 2000), BF16, 16),
    ((700, 1000), F32, None), ((1030, 1024), BF16, None),
    ((1024, 1024), F32, None), ((5, 100000), F32, None),
]


@pytest.mark.parametrize("shape, dtype, cs", CASES)
def test_probe_route_rule(shape, dtype, cs):
    """The cluster is the fewest CTAs whose two slabs fit; every mix takes
    the route of the block's shape and dtype."""
    z = torch.zeros(shape, dtype=dtype)
    got = hand.probe_cluster(*shape[-2:], dtype)
    assert (got and got[0]) == cs
    for mix in hand.ALU_PROBE_MIXES:
        assert hand.probe_route(z, mix) == ("l2" if cs is None
                                            else "cluster")
    with pytest.raises(ValueError, match="unknown mix"):
        hand.probe_route(z, "fma2")


def _slab_invariants(H, W, dtype):
    item = torch.empty((), dtype=dtype).element_size()
    got = hand.probe_cluster(H, W, dtype)
    pitch = -(-W // (16 // item)) * (16 // item)
    if got is None:
        # no cluster size fits with at least 2 rows a slab
        for cs in (1, 2, 4, 8, 16):
            rs = -(-H // cs)
            assert (cs > 1 and rs < 2) or \
                2 * rs * pitch * item > hand.PROBE_CLUSTER_SMEM
        return
    cs, rs, p, nbytes = got
    assert p == pitch and p % (16 // item) == 0 and p >= W
    assert cs * rs >= H and (cs == 1 or rs >= 2)
    assert nbytes == 2 * rs * p * item <= hand.PROBE_CLUSTER_SMEM
    if cs > 1:  # the fewest CTAs: half as many do not fit
        assert 2 * -(-H // (cs // 2)) * p * item > hand.PROBE_CLUSTER_SMEM


_RNG = np.random.default_rng(15)


@pytest.mark.parametrize("H, W, dtype", [
    (int(h), int(w), d) for d in (F32, BF16)
    for h, w in zip(_RNG.integers(1, 4000, 24), _RNG.integers(1, 3000, 24))])
def test_probe_cluster_invariants(H, W, dtype):
    _slab_invariants(H, W, dtype)


def test_probe_route_constants_are_the_source():
    text = PROBE_CU.read_text()
    smem = re.search(r"constexpr long long kClusterSmem = ([\d -]+);",
                     text)[1]
    assert hand.PROBE_CLUSTER_SMEM == eval(smem) == 232448 - 1024
    assert f"constexpr int kMaxCluster = {hand.PROBE_MAX_CLUSTER};" in text
    assert "enum ProbeRoute : int { kRouteL2 = 0, kRouteCluster = 1 };" \
        in text
    assert hand.PROBE_ROUTES == ("l2", "cluster")
    # the entry point refuses any other route than the rule's
    assert "if (route != probe_route(sizeof(T), H, W)) return " \
           "cudaErrorInvalidValue;" in text
    # no grid barrier on the cluster route, no barrier at all for fma
    cluster = text.split("// the cluster route")[1].split(
        "cudaError_t cluster_attrs()")[0]
    assert "grid.sync" not in cluster and "this_grid" not in cluster
    fma = cluster.split("if constexpr (MIX == kFma) {")[1].split(
        "  } else {")[0]
    assert "barrier" not in fma and "__syncthreads" not in fma


# ---------------------------------------------------------------------------
# the batch rule, the bound and the gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sms, clusters, tiles, want", [
    (132, 7, 64, 7), (132, 15, 64, 15), (132, 1, 64, 1),
    (132, 0, 64, 8), (132, 0, 1, 528), (1, 0, 1000, 1), (114, 0, 64, 7)])
def test_probe_batch_rule(sms, clusters, tiles, want):
    """As many blocks as the card holds clusters; on the l2 route (no
    cluster) enough tiles for about four CTAs an SM."""
    assert microbench.probe_batch_rule(sms, clusters, tiles) == want


def test_probe_batch_off_the_card_is_one():
    assert microbench.probe_batch(512, 512, torch.device("cpu"), BF16) == 1


@pytest.mark.parametrize("mix", hand.ALU_PROBE_MIXES)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_probe_bound_counts_issued_instructions(mix, dtype):
    """The bound is the issued lone ops over the issue rate; bfloat16 as
    bf16x2 does two elements an instruction."""
    rate = 132 * 128 * 1.98e9
    got = hand.probe_bound_s(mix, dtype, 7 * 512 * 512, 100, rate)
    per = 2 if dtype == BF16 else 1
    assert got == pytest.approx(hand.ALU_PROBE_REAL_OPS[mix] * 7 * 512
                                * 512 * 100 / per / rate, rel=1e-12)


def test_real_op_counts():
    """heat5: 2w, two sums and two differences, two scaled adds."""
    assert hand.ALU_PROBE_REAL_OPS == {
        "fma": 2, "step5_d0": 7, "step5_d1": 7, "step5fma_d0": 8,
        "step5fma_d1": 8, "heat5": 9, "dualdim": 25, "dualdim_lean": 19}


def test_chip_smoke_probe_gate_is_the_issue_rate(monkeypatch):
    """A probe row may issue at most 1.05× the card's lone-op rate (twice
    that in elements for bfloat16), not 67 TFLOP/s."""
    cs = _chip_smoke()
    rate = 132 * 128 * 1.98e9
    monkeypatch.setattr(cs, "issue_rate", lambda: rate)

    def row(mix, dname, issued_gops):
        nominal = 7
        v = issued_gops * nominal / hand.ALU_PROBE_REAL_OPS[mix]
        return {"metric": f"vpu_{mix}_{dname}_gops", "value": v,
                "unit": "Gop/s", "detail": f"x; nominal {nominal} ops/elt"}

    cs.check_one_card_rates("p", [row("step5_d0", "float32", rate / 1e9)])
    cs.check_one_card_rates("p", [row("step5_d1", "bfloat16",
                                      2 * rate / 1e9)])
    for dname, over in (("float32", 1.06), ("bfloat16", 2.12)):
        with pytest.raises(cs.SmokeFailure, match="issue rate"):
            cs.check_one_card_rates("p", [row("step5_d0", dname,
                                              over * rate / 1e9)])


# ---------------------------------------------------------------------------
# the counts and the A/B tool
# ---------------------------------------------------------------------------

def test_cpu_probe_counts_no_route():
    hand.reset_launch_counts()
    z = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 16, 40)).astype(np.float32))
    for mix in hand.ALU_PROBE_MIXES:
        hand.alu_probe(z, 2, mix, se=SE)
    assert hand.route_counts()["alu_probe"] == {"l2": 0, "cluster": 0}
    assert hand.alu_probe.launches == 0


def test_check_routes_wants_the_main_path_on_cluster():
    cs = _chip_smoke()
    cs.ROUTE_COUNTS["p"] = {"alu_probe": {"l2": 0, "cluster": 5}}
    cs.check_routes("p", "alu_probe", {"cluster": 5})
    cs.ROUTE_COUNTS["p"] = {"alu_probe": {"l2": 1, "cluster": 4}}
    with pytest.raises(cs.SmokeFailure, match="alu_probe"):
        cs.check_routes("p", "alu_probe", {"cluster": 5})


def test_probe_ab_variants_patch_one_line_each():
    """Every variant's edits find their text once in the tree and apply in
    turn; the designs the tree does not take (the shared-memory walk for
    every mix, float-then-round bfloat16) live only in those patches."""
    assert set(probe_ab.VARIANTS) == {
        "base", "max8", "t1024", "float", "l2", "walk"}
    for name, edits in probe_ab.VARIANTS.items():
        assert bool(edits) == (name != "base"), name
        patched = {}
        for file, old, new in edits:
            text = (build.CSRC / file).read_text()
            assert text.count(old) == 1, (name, old)
            patched.setdefault(file, text)
            assert patched[file].count(old) == 1, (name, old)
            patched[file] = patched[file].replace(old, new)
            assert old != new and (new not in text or new in old), name
    common = (build.CSRC / "stencil_common.cuh").read_text()
    assert "__floats2bfloat162_rn" not in common


@pytest.mark.parametrize("mangled, name", [
    ("_ZN5tpumt51_GLOBAL__N__9f1e2d3c_12_alu_probe_cu_7a1b2c3d20"
     "probe_cluster_kernelIfLi1EEEvPKT_PS2_xxi4CoeffiI", 
     "probe_cluster_kernel<float, 1>"),
    ("_ZN5tpumt51_GLOBAL__N__9f1e2d3c_12_alu_probe_cu_7a1b2c3d12"
     "probe_kernelI13__nv_bfloat16Li7EEEvPKT_PS3_S6_Pfxxxi4Coeffxx",
     "probe_kernel<bf16, 7>"),
])
def test_probe_instances_are_named(mangled, name, monkeypatch):
    assert probe_ab.kernel_name(mangled) == name
    log = (f"ptxas info    : Compiling entry function '{mangled}' for "
           f"'sm_90a'\nptxas info    : Used 92 registers\n"
           f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           f"loads\n")
    monkeypatch.setitem(build.BUILD_LOGS, "alu_probe", log)
    assert build.ptxas_summary("alu_probe", probe_ab.kernel_name) == {
        name: {"registers": 92, "stack": 0, "spill_stores": 0,
               "spill_loads": 0}}


# ---------------------------------------------------------------------------
# the plain version against the JAX package off the (8, 128) tiling
# ---------------------------------------------------------------------------

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def tolerance(mix, dtype, reps, want):
    """tests/test_torch_probe.py's tolerances."""
    dual = mix.startswith("dualdim")
    if dtype == "bfloat16":
        return 2 * reps * 2.0**-8 * float(np.abs(want).max()) if dual else 0
    return 1e-5 if dual else 2e-6


@pytest.mark.parametrize("dtype", list(JNP))
@pytest.mark.parametrize("shape", [(20, 36), (9, 24)])
@pytest.mark.parametrize("mix", hand.ALU_PROBE_MIXES)
def test_plain_probe_matches_pallas_off_the_tiling(mix, shape, dtype):
    a = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    z = jnp.asarray(a, JNP[dtype])
    want = np.asarray(PK.vpu_probe_pallas(z + 0, 3, mix, se=SE,
                                          interpret=True), np.float32)
    got = hand.alu_probe(array_from_jax(z), 3, mix, se=SE)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tolerance(mix, dtype, 3, want), err
    assert np.abs(want - np.asarray(z, np.float32)).max() > 1e-4
