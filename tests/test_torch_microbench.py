"""The port's microbench groups on the CPU at small sizes: ``daxpy``,
``ceiling``, ``streams``, and the one-card groups ``stencil``,
``iterate``, ``splitfused``, ``blocks`` (its world-of-one row included),
``heat``, ``vpu``, ``roofline2`` and ``stripebalance``.

On the CPU the hand tier is the kernels' plain versions, so the rates
are CPU rates and prove nothing about the card; what is checked is the
control flow: every metric name of the JAX groups (``xla``/``pallas``
tiers renamed ``torch``/``hand``; the TPU-only ``daxpy_block*`` sweep
left out) is printed once as a ``{"metric", "value", "unit"}`` JSON line
with a finite value, an unported group raises, and the entry point asked
for the card raises where there is none. For the one-card groups the
wanted names are read out of the JAX group's source text
(``tpu/microbench.py``, which is never imported), the tier names
translated; rows gated by their own fit checks may be NaN.
"""

import json
import math
import os
import re

import pytest
import torch

from tpu_mpi_tests_torch import microbench
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.utils import TpuMtError

CPU = torch.device("cpu")
SMALL = {
    "daxpy": {"sizes": (1 << 8, 1 << 10), "chain_n": 1 << 9},
    "ceiling": {"n": 1 << 10},
    "streams": {"n": 1 << 9, "n_big": 1 << 11},
}
WANT = {
    "daxpy": ["daxpy_torch_2^8_gbps", "daxpy_hand_2^8_gbps",
              "daxpy_torch_2^10_gbps", "daxpy_hand_2^10_gbps",
              "daxpy_chained_outofplace_gbps", "daxpy_chained_aliased_gbps"],
    "ceiling": ["stream_daxpy_3pass_gbps", "stream_scale_2pass_gbps",
                "hbm_ceiling_fit_gbps"],
    "streams": ["stream2_scale_gbps", "stream3_daxpy_gbps",
                "stream4_sum3_gbps", "stream_fit_per_stream_gbps",
                "stream3_daxpy_2^11_gbps"],
}


@pytest.mark.parametrize("group", list(WANT))
def test_group_prints_its_metrics(capsys, group):
    before = hand.launch_counts()
    recs = microbench.run_groups([group], CPU, **{group: SMALL[group]})
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == recs
    assert [r["metric"] for r in recs] == WANT[group]
    for r in recs:
        assert r["unit"] == "GB/s" and math.isfinite(r["value"])
        assert set(r) <= {"metric", "value", "unit", "detail"}
    # the plain versions ran: no kernel launch is counted on the CPU
    assert hand.launch_counts() == before


def test_default_sizes_are_the_jax_groups():
    import inspect

    def defaults(fn):
        return {k: p.default for k, p in
                inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty}

    assert defaults(microbench.bench_daxpy) == {
        "sizes": (1 << 24, 1 << 26, 1 << 28), "chain_n": 1 << 26}
    assert defaults(microbench.bench_ceiling) == {"n": 1 << 26}
    assert defaults(microbench.bench_streams) == {"n": 1 << 26,
                                                  "n_big": 1 << 28}


def test_unported_group_raises():
    with pytest.raises(TpuMtError, match="stripeskip sweeps the TPU"):
        microbench.run_groups(["daxpy", "stripeskip"], CPU)


def test_main_asked_for_cuda_raises_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TpuMtError, match="cuda"):
        microbench.main(["ceiling"])
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# the one-card groups: stencil, iterate, splitfused, blocks, heat, vpu,
# roofline2
# ---------------------------------------------------------------------------

JAX_SOURCE = open(os.path.join(os.path.dirname(__file__), "..", "tpu",
                               "microbench.py")).read()
ONE_CARD = {
    "stencil": {"shape": (36, 64), "n_iter": 20},
    "iterate": {"n": 64, "n_local0": 32, "chain": (2, 6), "chain_k": (2, 6)},
    "splitfused": {"n": 64, "chain": (2, 6)},
    "blocks": {"n": 64, "chain": (2, 6)},
    "heat": {"n": 32, "long_steps": 40},
    "vpu": {"H_": 16, "W": 128, "iters": 4, "n": 64, "long_steps": 100,
            "reps_div": 64},
    "roofline2": {"H_": 16, "W": 128, "iters": 4, "n": 32, "long_steps": 100,
                  "sizes": (24, 34, 48), "dual_iters": 20, "hbm_gbps": 100.0,
                  "reps_div": 32},
    "stripebalance": {"w": 4, "lq": 64, "d": 16, "chain": (2, 6)},
}


def jax_group_source(group: str) -> str:
    """The text of ``def bench_<group>`` in the JAX microbench."""
    m = re.search(rf"^def bench_{group}\(results\):\n(.*?)(?=^def )",
                  JAX_SOURCE, re.S | re.M)
    assert m, group
    return m.group(1)


def jax_metric_templates(group: str) -> list[str]:
    """Every metric name (an f-string template or a literal) the JAX
    group emits, tiers translated to the port's."""
    names = re.findall(r'_emit\(\s*results,\s*f?"([^"]+)"',
                       jax_group_source(group))
    # the heat rows spell their size (2048) out; the port prints its n
    return [n.replace("pallas", "hand").replace("xla", "torch")
            .replace("_2048_", "_{n}_") for n in names]


def matches(template: str, metric: str) -> bool:
    """``metric`` is an instance of the f-string ``template``."""
    pattern = re.sub(r"\\\{[^}]*\\\}", "[A-Za-z0-9_]+", re.escape(template))
    return re.fullmatch(pattern, metric) is not None


#: JAX rows the port leaves out on purpose (``microbench.py``'s
#: docstrings): the VMEM ``tile_rows=`` A/Bs and the flash skip tile's
#: decoupling gain
LEFT_OUT = ("stripe_skip_decouple_gain_kt{kt}{dtag}",
            "heat_bf16_tall_B{B}_steps_per_s",
            "heat_bf16_tall_B128_over_B256",
            "dualdim_bf16_tall_B{B}_ms_per_call",
            "dualdim_bf16_tall_B128_over_B256")


@pytest.mark.parametrize("group", list(ONE_CARD))
def test_one_card_group_emits_the_jax_metrics(capsys, group):
    before = hand.launch_counts()
    recs = microbench.run_groups([group], CPU, **{group: ONE_CARD[group]})
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["metric"] for r in lines] == [r["metric"] for r in recs]
    got = [r["metric"] for r in recs]
    assert len(set(got)) == len(got)
    templates = jax_metric_templates(group)
    for metric in got:  # nothing the JAX group does not have
        assert any(matches(t, metric) for t in templates), metric
    for t in templates:  # everything it has, bar the stated omissions
        assert (t in LEFT_OUT) != any(matches(t, m) for m in got), t
    for r in recs:
        assert isinstance(r["value"], float) and set(r) <= {
            "metric", "value", "unit", "detail"}
    assert hand.launch_counts() == before  # the plain versions ran


def test_one_card_defaults_are_the_jax_sizes():
    import inspect

    def defaults(fn):
        return {k: p.default for k, p in
                inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty}

    assert defaults(microbench.bench_stencil) == {"shape": (1028, 8192),
                                                  "n_iter": 500}
    it = defaults(microbench.bench_iterate)
    assert (it["n"], it["n_local0"], it["steps"]) == (8192, 1024, 4)
    assert it["chain"] == (100, 2100) and it["chain_k"] == (25, 525)
    assert defaults(microbench.bench_heat) == {"n": 2048, "ks": (1, 4, 8),
                                               "long_steps": 2000}
    bl = defaults(microbench.bench_blocks)
    assert (bl["n"], bl["steps"], bl["n_blocks"]) == (8192, 4, 2)
    vp = defaults(microbench.bench_vpu)
    assert (vp["H_"], vp["W"], vp["iters"], vp["n"], vp["ks"]) == (
        512, 512, 400, 8192, (2, 4, 6, 8))
    rf = defaults(microbench.bench_roofline2)
    assert rf["sizes"] == (2056, 2904, 4104) and rf["n"] == 2048
    assert rf["hbm_gbps"] is None and vp["reps_div"] == rf["reps_div"] == 1
    # the reps triples and nominal op counts, as the JAX tables have them
    for mix, (ops, reps3) in {**microbench._VPU_PROBES,
                              **microbench._ROOFLINE_PROBES}.items():
        assert re.search(rf'\("{mix}", (dname|"float32")\)\]? ?[=:] '
                         rf'\({ops}, \({reps3[0]}, {reps3[1]}, {reps3[2]}\)\)',
                         JAX_SOURCE), mix
    assert "744" not in open(microbench.__file__).read()


def test_vpu_step5fma_env_adds_the_ab_probes(capsys, monkeypatch):
    monkeypatch.setenv("TPU_MPI_VPU_STEP5FMA", "1")
    small = dict(ONE_CARD["vpu"], ks=(2, 4), long_steps=50)
    recs = microbench.run_groups(["vpu"], CPU, vpu=small)
    capsys.readouterr()
    got = [r["metric"] for r in recs if r["metric"].endswith("_gops")]
    assert got[:5] == ["vpu_fma_float32_gops", "vpu_step5_d0_float32_gops",
                       "vpu_step5fma_d0_float32_gops",
                       "vpu_step5_d1_float32_gops",
                       "vpu_step5fma_d1_float32_gops"]
    assert len(got) == 10
    for r in recs:
        if r["metric"].endswith("_gops"):
            assert "no device rate" in r["detail"]  # the CPU says so


def test_roofline2_runs_the_ceiling_fit_when_no_rate_is_given(capsys):
    small = dict(ONE_CARD["roofline2"], hbm_gbps=None, ceiling_n=1 << 10,
                 ks=(2, 4), sizes=(24, 30, 36))
    recs = microbench.run_groups(["roofline2"], CPU, roofline2=small)
    capsys.readouterr()
    names = [r["metric"] for r in recs]
    assert names[:3] == ["stream_daxpy_3pass_gbps", "stream_scale_2pass_gbps",
                         "hbm_ceiling_fit_gbps"]
    detail = next(r["detail"] for r in recs
                  if r["metric"] == "roofline_heat_float32_marginal_us")
    assert "this run's hbm_ceiling_fit_gbps" in detail


def test_no_argument_runs_every_ported_group_and_tile_sweeps_raise():
    assert list(microbench.GROUPS) == [
        "daxpy", "stencil", "iterate", "splitfused", "ceiling", "attention",
        "heat", "blocks", "causal", "streams", "vpu", "roofline2",
        "stripebalance"]
    with pytest.raises(TpuMtError, match="stripeskip sweeps the TPU"):
        microbench.run_groups(["stripeskip"], CPU)


def test_stripebalance_rows_and_the_bf16_tag(capsys, monkeypatch):
    """f32 folds at HIGHEST on the fma route's key tile; bf16 at DEFAULT
    on wgmma's, every row tagged; the paced proxy is Σ_s max_r and the
    contig grid's dead cells are counted in its detail."""
    small = ONE_CARD["stripebalance"]
    recs = microbench.run_groups(["stripebalance"], CPU,
                                 stripebalance=small)
    kt = hand.FLASH_K_TILES["fma"]
    assert [r["metric"] for r in recs] == [
        f"stripe_contig_kt{kt}_paced_ms", f"stripe_striped_kt{kt}_paced_ms",
        f"stripe_paced_speedup_kt{kt}", "stripe_to_striped_ms",
        "stripe_from_striped_ms"]
    assert "6 geometrically-dead cells" in recs[0]["detail"]
    monkeypatch.setenv("TPU_MPI_STRIPE_DTYPE", "bfloat16")
    recs = microbench.run_groups(["stripebalance"], CPU,
                                 stripebalance=small)
    capsys.readouterr()
    kt = hand.FLASH_K_TILES["wgmma"]
    assert [r["metric"] for r in recs][:3] == [
        f"stripe_contig_kt{kt}_bfloat16_paced_ms",
        f"stripe_striped_kt{kt}_bfloat16_paced_ms",
        f"stripe_paced_speedup_kt{kt}_bfloat16"]
    assert all(math.isfinite(r["value"]) and r["value"] > 0
               for r in recs if r["unit"] == "ms")


def test_paced_proxy_and_the_suspect_rule():
    import numpy as np

    t = np.array([[1.0, 0.0], [2.0, 3.0]])
    assert microbench._paced_with_suspect(t) == (5.0, "", False)
    spike = np.full((4, 4), 1.0)
    spike[2, 1] = 9.0
    paced, note, suspect = microbench._paced_with_suspect(spike)
    assert suspect and "OUTLIER-SUSPECT" in note and paced == 12.0
    t[0, 1] = float("nan")
    assert microbench._paced_with_suspect(t)[2]


def test_world_of_one_joins_and_leaves_a_group():
    from tpu_mpi_tests_torch.comm import dist

    assert not torch.distributed.is_initialized()
    with dist.world_of_one("cpu") as w:
        assert (w.rank, w.size, w.backend) == (0, 1, "gloo")
        assert torch.distributed.get_world_size() == 1
        assert dist.world() is w
    assert not torch.distributed.is_initialized()
    assert dist.world().backend is None
