"""The port's microbench groups (``daxpy``, ``ceiling``, ``streams``) on
the CPU at small sizes.

On the CPU the hand tier is the kernels' plain versions, so the rates
are CPU rates and prove nothing about the card; what is checked is the
control flow: every metric name of the JAX groups (``xla``/``pallas``
tiers renamed ``torch``/``hand``; the TPU-only ``daxpy_block*`` sweep
left out) is printed once as a ``{"metric", "value", "unit"}`` JSON line
with a finite value, an unported group raises, and the entry point asked
for the card raises where there is none.
"""

import json
import math

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
    with pytest.raises(TpuMtError, match="ROADMAP queue 1 item 21"):
        microbench.run_groups(["daxpy", "vpu"], CPU)


def test_main_asked_for_cuda_raises_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TpuMtError, match="cuda"):
        microbench.main(["ceiling"])
    assert capsys.readouterr().out == ""
