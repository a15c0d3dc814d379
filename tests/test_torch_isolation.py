"""The port stands alone and never falls back.

* No module of ``tpu_mpi_tests_torch`` and no line of ``chip_smoke.py``
  imports ``jax`` (or ``jaxlib``) or the JAX package ``tpu_mpi_tests`` —
  matched on the exact top-level name, since ``tpu_mpi_tests_torch``
  shares the JAX package's prefix.
* Asking for the card where there is none raises; entry points asked for
  ``cuda`` raise instead of printing a CPU result, and a kernel wrapper
  given a tensor that is neither on the CPU nor on the card raises
  instead of computing its plain version.
"""

import ast
from pathlib import Path

import pytest
import torch

from tpu_mpi_tests_torch import bench, microbench
from tpu_mpi_tests_torch.comm import alltoall, ring
from tpu_mpi_tests_torch.comm.mesh import MeshError, bootstrap, topology
from tpu_mpi_tests_torch.device import resolve_device
from tpu_mpi_tests_torch.drivers import (
    attnbench,
    heat2d,
    stencil2d,
    stencil2d_grid,
)
from tpu_mpi_tests_torch.kernels import hand
from tpu_mpi_tests_torch.utils import TpuMtError

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "tpu_mpi_tests"}
PORT_FILES = sorted((REPO / "tpu_mpi_tests_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def imported_roots(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports: ``import`` and
    ``from`` statements at any depth, and ``importlib.import_module`` /
    ``__import__`` calls with a literal name."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if name in ("import_module", "__import__"):
                roots.add(node.args[0].value.split(".")[0])
    return roots


def test_scanner_matches_exact_top_level_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import tpu_mpi_tests_torch.kernels\n"
                   "from tpu_mpi_tests.comm import halo\n"
                   "def f():\n    import jax.numpy as jnp\n"
                   "importlib.import_module('jaxlib.xla')\n")
    assert imported_roots(src) == {"tpu_mpi_tests_torch", "tpu_mpi_tests",
                                   "jax", "jaxlib"}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    bad = imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_port_has_its_kernel_sources():
    csrc = REPO / "tpu_mpi_tests_torch" / "kernels" / "csrc"
    for name in ("stencil_iterate.cu", "stencil_deriv.cu", "heat2d.cu",
                 "dual_dim_step.cu", "streams.cu", "flash_attention.cu"):
        assert (csrc / name).is_file()


def test_resolve_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TpuMtError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(TpuMtError):
        resolve_device()  # the default is the card
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(TpuMtError):
        resolve_device("mps")


def test_entry_points_asked_for_cuda_never_print_a_cpu_result(
        monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TPU_MPI_BENCH_N", "32")
    with pytest.raises(TpuMtError):
        bench.main([])
    with pytest.raises(TpuMtError):
        stencil2d.main(["--n-local", "8", "--n-other", "8"])
    with pytest.raises(TpuMtError):
        heat2d.main(["--nx-local", "8", "--ny-local", "8"])
    with pytest.raises(TpuMtError):
        stencil2d_grid.main(["--nx-local", "8", "--ny-local", "8"])
    with pytest.raises(TpuMtError):
        attnbench.main(["--seq-len", "64", "--head-dim", "8", "--tiers",
                        "xla,flash,ring,ulysses", "--n-iter", "10"])
    with pytest.raises(TpuMtError):
        microbench.main(["attention", "causal"])
    assert capsys.readouterr().out == ""


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    z = torch.empty(24, 16, device="meta")
    before = hand.launch_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        hand.stencil2d_iterate(z, 0.1, dim=0, steps=2, phys_static=(1, 1))
    with pytest.raises(ValueError, match="unsupported device"):
        hand.stencil2d_deriv(z, 1.0, dim=1)
    with pytest.raises(ValueError, match="unsupported device"):
        hand.heat2d(z, 0.1, 0.1, steps=2)
    with pytest.raises(ValueError, match="unsupported device"):
        hand.dual_dim_step(z, 2, 1.0, 1.0)
    m, l, acc = (torch.zeros(shape, device="meta")
                 for shape in ((24, 1), (24, 1), (24, 16)))
    with pytest.raises(ValueError, match="unsupported device"):
        hand.flash_attention_block(z, z, z, m, l, acc, 0, 0, scale=1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        hand.flash_attention(z, z, z, causal=True)
    # the attention modules reach the kernel wrapper, never its plain
    # version, for a tensor off the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        ring.ring_attention(z, z, z, flash=True)
    with pytest.raises(ValueError, match="unsupported device"):
        alltoall.ulysses_attention(z[:, None], z[:, None], z[:, None],
                                   flash=True)
    assert hand.launch_counts() == before


def test_world1_topology_and_multi_rank_refusal(monkeypatch):
    topo = topology(bootstrap("cpu"))
    assert (topo.platform, topo.device_kinds, topo.global_device_count) \
        == ("cpu", ("cpu",), 1)
    for var in ("WORLD_SIZE", "JAX_NUM_PROCESSES"):
        monkeypatch.setenv(var, "2")
        with pytest.raises(MeshError, match="ROADMAP queue 1 item 2"):
            bootstrap("cpu")
        monkeypatch.delenv(var)
