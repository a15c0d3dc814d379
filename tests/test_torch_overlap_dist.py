"""The port's overlap engine on gloo worlds of 2 and 4 ranks (CPU), held
against the JAX package.

One world per size is spawned for the file (``tests/torch_dist_workers.py``,
suite ``overlap``): the world of 2 runs the 1-D Jacobi pipeline on the
world ring and the heat and grid pipelines on the 1×2 and 2×1 grids, the
world of 4 on the ring of 4 and the 2×2 grid; every rank saves its block
and the tests put the blocks back together. The JAX functions run on the
first w of the test process's fake devices; the JAX drivers at the same
``--mesh`` in one subprocess per world with ``--fake-devices w``.

Pairs and tolerances, float64, the port on ``--device cpu``:

* each pipeline at depth 1 against depth 2, and against the port's serial
  body (``iterate_fused_fn``, the torch heat runner at k=1, the torch
  ``step2d_fn``): bit for bit (the residual too: the same sums, the same
  world reduction);
* ``iterate_overlap_fn`` against ``iterate_hand_fn``: bit for bit;
* against the JAX split functions under the JAX runner (and JAX's
  ``iterate_overlap_fn``, Pallas interpreted): rtol/atol 1e-13 (XLA's
  FMAs; JAX's strips in ``stencil1d_5``'s arithmetic), the residual rtol
  1e-13;
* the drivers' ``OVERLAP`` lines exactly (rates left out) and their gates
  within 1e-13 of the JAX drivers'; every rank prints the same gate.
"""

import functools
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_dist_workers as W
from tpu_mpi_tests.comm import halo as JH
from tpu_mpi_tests.comm.mesh import make_mesh
from tpu_mpi_tests.instrument.timers import block as jblock
from tpu_mpi_tests_torch.convert import grid_join

WORLDS = (2, 4)
GRID_CASES = [(w, px, py) for w in WORLDS for px, py in W.GRIDS[w]]
TOL = 1e-13
REPO = Path(__file__).resolve().parents[1]

# the JAX drivers in a process of their own with w fake devices, at low
# priority on one thread, as the port's spawned ranks run
JAX_DRIVERS = r"""
import contextlib, importlib, io, json, os, sys
os.nice(10)
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_multi_thread_eigen=false")
w, out, runs = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
from tpu_mpi_tests.drivers._common import force_cpu_devices
force_cpu_devices(w)
import jax
jax.config.update("jax_enable_x64", True)
for case, module, argv in runs:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = importlib.import_module(module).main(
            ["--fake-devices", str(w)] + argv)
    with open(os.path.join(out, case + ".txt"), "w") as f:
        f.write(f"RC {rc}\n" + buf.getvalue())
"""
JAX_MODULES = {"heat2d": "tpu_mpi_tests.drivers.heat2d",
               "stencil2d_grid": "tpu_mpi_tests.drivers.stencil2d_grid"}


def jax_runs(w):
    runs = []
    for px, py in W.GRIDS[w]:
        for case, name, argv in W.OV_DRIVER_RUNS:
            argv = ["xla" if a == "torch" else a for a in argv]
            runs.append((f"ov_driver_{case}_{W.grid_name(px, py)}",
                         JAX_MODULES[name], ["--mesh", f"{px},{py}"] + argv))
    runs.append(("ov_driver_stencil1d", "tpu_mpi_tests.workloads.stencil1d",
                 W.OV_STENCIL1D_ARGV))
    return runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's output directories: ``(port, jax)``; the JAX
    subprocesses start once the port's worlds have ended."""
    port = {w: W.spawn("overlap", w, tmp_path_factory.mktemp(f"ov{w}"))
            for w in WORLDS}
    procs, jax_dirs = {}, {}
    for w in WORLDS:
        jax_dirs[w] = tmp_path_factory.mktemp(f"ov_jax{w}")
        procs[w] = subprocess.Popen(
            [sys.executable, "-c", JAX_DRIVERS, str(w), str(jax_dirs[w]),
             json.dumps(jax_runs(w))], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for w, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, out
    return {w: (port[w], str(jax_dirs[w])) for w in WORLDS}


@functools.lru_cache(maxsize=None)
def ring_mesh(w):
    return Mesh(np.array(jax.devices()[:w]), ("shard",))


@functools.lru_cache(maxsize=None)
def grid_mesh(w, px, py):
    return make_mesh({"x": px, "y": py}, devices=jax.devices()[:w])


def joined(out_dir, case, px, py):
    return grid_join([W.load_rank(out_dir, case, r)
                      for r in range(px * py)], px, py)


def jax_steps(fns, z, rounds):
    ex_fn, core_fn, seam_fn = fns
    runner = JH.OverlapRunner("halo_exchange", depth=2)
    for _ in range(rounds):
        ex, zc = runner.step(ex_fn, core_fn, z)
        z = jblock(seam_fn(ex, zc))
    return np.asarray(z)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("periodic", [False, True])
def test_jacobi_pipeline_over_the_ring(runs, w, periodic):
    out = runs[w][0]
    case = f"ov_jacobi_p{int(periodic)}"
    d1, d2, serial = (W.join(out, f"{case}_{t}", w)
                      for t in ("d1", "d2", "serial"))
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(d1, serial)
    fns = JH.overlap_jacobi_fns(ring_mesh(w), "shard", 0, 1, 2, W.OV_SCALE,
                                W.OV_EPS, periodic=periodic)
    want = jax_steps(fns, jnp.asarray(W.ov_jacobi_global(w, periodic)),
                     W.OV_ROUNDS)
    np.testing.assert_allclose(d1, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("periodic", [False, True])
def test_iterate_overlap_over_the_ring(runs, w, axis, periodic):
    out = runs[w][0]
    case = f"ov_iterate_ax{axis}_p{int(periodic)}"
    got = W.join(out, f"{case}_overlap", w, axis)
    np.testing.assert_array_equal(got, W.join(out, f"{case}_hand", w, axis))
    ovl = JH.iterate_overlap_fn(ring_mesh(w), "shard", 2, W.OV_EPS,
                                axis=axis, interpret=True, periodic=periodic)
    want = np.asarray(ovl(jnp.asarray(W.ov_iterate_global(w, axis,
                                                          periodic)), 5))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("w,px,py", GRID_CASES)
def test_heat_pipeline_over_the_grid(runs, w, px, py):
    out = runs[w][0]
    case = f"ov_heat_{W.grid_name(px, py)}"
    d1, d2, serial = (joined(out, f"{case}_{t}", px, py)
                      for t in ("d1", "d2", "serial"))
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(d1, serial)
    fns = JH.heat_overlap_fns(grid_mesh(w, px, py), "x", "y", W.HEAT_CX,
                              W.HEAT_CY)
    want = jax_steps(fns, jnp.asarray(W.heat_global(px, py, 1)),
                     W.OV_ROUNDS)
    np.testing.assert_allclose(d1, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("w,px,py", GRID_CASES)
def test_grid_pipeline_over_the_grid(runs, w, px, py):
    out = runs[w][0]
    case = f"ov_grid_{W.grid_name(px, py)}"
    got = {t: [joined(out, f"{case}_{t}_{f}", px, py) for f in ("dx", "dy")]
           for t in ("d1", "d2", "serial")}
    res = {t: [float(W.load_rank(out, f"{case}_{t}_res", r)[0])
               for r in range(w)] for t in got}
    for t in ("d2", "serial"):
        for a, b in zip(got["d1"], got[t]):
            np.testing.assert_array_equal(a, b)
        assert res[t] == res["d1"]
    assert len(set(res["d1"])) == 1  # one world sum, on every rank
    ex_fn, core_fn, seam_fn = JH.grid_overlap_fns(
        grid_mesh(w, px, py), "x", "y", 2, W.GRID_SX, W.GRID_SY)
    ex, cores = JH.OverlapRunner("halo_exchange2d", depth=2).step(
        ex_fn, core_fn, jnp.asarray(W.step_global(px, py)))
    jx, jy, jr = jblock(seam_fn(ex, *cores))
    for a, b in zip(got["d1"], (jx, jy)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(res["d1"][0], float(jr), rtol=TOL)


@pytest.mark.parametrize("w", WORLDS)
def test_accounting_and_dispatch_window_over_the_ring(runs, w):
    for r in range(w):
        acc = W.load_rank(runs[w][0], "ov_accounting", r)
        for frac, comm, steps in acc[0::2]:  # depth 1
            assert (frac, comm, steps) == (0.0, 0.0, W.OV_ROUNDS)
        for frac, comm, steps in acc[1::2]:  # depth 2
            assert frac > 0.0 and comm > 0.0 and steps == W.OV_ROUNDS
        assert W.load_rank(runs[w][0], "ov_window", r).tolist() == [1.0, 0.0]


def overlap_lines(text):
    return [re.sub(r" [\d.]+ it/s", "", line) for line in text.splitlines()
            if line.startswith(("OVERLAP", "NOTE", "RC "))]


def gate_values(text):
    return [float(v) for v in re.findall(
        r"(?:rel|err_dx|err_dy|err_norm) ?= ?([\d.e+-]+)", text)]


def jax_text(runs, w, case):
    with open(Path(runs[w][1]) / f"{case}.txt") as f:
        return f.read()


@pytest.mark.parametrize("w,px,py", GRID_CASES)
@pytest.mark.parametrize("case", [c for c, _, _ in W.OV_DRIVER_RUNS])
def test_grid_drivers_overlap_lines_match_jax(runs, w, px, py, case):
    name = f"ov_driver_{case}_{W.grid_name(px, py)}"
    ours = [W.read_text(runs[w][0], name, r) for r in range(w)]
    theirs = jax_text(runs, w, name)
    assert ours[0].startswith("RC 0") and theirs.startswith("RC 0"), \
        ours[0] + theirs
    assert overlap_lines(ours[0]) == overlap_lines(theirs)
    assert "depth=2" in ours[0] and "overlap_frac=1.000" in ours[0]
    got, want = gate_values(ours[0]), gate_values(theirs)
    assert len(got) == len(want) > 0
    # the grid's errors scale with the largest derivative (3x² at x = 8)
    assert all(abs(a - b) <= TOL * 200 for a, b in zip(got, want))
    assert all(gate_values(o) == got for o in ours)


@pytest.mark.parametrize("w", WORLDS)
def test_stencil1d_overlap_matches_jax(runs, w):
    ours = [W.read_text(runs[w][0], "ov_driver_stencil1d", r)
            for r in range(w)]
    theirs = jax_text(runs, w, "ov_driver_stencil1d")
    assert theirs.startswith("RC 0")
    for r, o in enumerate(ours):
        assert o.startswith("RC 0"), o
        want = [line for line in overlap_lines(theirs)
                if r == 0 or not line.startswith("OVERLAP halo depth res")]
        assert overlap_lines(o) == want
        assert re.search(r"^TIME overlap_interior : [\d.]+ count=5 ", o,
                         re.M)
