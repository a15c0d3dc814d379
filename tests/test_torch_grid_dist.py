"""The port's 2-D process grids, DAXPY drivers and two-level mesh on gloo
worlds of 2 and 4 ranks (CPU), held against the JAX package.

One world per size is spawned for the file (``tests/torch_dist_workers.py``,
suite ``grid``): the world of 2 runs the 1×2 and 2×1 grids, the world of
4 the 2×2 grid. Every rank cuts its block out of the JAX drivers' global
layout (``convert.grid_block``), runs every case and saves its block; the
tests put the blocks back (``convert.grid_join``) and compare them with
the JAX function on ``make_mesh({"x": px, "y": py},
devices=jax.devices()[:w])``. The JAX drivers run at the same ``--mesh``
on w fake devices, in one subprocess per world (the test process has 8).

Pairs and tolerances, float64, the port on ``--device cpu`` (the
kernels' plain versions), those of the world-1 tests:

* ``heat_step2d_fn`` at k = 1, 2, 4, both tiers, against the XLA body:
  rtol/atol 1e-13 (``tests/test_torch_heat2d.py``: XLA contracts
  mul+add into FMAs, eager torch cannot); the hand tier also against the
  Pallas body (interpreted) at k = 2, the same tolerance;
* ``step2d_fn`` against the XLA tier: derivatives rtol/atol 1e-13, the
  residual (a sum over the grid in another order) rtol 1e-13; the hand
  tier against the Pallas tier (interpreted): derivatives atol 1e-5,
  residual 1e-3 relative (``tests/test_torch_grid.py``);
* the ``heat2d`` and ``stencil2d_grid`` drivers: the ``HEAT`` and
  ``GRID TEST`` lines' grid and sizes exactly, ``HEAT ERR rel`` within
  1e-13 (the fields' tolerance, relative) and the error norms within
  1e-13 of the largest derivative; every rank prints the same gate
  lines; a ``--mesh`` the world does not multiply to prints the JAX
  ``ERROR`` line and exits 2;
* ``mpi_daxpy``, ``mpi_daxpy_nvtx`` and the ``daxpy`` spec: the checksum
  and banner lines exactly (the JAX checksums are exact). One host of w
  ranks weak-scales as one JAX process over w devices: the port counts
  nodes by hosts, JAX by processes;
* the two-level mesh's sums (exact, small integers) against JAX's
  ``psum`` on a ``dcn × ici`` mesh of the same shape: the world's own
  layout (one host: 1 × 2) and each rank a host of its own (2 × 1, the
  layout of ``tests/test_multiproc.py``'s two-process test).
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
from jax import lax
from jax.sharding import PartitionSpec as P

import torch_dist_workers as W
from tpu_mpi_tests.comm import halo as JH
from tpu_mpi_tests.comm.mesh import make_mesh
from tpu_mpi_tests.compat import shard_map
from tpu_mpi_tests_torch.convert import grid_join

WORLDS = (2, 4)
GRID_CASES = [(w, px, py) for w in WORLDS for px, py in W.GRIDS[w]]
TOL = 1e-13
REPO = Path(__file__).resolve().parents[1]
HEAT_RE = r"HEAT mesh:(\d+)x(\d+) n:(\d+)x(\d+); steps=(\d+) "
HEAT_ERR_RE = r"HEAT ERR rel=([\d.e+-]+) \(gate ([\d.e+-]+)\)"
GRID_RE = (r"GRID TEST px:(\d) py:(\d); [\d.]+, err_dx=([\d.e+-]+), "
           r"err_dy=([\d.e+-]+)")

# the JAX drivers in a process of their own with w fake devices, at low
# priority on one thread, as the port's spawned ranks run: they share the
# host with the rest of the test run
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
JAX_KERNEL = {"hand": "pallas", "torch": "xla"}


def jax_runs(w):
    """The JAX drivers' runs of world ``w``: the port's, at the same
    ``--mesh``, with the kernel tier's JAX name."""
    runs = []
    for px, py in W.GRIDS[w]:
        for case, name, argv in W.GRID_DRIVER_RUNS:
            argv = [JAX_KERNEL.get(a, a) for a in argv]
            runs.append((f"driver_{case}_{W.grid_name(px, py)}",
                         f"tpu_mpi_tests.drivers.{name}",
                         ["--mesh", f"{px},{py}", "--dtype", "float64"]
                         + argv))
    runs.append(("bad_mesh_heat2d", "tpu_mpi_tests.drivers.heat2d",
                 ["--mesh", f"{w},{w}"]))
    runs.append(("bad_mesh_stencil2d_grid",
                 "tpu_mpi_tests.drivers.stencil2d_grid",
                 ["--mesh", f"{w},{w}"]))
    for case, name, argv in W.DAXPY_RUNS:
        runs.append((f"daxpy_{case}", f"tpu_mpi_tests.drivers.{name}",
                     W.daxpy_argv(argv, w)))
    return runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's output directories: ``(port, jax)``. The JAX
    subprocesses start once the port's worlds have ended, so that the
    file never runs more than four processes of its own at a time."""
    port = {w: W.spawn("grid", w, tmp_path_factory.mktemp(f"grid{w}"))
            for w in WORLDS}
    procs, jax_dirs = {}, {}
    for w in WORLDS:
        jax_dirs[w] = tmp_path_factory.mktemp(f"jax_drivers{w}")
        procs[w] = subprocess.Popen(
            [sys.executable, "-c", JAX_DRIVERS, str(w), str(jax_dirs[w]),
             json.dumps(jax_runs(w))], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for w, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, out
    return {w: (port[w], str(jax_dirs[w])) for w in WORLDS}


@functools.lru_cache(maxsize=None)
def grid_mesh(w, px, py):
    return make_mesh({"x": px, "y": py}, devices=jax.devices()[:w])


def joined(out_dir, case, px, py):
    return grid_join([W.load_rank(out_dir, case, r)
                      for r in range(px * py)], px, py)


def jax_text(runs, w, case):
    with open(Path(runs[w][1]) / f"{case}.txt") as f:
        return f.read()


@pytest.mark.parametrize("w,px,py", GRID_CASES)
def test_grid_is_row_major_with_global_members(runs, w, px, py):
    """Rank r sits at divmod(r, py), as JAX reshapes its devices; its
    column ring's members share its ry, its row ring's its rx."""
    for r in range(w):
        got = W.load_rank(runs[w][0], f"coords_{W.grid_name(px, py)}", r)
        rx, ry = divmod(r, py)
        want = ([rx, ry] + [x * py + ry for x in range(px)]
                + [rx * py + y for y in range(py)])
        assert got.tolist() == want
        assert np.asarray(grid_mesh(w, px, py).devices)[rx, ry] \
            == jax.devices()[r]


@pytest.mark.parametrize("w,px,py", GRID_CASES)
@pytest.mark.parametrize("k", W.HEAT_STEPS)
@pytest.mark.parametrize("kernel", ["torch", "hand"])
def test_heat_step2d_fn_matches_xla_body(runs, w, px, py, k, kernel):
    g = W.heat_global(px, py, k)
    run = JH.heat_step2d_fn(grid_mesh(w, px, py), "x", "y", k, W.HEAT_CX,
                            W.HEAT_CY, steps=k)
    want = np.asarray(run(jnp.asarray(g), W.HEAT_BODIES))
    got = joined(runs[w][0], f"heat_{W.grid_name(px, py)}_k{k}_{kernel}",
                 px, py)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("w,px,py", GRID_CASES)
def test_heat_step2d_fn_hand_matches_pallas(runs, w, px, py):
    k = 2
    g = W.heat_global(px, py, k)
    run = JH.heat_step2d_fn(grid_mesh(w, px, py), "x", "y", k, W.HEAT_CX,
                            W.HEAT_CY, steps=k, kernel="pallas",
                            interpret=True)
    want = np.asarray(run(jnp.asarray(g), W.HEAT_BODIES))
    got = joined(runs[w][0], f"heat_{W.grid_name(px, py)}_k{k}_hand", px,
                 py)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("w,px,py", GRID_CASES)
@pytest.mark.parametrize("kernel", ["torch", "hand"])
def test_step2d_fn_matches_jax(runs, w, px, py, kernel):
    g = W.step_global(px, py)
    jax_kernel = JAX_KERNEL[kernel]
    jx, jy, jr = JH.step2d_fn(grid_mesh(w, px, py), "x", "y", 2, W.GRID_SX,
                              W.GRID_SY, kernel=jax_kernel,
                              interpret=True)(jnp.asarray(g))
    case = f"step_{W.grid_name(px, py)}_{kernel}"
    tx = joined(runs[w][0], f"{case}_dx", px, py)
    ty = joined(runs[w][0], f"{case}_dy", px, py)
    res = [float(W.load_rank(runs[w][0], f"{case}_res", r)[0])
           for r in range(w)]
    assert len(set(res)) == 1  # one world sum, on every rank
    if kernel == "torch":
        np.testing.assert_allclose(tx, np.asarray(jx), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ty, np.asarray(jy), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(res[0], float(jr), rtol=TOL)
    else:
        np.testing.assert_allclose(tx, np.asarray(jx), atol=1e-5)
        np.testing.assert_allclose(ty, np.asarray(jy), atol=1e-5)
        assert abs(res[0] - float(jr)) <= 1e-3 * abs(float(jr))


def gate_lines(text):
    """The gate's lines, the seconds a rank timed left out."""
    return [re.sub(r"; [\d.]+, err", "; err", line)
            for line in text.splitlines()
            if line.startswith(("RC ", "HEAT ERR", "GRID TEST", "HEAT FAIL",
                                "ERR_NORM"))]


@pytest.mark.parametrize("w,px,py", GRID_CASES)
@pytest.mark.parametrize("case", [c for c, m, _ in W.GRID_DRIVER_RUNS
                                  if m == "heat2d"])
def test_heat2d_driver_lines_match_jax(runs, w, px, py, case):
    name = f"driver_{case}_{W.grid_name(px, py)}"
    ours = [W.read_text(runs[w][0], name, r) for r in range(w)]
    theirs = jax_text(runs, w, name)
    assert ours[0].startswith("RC 0") and theirs.startswith("RC 0"), \
        ours[0] + theirs
    assert re.search(HEAT_RE, ours[0]).groups() \
        == re.search(HEAT_RE, theirs).groups()
    assert re.search(HEAT_RE, ours[0]).groups()[:2] == (str(px), str(py))
    rel, gate = (float(v) for v in re.search(HEAT_ERR_RE, ours[0]).groups())
    jrel, jgate = (float(v) for v in re.search(HEAT_ERR_RE, theirs).groups())
    assert gate == jgate and rel <= gate and jrel <= jgate
    assert abs(rel - jrel) <= TOL
    # every rank prints the same gate line (rank 0's, broadcast)
    assert all(gate_lines(o) == gate_lines(ours[0]) for o in ours)


@pytest.mark.parametrize("w,px,py", GRID_CASES)
@pytest.mark.parametrize("case", [c for c, m, _ in W.GRID_DRIVER_RUNS
                                  if m == "stencil2d_grid"])
def test_stencil2d_grid_driver_lines_match_jax(runs, w, px, py, case):
    name = f"driver_{case}_{W.grid_name(px, py)}"
    ours = [W.read_text(runs[w][0], name, r) for r in range(w)]
    theirs = jax_text(runs, w, name)
    assert ours[0].startswith("RC 0") and theirs.startswith("RC 0"), \
        ours[0] + theirs
    got = re.search(GRID_RE, ours[0]).groups()
    want = re.search(GRID_RE, theirs).groups()
    assert got[:2] == want[:2] == (str(px), str(py))
    # the largest derivative on the grid: 3x² at the far edge
    scale = 3.0 * (8.0 * (1 - 1 / (px * 16))) ** 2
    for e, je in zip(got[2:], want[2:]):
        assert abs(float(e) - float(je)) <= TOL * scale
    assert all(gate_lines(o) == gate_lines(ours[0]) for o in ours)
    assert all("step mean=" in o for o in ours)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("driver", ["heat2d", "stencil2d_grid"])
def test_mesh_not_the_world_prints_jax_error(runs, w, driver):
    theirs = jax_text(runs, w, f"bad_mesh_{driver}")
    error = [line for line in theirs.splitlines() if line.startswith("ERROR")]
    assert theirs.startswith("RC 2") and error
    for r in range(w):
        ours = W.read_text(runs[w][0], f"bad_mesh_{driver}", r)
        assert ours.splitlines() == ["RC 2"] + error
    assert W.read_text(runs[w][0], "make_grid_bad", 0) == (
        f"MeshError: a {w}x{w} process grid needs {w * w} ranks, the world "
        f"has {w}")


def daxpy_lines(text):
    """The checksum and banner lines of a DAXPY run (no times)."""
    keep = ("SUM =", "ALLSUM =", "nodes,", "logical ranks", "RC ")
    return [line for line in text.splitlines()
            if any(k in line for k in keep)]


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("case", [c for c, _, _ in W.DAXPY_RUNS])
def test_daxpy_drivers_match_jax(runs, w, case):
    theirs = daxpy_lines(jax_text(runs, w, f"daxpy_{case}"))
    ours = [daxpy_lines(W.read_text(runs[w][0], f"daxpy_{case}", r))
            for r in range(w)]
    assert theirs[0] == "RC 0" and any("SUM =" in t for t in theirs)
    assert ours[0] == theirs
    for r in range(1, w):
        # the other ranks print the same sums, under their own rank where
        # a line carries the printing rank (the ALLSUM), and no banner
        want = [t.replace("0/", f"{r}/", 1) if "ALLSUM" in t else t
                for t in theirs if "nodes," not in t
                and "logical ranks" not in t]
        assert ours[r] == want


def jax_two_level(dcn, ici):
    """[both, dcn, ici, both + dcn] per rank of JAX's ``psum`` on a
    ``dcn × ici`` mesh, rank r holding r (host-major, as
    ``make_mesh_2level`` orders its devices)."""
    mesh = make_mesh({"dcn": dcn, "ici": ici},
                     devices=jax.devices()[:dcn * ici])
    spec = P(("dcn", "ici"))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=spec,
                       out_specs=P(("dcn", "ici"), None))
    def sums(x):
        both = lax.psum(x, ("dcn", "ici"))
        d = lax.psum(x, "dcn")
        i = lax.psum(x, "ici")
        return jnp.stack([both, d, i, both + d], axis=1)

    return np.asarray(sums(jnp.arange(dcn * ici, dtype=jnp.float32)))


@pytest.mark.parametrize("tag,dcn,ici", [("one_host", 1, 2),
                                         ("host_a_rank", 2, 1)])
def test_two_level_mesh_sums_match_jax(runs, tag, dcn, ici):
    want = jax_two_level(dcn, ici)
    for r in range(2):
        got = W.load_rank(runs[2][0], f"2level_{tag}", r)
        assert got[:4].tolist() == [dcn, ici, *divmod(r, ici)]
        np.testing.assert_array_equal(got[4:], want[r])
    if tag == "host_a_rank":  # tests/test_multiproc.py's check
        assert all(W.load_rank(runs[2][0], f"2level_{tag}", r)[7] == 2.0
                   for r in range(2))
