"""End-to-end CLI lifecycle test: param file + IC file -> run -> output
files (the L9 driver parity check [G2: main.c/run.c])."""

import os
import subprocess
import sys

import numpy as np
import pytest

from gadget_leicester_tpu.io.snapshot import (Header, SnapshotData,
                                              read_snapshot, write_snapshot)
from gadget_leicester_tpu.models.ics import gassphere_ics


@pytest.fixture(scope="module")
def ic_file(tmp_path_factory):
    """A GADGET fmt-1 IC file for a small Evrard sphere."""
    d = tmp_path_factory.mktemp("ics")
    pos, vel, mass, ptype, u = gassphere_ics(mode="grid")
    keep = np.arange(0, len(pos), 6)
    n = len(keep)
    h = Header()
    h.npart = np.array([n, 0, 0, 0, 0, 0], np.uint32)
    h.npart_total = h.npart.copy()
    snap = SnapshotData(
        header=h,
        pos=pos[keep].astype(np.float32),
        vel=vel[keep].astype(np.float32),
        ids=np.arange(1, n + 1, dtype=np.uint32),
        mass=(mass[keep] * len(pos) / n).astype(np.float32),
        u=u[keep].astype(np.float32),
    )
    path = str(d / "evrard_ic.dat")
    write_snapshot(path, snap, fmt=1)
    return path


def _param(tmp_path, ic_file):
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    text = f"""
InitCondFile  {ic_file}
OutputDir     {out}
TimeBegin 0.0
TimeMax   0.2
ComovingIntegrationOn 0
PeriodicBoundariesOn 0
GravityConstantInternal 1.0
MaxSizeTimestep 0.02
TimeBetSnapshot 0.1
TimeOfFirstSnapshot 0.05
TimeBetStatistics 0.02
SofteningGas 0.05
DesNumNgb 40
MaxNumNgbDeviation 3
"""
    p = tmp_path / "run.param"
    p.write_text(text)
    return str(p), str(out)


def test_full_lifecycle(tmp_path, ic_file):
    from gadget_leicester_tpu.models.simulation import Simulation

    parampath, outdir = _param(tmp_path, ic_file)
    sim = Simulation.from_param_file(parampath)
    assert int(sim.state.p.alive.sum()) > 100
    sim.run(max_steps=200)
    assert sim.time >= 0.2

    # output files exist and have content [G2: open_outputfiles()]
    for f in ("energy.txt", "info.txt", "cpu.txt", "timings.txt"):
        path = os.path.join(outdir, f)
        assert os.path.exists(path), f
        assert os.path.getsize(path) > 0, f
    # energy.txt has the 28-column format
    line = open(os.path.join(outdir, "energy.txt")).readline().split()
    assert len(line) == 28
    # snapshots written and readable
    snaps = [f for f in os.listdir(outdir) if f.startswith("snapshot_")]
    assert len(snaps) >= 1
    back = read_snapshot(os.path.join(outdir, snaps[0]))
    assert back.header.npart[0] > 100
    assert back.rho is not None


def test_cli_subprocess(tmp_path, ic_file):
    parampath, outdir = _param(tmp_path, ic_file)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "gadget_leicester_tpu", parampath,
         "--max-steps", "3"],
        capture_output=True, text=True, timeout=1200,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "particles" in r.stdout
    assert "done:" in r.stdout
