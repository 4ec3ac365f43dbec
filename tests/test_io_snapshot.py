"""Snapshot format round-trip tests (SURVEY.md §7 hard part 5 —
bit-compatible I/O; golden-file structure checks for F77 record framing)."""

import struct

import numpy as np
import pytest

from gadget_leicester_tpu.io.snapshot import (Header, SnapshotData,
                                              read_snapshot, write_snapshot)


def _mk_snap(rng, ngas=10, nhalo=7):
    n = ngas + nhalo
    h = Header()
    h.npart = np.array([ngas, nhalo, 0, 0, 0, 0], np.uint32)
    h.npart_total = h.npart.copy()
    h.mass = np.array([0.0, 0.25, 0, 0, 0, 0])  # gas variable, halo from header
    h.time = 1.5
    h.box_size = 100.0
    snap = SnapshotData(
        header=h,
        pos=rng.uniform(0, 100, (n, 3)).astype(np.float32),
        vel=rng.normal(size=(n, 3)).astype(np.float32),
        ids=np.arange(1, n + 1, dtype=np.uint32),
        mass=np.concatenate([
            rng.uniform(0.1, 0.2, ngas), np.full(nhalo, 0.25)
        ]).astype(np.float32),
        u=rng.uniform(1, 2, ngas).astype(np.float32),
        rho=rng.uniform(0.5, 1.5, ngas).astype(np.float32),
        hsml=rng.uniform(0.1, 0.3, ngas).astype(np.float32),
    )
    return snap


@pytest.mark.parametrize("fmt", [1, 2])
def test_roundtrip(tmp_path, rng, fmt):
    snap = _mk_snap(rng)
    path = str(tmp_path / f"snap_fmt{fmt}")
    write_snapshot(path, snap, fmt=fmt)
    back = read_snapshot(path)
    np.testing.assert_array_equal(back.header.npart, snap.header.npart)
    assert back.header.time == snap.header.time
    assert back.header.box_size == snap.header.box_size
    np.testing.assert_array_equal(back.pos, snap.pos)
    np.testing.assert_array_equal(back.vel, snap.vel)
    np.testing.assert_array_equal(back.ids, snap.ids)
    np.testing.assert_allclose(back.mass, snap.mass)  # densified
    np.testing.assert_array_equal(back.u, snap.u)
    np.testing.assert_array_equal(back.rho, snap.rho)
    np.testing.assert_array_equal(back.hsml, snap.hsml)


def test_roundtrip_big_endian(tmp_path, rng):
    snap = _mk_snap(rng)
    path = str(tmp_path / "snap_be")
    write_snapshot(path, snap, fmt=1, endian=">")
    back = read_snapshot(path)  # endian auto-detected
    np.testing.assert_array_equal(back.pos, snap.pos)
    np.testing.assert_array_equal(back.ids, snap.ids)


def test_fmt1_exact_layout(tmp_path, rng):
    """Byte-level check of the F77 framing: marker / payload / marker,
    256-byte header, float32 pos block of 12N bytes [G2: io.c]."""
    snap = _mk_snap(rng, ngas=4, nhalo=0)
    path = str(tmp_path / "snap_layout")
    write_snapshot(path, snap, fmt=1)
    raw = open(path, "rb").read()
    (m0,) = struct.unpack("<i", raw[:4])
    assert m0 == 256
    (m1,) = struct.unpack("<i", raw[4 + 256:8 + 256])
    assert m1 == 256
    # next record: POS = 4 particles * 3 * 4 bytes = 48
    off = 8 + 256
    (m2,) = struct.unpack("<i", raw[off:off + 4])
    assert m2 == 48
    pos_back = np.frombuffer(raw[off + 4:off + 4 + 48], "<f4").reshape(4, 3)
    np.testing.assert_array_equal(pos_back, snap.pos)


def test_fmt2_labels(tmp_path, rng):
    snap = _mk_snap(rng, ngas=4, nhalo=2)
    path = str(tmp_path / "snap_fmt2")
    write_snapshot(path, snap, fmt=2)
    raw = open(path, "rb").read()
    # first record is the HEAD label: marker=8, "HEAD", size, marker=8
    (m0,) = struct.unpack("<i", raw[:4])
    assert m0 == 8
    assert raw[4:8] == b"HEAD"
    (blocksize,) = struct.unpack("<i", raw[8:12])
    assert blocksize == 256 + 8
    assert b"POS " in raw[:400]


def test_header_mass_table_roundtrip(tmp_path, rng):
    """All-fixed-mass snapshot must carry NO mass block."""
    snap = _mk_snap(rng, ngas=0, nhalo=5)
    snap.header.mass[:] = 0
    snap.header.mass[1] = 0.5
    snap.mass[:] = 0.5
    path = str(tmp_path / "snap_nomass")
    write_snapshot(path, snap, fmt=1)
    raw = open(path, "rb").read()
    n = 5
    expected = (8 + 256) + 2 * (8 + 12 * n) + (8 + 4 * n)  # head,pos,vel,id
    assert len(raw) == expected
    back = read_snapshot(path)
    np.testing.assert_allclose(back.mass, 0.5)


def test_pot_block_roundtrip(tmp_path, rng):
    """Optional POT block [G2: OUTPUTPOTENTIAL] round-trips, both formats."""
    snap = _mk_snap(rng)
    n = int(snap.header.npart.sum())
    snap.pot = rng.normal(size=n).astype(np.float32)
    for fmt in (1, 2):
        path = str(tmp_path / f"snap_pot{fmt}")
        write_snapshot(path, snap, fmt=fmt)
        back = read_snapshot(path)
        np.testing.assert_array_equal(back.pot, snap.pot)
        np.testing.assert_array_equal(back.hsml, snap.hsml)


def test_pot_block_collisionless(tmp_path, rng):
    snap = _mk_snap(rng, ngas=0, nhalo=9)
    snap.u = snap.rho = snap.hsml = None
    snap.pot = rng.normal(size=9).astype(np.float32)
    path = str(tmp_path / "snap_dm_pot")
    write_snapshot(path, snap, fmt=1)
    back = read_snapshot(path)
    np.testing.assert_array_equal(back.pot, snap.pot)


def test_fmt2_unknown_blocks_skipped(tmp_path, rng):
    """Extra fmt-2 blocks from other GADGET builds (ACCE/TSTP/DTEN) must be
    skipped, never misread into a known attribute [ADVICE r1]."""
    snap = _mk_snap(rng)
    path = str(tmp_path / "snap_fmt2")
    write_snapshot(path, snap, fmt=2)
    raw = open(path, "rb").read()

    def labeled_block(label, payload):
        lab = label.encode().ljust(4)[:4] + struct.pack("<i", len(payload) + 8)
        return (struct.pack("<i", 8) + lab + struct.pack("<i", 8)
                + struct.pack("<i", len(payload)) + payload
                + struct.pack("<i", len(payload)))

    # splice an all-particle ACCE block right after ID (before MASS/U)
    # and a gas-sized TSTP block at the end
    n = int(snap.header.npart.sum())
    acce = labeled_block("ACCE", b"\x7f" * (12 * n))
    # locate the insertion point: after the 3rd data block (POS,VEL,ID),
    # i.e. after 1 header + 3 data, each preceded by a label record
    off = 0
    for _ in range(4 * 2):  # 4 label records + 4 payload records
        (sz,) = struct.unpack("<i", raw[off:off + 4])
        off += 4 + sz + 4
    doctored = raw[:off] + acce + raw[off:] + labeled_block(
        "TSTP", b"\x01" * (4 * int(snap.header.npart[0])))
    p2 = str(tmp_path / "snap_fmt2_extra")
    open(p2, "wb").write(doctored)

    back = read_snapshot(p2)
    np.testing.assert_array_equal(back.u, snap.u)
    np.testing.assert_array_equal(back.rho, snap.rho)
    np.testing.assert_array_equal(back.hsml, snap.hsml)
    np.testing.assert_allclose(back.mass, snap.mass)


@pytest.mark.parametrize("op", ["read", "write"])
def test_hdf5_without_h5py_raises_clearly(tmp_path, rng, monkeypatch, op):
    """h5py is optional: without it, formats 1/2 still work and the HDF5
    reader/writer raise an error naming the missing package."""
    import sys
    monkeypatch.setitem(sys.modules, "h5py", None)   # import -> ImportError
    snap = _mk_snap(rng)
    path = str(tmp_path / "snap.hdf5")
    if op == "read":
        with open(path, "wb") as fh:                  # HDF5 signature only
            fh.write(b"\x89HDF\r\n\x1a\n" + bytes(64))
        with pytest.raises(RuntimeError, match="h5py"):
            read_snapshot(path)
    else:
        with pytest.raises(RuntimeError, match="h5py"):
            write_snapshot(path, snap, fmt=3)
    write_snapshot(str(tmp_path / "snap1"), snap, fmt=1)
    back = read_snapshot(str(tmp_path / "snap1"))
    np.testing.assert_array_equal(back.pos, snap.pos)
