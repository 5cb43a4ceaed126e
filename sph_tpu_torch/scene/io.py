"""Scene file I/O in the reference's text formats (counterpart of
``sph_tpu/scene/io.py``; NumPy only).

Readers/writers for the reference's on-disk formats
(the reference's `src/owHelper.cpp:1431-1805`):

* ``position.txt`` / ``velocity.txt``: 4-col TSV (x, y, z, type-code)
* ``elasticconnections.txt`` / ``connection_buffer.txt``: rows of
  (jd, rest_scaled, spring_type, unused), MAX_NEIGHBORS rows per elastic
  particle, jd = -1 padding
* sectioned ``configuration.txt``: ``Position`` / ``Velocity`` /
  ``ElasticConnection`` headers
* dump/replay: ``position_buffer.txt`` (header = n_elastic, n_liquid; then
  non-boundary positions appended per frame), one-shot
  ``connection_buffer.txt`` + ``membranes_buffer.txt``

In loaded scenes the memory order is boundary/elastic/liquid or any
contiguous arrangement; springs are re-indexed into absolute particle ids.

The writers produce the same bytes as sph_tpu's for the same arrays: each
value is formatted as there (``%.9g`` of a position, ``%.6g`` of a type
code, ...), but a whole table goes through one ``%`` format of its rows
instead of a Python loop over them.
"""
from __future__ import annotations

import os

import numpy as np

from ..constants import (
    BOUNDARY_PARTICLE,
    ELASTIC_PARTICLE,
    MAX_NEIGHBORS,
)
from .scene import Scene


def _read_rows(path: str, ncols: int) -> np.ndarray:
    rows = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < ncols:
                continue
            rows.append([float(p) for p in parts[:ncols]])
    return np.asarray(rows, np.float32).reshape(-1, ncols)


def _format_rows(row_fmt: str, *cols) -> str:
    """The rows of the equal-length columns ``cols``, each formatted by
    ``row_fmt`` (one ``%`` conversion a column); every value is converted
    to a Python number first, as an f-string of a NumPy scalar does."""
    n = len(cols[0])
    if n == 0:
        return ""
    flat = np.column_stack([np.asarray(c, np.float64) for c in cols])
    return (row_fmt * n) % tuple(flat.ravel().tolist())


def _positions_text(pos: np.ndarray, color: np.ndarray) -> str:
    return _format_rows("%.9g\t%.9g\t%.9g\t%.6g\n", pos[:, 0], pos[:, 1],
                        pos[:, 2], color)


def _springs_text(scene: Scene) -> str:
    jd = np.asarray(scene.spring_idx).ravel()
    # jd + 0.1 marks a particle id (owHelper.cpp:998), -1.0 an empty slot
    jd_f = np.where(jd >= 0, jd.astype(np.float64) + 0.1, -1.0)
    return _format_rows("%.6g\t%.8g\t%.6g\t0\n", jd_f,
                        np.asarray(scene.spring_rest).ravel(),
                        np.asarray(scene.spring_type).ravel())


def _springs_from_table(
    table: np.ndarray, ptype: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Reshape a flat (jd, rest, type, unused) table into per-row arrays.

    Row r of the table block belongs to the r-th *elastic* particle in memory
    order; jd values are absolute particle indices already
    (`owHelper.cpp:998` writes j + 0.1).
    """
    elastic_ids = np.nonzero(ptype == ELASTIC_PARTICLE)[0].astype(np.int32)
    n_e = len(elastic_ids)
    table = table[: n_e * MAX_NEIGHBORS]
    if len(table) < n_e * MAX_NEIGHBORS:
        pad = np.zeros((n_e * MAX_NEIGHBORS - len(table), 4), np.float32)
        pad[:, 0] = -1
        table = np.concatenate([table, pad])
    jd = table[:, 0].reshape(n_e, MAX_NEIGHBORS)
    idx = np.where(jd >= 0, jd, -1).astype(np.int32)
    rest = table[:, 1].reshape(n_e, MAX_NEIGHBORS).astype(np.float32)
    stype = table[:, 2].reshape(n_e, MAX_NEIGHBORS).astype(np.float32)
    stype = np.where(idx >= 0, stype, 0.0).astype(np.float32)
    return elastic_ids, idx, rest, stype


def _split_velocity(pos4: np.ndarray, vel4: np.ndarray, muscle_model: bool):
    """A Scene from the 4-column position and velocity rows: boundary rows
    carry wall normals in the velocity file (sphFluid.cl:860)."""
    pos, color = pos4[:, :3], pos4[:, 3]
    ptype = color.astype(np.int32)
    is_b = (ptype == BOUNDARY_PARTICLE)[:, None]
    vel = np.where(is_b, 0.0, vel4[:, :3]).astype(np.float32)
    normal = np.where(is_b, vel4[:, :3], 0.0).astype(np.float32)
    return Scene(pos=pos, vel=vel, color=color, normal=normal,
                 muscle_model=muscle_model)


def load_scene(
    config_dir: str,
    position_file: str = "position.txt",
    velocity_file: str = "velocity.txt",
    connections_file: str = "elasticconnections.txt",
    muscle_model: bool = True,
) -> Scene:
    """Load the reference's three-file scene format
    (owHelper.cpp:1460-1545)."""
    pos4 = _read_rows(os.path.join(config_dir, position_file), 4)
    vel4 = _read_rows(os.path.join(config_dir, velocity_file), 4)
    scene = _split_velocity(pos4, vel4, muscle_model)

    conn_path = os.path.join(config_dir, connections_file)
    if (scene.ptype == ELASTIC_PARTICLE).any() and os.path.exists(conn_path):
        table = _read_rows(conn_path, 4)
        rows, idx, rest, stype = _springs_from_table(table, scene.ptype)
        scene.spring_rows = rows
        scene.spring_idx = idx
        scene.spring_rest = rest
        scene.spring_type = stype
    return scene


def load_scene_one_file(path: str, muscle_model: bool = True) -> Scene:
    """Load the sectioned ``configuration.txt`` format
    (owHelper.cpp:1547-1639): Position / Velocity / ElasticConnection blocks;
    the first ElasticConnection row is the connection count, then rows of
    (id, jd, rest, type)."""
    blocks: dict[str, list[list[float]]] = {}
    current = None
    with open(path) as fh:
        for line in fh:
            token = line.strip()
            if token in ("Position", "Velocity", "ElasticConnection"):
                current = token
                blocks[current] = []
                continue
            parts = line.split()
            if not parts or current is None:
                continue
            try:
                blocks[current].append([float(p) for p in parts[:4]])
            except ValueError:
                continue

    pos4 = np.asarray(blocks.get("Position", []), np.float32).reshape(-1, 4)
    vel4 = np.asarray(blocks.get("Velocity", []), np.float32).reshape(-1, 4)
    if len(vel4) < len(pos4):
        vel4 = np.concatenate(
            [vel4, np.zeros((len(pos4) - len(vel4), 4), np.float32)]
        )
    scene = _split_velocity(pos4, vel4, muscle_model)

    conns = blocks.get("ElasticConnection", [])
    if len(conns) > 1:
        n_conn = int(conns[0][0])
        rows = np.asarray(conns[1:1 + n_conn], np.float32)
        # rows: (i, jd, rest, type) — sparse list; densify to [Ne, 32]
        elastic_ids = np.nonzero(
            scene.ptype == ELASTIC_PARTICLE)[0].astype(np.int32)
        row_of = {int(p): r for r, p in enumerate(elastic_ids)}
        idx = np.full((len(elastic_ids), MAX_NEIGHBORS), -1, np.int32)
        rest = np.zeros((len(elastic_ids), MAX_NEIGHBORS), np.float32)
        stype = np.zeros((len(elastic_ids), MAX_NEIGHBORS), np.float32)
        fill = np.zeros(len(elastic_ids), np.int32)
        for i_f, jd, r0_, t in rows:
            r = row_of.get(int(i_f))
            if r is None or fill[r] >= MAX_NEIGHBORS:
                continue
            idx[r, fill[r]] = int(jd)
            rest[r, fill[r]] = r0_
            stype[r, fill[r]] = t
            fill[r] += 1
        scene.spring_rows = elastic_ids
        scene.spring_idx = idx
        scene.spring_rest = rest
        scene.spring_type = stype
    return scene


def save_scene(scene: Scene, config_dir: str) -> None:
    """Write position/velocity/elasticconnections in the reference layout
    (inverse of :func:`load_scene`). Boundary velocity rows carry normals."""
    os.makedirs(config_dir, exist_ok=True)
    is_b = (scene.ptype == BOUNDARY_PARTICLE)[:, None]
    vel4 = np.where(is_b, scene.normal, scene.vel)

    with open(os.path.join(config_dir, "position.txt"), "w") as fh:
        fh.write(_positions_text(scene.pos, scene.color))
    with open(os.path.join(config_dir, "velocity.txt"), "w") as fh:
        fh.write(_positions_text(vel4, scene.color))
    if len(scene.spring_rows):
        with open(os.path.join(config_dir, "elasticconnections.txt"),
                  "w") as fh:
            fh.write(_springs_text(scene))


class TrajectoryDumper:
    """``position_buffer.txt``-compatible trajectory dump
    (owHelper.cpp:1640-1672): header = n_elastic, n_liquid; per dumped frame
    the non-boundary positions (with type codes); springs and membranes
    written once. Membrane rows here are 3 ints (the reference writes a 4th
    out-of-bounds value, owHelper.cpp:1665 — not reproduced)."""

    def __init__(self, out_dir: str, scene: Scene):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "position_buffer.txt")
        self.scene = scene
        c = scene.counts
        self._moving = scene.ptype != BOUNDARY_PARTICLE
        with open(self.path, "w") as fh:
            fh.write(f"{c['elastic']}\n{c['liquid']}\n")
        if len(scene.spring_rows):
            with open(os.path.join(out_dir, "connection_buffer.txt"),
                      "w") as fh:
                fh.write(_springs_text(scene))
        if len(scene.tris):
            with open(os.path.join(out_dir, "membranes_buffer.txt"),
                      "w") as fh:
                tris = np.asarray(scene.tris)
                fh.write(f"{len(tris)}\n")
                fh.write(("%d\t%d\t%d\n" * len(tris))
                         % tuple(tris.ravel().tolist()))

    def append(self, pos: np.ndarray) -> None:
        pos = np.asarray(pos)
        with open(self.path, "a") as fh:
            fh.write(_positions_text(pos[self._moving],
                                     self.scene.color[self._moving]))


def load_trajectory(path: str):
    """Replay reader for ``position_buffer.txt``
    (owHelper.cpp:1674-1739): returns (n_elastic, n_liquid,
    frames [T, n_moving, 4])."""
    with open(path) as fh:
        n_e = int(fh.readline())
        n_l = int(fh.readline())
        data = np.loadtxt(fh, dtype=np.float32).reshape(-1, 4)
    per = n_e + n_l
    if per == 0:
        raise ValueError(f"{path}: empty trajectory (no moving particles)")
    n_frames = len(data) // per
    return n_e, n_l, data[: n_frames * per].reshape(n_frames, per, 4)
