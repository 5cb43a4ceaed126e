"""Offline rendering of simulation states and dumped trajectories
(a copy of ``sph_tpu/viz/render.py``; NumPy, with matplotlib and PIL
imported inside the functions that need them).

Replaces the reference's GLUT window (its `src/owWorldSimulation.cpp:
100-358`) with headless matplotlib output: the same density-based coloring
bands (+-4% around rho0, `owWorldSimulation.cpp:129-142`) and
particle-class colors, but written as PNGs from a live state or a
``position_buffer.txt`` replay — the `-l_from` path without a GL stack.
"""
from __future__ import annotations

import os

import numpy as np

from ..constants import BOUNDARY_PARTICLE, ELASTIC_PARTICLE, LIQUID_PARTICLE


def _colors(ptype: np.ndarray, rho: np.ndarray | None, rho0: float):
    c = np.zeros((len(ptype), 3))
    c[ptype == BOUNDARY_PARTICLE] = (0.4, 0.4, 0.4)
    c[ptype == ELASTIC_PARTICLE] = (0.9, 0.8, 0.2)
    liq = ptype == LIQUID_PARTICLE
    if rho is None:
        c[liq] = (0.2, 0.4, 0.9)
    else:
        # density bands as in the reference HUD: blue below rho0-4%,
        # green near rho0, red above rho0+4%
        r = rho[liq]
        t = np.clip((r - rho0 * 0.96) / (rho0 * 0.08), 0.0, 1.0)
        band = np.stack([t, 0.6 * (1 - np.abs(2 * t - 1)), 1.0 - t], axis=1)
        c[liq] = band
    return c


# muscle spring colors by type-code fraction (owWorldSimulation.cpp:233-287:
# +0.5 violet, +0.4 magenta, +0.3 orange, +0.2/+0.1 red)
_MUSCLE_FRAC_COLORS = (
    (0.45, (0.5, 0.0, 1.0)),
    (0.35, (1.0, 0.0, 1.0)),
    (0.25, (1.0, 0.5, 0.0)),
    (-1.0, (1.0, 0.0, 0.0)),
)
_PLAIN_SPRING_COLOR = (150 / 255, 125 / 255, 0.0)


def _spring_segments(pos2, spring_rows, spring_idx, spring_type, activation):
    """Per-spring 2-D segments + colors + widths, reference semantics
    (owWorldSimulation.cpp:206-301): plain springs thin olive; muscle
    springs colored by the type-code fraction and drawn thick while their
    muscle's live activation exceeds 0.1."""
    i = np.repeat(np.asarray(spring_rows), spring_idx.shape[1])
    j = np.asarray(spring_idx).ravel()
    t = np.asarray(spring_type).ravel()
    keep = (j >= 0) & (i < j)  # draw each undirected spring once
    i, j, t = i[keep], j[keep], t[keep]
    segs = np.stack([pos2[i], pos2[j]], axis=1)

    colors = np.tile(np.array(_PLAIN_SPRING_COLOR), (len(i), 1))
    widths = np.full(len(i), 0.1)
    is_m = t > 1.0
    frac = t - np.floor(t)
    for lo, col in _MUSCLE_FRAC_COLORS:
        m = is_m & (frac > lo) & (widths <= 0.1)
        colors[m] = col
        widths[m] = 0.6
    if activation is not None and is_m.any():
        mid = np.floor(t).astype(int) - 1
        act = np.asarray(activation)[np.clip(mid, 0, len(activation) - 1)]
        widths[is_m & (act > 0.1)] = 1.8
    return segs, colors, widths


def _membrane_segments(pos2, tris):
    """Membrane midline triangles (owWorldSimulation.cpp:337-347): the
    small triangle through (i+j+4k)/6, (i+k+4j)/6, (j+k+4i)/6."""
    tris = np.asarray(tris)
    a = pos2[tris[:, 0]]
    b = pos2[tris[:, 1]]
    c = pos2[tris[:, 2]]
    m0 = (a + b + 4 * c) / 6
    m1 = (a + c + 4 * b) / 6
    m2 = (b + c + 4 * a) / 6
    return np.concatenate([
        np.stack([m0, m1], axis=1),
        np.stack([m1, m2], axis=1),
        np.stack([m2, m0], axis=1),
    ])


def _hud_text(counts, step, time_step, activation, fps=None):
    """The reference HUD block (owWorldSimulation.cpp:501-641): particle
    counts, step index + sim time (+FPS), and the 96 muscle activations in
    the four quadrant rows MDR/MVR/MVL/MDL."""
    lines = []
    if counts:
        lines.append(
            f"Liquid particles: {counts.get('liquid', 0)}, elastic matter "
            f"particles: {counts.get('elastic', 0)}, boundary particles: "
            f"{counts.get('boundary', 0)}; total count: "
            f"{sum(counts.get(k, 0) for k in ('liquid', 'elastic', 'boundary'))}"
        )
    if step is not None:
        fps_s = f"FPS = {fps:.2f}, " if fps is not None else ""
        lines.append(
            f"{fps_s}time step: {step} ({step * time_step:f} s)"
        )
    if activation is not None:
        act = np.asarray(activation)
        lines.append("Muscle activation signals:")
        for q, name in enumerate(("MDR", "MVR", "MVL", "MDL")):
            row = act[q * 24:(q + 1) * 24]
            lines.append(
                f"{name}: " + " ".join(f"{v:.2f}" for v in row)
                + f"  indexes: +{q * 24}"
            )
    return "\n".join(lines)


def render_frame(
    pos: np.ndarray,
    ptype: np.ndarray,
    out_path: str,
    rho: np.ndarray | None = None,
    rho0: float = 1000.0,
    axes: tuple[int, int] = (2, 1),
    show_boundary: bool = False,
    title: str | None = None,
    point_size: float = 1.0,
    springs=None,
    tris: np.ndarray | None = None,
    activation: np.ndarray | None = None,
    hud: bool = False,
    counts: dict | None = None,
    step: int | None = None,
    time_step: float = 5e-6,
    fps: float | None = None,
):
    """Scatter one frame onto the (axes[0], axes[1]) plane (default z-y,
    the worm's side view).

    Optional overlays replicate the reference GLUT view as outputs:
    ``springs=(spring_rows, spring_idx, spring_type)`` draws the elastic
    graph with per-muscle color and activation-dependent width
    (`owWorldSimulation.cpp:206-301`), ``tris`` draws membrane midline
    triangles (`:319-347`), and ``hud=True`` prints the counts / step /
    sim-time / 96-activation text block (`:501-641`).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    pos = np.asarray(pos)
    ptype = np.asarray(ptype)
    keep = np.ones(len(pos), bool)
    if not show_boundary:
        keep = ptype != BOUNDARY_PARTICLE
    c = _colors(ptype, rho, rho0)
    pos2 = pos[:, [axes[0], axes[1]]]

    fig, ax = plt.subplots(figsize=(14, 4.8 if hud else 4), dpi=110)
    ax.scatter(pos2[keep, 0], pos2[keep, 1],
               c=c[keep], s=point_size, linewidths=0)
    if springs is not None and len(springs[0]):
        segs, cols, lws = _spring_segments(pos2, *springs, activation)
        ax.add_collection(
            LineCollection(segs, colors=cols, linewidths=lws, alpha=0.7)
        )
    if tris is not None and len(tris):
        msegs = _membrane_segments(pos2, tris)
        ax.add_collection(
            LineCollection(msegs, colors=[(0.3, 0.8, 0.9)],
                           linewidths=0.2, alpha=0.5)
        )
    ax.set_aspect("equal")
    ax.set_facecolor("black")
    if hud:
        txt = _hud_text(counts, step, time_step, activation, fps)
        ax.text(0.01, 0.99, txt, transform=ax.transAxes, fontsize=5,
                va="top", ha="left", color="white", family="monospace")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def render_trajectory(
    buffer_path: str,
    out_dir: str,
    every: int = 1,
    **kw,
):
    """Render a dumped position_buffer.txt into numbered PNGs (replay mode,
    reference `-l_from`)."""
    from ..scene.io import load_trajectory

    n_e, n_l, frames = load_trajectory(buffer_path)
    paths = []
    for t in range(0, len(frames), every):
        f = frames[t]
        paths.append(render_frame(
            f[:, :3], f[:, 3].astype(np.int32),
            os.path.join(out_dir, f"frame_{t:05d}.png"),
            title=f"frame {t}", **kw,
        ))
    return paths


def frames_to_gif(paths, out_path: str, fps: float = 10.0) -> str:
    """Assemble rendered PNG frames into an animated GIF (the headless
    counterpart of the reference's screen-capture video workflow,
    README.md:89-119; no ffmpeg in the image, PIL only)."""
    from PIL import Image

    if not paths:
        raise ValueError("no frames to assemble")
    ims = [Image.open(p).convert("P", palette=Image.ADAPTIVE)
           for p in paths]
    ims[0].save(out_path, save_all=True, append_images=ims[1:],
                duration=int(1000 / fps), loop=0)
    return out_path
