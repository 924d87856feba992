"""Visualization (SURVEY.md §2.12): energy curves, TSDF field heatmaps, warp
quiver plots, and live-field-evolution videos — the reference's matplotlib /
OpenCV artifact set, reimplemented. All functions are host-side (numpy),
headless (Agg backend) and write into a run directory.

matplotlib and cv2 are optional: they are imported where they are used, and
a run on a host without them writes no plots or video and says so (the
notes returned by ``write_run_artifacts`` and ``FieldEvolutionVideo.skipped``).
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the headless Agg backend, or None when
    matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_energy_curves(rows: Sequence[dict], path: str) -> None:
    """Per-iteration energy components (reference's convergence plot)."""
    plt = _pyplot()
    it = [r["iteration"] for r in rows]
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 7), sharex=True)
    for key in ("data_energy", "smoothing_energy", "level_set_energy", "total_energy"):
        ax1.plot(it, [r[key] for r in rows], label=key)
    ax1.set_yscale("log")
    ax1.set_ylabel("energy")
    ax1.legend()
    ax2.plot(it, [r["max_warp_update"] for r in rows], label="max_warp_update")
    ax2.plot(it, [r["mean_warp_update"] for r in rows], label="mean_warp_update")
    ax2.set_yscale("log")
    ax2.set_xlabel("iteration")
    ax2.set_ylabel("warp update (voxels)")
    ax2.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def field_heatmap(field: np.ndarray, path: str, title: str = "TSDF") -> None:
    """2D TSDF field heatmap (x lateral, z depth), band-centered colormap."""
    plt = _pyplot()
    field = np.asarray(field)
    if field.ndim == 3:  # central y slice of a volume
        field = field[:, field.shape[1] // 2, :]
    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(field.T, origin="lower", cmap="RdBu", vmin=-1, vmax=1)
    ax.set_xlabel("x (voxels)")
    ax.set_ylabel("z (voxels)")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, label="Φ")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def warp_quiver(warp: np.ndarray, path: str, stride: int = 4, title: str = "warp") -> None:
    """Quiver plot of a 2D warp field (or the central slice of a 3D one)."""
    plt = _pyplot()
    warp = np.asarray(warp)
    if warp.ndim == 4:  # (X, Y, Z, 3) -> central y slice, (x, z) components
        warp = warp[:, warp.shape[1] // 2, :, :][..., [0, 2]]
    x, z = np.meshgrid(
        np.arange(0, warp.shape[0], stride), np.arange(0, warp.shape[1], stride),
        indexing="ij",
    )
    u = warp[::stride, ::stride, 0]
    v = warp[::stride, ::stride, 1]
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.quiver(x, z, u, v, angles="xy", scale_units="xy", scale=1.0, width=0.002)
    ax.set_xlabel("x (voxels)")
    ax.set_ylabel("z (voxels)")
    ax.set_title(title)
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


class FieldEvolutionVideo:
    """cv2 video writer for live-field evolution (reference's per-iteration
    videos). Frames are 2D fields rendered to the RdBu colormap.

    ``skipped`` names the missing package when cv2 or matplotlib is not
    installed; ``add_frame`` is then a no-op (and fetches nothing)."""

    def __init__(self, path: str, fps: int = 10):
        self.path = path
        self.fps = fps
        self._writer = None
        self.skipped = None
        plt = _pyplot()
        try:
            import cv2
        except ImportError:
            cv2 = None
        if plt is None or cv2 is None:
            missing = "matplotlib" if plt is None else "cv2"
            self.skipped = f"video: {missing} not installed"
            return
        self._cv2 = cv2
        self._cmap = plt.get_cmap("RdBu")

    def add_frame(self, field) -> None:
        if self.skipped:
            return
        cv2 = self._cv2
        field = np.asarray(field)
        if field.ndim == 3:
            field = field[:, field.shape[1] // 2, :]
        rgb = (self._cmap((field.T + 1.0) / 2.0)[..., :3] * 255).astype(np.uint8)
        bgr = rgb[::-1, :, ::-1]  # origin lower + RGB->BGR
        if self._writer is None:
            h, w = bgr.shape[:2]
            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            self._writer = cv2.VideoWriter(self.path, fourcc, self.fps, (w, h))
        self._writer.write(np.ascontiguousarray(bgr))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None


def write_run_artifacts(out_dir: str, rows: List[dict], canonical=None,
                        live=None, warped=None, warp=None) -> List[str]:
    """Standard artifact bundle after a solve (plots the reference emits).

    Returns notes on what was not written (empty when everything was)."""
    os.makedirs(out_dir, exist_ok=True)
    if _pyplot() is None:
        return ["plots: matplotlib not installed"]
    if rows:
        plot_energy_curves(rows, os.path.join(out_dir, "energy.png"))
    if canonical is not None:
        field_heatmap(np.asarray(canonical), os.path.join(out_dir, "canonical.png"), "canonical")
    if live is not None:
        field_heatmap(np.asarray(live), os.path.join(out_dir, "live.png"), "live")
    if warped is not None:
        field_heatmap(np.asarray(warped), os.path.join(out_dir, "warped_live.png"), "warped live")
    if warp is not None:
        warp_quiver(np.asarray(warp), os.path.join(out_dir, "warp.png"))
    return []
