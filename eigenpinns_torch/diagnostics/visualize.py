"""Matplotlib visualizations (mesh, sampler levels, eigenfunctions).

Parity with `mesh_helpers.visualize_mesh` (src/mesh_helpers.py:23-41) and
the Sampler's visualization suite (src/samplers.py:289-348), writing PNGs
instead of calling plt.show() (headless-friendly; the reference's
`visualize` also carries a latent self-passed-twice bug noted in
SURVEY.md 2.1 that this rewrite drops).

A copy of `eigenpinns_tpu/diagnostics/visualize.py`.
"""

from __future__ import annotations

import os

import numpy as np


def _ax3d(figsize=(10, 10)):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(projection="3d")
    ax.view_init(elev=130, azim=-90)  # reference camera (mesh_helpers:39)
    return fig, ax


def _save(fig, path):
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def plot_mesh(mesh, path: str, title: str = "Mesh",
              highlight_indices=None, scalars=None) -> None:
    """Translucent trisurf + optional highlighted vertices / scalar field."""
    fig, ax = _ax3d()
    v = mesh.verts
    if scalars is not None:
        tri = ax.plot_trisurf(v[:, 0], v[:, 1], v[:, 2],
                              triangles=mesh.faces, cmap="viridis",
                              alpha=0.9)
        tri.set_array(np.asarray(scalars)[mesh.faces].mean(axis=1))
        fig.colorbar(tri, ax=ax, shrink=0.6)
    else:
        ax.plot_trisurf(v[:, 0], v[:, 1], v[:, 2], triangles=mesh.faces,
                        alpha=0.3)
    if highlight_indices is not None:
        hv = v[np.asarray(highlight_indices)]
        ax.scatter(hv[:, 0], hv[:, 1], hv[:, 2], c="fuchsia", s=10,
                   alpha=0.8, label=f"{len(hv)} selected points")
        ax.legend()
    ax.set_title(title)
    _save(fig, path)


def plot_hierarchy_levels(hierarchy, path_prefix: str) -> None:
    """One scatter per level of a point-sampled hierarchy
    (the Sampler visualization, src/samplers.py:289-348)."""
    for i, X in enumerate(hierarchy.X_list):
        fig, ax = _ax3d(figsize=(8, 8))
        ax.scatter(X[:, 0], X[:, 1], X[:, 2], s=4)
        ax.set_title(f"level {i}: {X.shape[0]} points")
        _save(fig, f"{path_prefix}_level{i}.png")


def plot_eigenfunctions(mesh, U, path: str, modes=(0, 1, 2, 3)) -> None:
    """Grid of eigenfunction colorings on the mesh."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(modes)
    cols = min(n, 4)
    rows = (n + cols - 1) // cols
    fig = plt.figure(figsize=(4 * cols, 4 * rows))
    v = mesh.verts
    for j, m in enumerate(modes):
        ax = fig.add_subplot(rows, cols, j + 1, projection="3d")
        tri = ax.plot_trisurf(v[:, 0], v[:, 1], v[:, 2],
                              triangles=mesh.faces, cmap="coolwarm")
        tri.set_array(np.asarray(U[:, m])[mesh.faces].mean(axis=1))
        ax.set_title(f"mode {m}")
        ax.view_init(elev=130, azim=-90)
        ax.set_axis_off()
    _save(fig, path)


def plot_loss_history(history: dict, path: str,
                      keys=("loss", "res", "orth")) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for k in keys:
        if k in history and np.asarray(history[k]).size:
            vals = np.maximum(np.asarray(history[k], dtype=np.float64),
                              1e-16)
            ax.semilogy(vals, label=k)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    _save(fig, path)
