"""Grasp visualization: the 2-D square with its contact forces and gravity
(the counterpart of ``altro_tpu/models/grasp_viz.py``; parity with
benchmarks/grasp_optimization/src/visualize.jl:1-45, ``visualize_square``
/ ``pgf_square!``), drawn with matplotlib, which is imported when a figure
is drawn. Best-effort rendering for inspection; on no solver path. Takes
the port's tensors (on any device) or arrays.
"""
from __future__ import annotations

import numpy as np


def _np(a) -> np.ndarray:
    """A tensor (moved to the CPU) or an array as a numpy array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def visualize_square(ax, center, theta, F1, F2, p1, p2, mass=0.2,
                     half_width=1.0, force_scale=0.3):
    """Draw the rotated square in the y-z plane with force arrows.

    center: (y, z) object position; theta: rotation about x; F1/F2: 3-D
    contact forces; p1/p2: 3-D contact points (object frame, unrotated
    convention handled by caller).
    """
    from matplotlib import patches, transforms

    center, F1, F2, p1, p2 = (_np(a) for a in (center, F1, F2, p1, p2))
    cy, cz = float(center[0]), float(center[1])
    sq = patches.Rectangle((cy - half_width, cz - half_width), 2 * half_width,
                           2 * half_width, fill=True, alpha=0.4,
                           color="tab:blue")
    tr = (transforms.Affine2D().rotate_around(cy, cz, float(_np(theta)))
          + ax.transData)
    sq.set_transform(tr)
    ax.add_patch(sq)

    for F, p, color in ((F1, p1, "tab:red"), (F2, p2, "tab:green")):
        py, pz = cy + float(p[1]), cz + float(p[2])
        fy, fz = float(F[1]) * force_scale, float(F[2]) * force_scale
        ax.annotate("", xy=(py + fy, pz + fz), xytext=(py, pz),
                    arrowprops=dict(arrowstyle="->", color=color, lw=2))

    g = 9.81 * float(_np(mass)) * force_scale
    ax.annotate("", xy=(cy, cz - g), xytext=(cy, cz),
                arrowprops=dict(arrowstyle="->", color="k", lw=2))
    ax.set_aspect("equal")


def plot_grasp_trajectory(o, X, U, path: str, steps=None):
    """Render selected steps of one grasp trajectory (X [N, n], U [N-1, m]
    of one scenario; ``o`` from ``models.grasp.make_grasp_object``) to one
    figure at ``path`` (the grasp_ref_traj_plot.jl analog)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    X, U, theta = _np(X), _np(U), _np(o.theta)
    steps = steps if steps is not None else np.linspace(
        0, U.shape[0] - 1, 5).astype(int)
    fig, axes = plt.subplots(1, len(steps), figsize=(3 * len(steps), 3.2))
    for ax, k in zip(np.atleast_1d(axes), steps):
        th = float(theta[k])
        p1 = np.array([0.0, -np.cos(th), -np.sin(th)])  # rotated contact 1
        p2 = -p1
        visualize_square(ax, X[k, 1:3], th, U[k, :3], U[k, 3:], p1, p2,
                         mass=o.mass)
        ax.set_title(f"k={k}")
        ax.set_xlim(X[k, 1] - 2.5, X[k, 1] + 2.5)
        ax.set_ylim(X[k, 2] - 2.5, X[k, 2] + 2.5)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
