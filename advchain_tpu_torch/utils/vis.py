"""Visualization helpers (matplotlib) — parity with reference common/vis.py
(port of advchain_tpu/utils/vis.py).

Accepts numpy arrays and tensors on any device (``detach().cpu()``).
Matplotlib is imported only when no ``ax`` is given: with one, the
functions call its ``imshow`` / ``plot`` / ``set_title`` / ``set_axis_off``
/ ``grid`` / ``axis`` methods alone.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["plot_image", "plot_general", "plot_noise", "plot_bias_field",
           "plot_warped_grid"]


def _np(data):
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def _plt():
    import matplotlib.pyplot as plt
    return plt


def _show(data, ax, title, font_size, bold=True, **kwargs):
    """imshow ``data`` on ``ax`` (or the current pyplot axes) and title it,
    axes off, as the reference does."""
    if ax is not None:
        ax.imshow(data, **kwargs)
        ax.set_title(title, size=font_size, weight="bold")
        ax.set_axis_off()
        ax.grid(False)
        return ax
    plt = _plt()
    plt.imshow(data, **kwargs)
    if bold:
        plt.title(title, size=font_size, weight="bold")
    else:
        plt.title(title, size=font_size)
    plt.axis("off")
    return ax


def plot_image(data, ax=None, font_size=12, title="before"):
    """Grayscale image (reference vis.py:5-19)."""
    return _show(_np(data), ax, title, font_size, cmap="gray")


def plot_general(data, ax=None, font_size=12, title="", cmap="gray"):
    return _show(_np(data), ax, title, font_size, cmap=cmap)


def plot_noise(data, ax=None, font_size=12, title="rand noise"):
    """Diverging colormap centered like the reference (vis.py:39-56)."""
    data = _np(data)
    return _show(data, ax, title, font_size, cmap="RdBu_r",
                 interpolation="none", vmin=-np.max(data))


def plot_bias_field(data, ax=None, font_size=12, title="rand bias"):
    return _show(_np(data), ax, title, font_size, bold=False, cmap="jet")


def plot_warped_grid(dvf, ax=None, bg_img=None, interval=3,
                     title=r"$\mathcal{T}_\phi$", fontsize=20,
                     linewidth=0.5, show=True):
    """Deformation grid lines over a background image
    (reference vis.py:75-130).  ``dvf``: (2, H, W) offsets in [-1, 1]."""
    dvf = np.array(_np(dvf), copy=True)
    background = _np(bg_img) if bg_img is not None \
        else np.zeros(dvf.shape[1:])
    h, w = dvf.shape[1], dvf.shape[2]
    yy, xx = np.meshgrid(range(0, h, interval), range(0, w, interval),
                         indexing="ij")
    dvf[0] = dvf[0] * (background.shape[1] / 2)
    dvf[1] = dvf[1] * (background.shape[0] / 2)
    new_x = xx + dvf[0, yy, xx]
    new_y = yy + dvf[1, yy, xx]
    kwargs = {"linewidth": linewidth, "color": "r"}
    target = ax if ax is not None else _plt()
    if show:
        target.imshow(background, cmap="gray")
    for i in range(xx.shape[0]):
        target.plot(new_x[i, :], new_y[i, :], **kwargs)
    for i in range(xx.shape[1]):
        target.plot(new_x[:, i], new_y[:, i], **kwargs)
    if ax is not None:
        ax.set_title(title, fontsize=fontsize, weight="bold")
        ax.axis("off")
    else:
        target.title(title, size=fontsize, weight="bold")
        target.axis("off")
    return ax
