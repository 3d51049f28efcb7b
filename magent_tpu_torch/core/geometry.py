"""Coordinate transforms between body ("save") coords, the direction anchor
("real") coords and relative offsets, as branch-free tensor ops over the
direction enum EAST=0, SOUTH=1, WEST=2, NORTH=3, and their host forms
(``*_np``) for placement and the replay dumps (port of
``magent_tpu/core/geometry.py``; reference Map.cc:515-607)."""

from __future__ import annotations

import numpy as np
import torch

from ..spec import NORTH, SOUTH, WEST


def save_to_real(x, y, d, w, l):
    """Stored top-left -> direction anchor (reference: Map.cc:553-574)."""
    rx = torch.where(d == NORTH, x, torch.where(
        d == SOUTH, x + w - 1, torch.where(d == WEST, x, x + l - 1)))
    ry = torch.where(d == NORTH, y, torch.where(
        d == SOUTH, y + l - 1, torch.where(d == WEST, y + w - 1, y)))
    return rx, ry


def real_to_save(x, y, d, w, l):
    """Direction anchor -> stored top-left (reference: Map.cc:576-595)."""
    sx = torch.where(d == NORTH, x, torch.where(
        d == SOUTH, x - w + 1, torch.where(d == WEST, x, x - l + 1)))
    sy = torch.where(d == NORTH, y, torch.where(
        d == SOUTH, y - l + 1, torch.where(d == WEST, y - w + 1, y)))
    return sx, sy


def rela_to_abs(cx, cy, d, rx, ry):
    """Relative (agent frame) -> absolute (reference: Map.cc:515-532)."""
    ax = torch.where(d == NORTH, cx + rx, torch.where(
        d == SOUTH, cx - rx, torch.where(d == WEST, cx + ry, cx - ry)))
    ay = torch.where(d == NORTH, cy + ry, torch.where(
        d == SOUTH, cy - ry, torch.where(d == WEST, cy - rx, cy + rx)))
    return ax, ay


def size_for_dir(d, w, l):
    """Axis-aligned body rect size for a direction (reference: Map.cc:597-607)."""
    ns = (d == NORTH) | (d == SOUTH)
    return torch.where(ns, w, l), torch.where(ns, l, w)


def rotate_move_delta(d, dx, dy):
    """Move delta rotation (reference: GridWorld.cc:587-595)."""
    ddx = torch.where(d == NORTH, dx, torch.where(
        d == SOUTH, -dx, torch.where(d == WEST, dy, -dy)))
    ddy = torch.where(d == NORTH, dy, torch.where(
        d == SOUTH, -dy, torch.where(d == WEST, -dx, dx)))
    return ddx, ddy


# ---------------------------------------------------------------- host forms
# the same conventions on host integers and NumPy arrays (placement and the
# replay dumps; JAX ``core/geometry.py:55-87``)
def size_for_dir_np(d, w, l):
    """Host (scalar) variant of :func:`size_for_dir`."""
    ns = (d == NORTH) | (d == SOUTH)
    return (w if ns else l), (l if ns else w)


def save_to_real_np(x, y, d, w, l):
    """Host (NumPy) variant of :func:`save_to_real`."""
    rx = np.where(d == NORTH, x, np.where(
        d == SOUTH, x + w - 1, np.where(d == WEST, x, x + l - 1)))
    ry = np.where(d == NORTH, y, np.where(
        d == SOUTH, y + l - 1, np.where(d == WEST, y + w - 1, y)))
    return rx, ry


def rela_to_abs_np(cx, cy, d, rx, ry):
    """Host (NumPy) variant of :func:`rela_to_abs`."""
    ax = np.where(d == NORTH, cx + rx, np.where(
        d == SOUTH, cx - rx, np.where(d == WEST, cx + ry, cx - ry)))
    ay = np.where(d == NORTH, cy + ry, np.where(
        d == SOUTH, cy - ry, np.where(d == WEST, cy - rx, cy + rx)))
    return ax, ay
