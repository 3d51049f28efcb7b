"""Kernels of the port: each wrapper launches a CUDA kernel on CUDA tensors
and calls its plain PyTorch version on CPU tensors.  :func:`launch_counts`
reads how many times each kernel was launched (plain-version calls do not
count)."""

from . import _build

KERNELS = ("window_gather", "occupant", "rank_prefix", "move_resolve",
           "rank_prefix_hp", "move_claims", "occupant_rect",
           "rect_first_overlap", "window_gather4", "occupant_rect_seg",
           "rect_first_overlap_seg", "rank_prefix_seg", "window_gather_banded",
           "window_ladder", "window_shared_tile", "window_gather_bf16",
           "window_gather4_bf16", "window_gather_banded_bf16", "threefry",
           "gru_cell", "gru_cell_backward")


def launch_counts() -> dict:
    return {name: _build.LAUNCHES[name] for name in KERNELS}


def reset_launch_counts() -> None:
    _build.LAUNCHES.clear()
