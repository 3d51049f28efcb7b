"""Random operands of the port's y-segmented pair sweeps, made with numpy
from a seed as tests/test_pairwise_kernels.py:99-243 makes them: A = 3072
slots, three segments of 1024, in two cases, y uniform over 400 rows (the
windows subset) and y in 3 rows (the windows overflow and the full sweep
runs).  Imports only the port, so the card's tests use them too
(tests/test_torch_port_seg_kernels.py, tests/test_torch_port_gpu.py)."""

import numpy as np
import torch

from magent_tpu_torch.ops import attack_prefix as tap

A = 3072
MB = 2
CASES = ["uniform", "degenerate"]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def sorted_by_y(y):
    """(sort_y, order) of a stable sort of y."""
    order = np.argsort(y, kind="stable").astype(np.int32)
    return y[order].astype(np.int32), order


def rect_case(case, seed=57, n=A):
    """Rect-sweep operands pre-sorted by y, original slot ids shuffled by
    the sort (tests/test_pairwise_kernels.py:99-124)."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 3 if case == "degenerate" else 400, n).astype(np.int32)
    x = rng.randint(0, 400, n).astype(np.int32)
    bw = rng.randint(0, MB + 1, n).astype(np.int32)
    bh = rng.randint(0, MB + 1, n).astype(np.int32)
    qx = (x + rng.randint(-2, 3, n)).astype(np.int32)
    qy = (y + rng.randint(-2, 3, n)).astype(np.int32)
    sent = rng.uniform(size=n) < 0.2
    qx = np.where(sent, tap.RECT_PAD, qx).astype(np.int32)
    tbw = np.where(sent, 0, bw).astype(np.int32)
    tbh = np.where(sent, 0, bh).astype(np.int32)
    sort_y, order = sorted_by_y(y)
    args = tuple(a[order] for a in (qx, qy, tbw, tbh, x, y, bw, bh))
    return args, sort_y, order


def occupant_case(case):
    """tests/test_pairwise_kernels.py:171-204's operands: query cells
    within 3 of random (possibly overlapping) rects, random hp, pre-sorted
    by y -> (args, sort_y, order, margin)."""
    rng = np.random.RandomState(77 + (case == "degenerate"))
    y = rng.randint(0, 3 if case == "degenerate" else 400, A).astype(np.int32)
    x = rng.randint(0, 400, A).astype(np.int32)
    bw = rng.randint(0, MB + 1, A).astype(np.int32)
    bh = rng.randint(0, MB + 1, A).astype(np.int32)
    hp = rng.uniform(size=A).astype(np.float32)
    qx = (x + rng.randint(-3, 4, A)).astype(np.int32)
    qy = (y + rng.randint(-3, 4, A)).astype(np.int32)
    sort_y, order = sorted_by_y(y)
    return tuple(a[order] for a in (qx, qy, x, y, bw, bh, hp)), sort_y, \
        order, 3 + MB


def rank_case(case):
    """tests/test_pairwise_kernels.py:207-243's operands: targets among
    the y-neighbours (|dy| <= 3), random damage, no-target rows at the
    engine's sentinel A with zero damage, pre-sorted by y -> (args, sort_y,
    live rows, margin)."""
    rng = np.random.RandomState(99 + (case == "degenerate"))
    y = rng.randint(0, 3 if case == "degenerate" else 400, A).astype(np.int32)
    valid = rng.uniform(size=A) < 0.7
    sort_y, order = sorted_by_y(y)
    rank_in_sorted = np.empty(A, np.int64)
    rank_in_sorted[order] = np.arange(A)
    nb = np.clip(rank_in_sorted + rng.randint(-8, 9, A), 0, A - 1)
    tgt_raw = order[nb]
    ok = np.abs(y[tgt_raw] - y) <= 3
    tgt = np.where(valid & ok, tgt_raw, A).astype(np.int32)
    bits = rng.randint(0, 2**32, size=A, dtype=np.uint64).astype(np.int64)
    rank = tap.pack_rank(torch.from_numpy(bits), A).numpy()
    dmg = np.where(valid & ok, rng.uniform(size=A), 0.0).astype(np.float32)
    return tuple(a[order] for a in (tgt, rank, dmg)), sort_y, \
        (valid & ok)[order], 2 * 4


def seg_calls(case):
    """(name, wrapper, plain version, operands as CPU tensors, keywords) of
    the three sweeps on this module's operands."""
    rect, r_sort, r_order = rect_case(case)
    occ, o_sort, o_order, o_margin = occupant_case(case)
    rank, k_sort, _, k_margin = rank_case(case)
    calls = [("rect_first_overlap_seg", tap.rect_first_overlap_seg,
              tap.rect_first_overlap_seg_ref,
              list(rect) + [r_sort, r_order],
              dict(max_body=MB, gate=gate, margin=MB + 4))
             for gate in ("exclude_self", "lower_only")]
    calls.append(("occupant_rect_seg", tap.occupant_rect_seg,
                  tap.occupant_rect_seg_ref, list(occ) + [o_sort, o_order],
                  dict(margin=o_margin)))
    calls.append(("rank_prefix_seg", tap.rank_prefix_seg,
                  tap.rank_prefix_seg_ref, list(rank) + [k_sort],
                  dict(margin=k_margin)))
    return [(name, fn, ref, [t(a) for a in args], kw)
            for name, fn, ref, args, kw in calls]
