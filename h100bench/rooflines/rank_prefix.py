"""``rank_prefix``: per (query, slot) pair a target compare and a rank
compare (int32) and a predicated damage add (f32), over B * A^2 pairs."""

from ..peaks import nbytes


def work(args, kwargs, out):
    B, A = args[0].shape
    return dict(bytes=nbytes(args, out), int32=2 * B * A * A, f32=B * A * A)
