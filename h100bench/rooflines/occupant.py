"""``occupant``: one int32 compare per (query, slot) pair over B * A^2
pairs, and per query that found a slot a count and a slot add (int32) and
an hp add (f32)."""

from ..peaks import nbytes


def work(args, kwargs, out):
    B, A = args[0].shape
    found = int((out[0] >= 0).sum())
    return dict(bytes=nbytes(args, out), int32=B * A * A + 2 * found,
                f32=found)
