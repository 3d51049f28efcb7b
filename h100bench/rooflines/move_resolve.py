"""``move_resolve``: per (query, slot) pair nine int32 instructions
(target compare, the lower-slot count, the head's min, the occupant
compare, its self gate, count and slot sum), over B * A^2 pairs."""

from ..peaks import nbytes


def work(args, kwargs, out):
    B, A = args[0].shape
    return dict(bytes=nbytes(args, out), int32=9 * B * A * A)
