"""``window_gather``: every window written once (one mask multiply per
element); the image is not counted, since windows need not cover it."""

from ..peaks import nbytes


def work(args, kwargs, out):
    pos, mask = args[1], args[2]
    return dict(bytes=nbytes(out, pos, mask), f32=out.numel())
