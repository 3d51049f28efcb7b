"""``window_gather_banded``: every window written once, the positions,
the mask and the epilogue operands read once, and each image value that
some window reads under a non-zero mask entry read once (the image's
bands as the windows cover them; a window at a negative position, or
leaving the image on the right, reads nothing, and rows past the image
read as zeros); per output element the mask multiply, and the
epilogue's liveness multiply and two minimap adds where it has them
(f32).  The arithmetic of ``magent_tpu_torch/tools/profile_gather.py``
``window_bytes``."""

import torch

from ..peaks import nbytes


def image_values_read(gfull, pos, mask, C, Wp):
    """Image values under a non-zero mask entry of some window, each once."""
    B, Hp, lanes = gfull.shape
    oy, ox = torch.nonzero(mask != 0, as_tuple=True)
    vwc = mask.shape[1]
    touched = torch.zeros((Hp, lanes), dtype=torch.bool, device=gfull.device)
    n = 0
    for b in range(B):
        tl = pos[b].long()
        tl = tl[(tl >= 0) & ((tl % Wp) * C + vwc <= lanes)]
        rows = (tl // Wp)[:, None] + oy
        cols = ((tl % Wp) * C)[:, None] + ox
        inside = rows < Hp
        touched.zero_()
        touched[rows[inside], cols[inside]] = True
        n += int(touched.sum())
    return n


def work(args, kwargs, out):
    gfull, pos, mask = args
    view = out[0] if isinstance(out, tuple) else out
    epilogue = [kwargs.get(k) for k in ("act", "mm", "self_cell", "mm_maskc")]
    n_read = image_values_read(gfull, pos, mask, kwargs["C"], kwargs["Wp"])
    per_value = (1 + (1 if kwargs.get("act") is not None else 0)
                 + (2 if kwargs.get("mm") is not None else 0))
    return dict(bytes=n_read * gfull.element_size()
                + nbytes(out, pos, mask, *epilogue),
                f32=per_value * view.numel())
