"""One file per entry point of ``magent_tpu_torch.ops``: ``work(args,
kwargs, out)`` gives the bytes and instructions that the function needs on
the call's operands (``args``, ``kwargs``) and results (``out``): each
input byte read once, each output byte written once, and per pair of a
sweep the fewest instructions its formula needs.  The count follows what
the function computes, not how a kernel computes it."""
