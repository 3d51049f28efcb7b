"""Host syncs per train step: ``torch.cuda.set_sync_debug_mode``'s warnings
over one loop call, per train step."""


def read(ctx):
    return ctx.syncs_per_train_step
