"""Device ms of a point-net train step's gather backwards, summed over the
step: the program's own spans ``gather.backward`` (CUDA events around
each ``SortedGather.backward``: kernel 2 and its preparation above the
size gate, ``gather.row_sum`` below it), read from its tracer
(``pointunet_tpu_torch.core.trace``), mean over the window's steps (its
last ``train_point`` records that no profiler saw). None where the
program has no tracer or the step ran off the card."""


def read(run):
    try:
        from pointunet_tpu_torch.core import trace
    except ImportError:
        return None
    return trace.window_mean("train_point", len(run.get("rows") or ()),
                             lambda r: trace.span_ms(r, "gather.backward", "device"))
