"""Host syncs a served request: the program's own counter ``host_sync``,
one for each call on the request path that blocks the host until the
device reaches it (the volume's pageable copy in, the ROI's reads, the
sampler's grid size copied in, two a cell-window search's ``bincount``,
the pyramid's ``nonzero`` a level, the wait for the labels and their
copy out), read from its tracer (``pointunet_tpu_torch.core.trace``), mean
over the window's requests (its last serve records that no profiler
saw). None where the program has no tracer."""


def read(run):
    try:
        from pointunet_tpu_torch.core import trace
    except ImportError:
        return None
    return trace.window_mean("serve", len(run["walls"]),
                             lambda r: r["counters"].get("host_sync"))
