"""Host ms a served request spends copying its labels back to the host,
after the host has waited for the device: the program's own span
``serve.copy_out`` (``FusedPointUnet.segment_volume``, around
``.cpu().numpy()``), read from its tracer
(``pointunet_tpu_torch.core.trace``), mean over the window's requests
(its last serve records that no profiler saw). None where the program
has no tracer."""


def read(run):
    try:
        from pointunet_tpu_torch.core import trace
    except ImportError:
        return None
    return trace.window_mean("serve", len(run["walls"]),
                             lambda r: trace.span_ms(r, "serve.copy_out"))
