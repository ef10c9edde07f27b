"""Host ms a served request spends copying its volume to the card: the
program's own span ``serve.copy_in`` (``FusedPointUnet.segment_volume``,
around ``torch.as_tensor(..., device=)``), read from its tracer
(``pointunet_tpu_torch.core.trace``), mean over the window's requests
(its last serve records that no profiler saw). None where the program
has no tracer."""


def read(run):
    try:
        from pointunet_tpu_torch.core import trace
    except ImportError:
        return None
    return trace.window_mean("serve", len(run["walls"]),
                             lambda r: trace.span_ms(r, "serve.copy_in"))
