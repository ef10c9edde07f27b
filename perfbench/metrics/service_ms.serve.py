"""Host-side ms of a served request outside the four stages: the request's
wall (``segment_volume``: the volume's copy to the card, the transposes,
the labels' copy back) less its four stage spans, mean over the window."""
import math

from perfbench.readings import mean
from perfbench.spans import span_ms

STAGES = ("attention", "sampling", "pyramid", "pointseg")


def read(run):
    rows = run.get("rows") or []
    return mean(w * 1e3 - sum(span_ms(r, s) for s in STAGES)
                for w, r in zip(run["walls"], rows) if math.isfinite(w))
