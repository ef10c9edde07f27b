"""The readers of the program's own spans and counters
(``metrics/copy_in_ms.serve.py`` and the others that read
``pointunet_tpu_torch.core.trace``), on a tiny cell on the CPU: each
reads the window's records and leaves out those a profiler saw after it."""
import copy

import pytest
import torch

from perfbench import manifest, run
from perfbench.tests import tiny

SEED = 2 ** 31 + 17
SERVE = {"copy_in_ms.serve": ("span", "serve.copy_in"),
         "copy_out_ms.serve": ("span", "serve.copy_out"),
         "relabel_ms.serve": ("span", "serve.relabel"),
         "host_syncs.serve": ("counter", "host_sync")}
TRAIN = {"update_ms.train": "train.update",
         "gather_backward_ms.train": "gather.backward"}


def _cell(name):
    """The generator's record of a tiny CPU run of cell ``name``, and the
    cell."""
    w = manifest.workload(manifest.load(), name)
    cfg, traffic = tiny.config(w["config"]), tiny.traffic(w["traffic"])
    cell = run.Cell(name, cfg, traffic,
                    manifest.module("counters", cfg["counter"]), SEED, 0.3,
                    False, torch.device("cpu"), 0.0)
    out = manifest.module("generators", traffic["generator"]).run(cell)
    return out, cell


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        fn()


def _mean(values):
    return sum(values) / len(values)


def test_serve_readers_read_the_window_and_skip_profiled_records():
    from perfbench.generators import serve_volumes
    from pointunet_tpu_torch.core import trace

    out, cell = _cell("brats.serve")
    record = out["record"]
    n = len(record["walls"])
    window = [r for r in trace.records() if r["kind"] == "serve"][-n:]
    pipe, _ = serve_volumes.build(cell.cfg, SEED, cell.device)
    volume = serve_volumes.pool(cell.cfg, cell.traffic, SEED, cell.device)[0]
    _profiled(lambda: pipe.segment_volume(volume, seed=1))
    assert trace.records()[-1]["profiled"]
    for metric, (what, name) in SERVE.items():
        value = manifest.module("metrics", metric).read(record)
        if what == "span":
            want = _mean([trace.span_ms(r, name) for r in window])
        else:
            want = _mean([r["counters"][name] for r in window])
        assert value == pytest.approx(want, rel=1e-12), metric
    # the copy in, the ROI's 6 reads, the sampler's, 5 pyramid levels and
    # the copy out (no level of 2,048 points takes the grid search; the
    # wait for the labels is a sync on a card alone)
    assert manifest.module("metrics", "host_syncs.serve").read(record) == 14


def test_train_readers_read_device_spans_and_skip_profiled_records(monkeypatch):
    from perfbench.generators import train_points
    from pointunet_tpu_torch.core import trace
    from pointunet_tpu_torch.ops import scatter_sorted

    monkeypatch.setattr(scatter_sorted, "TIMED_EVERY", 1)
    out, cell = _cell("brats.train_point")
    record = dict(out["record"], rows=[None] * out["attempted"])
    n = out["attempted"]
    trainer, state, _ = train_points.build(cell.cfg, SEED, cell.device)
    clouds = train_points.pool(cell.cfg, cell.traffic, SEED, cell.device)
    _profiled(lambda: trainer.train_step(state, *clouds[0]))
    for metric in TRAIN:      # off the card, no device time is read
        assert manifest.module("metrics", metric).read(record) is None

    # the same records as if timed on the card: the window's spans read
    # their host ms, the profiled step's a value far off; as where the
    # gather backwards are spans in one step of several, the last step
    # alone keeps them
    last = trace.records()[-2]["id"]

    def timed(rec):
        rec = copy.deepcopy(rec)
        if rec["id"] < last:
            rec["spans"] = [s for s in rec["spans"]
                            if s["name"] != "gather.backward"]
        for s in rec["spans"]:
            s["device_ms"] = 1e9 if rec["profiled"] else s["host_ms"]
        return rec
    recs = [timed(r) for r in trace.records()]
    assert recs[-1]["profiled"] and recs[-1]["kind"] == "train_point"
    window = [r for r in recs if r["kind"] == "train_point"
              and not r["profiled"]][-n:]
    monkeypatch.setattr(trace, "records", lambda: recs)
    for metric, name in TRAIN.items():
        value = manifest.module("metrics", metric).read(record)
        device = [trace.span_ms(r, name, "device") for r in window]
        want = _mean([v for v in device if v is not None])
        assert value == pytest.approx(want, rel=1e-12), metric
        assert value < 1e6
    assert [r["id"] for r in window
            if trace.span_ms(r, "gather.backward") is not None] == [last]


def test_readers_return_none_without_records():
    for metric in list(SERVE) + list(TRAIN):
        reader = manifest.module("metrics", metric)
        assert reader.read({"walls": [], "rows": []}) is None, metric
