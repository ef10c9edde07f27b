"""The port's tracer (pointunet_tpu_torch/core/trace.py) and the spans and
counters the port records with it, on the CPU at tiny sizes: records,
nesting, the ring, counters, the ``serve``, ``train_point`` and
``train_saliency`` records, the profiler ranges, and the benchmark's own
spans over a traced pipeline."""
import time

import numpy as np
import pytest
import torch

from pointunet_tpu_torch.core import trace
from pointunet_tpu_torch.core.config import (
    brats_pointseg_config,
    brats_saliency_config,
)
from pointunet_tpu_torch.models.randlanet import init_randlanet
from pointunet_tpu_torch.models.saliency_unet import init_saliency_unet
from pointunet_tpu_torch.ops import scatter_sorted
from pointunet_tpu_torch.pipeline.fused import FusedPointUnet

torch.set_num_threads(1)

SERVE_SPANS = ("serve.copy_in", "serve.attention", "serve.sampling",
               "serve.pyramid", "serve.pointseg", "serve.wait",
               "serve.copy_out", "serve.relabel")
VOLUME = (40, 36, 20)          # (X, Y, Z)
N = 2048


def _names(record):
    return [s["name"] for s in record["spans"]]


def test_spans_nest_with_parent_and_request_id():
    tr = trace.Tracer()
    with tr.request("serve") as rid:
        with tr.span("outer"):
            with tr.span("inner"):
                time.sleep(0.002)
            with tr.request("serve") as joined:      # joins the open record
                with tr.span("second"):
                    pass
        with tr.span("top"):
            pass
    with tr.span("no record"):                       # records nothing
        pass
    (rec,) = tr.records()
    assert joined == rid == rec["id"] and rec["kind"] == "serve"
    assert not rec["profiled"]
    assert _names(rec) == ["outer", "inner", "second", "top"]
    assert [s["parent"] for s in rec["spans"]] == [None, 0, 0, None]
    assert {s["request"] for s in rec["spans"]} == {rid}
    outer, inner = rec["spans"][:2]
    assert outer["start_ns"] <= inner["start_ns"] < inner["end_ns"] <= outer["end_ns"]
    assert inner["host_ms"] >= 2.0 and inner["device_ms"] is None
    assert trace.span_ms(rec, "inner") == inner["host_ms"]
    assert trace.span_ms(rec, "inner", "device") is None
    assert trace.span_ms(rec, "missing") is None


def test_a_failed_request_closes_its_record():
    tr = trace.Tracer()
    with pytest.raises(ValueError):
        with tr.request("serve"):
            with tr.span("a"):
                raise ValueError("no")
    with tr.request("serve"):
        with tr.span("b"):
            pass
    first, second = tr.records()
    assert _names(first) == ["a"] and _names(second) == ["b"]
    assert second["spans"][0]["parent"] is None


def test_ring_keeps_its_last_records(monkeypatch):
    tr = trace.Tracer()
    for i in range(trace.RING + 6):
        with tr.request("train_point" if i % 2 else "serve"):
            tr.count("step", i)
    recs = tr.records()
    assert len(recs) == trace.RING == 1024
    assert [r["id"] for r in recs] == list(range(7, trace.RING + 7))
    assert recs[-1]["counters"] == {"step": trace.RING + 5}
    monkeypatch.setattr(trace, "records", tr.records)
    last = trace.window("serve", 3)
    assert [r["id"] for r in last] == [trace.RING + 1, trace.RING + 3, trace.RING + 5]


def test_counters_add_per_record_and_in_total():
    tr = trace.Tracer()
    tr.count("host_sync", 3)                  # no record open: total only
    with tr.request("serve"):
        tr.count("host_sync")
        tr.count("host_sync", 2)
        tr.count("gather_backward")
    with tr.request("serve"):
        tr.count("host_sync")
    a, b = tr.records()
    assert a["counters"] == {"host_sync": 3, "gather_backward": 1}
    assert b["counters"] == {"host_sync": 1}
    totals = tr.totals()
    assert totals["host_sync"] == 7 and totals["gather_backward"] == 1
    assert set(totals["launches"]) == {"knn_cell_window", "scatter_sorted",
                                       "conv3d_3x3", "windowed_scatter"}


def test_window_mean_leaves_out_profiled_records(monkeypatch):
    recs = [{"kind": "serve", "profiled": p, "spans": [], "counters": {"n": v}}
            for p, v in ((False, 1), (False, 2), (False, 4), (True, 100))]
    monkeypatch.setattr(trace, "records", lambda: recs)

    def n(r):
        return r["counters"]["n"]
    assert trace.window_mean("serve", 2, n) == 3.0
    assert trace.window_mean("serve", 5, n) == 7 / 3
    assert trace.window_mean("serve", 0, n) is None
    assert trace.window_mean("train_point", 2, lambda r: 1.0) is None


@pytest.fixture(scope="module")
def models():
    scfg = brats_saliency_config()
    pcfg = brats_pointseg_config(num_points=N)
    sal = init_saliency_unet(scfg, torch.Generator().manual_seed(0))
    pnt = init_randlanet(pcfg, torch.Generator().manual_seed(1))
    return sal, pnt, scfg, pcfg


def _volume():
    vol = np.random.default_rng(0).normal(size=(4,) + VOLUME).astype(np.float32)
    vol[:, :3] = 0                           # a margin outside the brain
    return vol


# the host syncs of a request: the volume's pageable copy in, 2 a ROI axis
# (its first and last brain voxel), the sampler's grid size copied in, 2 a
# cell-window search (``bincount``'s min and max), 1 a pyramid level
# (``nonzero``) and the labels' copy out; on a card also the wait for the
# labels (``test_host_sync_counter_matches_cuda_sync_debug_mode``); with
# the grid threshold at 512, level 0 (2,048 points) takes the cell-window
# search
@pytest.mark.parametrize("roi,grid,syncs", [
    ((32, 32, 16), None, 1 + 6 + 1 + 5 + 1),
    (None, 512, 1 + 1 + 2 * 2 + 5 + 1),
])
def test_segment_volume_leaves_one_serve_record(models, monkeypatch, roi, grid,
                                                syncs):
    from pointunet_tpu_torch.ops import pyramid

    if grid is not None:
        monkeypatch.setattr(pyramid, "GRID_THRESHOLD", grid)
    pipe = FusedPointUnet(*models, threshold=0.5, volume_shape=VOLUME,
                          roi_shape=roi, device="cpu")
    before = len(trace.records())
    labels = pipe.segment_volume(_volume(), seed=3)
    recs = trace.records()
    rec = recs[-1]
    assert len(recs) == min(before + 1, trace.RING)
    assert labels.shape == VOLUME
    assert rec["kind"] == "serve" and not rec["profiled"]
    assert _names(rec) == list(SERVE_SPANS)
    assert all(s["parent"] is None for s in rec["spans"])
    assert all(s["device_ms"] is None and s["host_ms"] > 0 for s in rec["spans"])
    assert rec["counters"] == {"host_sync": syncs}
    assert set(trace.split_ms(rec)) == set(SERVE_SPANS)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA's sync debug mode counts the "
                    "syncs of a served request at the cell's size")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("config", ["brats", "pancreas"])
def test_host_sync_counter_matches_cuda_sync_debug_mode(card, config):
    """The record's ``host_sync`` of a warm request, as the benchmark's
    serve cell builds and sends it, is the number of synchronizing CUDA
    calls that CUDA's sync debug mode reports in that request."""
    import warnings

    from perfbench import manifest
    from perfbench.generators import serve_volumes

    cfg = manifest.read_json("configs", config)
    traffic = manifest.read_json("traffic", "serve")
    pipe, _ = serve_volumes.build(cfg, 11, card)
    volume = serve_volumes.pool(cfg, traffic, 11, card)[0]
    brats = cfg["serve"]["brats_labels"]
    for _ in range(2):
        pipe.segment_volume(volume, seed=5, brats_labels=brats)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pipe.segment_volume(volume, seed=5, brats_labels=brats)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    counted = trace.records()[-1]["counters"]["host_sync"]
    assert syncs > 0 and counted == syncs, (counted, [
        f"{w.filename}:{w.lineno}" for w in caught])


def _cloud(n):
    rng = np.random.default_rng(1)
    xyz = rng.uniform(0, 1, (1, n, 3)).astype(np.float32)
    feats = np.concatenate([xyz, rng.normal(size=(1, n, 4)).astype(np.float32)], -1)
    labels = rng.integers(0, 4, (1, n)).astype(np.int64)
    return xyz, feats, labels


@pytest.mark.parametrize("every", [1, 10 ** 9])
def test_point_train_step_leaves_one_record(monkeypatch, every):
    from pointunet_tpu_torch.train.pointseg import PointSegTrainer

    monkeypatch.setattr(scatter_sorted, "TIMED_EVERY", every)
    calls = []
    real = scatter_sorted.row_sum

    def row_sum(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(scatter_sorted, "row_sum", row_sum)
    trainer = PointSegTrainer(brats_pointseg_config(num_points=N, d_out=(8, 8, 8, 8, 8)),
                              device="cpu")
    state = trainer.init_state()
    trainer.train_step(state, *_cloud(N))
    rec = trace.records()[-1]
    assert rec["kind"] == "train_point"
    top = [s["name"] for s in rec["spans"] if s["parent"] is None]
    assert top == ["train.pyramid", "train.forward_loss", "train.backward",
                   "train.update"]
    backward = _names(rec).index("train.backward")
    gathers = [s for s in rec["spans"] if s["name"] == "gather.backward"]
    assert len(calls) > 0
    assert rec["counters"]["gather_backward"] == len(calls)
    # a span each in one record of every TIMED_EVERY, none in the others
    assert len(gathers) == (len(calls) if rec["id"] % every == 0 else 0)
    assert all(s["parent"] == backward for s in gathers)
    assert rec["counters"]["host_sync"] == 5          # the pyramid's levels


def test_saliency_train_step_records_its_parts_at_its_marks():
    from pointunet_tpu_torch.train.saliency import SaliencyTrainer

    cfg = brats_saliency_config(patch_size=(16, 16, 16), batch_size=2,
                                remat=False)
    trainer = SaliencyTrainer(cfg, device="cpu")
    state = trainer.init_state()
    rng = np.random.default_rng(2)
    images = rng.normal(size=(2, 16, 16, 16, 4)).astype(np.float32)
    weights = np.ones((2, 16, 16, 16), np.float32)
    labels = rng.integers(0, 2, (2, 16, 16, 16))
    marks = []
    trainer.train_step(state, images, weights, labels, mark=marks.append)
    rec = trace.records()[-1]
    assert marks == ["prepare", "forward_loss", "backward", "forward_loss",
                     "backward", "optimizer"]
    assert rec["kind"] == "train_saliency"
    assert _names(rec) == ["train.forward_loss", "train.backward",
                           "train.forward_loss", "train.backward",
                           "train.update"]
    assert rec["counters"] == {"host_sync": 1}


def test_ranges_open_only_under_a_profiler(models, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    pipe = FusedPointUnet(*models, threshold=0.5, volume_shape=VOLUME,
                          roi_shape=(32, 32, 16), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.segment_volume(_volume(), seed=3)
    assert trace.records()[-1]["profiled"]
    names = {e.name for e in prof.events()}
    assert set(SERVE_SPANS) <= names
    assert {"saliency.encoder", "saliency.encoder.block0", "saliency.cfe_c3",
            "saliency.sa", "saliency.head"} <= names

    def refuse(name):
        raise AssertionError(f"a range {name!r} opened with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    pipe.segment_volume(_volume(), seed=3)
    assert not trace.records()[-1]["profiled"]


class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the CPU: the host clock;
    ``made`` counts the events made, ``passed`` says whether the device
    has reached them."""
    made = 0
    passed = True

    def __init__(self, enable_timing=True):
        self.t = None
        _HostEvent.made += 1

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self):
        return _HostEvent.passed

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _host_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    monkeypatch.setattr(trace.Tracer, "_stream", lambda self: None)
    monkeypatch.setattr(_HostEvent, "made", 0)
    monkeypatch.setattr(_HostEvent, "passed", True)


def test_device_spans_reuse_their_events(monkeypatch):
    _host_events(monkeypatch)
    tr = trace.Tracer()

    def step():
        with tr.request("train_point"):
            for name in ("a", "b", "c"):
                with tr.span(name, device=True):
                    time.sleep(0.001)
            with tr.span("host"):
                pass
    for _ in range(5):
        step()
    assert _HostEvent.made == 6                 # the first record's alone
    _HostEvent.passed = False                   # the device falls behind:
    for _ in range(3):                          # the pool's 6, then new ones,
        step()                                  # and nothing read
    assert _HostEvent.made == 6 * 3
    recs = tr.records()                         # waits, reads, pools them
    _HostEvent.passed = True
    step()
    assert _HostEvent.made == 6 * 3
    recs = tr.records()
    assert len(recs) == 9
    for rec in recs:
        assert [s["device_ms"] is not None for s in rec["spans"]] == [
            True, True, True, False]
        assert all(s["device_ms"] >= 1.0 for s in rec["spans"][:3])
        assert trace.span_ms(rec, "b", "device") == rec["spans"][1]["device_ms"]


def test_records_the_ring_drops_give_back_their_events(monkeypatch):
    _host_events(monkeypatch)
    _HostEvent.passed = False                   # the device far behind

    def serve():
        with tr.request("serve"):
            with tr.span("a", device=True):
                pass
    tr = trace.Tracer()
    for _ in range(trace.RING + 3):
        serve()
    assert _HostEvent.made == 2 * (trace.RING + 3)
    recs = tr.records()
    assert len(recs) == trace.RING
    assert all(r["spans"][0]["device_ms"] is not None for r in recs)
    for _ in range(trace.RING + 3):             # every pair is back
        serve()
    assert _HostEvent.made == 2 * (trace.RING + 3)


def test_a_span_of_every_k_records():
    tr = trace.Tracer()
    for _ in range(12):
        with tr.request("train_point"):
            with tr.request("train_point"):      # a joined request: the same
                with tr.span("often", every=4):
                    pass
            with tr.span("always"):
                pass
    recs = tr.records()
    assert [r["id"] for r in recs if "often" in _names(r)] == [4, 8, 12]
    assert all(_names(r)[-1] == "always" for r in recs)


def test_harness_spans_still_wrap_a_traced_pipeline(models, monkeypatch):
    from perfbench.generators.serve_volumes import STAGES
    from perfbench.spans import Spans, span_ms

    _host_events(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    pipe = FusedPointUnet(*models, threshold=0.5, volume_shape=VOLUME,
                          roi_shape=(32, 32, 16), device="cpu")
    sp = Spans(timed=True)
    for method, name in STAGES:
        sp.wrap(pipe, method, name)
    sp.capture = {}
    for seed in (3, 4):
        sp.begin()
        pipe.segment_volume(_volume(), seed=seed)
    rows = sp.rows()
    assert len(rows) == 2
    for row in rows:
        assert [label for label, _ in row] == ["begin"] + [
            f"{n}.{end}" for _, n in STAGES for end in ("start", "end")]
        assert all(span_ms(row, n) > 0 for _, n in STAGES)
    assert set(sp.capture) == {n for _, n in STAGES}
    rec = trace.records()[-1]
    assert _names(rec) == list(SERVE_SPANS)
    assert trace.span_ms(rec, "serve.attention") >= span_ms(rows[-1], "attention")
