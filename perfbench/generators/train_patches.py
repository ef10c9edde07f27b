"""Saliency-net training (stage 1): ``SaliencyTrainer.train_step`` on
batches of seeded patches made on the device, drawn in turn from a pool.

Traffic parameters (``traffic/<mix>.json``): ``pool``, the labelled blob's
voxel count of each patch (consecutive patches form a batch of the
configuration's batch size); ``checked_steps``, the first steps, taken in
set-up on batches that all differ, which the reference follows;
``trace``, the steps run under the profiler after the window.

Set-up builds the trainer and its state (model and momentum SGD) in the
configuration's training precision, fills the weights from the seed on
the device, makes the pool and runs the checked steps through
``train_step`` itself; that same state goes on into the window.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .. import device as device_mod
from .. import phantoms, spans as spans_mod, weights
from ..reference import judge_train, saliency
from ..reference.precision import strict_f32
from .serve_volumes import _tuples
from .train_points import _norm


def build(cfg: dict, seed: int, dev, bf16: bool = False):
    from pointunet_tpu_torch.core.config import SaliencyConfig
    from pointunet_tpu_torch.train.saliency import SaliencyTrainer

    scfg = SaliencyConfig(**_tuples(cfg["saliency"]))
    if bf16:
        scfg = dataclasses.replace(scfg, use_bfloat16=True)
    trainer = SaliencyTrainer(scfg, device=str(dev))
    state = trainer.init_state()
    w0 = {k: v.clone() for k, v in
          weights.fill(state.model, weights.sub_seed(seed, 1)).items()}
    return trainer, state, w0


def pool(cfg: dict, traffic: dict, seed: int, dev):
    g = torch.Generator(device=dev).manual_seed(weights.sub_seed(seed, 3))
    b = cfg["saliency"]["batch_size"]
    sizes = traffic["pool"]
    return [phantoms.patches(cfg, b, sizes[i:i + b], g, dev)
            for i in range(0, len(sizes), b)]


def first_steps(state, w0, steps: int, step) -> dict:
    """Run ``steps`` steps through ``step(i)``: the losses, the first
    gradient as momentum SGD took it (its trace after one step), each
    leaf's change after them, and the logits of the first patch's forward."""
    losses, grads, first = [], None, []
    hook = state.model.register_forward_hook(
        lambda _m, _i, out: first.append(out.detach().clone()) if not first else None)
    for i in range(steps):
        losses.append(float(step(i)["loss"]))
        hook.remove()
        if grads is None:
            grads = {k: _norm(state.optimizer.state[p].get("momentum_buffer"))
                     for k, p in state.model.named_parameters()}
    update = {k: float((p.detach() - w0[k]).norm())
              for k, p in state.model.named_parameters()}
    return {"losses": losses, "grad_norms": grads, "update_norms": update,
            "logits0": first[0]}


def run(cell) -> dict:
    cfg, traffic, seed, dev = cell.cfg, cell.traffic, cell.seed, cell.device
    trainer, state, w0 = build(cfg, seed, dev)
    phases = {"built": time.perf_counter() - cell.t0}
    batches = pool(cfg, traffic, seed, dev)
    phases["pool"] = time.perf_counter() - cell.t0
    sp = spans_mod.Spans(timed=cell.trace)
    mark = (lambda name: sp.mark(f"mark.{name}")) if cell.trace else None

    def step(i: int):
        return trainer.train_step(state, *batches[i % len(batches)], mark=mark)[1]

    checked = traffic["checked_steps"]
    port = first_steps(state, w0, checked, step)
    device_mod.sync(dev)
    setup_s = time.perf_counter() - cell.t0

    steps, start = 0, time.perf_counter()
    while time.perf_counter() - start < cell.seconds:
        sp.begin()
        step(checked + steps)
        steps += 1
    device_mod.sync(dev)
    window_s = time.perf_counter() - start
    peak = device_mod.peak(dev)
    out = {
        "phases": phases, "attempted": steps, "failed": 0, "errors": [], "setup_s": setup_s,
        "peak": peak,
        "e2e": {"train_step_ms": window_s * 1e3 / steps, "setup_s": setup_s},
        "record": {"step_s": window_s / steps, "path": "train_saliency",
                   "work": cell.counter.train_saliency(cfg), "cfg": cfg},
    }
    if cell.trace:
        out["record"]["rows"] = sp.rows()
        prof = spans_mod.profile(lambda: step(0), traffic["trace"])
        out["profile"] = out["record"]["profile"] = prof
    del trainer, state
    device_mod.release(dev)
    with strict_f32():
        ref = saliency.train_steps(cfg, w0, batches[:checked])
    out["checks"] = judge_train.judge(port, ref)
    return out
