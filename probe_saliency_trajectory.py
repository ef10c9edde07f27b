"""Train the reference's saliency net and the port's side by side on the
CPU, step by step, from the reference's own initial draw: how far the two
trajectories part, beside how far rounding alone parts two runs of the
port.

    PYTHONPATH= JAX_PLATFORMS=cpu python probe_saliency_trajectory.py \
        [--dataset brats|pancreas] [--steps 20] [--bf16] [--no_port] \
        [--contract] [--save DIR [--save_at K ...]] [--dice_every N]
    PYTHONPATH= JAX_PLATFORMS=cpu python probe_saliency_trajectory.py \
        --forward --params FILE [--dataset brats|pancreas] [--maps DIR]

The setup of the reference bench's accuracy presets, reduced task
(``bench.py:bench_accuracy``, ``bench_accuracy_pancreas``): the seeded
synthetic volumes from ``default_rng(0)``, the full-width net
(base_filter 16, remat) at patch (32, 96, 96), batch 1, lr 0.01, f32
(``--bf16``: ``use_bfloat16`` on both sides), the reference trainer's
``init_state()`` (the draw ``export_jax_checkpoint.py --init 0``
writes), the batches of ``patch_batches(..., default_rng(1),
"one_positive")``, each fed to both sides.

The reference's step is ``reference_step``: its trainer's pieces
(``model.apply`` and ``saliency_dice_loss`` under ``jax.value_and_grad``,
then ``tx.update`` and ``optax.apply_updates``) in one ``jax.jit``, the
arithmetic of its ``train_step`` at batch 1 without the ``lax.scan``
around the gradient, whose compile stalls XLA:CPU
(tests/test_torch_reference_step.py holds the two equal). The port's
step is its ``SaliencyTrainer.train_step`` on the CPU; a second port run
(the control) starts from the same draw with every weight moved by one
f32 ulp (``np.nextafter``). Each step prints the three losses, the
relative distance of the port's parameters from the reference's, the
control's from the port's, and the mask Dice (softmax >= 0.5 against
the label; every ``--dice_every`` steps and at the last) of the reference
and the port on the central patch of the first held-out volume, and the gradients' distances (port from
reference, control from port). At the first step where the distance to
the reference exceeds 10x the control's it prints each parameter leaf's
gradient distance |g_port - g_ref| / |g_ref| beside the control's,
largest first, and (off the contract) each gradient's distance from
the f64 gradient of the same weights and batch (the port's net copied
to f64). Distances leave out the conv biases that feed an
instance norm (their gradient is zero analytically). The last
line is one JSON object of it all. ``--no_port`` trains the reference
alone (for a long run to export); ``--save DIR`` saves its trained state
with the JAX package's ``BestMetricCheckpointer`` for
``export_jax_checkpoint.py --src DIR --stage saliency``.

``--contract`` takes the accuracy contract's task instead
(``cli/accuracy.py --acc_full``: the (64, 160, 160) patch, the
(240, 240, 155) / (256, 256, 160) volumes); ``--patch``, ``--shape``
and ``--base_filter`` cut a run to size (the tests'). Off the contract
a run also reports step 0's gradients' distances from the f64 gradient
(``from_f64_step0``: the reference's, the port's, the control's); at
the contract's patch the CPU's f64 convolutions would need ~68 GB, so
``probe_contract_step.py`` takes the f64 gradient on the card. ``--save
DIR`` writes, besides the orbax state after each step ``k`` of
``--save_at`` (as step k + 1; default the last step), what that probe
reads: the reference's draw as ``DIR/init/0.npz``
(``export_jax_checkpoint.py --init``'s form), its parameters after step
k (``ref_params_<k>.npz``, flat ``params/...`` f32), step 0's gradients
of the reference and the port (``grads_0.npz``, ``reference/params/...``
and ``port/params/...``; with the port) and the last line
(``trajectory.json``).

``--forward --params FILE``: held-out volume 0 of the task through the
attention stage as the fused path runs it (the Pancreas volume whole,
the BraTS ROI padded to the net's stride; gate stride 1, threshold
0.5) with the flat reference parameters of ``FILE`` (a
``ref_params_<k>.npz``): the reference (``SaliencyUNet.apply``) and the
port (``FusedPointUnet``'s stage), each in f32 and in bf16, the port
beside controls whose weights are moved by one f32 ulp and (bf16) one
bf16 ulp. Prints each map's voxels above the threshold, the port's
probability distance and mask Dice against the reference's and the
controls' against the port's; ``--maps DIR`` writes the reference's
maps (``forward_ref.npz``: the f32 map's probabilities as f32, the
bf16 map's as f16, masks exact) for ``probe_contract_step.py --forward
--ref_maps``, which holds them to the card's f64 map.

Run one JAX process at a time, with an empty ``PYTHONPATH``; the port
never imports this file.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))

from pointunet_tpu.core.checkpoint import BestMetricCheckpointer  # noqa: E402
from pointunet_tpu.core.config import TrainConfig  # noqa: E402
from pointunet_tpu.core.config import brats_pointseg_config as ref_bp  # noqa: E402
from pointunet_tpu.core.config import brats_saliency_config as ref_brats  # noqa: E402
from pointunet_tpu.core.config import pancreas_pointseg_config as ref_pp  # noqa: E402
from pointunet_tpu.core.config import pancreas_saliency_config as ref_pancreas  # noqa: E402
from pointunet_tpu.data.sampler import patch_batches  # noqa: E402
from pointunet_tpu.models.losses import saliency_dice_loss  # noqa: E402
from pointunet_tpu.pipeline.fused import FusedPointUnet as RefFused  # noqa: E402
from pointunet_tpu.train.saliency import SaliencyTrainer as RefTrainer  # noqa: E402
from pointunet_tpu_torch.cli import accuracy  # noqa: E402
from pointunet_tpu_torch.convert import convert_saliency_train_state  # noqa: E402
from pointunet_tpu_torch.core import config as port_config  # noqa: E402
from pointunet_tpu_torch.models.fastconv import Conv  # noqa: E402
from pointunet_tpu_torch.train.saliency import (  # noqa: E402
    SaliencyTrainer,
    SaliencyTrainState,
)
from export_jax_checkpoint import flatten_state  # noqa: E402
from probe_contract_step import (  # noqa: E402
    THRESHOLD,
    attention,
    compare,
    contract_task,
    mods_volume,
    prob_dist,
    save_maps,
)
from test_torch_saliency_train import BIAS_BEFORE_NORM, _flat_state  # noqa: E402
from torch_parity import named_to_flax_flat  # noqa: E402

DEPART = 10.0          # the distance to the reference over the control's


def reference_step(trainer):
    """One jitted update of the reference trainer at batch 1: (params,
    opt_state, images, weights, labels) -> (params, opt_state, loss,
    grads), ``train_step``'s arithmetic without its scan."""
    def loss_fn(params, images, weights, labels):
        logits = trainer.model.apply({"params": params}, images, train=True)
        return saliency_dice_loss(logits, weights, labels)

    def step(params, opt_state, images, weights, labels):
        loss, grads = jax.value_and_grad(loss_fn)(params, images, weights,
                                                  labels)
        updates, opt_state = trainer.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    return jax.jit(step)


def _flat_state_params(params) -> dict:
    from flax.traverse_util import flatten_dict
    return {f"params/{k}": np.asarray(v, np.float64)
            for k, v in flatten_dict(params, sep="/").items()}


def _port_flat(model, grads: bool = False) -> dict:
    named = ({n: p.grad for n, p in model.named_parameters()} if grads
             else dict(model.named_parameters()))
    return {k: np.asarray(v, np.float64)
            for k, v in named_to_flax_flat(named).items()}


def f64_gradient(trainer, model, images, weights, labels) -> dict:
    """The port's gradient of one batch in f64 from ``model``'s weights
    (its convs' casts off): the step's gradient without rounding."""
    model = model.double()
    for m in model.modules():
        if isinstance(m, Conv):
            m.dtype = None
    images, weights, labels = trainer.prepare(images, weights, labels)
    trainer.forward_loss(SaliencyTrainState(model, None, 0),
                         images.double(), weights.double(),
                         labels).backward()
    return _port_flat(model, grads=True)


def rel_dist(a: dict, b: dict) -> float:
    """|a - b| / |b| over all leaves of ``b``."""
    b = {k: v for k, v in b.items() if not BIAS_BEFORE_NORM.search(k)}
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    return float(np.sqrt(num / sum(float((b[k] ** 2).sum()) for k in b)))


def leaf_dists(a: dict, b: dict, c: dict) -> list:
    """[(leaf, |a - b| / |b|, |c - a| / |a|)] largest first."""
    def d(x, y):
        return float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30))

    out = [(k, d(a[k], b[k]), d(c[k], a[k])) for k in b
           if not BIAS_BEFORE_NORM.search(k)]
    return sorted(out, key=lambda kv: -kv[1])


def mask_dice(prob1: np.ndarray, label: np.ndarray) -> float:
    m = prob1 >= 0.5
    t = label > 0
    denom = m.sum() + t.sum()
    return float(2 * (m & t).sum() / denom) if denom else 1.0


def central_patch(vol, seg, patch, dataset):
    """(1, D, H, W, C) image and (D, H, W) label at the centre of a held-out
    (modalities, labels) pair, in the sampler's layout."""
    img = np.transpose(vol, (3, 2, 1, 0))                # (Z, Y, X, C)
    lab = np.transpose(seg, (2, 1, 0))
    lab = (lab > 0 if dataset == "brats" else lab).astype(np.int32)
    lo = [(n - p) // 2 for n, p in zip(lab.shape, patch)]
    sl = tuple(slice(s, s + p) for s, p in zip(lo, patch))
    return img[sl][None].astype(np.float32), lab[sl]


def _save_params(path: str, params) -> None:
    np.savez(path, **{k: v.astype(np.float32)
                      for k, v in _flat_state_params(params).items()})


def ref_attention(trainer, params, mods: np.ndarray, task) -> tuple:
    """The reference's fused attention stage on ``mods`` (C, X, Y, Z):
    (probabilities over the ROI (Z, Y, X) f32, the (X, Y, Z) mask), the
    crop, pad and softmax of ``pointunet_tpu/pipeline/fused.py``'s
    ``attention_mask`` at gate stride 1 with no downscale, the mask the
    probabilities >= ``THRESHOLD`` (tests/test_torch_contract_probe.py
    holds it to the stage's own)."""
    x, y, z = task.shape
    rx, ry, rz = task.roi or task.shape
    pad = [-(-v // 16) * 16 for v in (rz, ry, rx)]
    sx = sy = sz = 0
    if task.roi is not None:
        brain = np.any(mods != 0, axis=0)

        def start(present, size, r):
            idx = np.arange(size)
            first = np.min(np.where(present, idx, size))
            last = np.max(np.where(present, idx, -1))
            return int(np.clip((first + last + 1) // 2 - r // 2, 0,
                               max(size - r, 0)))

        sx = start(brain.any((1, 2)), x, rx)
        sy = start(brain.any((0, 2)), y, ry)
        sz = start(brain.any((0, 1)), z, rz)
    roi = mods[:, sx:sx + rx, sy:sy + ry, sz:sz + rz]
    vol = np.transpose(roi, (3, 2, 1, 0))
    vol = np.pad(vol, [(0, p - r) for p, r in zip(pad, (rz, ry, rx))]
                 + [(0, 0)])
    probs = jax.jit(lambda prm, v: jax.nn.softmax(trainer.model.apply(
        {"params": prm}, v[None], train=False)[0], -1)[..., 1])(
            params, jnp.asarray(vol))
    probs = np.asarray(probs, np.float32)[:rz, :ry, :rx]
    mask = np.zeros((x, y, z), bool)
    mask[sx:sx + rx, sy:sy + ry, sz:sz + rz] = np.transpose(
        probs >= THRESHOLD, (2, 1, 0))
    return probs, mask


def ref_pipe_mask(trainer, params, mods: np.ndarray, task,
                  brats: bool) -> np.ndarray:
    """The mask of the reference's own ``FusedPointUnet`` stage."""
    pipe = RefFused(trainer.model, {"params": params}, None, None,
                    trainer.cfg, (ref_bp if brats else ref_pp)(),
                    threshold=THRESHOLD, volume_shape=task.shape,
                    roi_shape=task.roi)
    return np.asarray(pipe._attention_mask(jnp.asarray(mods)))


def _ref_trainer(brats: bool, task, bf16: bool, base_filter=None):
    kw = dict(patch_size=task.patch, batch_size=1, base_lr=0.01,
              use_bfloat16=bf16)
    if base_filter is not None:
        kw["base_filter"] = base_filter
    return RefTrainer((ref_brats if brats else ref_pancreas)(**kw),
                      TrainConfig(donate_state=False)), kw


def forward(args, task) -> dict:
    """``--forward`` (see the module docstring)."""
    from flax.traverse_util import unflatten_dict

    brats = args.dataset == "brats"
    mods = mods_volume(args.dataset, task)
    with np.load(args.params) as z:
        flat = {k: z[k] for k in z.files if k.startswith("params/")}
    params = unflatten_dict({tuple(k.split("/")[1:]): jnp.asarray(v)
                             for k, v in flat.items()})
    cpu = torch.device("cpu")
    out = {"dataset": args.dataset, "roi": task.roi, "maps": []}

    def emit(row, got, *against):
        row.update(voxels=int(got[1].sum()),
                   seconds=time.perf_counter() - t0)
        for tag, base in against:
            row[f"vs_{tag}"] = compare(*got, base)
        out["maps"].append(row)
        print(json.dumps(row), flush=True)

    refs = {}
    for dtype in ("f32", "bf16"):
        trainer, _ = _ref_trainer(brats, task, dtype == "bf16",
                                  args.base_filter)
        t0 = time.perf_counter()
        ref = refs[f"ref_{dtype}"] = ref_attention(trainer, params, mods,
                                                   task)
        emit({"side": "reference", "dtype": dtype, "f16_storage_dist":
              prob_dist(ref[0].astype(np.float16).astype(np.float32),
                        ref[0])}, ref)
        port = None
        for control in (None, "f32") + (("bf16",) if dtype == "bf16"
                                         else ()):
            t0 = time.perf_counter()
            got = attention(args.dataset, task, flat, mods, cpu, dtype,
                            None, control, args.base_filter)
            against = [("reference", ref)] + ([("port", port)] if port
                                              else [])
            emit({"side": "port", "dtype": dtype, "control": control}, got,
                 *against)
            port = port or got
    out["ref_bf16_vs_ref_f32"] = compare(*refs["ref_bf16"], refs["ref_f32"])
    if args.maps:
        os.makedirs(args.maps, exist_ok=True)
        out["maps_file"] = os.path.join(args.maps, "forward_ref.npz")
        save_maps(out["maps_file"], refs, exact=("ref_f32",))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", choices=("brats", "pancreas"),
                   default="brats")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--no_port", action="store_true")
    p.add_argument("--contract", action="store_true",
                   help="the accuracy contract's task (--acc_full)")
    p.add_argument("--patch", type=int, nargs=3)
    p.add_argument("--shape", type=int, nargs=3)
    p.add_argument("--base_filter", type=int)
    p.add_argument("--save")
    p.add_argument("--save_at", type=int, nargs="+")
    p.add_argument("--dice_every", type=int, default=1)
    p.add_argument("--forward", action="store_true")
    p.add_argument("--params")
    p.add_argument("--maps")
    p.add_argument("--threads", type=int, default=os.cpu_count(),
                   help="torch's CPU threads (the tests' module pins 1)")
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    brats = args.dataset == "brats"
    task = contract_task(args.dataset, args.patch, args.shape, args.contract)
    if args.forward:
        out = forward(args, task)
        print(json.dumps(out), flush=True)
        return out
    trainer, kw = _ref_trainer(brats, task, args.bf16, args.base_filter)
    state = trainer.init_state()
    step_fn = reference_step(trainer)
    train_vols, test_vols = accuracy.make_volumes(args.dataset, task)
    records = accuracy.saliency_records(train_vols, args.dataset)
    batches = patch_batches(records, task.patch, 1, np.random.default_rng(1),
                            "one_positive")
    img, lab = central_patch(*test_vols[0], task.patch, args.dataset)
    ref_eval = jax.jit(lambda prm, x: jax.nn.softmax(trainer.model.apply(
        {"params": prm}, x, train=False), -1)[..., 1])
    save_at = set(args.save_at if args.save_at is not None
                  else [args.steps - 1])
    ckpt = None
    if args.save:
        ckpt = BestMetricCheckpointer(args.save)
        os.makedirs(os.path.join(args.save, "init"), exist_ok=True)
        np.savez_compressed(os.path.join(args.save, "init", "0.npz"),
                            **flatten_state(state, "saliency"))

    ports = []
    if not args.no_port:
        pcfg = (port_config.brats_saliency_config if brats
                else port_config.pancreas_saliency_config)(**kw)
        flat0 = _flat_state(state)
        for ulp in (False, True):
            flat = dict(flat0)
            if ulp:
                flat = {k: (np.nextafter(v, np.float32(np.inf))
                            if k.startswith("params/") else v)
                        for k, v in flat.items()}
            tr = SaliencyTrainer(pcfg, device="cpu")
            st = tr.init_state()
            st.load_state_dict(convert_saliency_train_state(flat, st.model))
            ports.append((tr, st))
    x_port = torch.from_numpy(img).permute(0, 4, 1, 2, 3).contiguous()

    def port_dice(st) -> float:
        with torch.no_grad():
            logits = st.model.eval()(x_port)
        prob = torch.softmax(logits.float(), 1)[0, 1].numpy()
        return mask_dice(prob, lab)

    rows, depart, from_f64 = [], None, None
    params, opt_state = state.params, state.opt_state
    t_start = time.perf_counter()
    for k, (im, w, lb) in zip(range(args.steps), batches):
        t0 = time.perf_counter()
        params, opt_state, loss, grads = step_fn(
            params, opt_state, jnp.asarray(im), jnp.asarray(w),
            jnp.asarray(lb))
        row = {"step": k, "loss_ref": float(loss),
               "foreground": float(np.mean(lb))}
        row["ref_s"] = time.perf_counter() - t0
        if ckpt is not None and k in save_at:
            _save_params(os.path.join(args.save, f"ref_params_{k}.npz"),
                         params)
            ckpt.save(state._replace(params=params, opt_state=opt_state,
                                     step=state.step + k + 1), k + 1)
        scored = k % args.dice_every == 0 or k == args.steps - 1
        if scored:
            row["dice_ref"] = mask_dice(np.asarray(ref_eval(
                params, jnp.asarray(img)), np.float32), lab)
        if ports:
            pre = (copy.deepcopy(ports[0][1].model)
                   if depart is None and not args.contract else None)
            t1 = time.perf_counter()
            losses = []
            for tr, st in ports:
                _, m = tr.train_step(st, im, w, lb)
                losses.append(m["loss"])
            row["port_s"] = time.perf_counter() - t1
            ref_flat = _flat_state_params(params)
            port_flat = _port_flat(ports[0][1].model)
            row.update(
                loss_port=losses[0], loss_control=losses[1],
                dist_ref=rel_dist(port_flat, ref_flat),
                dist_control=rel_dist(_port_flat(ports[1][1].model),
                                      port_flat))
            if scored:
                row["dice_port"] = port_dice(ports[0][1])
            row["ratio"] = row["dist_ref"] / max(row["dist_control"], 1e-30)
            g_ref = _flat_state_params(grads)
            g_port = _port_flat(ports[0][1].model, grads=True)
            g_control = _port_flat(ports[1][1].model, grads=True)
            row["grad_dist"] = rel_dist(g_port, g_ref)
            row["grad_dist_control"] = rel_dist(g_control, g_port)
            if k == 0 and args.save:
                np.savez(os.path.join(args.save, "grads_0.npz"), **{
                    f"{side}/{leaf}": v.astype(np.float32)
                    for side, g in (("reference", g_ref), ("port", g_port))
                    for leaf, v in g.items()})
            if k == 0 and not args.contract:
                t2 = time.perf_counter()
                g64 = f64_gradient(ports[0][0], pre, im, w, lb)
                from_f64 = {"reference": rel_dist(g_ref, g64),
                            "port": rel_dist(g_port, g64),
                            "control": rel_dist(g_control, g64),
                            "seconds": time.perf_counter() - t2}
                print(f"step 0's gradients' distance from the f64 one: "
                      f"{from_f64}", flush=True)
            if depart is None and row["ratio"] > DEPART:
                depart = {"step": k,
                          "leaves": leaf_dists(g_port, g_ref, g_control)}
                print(f"departs at step {k}: gradient distance by leaf "
                      "(to the reference, the control's)", flush=True)
                for leaf, d, dc in depart["leaves"]:
                    print(f"  {leaf} {d:.3e} {dc:.3e}", flush=True)
                if not args.contract:
                    g64 = (g64 if k == 0 else
                           f64_gradient(ports[0][0], pre, im, w, lb))
                    depart["from_f64"] = {
                        "reference": rel_dist(g_ref, g64),
                        "port": rel_dist(g_port, g64),
                        "control": rel_dist(g_control, g64)}
                    print(f"  gradients' distance from the f64 one: "
                          f"{depart['from_f64']}", flush=True)
            del pre
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = {"dataset": args.dataset, "bf16": args.bf16, "steps": args.steps,
           "patch": list(task.patch), "shape": list(task.shape),
           "depart_over_control": DEPART, "rows": rows,
           "from_f64_step0": from_f64, "departs": depart,
           "seconds": time.perf_counter() - t_start}
    if ckpt is not None:
        ckpt.close()
        out["saved"] = args.save
        with open(os.path.join(args.save, "trajectory.json"), "w") as f:
            json.dump(out, f)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
