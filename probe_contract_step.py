"""The port's saliency steps and its attention stage at the accuracy
contract's own geometry, from the reference's weights, on the card.

    python3 probe_contract_step.py --dataset pancreas|brats \
        --init DIR --ref DIR [--ref_bf16 DIR] [--steps 10] \
        [--bf16_steps 5] [--recipes tf32 f32 bf16] [--device cuda]
    python3 probe_contract_step.py --forward --dataset pancreas|brats \
        --params FILE [--ref_maps FILE] [--device cuda]

Steps (the default): the contract's saliency training
(``cli/accuracy.py --acc_full``: the (64, 160, 160) patch of the
contract's seeded volumes, batch 1, lr 0.01) from the reference's draw
``--init`` (``export_jax_checkpoint.py --init 0 --stage saliency``, or
the ``init/`` that ``probe_saliency_trajectory.py --save`` writes), on
the batches of ``patch_batches(..., default_rng(1), "one_positive")``,
under each of the accuracy path's recipes: ``tf32`` (its default: f32
with cuDNN's TF32 convs), ``f32`` (TF32 off) and ``bf16``
(``--saliency_bf16``), all under cuDNN's deterministic algorithms as
the path runs them. Each recipe runs twice, from the draw and from the
draw moved by one f32 ulp (the control). Prints, a recipe: each step's
loss and the control's; step 0's gradient's relative distance from the
f64 gradient of the same weights and batch (the net and the batch in
f64 on the device), the control's beside it, and the CPU's (the
reference's and the port's step-0 gradients in ``--ref``'s
``grads_0.npz``, which ``probe_saliency_trajectory.py --contract
--save`` writes, with its losses in ``trajectory.json``); the relative
distance of the last step's weights from the reference's after the
same step
(``ref_params_<k>.npz``; ``--ref_bf16``'s for ``bf16``, which runs
``--bf16_steps``) beside the control's distance from them, and their
ratio. Distances leave out the conv biases that feed an instance norm
(their gradient is zero analytically).

``--forward``: held-out volume 0 of the contract through the port's
fused attention stage (``FusedPointUnet._attention_mask``: the
Pancreas volume whole, the BraTS (192, 208, 155) ROI padded to the
net's stride; gate stride 1, threshold 0.5) with the weights of
``--params`` (flat reference parameters, ``params/...``), TF32 off:
the saliency net in f64 (the net and the volume: the exact map), in
f32 and in bf16 under the default conv route, and in bf16 under
``POINTUNET_FASTCONV=pallas``, the f32 and bf16 maps each beside
controls whose weights are moved by one f32 ulp and (bf16) one bf16
ulp. Prints each map's voxels above the threshold, the relative
distance of its probabilities (ROI, before the threshold) from the
same type's default-route map, from the f64 map and from the
reference's (``--ref_maps``: the maps that
``probe_saliency_trajectory.py --forward`` writes) and its mask's Dice
against theirs, and the reference's maps against the f64 one.

The last line is one JSON object of it all. Imports torch and the port
only, so it runs on the card's machine; ``--device cpu`` runs the same
on the CPU (the tests' mode, with ``--patch``, ``--shape`` and
``--base_filter`` to cut it to size).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import time

import numpy as np
import torch

from pointunet_tpu_torch.cli import accuracy
from pointunet_tpu_torch.convert import convert_leaves
from pointunet_tpu_torch.core.config import (
    TrainConfig,
    brats_pointseg_config,
    brats_saliency_config,
    pancreas_pointseg_config,
    pancreas_saliency_config,
)
from pointunet_tpu_torch.data.sampler import patch_batches
from pointunet_tpu_torch.models.fastconv import Conv
from pointunet_tpu_torch.models.randlanet import RandLANet
from pointunet_tpu_torch.models.saliency_unet import init_saliency_unet
from pointunet_tpu_torch.pipeline.fused import FusedPointUnet
from pointunet_tpu_torch.train.saliency import SaliencyTrainer

RECIPES = ("tf32", "f32", "bf16")
ROUTES = {"default": None, "pallas": "pallas"}
THRESHOLD = 0.5
# conv biases that feed an instance norm: zero gradient analytically
BIAS_BEFORE_NORM = re.compile(
    r"(ConvNormRelu_\d+/Conv_0|SpatialAttention3D_0/Conv_\d+)/bias$"
)


def contract_task(dataset: str, patch=None, shape=None,
                  contract: bool = True) -> accuracy.Task:
    """The accuracy path's task (``--acc_full``'s unless not
    ``contract``), its patch and volume shape overridden where given
    (the ROI clipped to the shape)."""
    task = (accuracy.brats_task if dataset == "brats"
            else accuracy.pancreas_task)(contract)
    if patch:
        task = dataclasses.replace(task, patch=tuple(patch))
    if shape:
        shape = tuple(shape)
        roi = (None if task.roi is None
               else tuple(min(r, s) for r, s in zip(task.roi, shape)))
        task = dataclasses.replace(task, shape=shape, roi=roi)
    return task


def first_batches(records, task, n: int) -> list:
    """The first ``n`` saliency batches of the accuracy path."""
    batches = patch_batches(records, task.patch, 1, np.random.default_rng(1),
                            "one_positive")
    return [b for _, b in zip(range(n), batches)]


def saliency_config(dataset: str, task, bf16: bool, base_filter=None):
    """The accuracy path's saliency config (batch 1, lr 0.01)."""
    make = (brats_saliency_config if dataset == "brats"
            else pancreas_saliency_config)
    extra = {} if base_filter is None else {"base_filter": base_filter}
    return make(patch_size=task.patch, batch_size=1, base_lr=0.01,
                use_bfloat16=bf16, **extra)


@contextlib.contextmanager
def recipe(name: str):
    """The conv settings of a recipe: cuDNN's deterministic algorithms
    always; TF32 convs for ``tf32`` and ``bf16`` (the accuracy path's
    saliency stage), none for ``f32``."""
    cudnn = torch.backends.cudnn
    old = cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    with accuracy.deterministic_convs():
        try:
            if name == "f32":
                cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
                yield
            else:
                with accuracy.tf32_convs():
                    yield
        finally:
            cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


@torch.no_grad()
def ulp_up(model, dtype=torch.float32) -> None:
    """Move every parameter by one ulp of ``dtype`` towards +inf (for
    bf16: the parameter rounded to bf16, then one bf16 ulp up)."""
    for p in model.parameters():
        if dtype == torch.float32:
            p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
        else:
            b = p.to(dtype)
            bits = b.view(torch.int16)
            up = torch.where(b >= 0, bits + 1, bits - 1)
            up = torch.where(b == 0, torch.ones_like(bits), up)  # +0 -> +min
            p.copy_(up.view(dtype).float())


def named_flax(named: dict) -> dict:
    """Port tensors by name -> {flax-style path: f64 numpy} (the names
    only: a path of "/" for the bias regex; layouts stay the port's)."""
    return {k.replace(".", "/"): v.detach().double().cpu().numpy()
            for k, v in named.items()}


def rel_dist(a: dict, b: dict) -> float:
    """|a - b| / |b| over the leaves of ``b`` but the biases before a
    norm."""
    keys = [k for k in b if not BIAS_BEFORE_NORM.search(k)]
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in keys)
    return float(np.sqrt(num / sum(float((b[k] ** 2).sum()) for k in keys)))


def load_flat(path: str, model, prefix: str = "") -> dict:
    """A flat reference file (``params/...``, after ``prefix``:
    parameters or gradients) onto ``model``'s parameter names, as
    ``named_flax`` gives them."""
    head = prefix + "params/"
    with np.load(path) as z:
        flat = {k[len(prefix):]: z[k] for k in z.files if k.startswith(head)}
    return named_flax(convert_leaves(flat, dict(model.named_parameters())))


def _params(model) -> dict:
    return named_flax(dict(model.named_parameters()))


def _grads(model) -> dict:
    return named_flax({n: p.grad for n, p in model.named_parameters()})


def f64_gradient(dataset: str, task, batch, init: str, dev,
                 base_filter=None) -> dict:
    """The gradient of the first batch's loss at the draw, the net and
    the batch in f64 (its convs' casts off): the step's gradient without
    rounding, by ``named_flax``'s names."""
    cfg = saliency_config(dataset, task, False, base_filter)
    trainer = SaliencyTrainer(cfg, TrainConfig(), device=dev)
    state = accuracy.initial_state(trainer, 0, init)
    state.model.double()
    for m in state.model.modules():
        if isinstance(m, Conv):
            m.dtype = None
    images, weights, labels = trainer.prepare(*batch)
    with accuracy.deterministic_convs():
        trainer.forward_loss(state, images.double(), weights.double(),
                             labels).backward()
    return _grads(state.model)


def run_recipe(name: str, dataset: str, task, batches, init: str,
               ref: str, steps: int, dev, g64: dict,
               base_filter=None) -> dict:
    """One recipe's ``steps`` from the draw and from the draw one ulp up:
    losses, step 0's gradients against the f64 one ``g64``, the last
    weights against the reference's (see the module docstring)."""
    cfg = saliency_config(dataset, task, name == "bf16", base_filter)
    out = {"recipe": name, "steps": steps}
    runs = []
    for control in (False, True):
        trainer = SaliencyTrainer(cfg, TrainConfig(), device=dev)
        state = accuracy.initial_state(trainer, 0, init)
        if control:
            ulp_up(state.model)
        losses, grad0 = [], None
        t0 = time.perf_counter()
        with recipe(name):
            for k, (im, w, lab) in enumerate(batches[:steps]):
                state, m = trainer.train_step(state, im, w, lab)
                losses.append(m["loss"])
                if k == 0:
                    grad0 = _grads(state.model)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        runs.append({"losses": losses, "grad0": grad0,
                     "params": _params(state.model),
                     "seconds": time.perf_counter() - t0,
                     "model": state.model})
    port, ctrl = runs
    out["losses"], out["losses_control"] = port["losses"], ctrl["losses"]
    out["seconds"] = [port["seconds"], ctrl["seconds"]]
    out["grad0_from_f64"] = rel_dist(port["grad0"], g64)
    out["grad0_control_from_f64"] = rel_dist(ctrl["grad0"], g64)
    out["grad0_control_dist"] = rel_dist(ctrl["grad0"], port["grad0"])
    last = os.path.join(ref, f"ref_params_{steps - 1}.npz")
    out["dist_control"] = rel_dist(ctrl["params"], port["params"])
    if os.path.exists(last):
        theta = load_flat(last, port["model"])
        out["dist_ref"] = rel_dist(port["params"], theta)
        out["control_dist_ref"] = rel_dist(ctrl["params"], theta)
        out["ratio"] = out["dist_ref"] / max(out["dist_control"], 1e-30)
    cpu = os.path.join(ref, "trajectory.json")
    if os.path.exists(cpu):
        with open(cpu) as f:
            traj = json.load(f)
        rows = traj["rows"][:steps]
        out["cpu"] = {"loss_ref": [r["loss_ref"] for r in rows],
                      "loss_port": [r.get("loss_port") for r in rows],
                      "dist_ref": rows[-1].get("dist_ref"),
                      "dist_control": rows[-1].get("dist_control")}
    return out


def card_name(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _log(msg: str) -> None:
    print(msg, flush=True)


def steps_main(args, dev) -> dict:
    task = contract_task(args.dataset, args.patch, args.shape)
    train_vols, _ = accuracy.make_volumes(args.dataset, task)
    records = accuracy.saliency_records(train_vols, args.dataset)
    n = max(args.steps, args.bf16_steps)
    batches = first_batches(records, task, n)
    fg = float(np.mean([b[2].mean() for b in batches]))
    _log(f"[contract] {args.dataset} patch {task.patch} of {task.shape}: "
         f"{n} batches, foreground {fg:.4f} | {card_name(dev)}")
    out = {"dataset": args.dataset, "patch": list(task.patch),
           "shape": list(task.shape), "card": card_name(dev), "recipes": []}
    t0 = time.perf_counter()
    g64 = f64_gradient(args.dataset, task, batches[0], args.init, dev,
                       args.base_filter)
    out["f64_seconds"] = time.perf_counter() - t0
    cpu = os.path.join(args.ref, "grads_0.npz")
    if os.path.exists(cpu):
        model = init_saliency_unet(saliency_config(
            args.dataset, task, False, args.base_filter), torch.Generator())
        out["cpu_grad0_from_f64"] = {
            side: rel_dist(load_flat(cpu, model, f"{side}/"), g64)
            for side in ("reference", "port")}
        _log(f"[contract] the CPU's step-0 gradients' distance from the "
             f"f64 one: {out['cpu_grad0_from_f64']}")
    for name in args.recipes:
        bf16 = name == "bf16"
        ref = args.ref_bf16 if bf16 else args.ref
        steps = args.bf16_steps if bf16 else args.steps
        row = run_recipe(name, args.dataset, task, batches, args.init,
                         ref or "", steps, dev, g64, args.base_filter)
        out["recipes"].append(row)
        _log("[contract] " + json.dumps(row))
    return out


def mods_volume(dataset: str, task, index: int = 0) -> np.ndarray:
    """Held-out volume ``index`` of the task, (C, X, Y, Z) f32."""
    _, test_vols = accuracy.make_volumes(dataset, task)
    return test_vols[index][0]


def attention(dataset: str, task, params: dict, mods: np.ndarray, dev,
              dtype: str = "bf16", route=None, control=None,
              base_filter=None) -> tuple:
    """The port's fused attention stage on ``mods`` with the reference's
    flat ``params``, the saliency net in ``dtype`` (f32, bf16, or f64:
    the net and the volume in f64 with its convs' casts off, the
    stage without rounding), its weights moved by one ulp of
    ``control`` (f32 or bf16) unless None: (probabilities over the ROI
    (Z, Y, X) f32, the stage's (X, Y, Z) bool mask). The probabilities
    are the stage's softmax of the net's logits, taken by a forward
    hook."""
    scfg = saliency_config(dataset, task, dtype == "bf16", base_filter)
    model = init_saliency_unet(scfg, torch.Generator())
    model.load_state_dict(convert_leaves(params, model.state_dict()))
    if control is not None:
        ulp_up(model, torch.bfloat16 if control == "bf16" else torch.float32)
    x = torch.as_tensor(mods)
    if dtype == "f64":
        model = model.double()
        for m in model.modules():
            if isinstance(m, Conv):
                m.dtype = None
        x = x.double()
    pcfg = (brats_pointseg_config if dataset == "brats"
            else pancreas_pointseg_config)(num_points=task.n_points)
    pipe = FusedPointUnet(model, RandLANet(pcfg), scfg, pcfg,
                          threshold=THRESHOLD, volume_shape=task.shape,
                          roi_shape=task.roi, device=dev)
    got = {}
    hook = pipe.saliency_model.register_forward_hook(
        lambda m, i, o: got.__setitem__("logits", o))
    old = os.environ.get("POINTUNET_FASTCONV")
    if route is None:
        os.environ.pop("POINTUNET_FASTCONV", None)
    else:
        os.environ["POINTUNET_FASTCONV"] = route
    try:
        mask = pipe._attention_mask(x.to(dev))
    finally:
        hook.remove()
        if old is None:
            os.environ.pop("POINTUNET_FASTCONV", None)
        else:
            os.environ["POINTUNET_FASTCONV"] = old
    rx, ry, rz = pipe._roi
    with torch.inference_mode():
        probs = torch.softmax(got["logits"], dim=1)[0, 1, :rz, :ry, :rx]
    return probs.float().cpu().numpy(), mask.bool().cpu().numpy()


def prob_dist(a: np.ndarray, b: np.ndarray) -> float:
    """|a - b| / |b| of two probability maps."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def dice(a: np.ndarray, b: np.ndarray) -> float:
    denom = int(a.sum()) + int(b.sum())
    return float(2 * int((a & b).sum()) / denom) if denom else 1.0


def save_maps(path: str, maps: dict, exact=()) -> None:
    """{tag: (probs, mask)} -> ``path``: each map's probabilities as f16
    (as f32 for the tags in ``exact``) and its mask as packed bits (with
    its shape)."""
    arrays = {}
    for tag, (probs, mask) in maps.items():
        arrays[f"{tag}/probs"] = probs.astype(
            np.float32 if tag in exact else np.float16)
        arrays[f"{tag}/mask"] = np.packbits(mask.ravel())
        arrays[f"{tag}/shape"] = np.asarray(mask.shape)
    np.savez(path, **arrays)


def load_maps(path: str) -> dict:
    """``save_maps``'s file -> {tag: (probs f32, mask bool)}."""
    out = {}
    with np.load(path) as z:
        for tag in sorted({k.rsplit("/", 1)[0] for k in z.files}):
            shape = tuple(z[f"{tag}/shape"])
            mask = np.unpackbits(z[f"{tag}/mask"])[:int(np.prod(shape))]
            out[tag] = (z[f"{tag}/probs"].astype(np.float32),
                        mask.reshape(shape).astype(bool))
    return out


def compare(probs, mask, base) -> dict:
    """A map's distance from ``base`` (probs, mask): the probabilities'
    relative distance and the masks' Dice."""
    return {"prob_dist": prob_dist(probs, base[0]),
            "dice": dice(mask, base[1])}


# (compute type, weight control) of each forward a route: f64 is the
# exact map (the net and the volume in f64), the others are held to it
CASES = {"default": (("f64", None), ("f32", None), ("f32", "f32"),
                     ("bf16", None), ("bf16", "f32"), ("bf16", "bf16")),
         "pallas": (("bf16", None), ("bf16", "f32"), ("bf16", "bf16"))}


def forward_main(args, dev) -> dict:
    task = contract_task(args.dataset, args.patch, args.shape)
    mods = mods_volume(args.dataset, task)
    with np.load(args.params) as z:
        params = {k: z[k] for k in z.files if k.startswith("params/")}
    refs = load_maps(args.ref_maps) if args.ref_maps else {}
    out = {"dataset": args.dataset, "roi": task.roi, "card": card_name(dev),
           "maps": []}
    keep = {}
    for route, cases in CASES.items():
        for dtype, control in cases:
            t0 = time.perf_counter()
            with recipe("f32"):                    # no TF32 anywhere
                probs, mask = attention(args.dataset, task, params, mods,
                                        dev, dtype, ROUTES[route], control,
                                        args.base_filter)
            row = {"dtype": dtype, "route": route, "control": control,
                   "voxels": int(mask.sum()),
                   "seconds": time.perf_counter() - t0}
            if control is None and route == "default":
                keep[dtype] = (probs, mask)
            else:
                row["vs_port"] = compare(probs, mask, keep[dtype])
            if dtype != "f64":
                row["vs_f64"] = compare(probs, mask, keep["f64"])
            for tag, ref_map in refs.items():
                row[f"vs_{tag}"] = compare(probs, mask, ref_map)
            out["maps"].append(row)
            _log("[forward] " + json.dumps(row))
    out["ref_vs_f64"] = {tag: compare(*m, keep["f64"])
                         for tag, m in refs.items()}
    _log(f"[forward] the reference's maps against the f64 one: "
         f"{json.dumps(out['ref_vs_f64'])}")
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", choices=("brats", "pancreas"),
                   default="pancreas")
    p.add_argument("--forward", action="store_true")
    p.add_argument("--init", help="the reference's exported draw")
    p.add_argument("--ref", default="",
                   help="probe_saliency_trajectory.py --save's directory "
                   "of the f32 run")
    p.add_argument("--ref_bf16", default="",
                   help="the same of the bf16 run")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--bf16_steps", type=int, default=5)
    p.add_argument("--recipes", nargs="+", choices=RECIPES,
                   default=list(RECIPES))
    p.add_argument("--params", help="--forward: flat reference parameters")
    p.add_argument("--ref_maps", help="--forward: the reference's maps")
    p.add_argument("--device", default="cuda")
    p.add_argument("--patch", type=int, nargs=3)
    p.add_argument("--shape", type=int, nargs=3)
    p.add_argument("--base_filter", type=int)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_contract_step: no CUDA device")
    out = forward_main(args, dev) if args.forward else steps_main(args, dev)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
