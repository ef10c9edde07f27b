"""The contract probes at the tests' size: ``probe_saliency_trajectory.py
--contract`` (the reference's composed step beside the port's on the
CPU) and ``probe_contract_step.py`` (the port alone, the card's probe,
here in its CPU mode), each cut to a (16, 32, 32) patch of (48, 48, 32)
Pancreas volumes at base_filter 4 by their own flags.

- The trajectory's saved reference weights and step-0 gradient are
  ``reference_step``'s from the same draw on the same batches, bit for
  bit; its saved draw is that draw.
- The card probe's CPU mode repeats the trajectory's port run from the
  saved draw: the same losses, the same distance from the reference's
  weights (both run the port's f32 step on the CPU); its f64 gradient
  puts the port's step-0 gradient as far from it as the saved CPU one
  (measured 1.9e-3 here, the reference's 1.9e-3: at base_filter 4 the
  gradient is ill-conditioned, the one-ulp control's lies 1.6e-4 from
  it); its bf16 recipe runs, and its control moves.
- The CPU forward's reference map is the reference's own
  ``FusedPointUnet`` stage's (the crop, pad and threshold, on a BraTS ROI
  smaller than the volume); the port's stage on the same weights lies
  within 2e-3 of it in f32 (measured 6.3e-4 on the Pancreas case, a
  one-ulp control 5.3e-6 from the port); the maps' file reloads exactly.

~60 s on an 8-core CPU, most of it XLA's compiles.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

import probe_contract_step as card
import probe_saliency_trajectory as traj
from pointunet_tpu.data.sampler import patch_batches
from pointunet_tpu_torch.cli import accuracy

SIZE = ["--patch", "16", "32", "32", "--shape", "48", "48", "32",
        "--base_filter", "4"]
STEPS = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("contract"))
    got = traj.main(["--dataset", "pancreas", "--contract", "--steps",
                     str(STEPS), "--save", out, "--save_at", "0",
                     str(STEPS - 1), "--threads", "1"] + SIZE)
    return out, got


def test_trajectory_saves_the_reference_steps(run):
    out, got = run
    task = card.contract_task("pancreas", (16, 32, 32), (48, 48, 32))
    trainer, _ = traj._ref_trainer(False, task, False, 4)
    state = trainer.init_state()
    train_vols, _ = accuracy.make_volumes("pancreas", task)
    records = accuracy.saliency_records(train_vols, "pancreas")
    batches = patch_batches(records, task.patch, 1,
                            np.random.default_rng(1), "one_positive")
    step = traj.reference_step(trainer)
    params, opt = state.params, state.opt_state
    with np.load(os.path.join(out, "init", "0.npz")) as z:
        draw = {k: z[k] for k in z.files if k.startswith("params/")}
    for key, value in traj._flat_state_params(state.params).items():
        np.testing.assert_array_equal(draw[key], value, err_msg=key)
    for k, (im, w, lab) in zip(range(STEPS), batches):
        params, opt, loss, grads = step(params, opt, jnp.asarray(im),
                                        jnp.asarray(w), jnp.asarray(lab))
        assert float(loss) == got["rows"][k]["loss_ref"]
        with np.load(os.path.join(out, f"ref_params_{k}.npz")) as z:
            for key, value in traj._flat_state_params(params).items():
                np.testing.assert_array_equal(z[key], value, err_msg=key)
        if k == 0:
            with np.load(os.path.join(out, "grads_0.npz")) as z:
                for key, value in traj._flat_state_params(grads).items():
                    np.testing.assert_array_equal(z["reference/" + key],
                                                  value, err_msg=key)
                    assert z["port/" + key].shape == value.shape
    assert got["from_f64_step0"] is None       # the card's, at the contract
    with open(os.path.join(out, "trajectory.json")) as f:
        assert json.load(f)["rows"] == got["rows"]
    assert got["patch"] == [16, 32, 32] and got["shape"] == [48, 48, 32]


def test_card_probe_cpu_mode_repeats_the_port_run(run):
    out, got = run
    res = card.main(["--dataset", "pancreas", "--device", "cpu", "--init",
                     os.path.join(out, "init"), "--ref", out, "--steps",
                     str(STEPS), "--bf16_steps", "1", "--recipes", "f32",
                     "bf16"] + SIZE)
    f32, bf16 = res["recipes"]
    rows = got["rows"]
    np.testing.assert_allclose(f32["losses"], [r["loss_port"] for r in rows],
                               rtol=1e-6)
    np.testing.assert_allclose(f32["losses"], [r["loss_ref"] for r in rows],
                               rtol=1e-3)
    cpu = res["cpu_grad0_from_f64"]
    np.testing.assert_allclose(f32["grad0_from_f64"], cpu["port"], rtol=1e-6)
    assert 0 < cpu["port"] < 1e-2 and 0 < cpu["reference"] < 1e-2
    np.testing.assert_allclose(f32["dist_ref"], rows[-1]["dist_ref"],
                               rtol=1e-4)
    np.testing.assert_allclose(f32["dist_control"], rows[-1]["dist_control"],
                               rtol=1e-4)
    assert f32["cpu"]["loss_ref"] == [r["loss_ref"] for r in rows]
    assert 0 < f32["grad0_control_dist"] < 1e-2
    assert len(bf16["losses"]) == 1 and np.isfinite(bf16["losses"]).all()
    assert bf16["dist_control"] > 0 and "dist_ref" not in bf16


def test_ulp_up_moves_each_weight_one_ulp():
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.copy_(torch.tensor([[1.0, -1.0, 0.0], [0.5, 3.0, -2.0]]))
    w = model.weight.detach().clone()
    card.ulp_up(model)
    want = torch.nextafter(w, torch.full_like(w, float("inf")))
    assert torch.equal(model.weight, want)
    model.weight.data.copy_(w)
    card.ulp_up(model, torch.bfloat16)
    b = w.to(torch.bfloat16)
    got = model.weight.detach()
    step = got.to(torch.bfloat16).float() - b.float()
    assert (step > 0).all()
    assert torch.equal(got, got.to(torch.bfloat16).float())
    assert float(step[0, 0]) == 2.0 ** -7                  # 1.0: one ulp


def test_forward_maps_are_the_stage(tmp_path):
    task = accuracy.Task((48, 48, 32), 4096, (16, 32, 32), (40, 36, 24), 16)
    trainer, _ = traj._ref_trainer(True, task, False, 4)
    flat = traj._flat_state_params(trainer.init_state().params)
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    params = unflatten_dict({tuple(k.split("/")[1:]): jnp.asarray(v)
                             for k, v in flat.items()})
    mods = np.zeros((4, 48, 48, 32), np.float32)
    rng = np.random.default_rng(3)
    mods[:, 6:44, 10:40, 4:28] = rng.standard_normal((4, 38, 30, 24))
    probs, mask = traj.ref_attention(trainer, params, mods, task)
    assert probs.shape == (24, 36, 40)
    np.testing.assert_array_equal(
        mask, traj.ref_pipe_mask(trainer, params, mods, task, True))
    port = card.attention("brats", task, flat, mods, torch.device("cpu"),
                          "f32", base_filter=4)
    assert port[0].shape == probs.shape and port[1].shape == mask.shape
    assert card.prob_dist(port[0], probs) < 2e-3
    exact = card.attention("brats", task, flat, mods, torch.device("cpu"),
                           "f64", base_filter=4)
    assert card.prob_dist(port[0], exact[0]) < 1e-4
    path = str(tmp_path / "maps.npz")
    card.save_maps(path, {"ref_f32": (probs, mask), "ref_bf16": port},
                   exact=("ref_f32",))
    back = card.load_maps(path)
    np.testing.assert_array_equal(back["ref_f32"][1], mask)
    np.testing.assert_array_equal(back["ref_f32"][0], probs)
    np.testing.assert_array_equal(back["ref_bf16"][0],
                                  port[0].astype(np.float16))


def test_forward_probes_share_the_maps(run, tmp_path):
    out, _ = run
    params = os.path.join(out, f"ref_params_{STEPS - 1}.npz")
    ref = traj.main(["--dataset", "pancreas", "--contract", "--forward",
                     "--params", params, "--maps", str(tmp_path),
                     "--threads", "1"] + SIZE)
    rows = {(r["side"], r["dtype"], r.get("control")): r
            for r in ref["maps"]}
    assert set(rows) == {("reference", "f32", None), ("reference", "bf16", None),
                         ("port", "f32", None), ("port", "f32", "f32"),
                         ("port", "bf16", None), ("port", "bf16", "f32"),
                         ("port", "bf16", "bf16")}
    port_f32 = rows[("port", "f32", None)]
    assert port_f32["vs_reference"]["prob_dist"] < 2e-3
    assert rows[("port", "f32", "f32")]["vs_port"]["prob_dist"] < 1e-4
    res = card.main(["--forward", "--dataset", "pancreas", "--device", "cpu",
                     "--params", params, "--ref_maps", ref["maps_file"]]
                    + SIZE)
    got = {(r["dtype"], r["route"], r["control"]): r for r in res["maps"]}
    assert len(got) == 9
    f32 = got[("f32", "default", None)]
    assert f32["voxels"] == port_f32["voxels"]
    np.testing.assert_allclose(f32["vs_ref_f32"]["prob_dist"],
                               port_f32["vs_reference"]["prob_dist"],
                               rtol=1e-6)
    assert f32["vs_f64"]["prob_dist"] < 1e-4
    assert set(res["ref_vs_f64"]) == {"ref_f32", "ref_bf16"}
    pallas = got[("bf16", "pallas", None)]
    assert pallas["vs_port"]["dice"] > 0.9
