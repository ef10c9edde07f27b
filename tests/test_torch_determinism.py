"""The port's deterministic gather gradient (``ops/gather.py:row_sum``,
``RowGather``, ``SortedGather`` below its size gate) against the
reference and the ``index_add_`` it replaced, on the CPU at small sizes.

``row_sum`` adds each row's terms one after another in a fixed order in
f32, so that a point-net train step on the card gives the same bits on
every run (CUDA's ``index_add_`` adds with float atomics). Tolerances:

* ``row_sum`` against ``jax.vjp`` of the reference's row gather (XLA's
  scatter on the CPU), f32: within 1e-6 x max |g|, the rounding of f32
  sums of up to a few dozen terms in another order; with bf16 ct against
  the reference's VJP of the same (bf16-representable) values in f32:
  the same bound, since both sum in f32;
* two calls, and bf16 ct against its f32 copy: bit-equal (the same f32
  values added in the same order);
* ``SortedGather`` below the gate and the up-sample's ``RowGather``
  against the ``index_add_`` they ran before: 1e-6 x max |g| in f32; in
  bf16 the old sum ran in bf16, so the new (one f32 sum, rounded once)
  is held to the f32 sum of the same values within one bf16 rounding;
* the accuracy path's saliency stage with ``cudnn.deterministic`` on,
  and both nets started from ``--seed`` or a saved state: exact;
* one RandLANet backward at 512 points (3 levels), every parameter's
  gradient against ``jax.grad`` of the reference model on the same weights,
  pyramid and inputs: within 1e-4 x its max |g|, as
  ``test_torch_train.py`` holds a train step (the Linear biases that
  feed a batch norm have a zero gradient analytically: both sides below
  1e-6 of the largest gradient).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pointunet_tpu.core.config import brats_pointseg_config as jax_cfg
from pointunet_tpu.models.randlanet import RandLANet as JaxRandLANet
from pointunet_tpu.ops.gather import gather_neighbour as jax_gather
from pointunet_tpu.ops.pyramid import build_pyramid_batch
from pointunet_tpu_torch.cli import accuracy
from pointunet_tpu_torch.core.checkpoint import BestMetricCheckpointer
from pointunet_tpu_torch.core.config import brats_pointseg_config
from pointunet_tpu_torch.models import randlanet
from pointunet_tpu_torch.ops import gather
from pointunet_tpu_torch.ops import scatter_sorted as ss
from pointunet_tpu_torch.ops.pyramid import Pyramid
from torch_parity import named_to_flax_flat, to_flax_flat, to_torch, voxel_block

torch.set_num_threads(1)

REL = 1e-6
BF16_ROUNDING = 2.0 ** -8        # a bf16 rounding's relative error bound
BIAS_BEFORE_BN = re.compile(r"(^params|SharedMLP_\d+)/Dense_0/bias$")


def _case(rng, n=300, m=700, k=6, c=5):
    """A (n, c) table, (m, k) row ids with repeats and (m, k, c) ct."""
    table = rng.standard_normal((n, c)).astype(np.float32)
    idx = rng.integers(0, n, (m, k))
    ct = rng.standard_normal((m, k, c)).astype(np.float32)
    return table, idx, ct


def _bf16_values(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).bfloat16().float().numpy()


def _reference_grad(table, idx, ct) -> np.ndarray:
    _, vjp = jax.vjp(lambda t: jax_gather(t, jnp.asarray(idx, jnp.int32)),
                     jnp.asarray(table))
    return np.asarray(vjp(jnp.asarray(ct))[0])


def _within(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _index_add(ct: torch.Tensor, idx, n: int) -> torch.Tensor:
    """The gradient as the port summed it before: ``index_add_`` into
    zeros of ct's type."""
    c = ct.shape[-1]
    return torch.zeros((n, c), dtype=ct.dtype).index_add_(
        0, torch.as_tensor(idx).reshape(-1).long(), ct.reshape(-1, c))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_sum_matches_reference_vjp(rng, dtype):
    table, idx, ct = _case(rng)
    if dtype == torch.bfloat16:
        ct = _bf16_values(ct)
    want = _reference_grad(table, idx, ct)
    got = gather.row_sum(torch.from_numpy(ct).to(dtype), torch.from_numpy(idx),
                         table.shape[0])
    assert got.dtype == torch.float32
    _within(got, want)


def test_row_sum_is_bit_equal_and_sums_bf16_in_f32(rng):
    table, idx, ct = _case(rng)
    i = torch.from_numpy(idx)
    ct32 = torch.from_numpy(ct)
    ct16 = ct32.bfloat16()
    n = table.shape[0]
    a, b = gather.row_sum(ct32, i, n), gather.row_sum(ct32, i, n)
    assert torch.equal(a, b)
    assert torch.equal(gather.row_sum(ct16, i, n),
                       gather.row_sum(ct16.float(), i, n))
    # 257 bf16 ones into one row: 257 is no bf16 value, so only a sum
    # in f32 (or wider) returns it
    ones = torch.ones(257, 1, dtype=torch.bfloat16)
    got = gather.row_sum(ones, torch.zeros(257, dtype=torch.long), 1)
    assert got.dtype == torch.float32 and float(got[0, 0]) == 257.0
    # rows no index names stay zero; no rows at all give zeros
    assert not gather.row_sum(ct32, i, n + 3)[n:].any()
    assert not gather.row_sum(torch.zeros(0, 5), torch.zeros(0), 4).any()


def _grad_of(fn, table: np.ndarray, ct: np.ndarray, dtype) -> torch.Tensor:
    t = torch.from_numpy(table).to(dtype).requires_grad_(True)
    fn(t).backward(torch.from_numpy(ct).to(dtype))
    assert t.grad.dtype == dtype
    return t.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gathers_below_the_gate_give_index_adds_gradient(rng, monkeypatch,
                                                         dtype):
    """``SortedGather`` below its gate and the up-sample's ``RowGather``
    (through ``randlanet._interp``) take ``row_sum``, never the plan,
    and give the gradient ``index_add_`` gave."""
    planned, summed = [], []
    monkeypatch.setattr(ss, "scatter_sorted_plain",
                        lambda *a: planned.append(a))
    for module in (ss, gather):
        real = module.row_sum
        monkeypatch.setattr(
            module, "row_sum",
            lambda *a, real=real: summed.append(a[0].shape) or real(*a))
    table, idx, ct = _case(rng, n=512, m=512, k=4, c=3)
    if dtype == torch.bfloat16:
        table, ct = _bf16_values(table), _bf16_values(ct)
    xyz = torch.from_numpy(rng.uniform(0, 1, (512, 3)).astype(np.float32))
    lo, span = xyz.amin(0), xyz.amax(0) - xyz.amin(0)
    i = torch.from_numpy(idx)
    sorted_grad = _grad_of(
        lambda t: ss.sorted_gather(t, i, xyz, xyz, lo, span, 8, 0),
        table, ct, dtype)
    up_idx = i[:, :1]                                     # (N, 1)
    up_grad = _grad_of(
        lambda t: randlanet._interp(t[None], up_idx[None])[0],
        table, ct[:, 0], dtype)
    assert planned == [] and len(summed) == 2
    for got, rows, c in ((sorted_grad, idx, ct), (up_grad, up_idx, ct[:, 0])):
        want = _index_add(torch.from_numpy(c), rows, table.shape[0])
        if dtype == torch.float32:
            _within(got, want)
        else:
            assert bool(((got.float() - want).abs()
                         <= BF16_ROUNDING * want.abs()).all())


def test_randlanet_backward_matches_reference(rng, monkeypatch):
    """Train mode, no dropout, the reference's pyramid at 512 points (3
    levels, k 4, ratios 2), the port's initial weights in both models:
    every gather takes ``row_sum`` (9 neighbour and pool gathers below
    the gate, 3 up-samples)."""
    n = 512
    opts = dict(num_points=n, num_layers=3, d_out=(8, 16, 16), k_n=4,
                sub_sampling_ratio=(2, 2, 2), dropout_rate=0.0,
                use_bfloat16=False)
    cfg = jax_cfg(**opts)
    port = randlanet.init_randlanet(brats_pointseg_config(**opts),
                                    torch.Generator().manual_seed(0))
    variables = traverse_util.unflatten_dict({
        tuple(k.split("/")): jnp.asarray(v)
        for k, v in to_flax_flat(port).items()})
    xyz = voxel_block((8, 8, 8), rng)[None]
    feats = np.concatenate(
        [xyz, rng.standard_normal((1, n, 4)).astype(np.float32)], -1)
    pyr = build_pyramid_batch(jnp.asarray(xyz), cfg.k_n,
                              cfg.sub_sampling_ratio)
    feats = np.array(jnp.take_along_axis(jnp.asarray(feats),
                                         pyr.order[..., None], 1))
    weight = rng.standard_normal((1, n, cfg.num_classes)).astype(np.float32)

    def objective(params):
        logits, _ = JaxRandLANet(cfg).apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(feats), pyr, train=True,
            rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        return jnp.sum(logits * weight)

    want = {f"params/{k}": np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.jit(jax.grad(objective))(variables["params"]), sep="/").items()}

    summed = []
    for module in (ss, gather):
        real = module.row_sum
        monkeypatch.setattr(
            module, "row_sum",
            lambda *a, real=real: summed.append(a[0].shape) or real(*a))
    logits = port.train()(torch.from_numpy(feats), Pyramid(*to_torch(pyr)))
    (logits * torch.from_numpy(weight)).sum().backward()
    assert len(summed) == 12
    got = named_to_flax_flat({k: p.grad for k, p in port.named_parameters()})
    assert set(got) == set(want)
    top = max(float(np.abs(g).max()) for g in want.values())
    for key, w in want.items():
        if BIAS_BEFORE_BN.search(key):
            assert float(np.abs(w).max()) < 1e-6 * top, key
            assert float(np.abs(got[key]).max()) < 1e-6 * top, key
            continue
        np.testing.assert_allclose(got[key], w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=key)


TINY_TASK = accuracy.Task((32, 32, 16), 8192, (16, 32, 32), None)


def test_saliency_stage_pins_deterministic_convs(monkeypatch):
    """The accuracy path's saliency stage trains with cuDNN's
    deterministic algorithms (and TF32 convs) whatever the caller set,
    and the caller's settings are back after it."""
    seen = []

    def fake_train(trainer, state, records, steps, log):
        seen.append((torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.allow_tf32))
        return state, np.zeros(0)

    monkeypatch.setattr(accuracy, "train_saliency", fake_train)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    args = accuracy.parse_args(["--device", "cpu", "--pointseg_steps", "0"])
    accuracy.train("pancreas", args, TINY_TASK, log=lambda *a: None)
    assert seen == [(True, True)]
    assert torch.backends.cudnn.deterministic is False


def test_accuracy_starts_from_a_seed_or_a_saved_state(tmp_path):
    """``--seed`` draws both nets; ``--saliency_init`` and
    ``--pointseg_init`` restore the latest state of a checkpoint
    directory (an exported JAX state or the port's own) over it."""
    def weights(state):
        return [p.detach().clone() for p in state.model.parameters()]

    def run(*flags):
        args = accuracy.parse_args(["--device", "cpu", "--saliency_steps",
                                    "0", "--pointseg_steps", "0", *flags])
        return accuracy.train("pancreas", args, TINY_TASK,
                              log=lambda *a: None)

    seed0, seed3 = run(), run("--seed", "3")
    for net in ("sstate", "pstate"):
        a, b = weights(getattr(seed0, net)), weights(getattr(seed3, net))
        assert any(not torch.equal(x, y) for x, y in zip(a, b)), net
    for net in ("saliency", "pointseg"):
        BestMetricCheckpointer(str(tmp_path / net)).save(
            getattr(seed3, net[0] + "state"), 0)
    restored = run("--saliency_init", str(tmp_path / "saliency"),
                   "--pointseg_init", str(tmp_path / "pointseg"))
    for net in ("sstate", "pstate"):
        a, b = weights(getattr(restored, net)), weights(getattr(seed3, net))
        assert all(torch.equal(x, y) for x, y in zip(a, b)), net
    with pytest.raises(FileNotFoundError):
        run("--pointseg_init", str(tmp_path / "empty"))
