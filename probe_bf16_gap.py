"""How far one bf16 saliency step's gradient lies from the f32 one, in the
reference and in the port, on the CPU: the batch and the measure of
``tests/test_torch_accuracy_loops.py::test_bf16_saliency_gradient_is_rounding_bound``.

    JAX_PLATFORMS=cpu python probe_bf16_gap.py [--base_filter 4 16]
    XLA_FLAGS=--xla_allow_excess_precision=false JAX_PLATFORMS=cpu \
        python probe_bf16_gap.py

XLA keeps bf16 intermediates of fused ops in f32 unless
``--xla_allow_excess_precision=false``; eager PyTorch rounds every op's
output to bf16. Run once with the flag and once without, each in a fresh
process (XLA reads it at start): if the reference's gap rises to the
port's with the flag, that excess precision is what keeps the
reference's bf16 steps nearer its f32 ones. For each ``--base_filter``
it prints |g_bf16 - g_f32| / |g_f32| (over all leaves, the biases that
feed an instance norm left out) for the reference and the port, the f32
gradients' distance from each other and the bf16 ones' (|g_port -
g_ref| / |g_ref|), and, as the control of the last, the distance of the
reference's own bf16 gradient run op by op (no ``jax.jit``: every op
rounded to its declared type) from its jitted one, and the port's from
the op-by-op one; then a JSON line of them all.
It is a CPU probe that imports JAX, like the tests; the port never
imports it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
from flax.traverse_util import flatten_dict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))

import test_torch_accuracy_loops as loops  # noqa: E402


def reference_eager_bf16(batch) -> dict:
    """The reference's bf16 gradient of ``batch`` with every op run on its
    own (no ``jax.jit``): each op's output rounded to its declared type,
    where the jitted program lets XLA keep fused intermediates in f32."""
    img, w, lab = batch
    trainer = loops.JaxSalTrainer(loops.jax_scfg(
        remat=False, use_bfloat16=True, **loops.TINY))
    state = trainer.init_state(seed=0)

    def loss_fn(params):
        logits = trainer.model.apply({"params": params}, jnp.asarray(img),
                                     train=True)
        return loops.jax_losses.saliency_dice_loss(
            logits, jnp.asarray(w), jnp.asarray(lab))

    grads = jax.grad(loss_fn)(state.params)
    flat = {f"params/{k}": np.asarray(v, np.float64) for k, v in
            flatten_dict(grads, sep="/").items()}
    return {k: v for k, v in flat.items()
            if not loops.BIAS_BEFORE_NORM.search(k)}


def gaps(base_filter: int) -> dict:
    loops.TINY = dict(loops.TINY, base_filter=base_filter)
    batch = loops._batch(np.random.default_rng(7), b=1)
    ref32, port32 = loops._saliency_gradients(False, batch)
    ref16, port16 = loops._saliency_gradients(True, batch)
    eager16 = reference_eager_bf16(batch)
    return {"base_filter": base_filter,
            "reference_gap": loops._rel_l2(ref16, ref32),
            "port_gap": loops._rel_l2(port16, port32),
            "f32_port_vs_reference": loops._rel_l2(port32, ref32),
            "bf16_port_vs_reference": loops._rel_l2(port16, ref16),
            "bf16_reference_eager_vs_jit": loops._rel_l2(eager16, ref16),
            "bf16_port_vs_reference_eager": loops._rel_l2(port16, eager16)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--base_filter", type=int, nargs="+", default=[4])
    args = p.parse_args(argv)
    rows = []
    for bf in args.base_filter:
        rows.append(gaps(bf))
        print(json.dumps(rows[-1]), flush=True)
    out = {"xla_flags": os.environ.get("XLA_FLAGS", ""), "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
