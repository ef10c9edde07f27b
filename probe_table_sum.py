"""Time the activation-sharded train step with the table all-gather's
backward summed in f32 (``parallel/collectives.py:_AllGatherRows``, the
port's) against summed in the cotangent's own type (bf16), on one card.

    python3 probe_table_sum.py

Builds the kernels, then runs ``chip_smoke.py`` phase 12 (d)'s setting:
4 ranks sharing the card over gloo on ``MeshConfig(data=1, point=4)``,
the Train config on one synthetic cloud (seed 5), 4 steps a run, in
turns f32, bf16, bf16, f32 within one launch. Prints each rank's losses
and the mean split of its warm steps (CUDA events) for each run."""
import os
import tempfile
import time

import torch

import chip_smoke as c
from pointunet_tpu_torch.parallel import collectives as col

ORDER = ("f32", "bf16", "bf16", "f32")


def _bf16_backward(ctx, grad):
    whole = col.all_reduce_(grad.contiguous().clone(), ctx.group)
    rank = torch.distributed.get_rank(ctx.group)
    lo = sum(ctx.sizes[:rank])
    return whole[lo:lo + ctx.sizes[rank]], None, None


def rank_fn(rank, world, path):
    from pointunet_tpu_torch.core.config import MeshConfig
    from pointunet_tpu_torch.parallel.mesh import make_mesh

    c._full_f32()
    data = torch.load(path, weights_only=False)
    mesh = make_mesh(MeshConfig(data=1, point=4))
    f32 = col._AllGatherRows.backward
    out = []
    for kind in ORDER:
        col._AllGatherRows.backward = (
            staticmethod(_bf16_backward) if kind == "bf16" else f32)
        t = c._mesh_train(rank, mesh, data, slice(0, 1), 4, False, kind)
        out.append((kind, t["split_ms"], t["losses"]))
    col._AllGatherRows.backward = f32
    return out


if __name__ == "__main__":
    from pointunet_tpu_torch.cli.profile_train import synthetic_cloud
    from pointunet_tpu_torch.ops.pyramid import build_pyramid_batch

    t0 = time.perf_counter()
    c.phase_build()
    dev = torch.device("cuda", 0)
    xyz, feats, labels = synthetic_cloud(dev, c.N_POINTS, seed=5)
    with torch.no_grad():
        pyr = c._to_cpu(build_pyramid_batch(xyz, c.K, c.RATIOS))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ab.pt")
        torch.save({"xyz": xyz.cpu(), "feats": feats.cpu(),
                    "labels": labels.cpu(), "pyramids": [pyr]}, path)
        del xyz, feats, labels
        torch.cuda.empty_cache()
        runs = col.spawn(rank_fn, 4, path, timeout=600)
    for rank, res in enumerate(runs):
        for kind, splits, losses in res:
            warm = splits[1:]
            mean = {k: sum(s[k] for s in warm) / len(warm) for k in warm[0]}
            print(f"[ab] rank {rank} {kind}: losses {losses}; warm mean "
                  + ", ".join(f"{k} {v:.3f}" for k, v in mean.items()),
                  flush=True)
    print("total", time.perf_counter() - t0, flush=True)
