"""The port's serving entry point (pointunet_tpu_torch/cli/serve.py), its
independence from JAX, its configs, and the refusal of chip_smoke.py to
run without a card."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from pointunet_tpu.core import config as ref_config
from pointunet_tpu_torch.core import config as port_config
from pointunet_tpu_torch.data import nifti
from util_synthetic import make_brats_case

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_serve_once_on_cpu(tmp_path):
    from pointunet_tpu_torch.cli import serve

    inbox, outbox = tmp_path / "in", tmp_path / "out"
    _, seg = make_brats_case(str(inbox), "case_a")
    argv = ["--inbox", str(inbox), "--outbox", str(outbox), "--once",
            "--device", "cpu", "--n_point", "4096"]
    assert serve.main(argv).served == 1
    labels = nifti.load(str(outbox / "case_a.nii.gz")).data
    assert labels.shape == seg.shape and labels.dtype == np.uint8
    assert set(np.unique(labels)) <= {0, 1, 2, 4}
    rec = json.loads((outbox / "case_a.json").read_text())
    assert rec["case"] == "case_a" and rec["latency_s"] >= 0
    assert rec["voxels"] == int((labels > 0).sum()) <= 4096
    # restart-safe: a served case is not served again
    assert serve.main(argv).served == 0


def test_serve_restores_a_pointseg_checkpoint(tmp_path):
    """``--pointseg_checkpoint`` restores what the port's trainer saved, as
    ``segment`` does: the served model holds its weights, and a head
    biased to class 3 labels every sampled voxel 4 (BraTS values)."""
    from pointunet_tpu_torch.cli import serve
    from pointunet_tpu_torch.core.checkpoint import BestMetricCheckpointer
    from pointunet_tpu_torch.train.pointseg import PointSegTrainer

    n = 4096
    state = PointSegTrainer(port_config.brats_pointseg_config(num_points=n),
                            device="cpu").init_state(seed=5)
    with torch.no_grad():
        state.model.head.bias[3] += 1e4
    BestMetricCheckpointer(str(tmp_path / "ckpt")).save(state, 3, metric=0.5)
    inbox, outbox = tmp_path / "in", tmp_path / "out"
    make_brats_case(str(inbox), "case_a")
    server = serve.main([
        "--inbox", str(inbox), "--outbox", str(outbox), "--once",
        "--device", "cpu", "--n_point", str(n),
        "--pointseg_checkpoint", str(tmp_path / "ckpt"),
    ])
    assert server.served == 1
    served = server.pipeline.pointseg_model.state_dict()
    for name, t in state.model.state_dict().items():
        assert torch.equal(served[name].cpu(), t), name
    labels = nifti.load(str(outbox / "case_a.nii.gz")).data
    assert set(np.unique(labels)) == {0, 4}
    assert (labels == 4).sum() == n


@pytest.mark.parametrize("flags,item", [
    (["--saliency_checkpoint", "{tmp}/orbax"], "export_jax_checkpoint.py"),
])
def test_serve_refuses_with_the_roadmap_item(tmp_path, flags, item):
    """The reference's flags parse (no argparse exit 2) and end in a
    ``SystemExit`` that names what the user must run: a saliency
    checkpoint directory of the JAX package (orbax step folders and a
    ``best.json``, no snapshot the port reads) names the exporter."""
    from pointunet_tpu_torch.cli import serve

    (tmp_path / "orbax" / "7").mkdir(parents=True)
    (tmp_path / "orbax" / "best.json").write_text('{"step": 7, "metric": 1}')
    with pytest.raises(SystemExit) as e:
        serve.main(["--inbox", str(tmp_path / "in"), "--outbox",
                    str(tmp_path / "out"), "--device", "cpu",
                    *(f.format(tmp=tmp_path) for f in flags)])
    assert e.value.code != 2 and item in str(e.value.code)


def test_serve_and_segment_restore_a_saliency_checkpoint(tmp_path):
    """``--saliency_checkpoint`` restores what the port's saliency trainer
    saved after a train step: ``serve`` (its ``--fast`` models) and
    ``segment`` (its f32 models) hold the trained weights, and their nets'
    logits equal the trained model's."""
    import argparse

    from pointunet_tpu_torch.cli import segment, serve
    from pointunet_tpu_torch.core.checkpoint import BestMetricCheckpointer
    from pointunet_tpu_torch.train.saliency import SaliencyTrainer

    trainer = SaliencyTrainer(port_config.brats_saliency_config(),
                              device="cpu")
    state = trainer.init_state(seed=4)
    rng = np.random.default_rng(4)
    images = rng.standard_normal((1, 16, 32, 32, 4)).astype(np.float32)
    labels = (images[..., 0] > 1).astype(np.int32)
    trainer.train_step(state, images, np.ones(labels.shape, np.float32),
                       labels)
    BestMetricCheckpointer(str(tmp_path / "ckpt")).save(state, 1, 0.5)
    x = torch.from_numpy(images).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        want = state.model.eval()(x)

    inbox, outbox = tmp_path / "in", tmp_path / "out"
    make_brats_case(str(inbox), "case_a")
    server = serve.main([
        "--inbox", str(inbox), "--outbox", str(outbox), "--once",
        "--device", "cpu", "--n_point", "4096",
        "--saliency_checkpoint", str(tmp_path / "ckpt"),
    ])
    assert server.served == 1
    built = segment.build_pipeline(argparse.Namespace(
        dataset="brats", fast=False, sa_stride=None, n_point=4096,
        saliency_checkpoint=str(tmp_path / "ckpt"), pointseg_checkpoint=None,
    ))
    for model in (server.pipeline.saliency_model, built.saliency_model):
        for name, t in state.model.state_dict().items():
            assert torch.equal(model.state_dict()[name].cpu(), t), name
    with torch.no_grad():
        got = built.saliency_model.eval()(x)
    assert torch.equal(got, want)


def test_serve_without_device_needs_the_card(tmp_path, monkeypatch):
    """``--device`` defaults to cuda: on a host without a card the service
    fails on every case and writes no labels, instead of quietly serving
    on the CPU."""
    from pointunet_tpu_torch.cli import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inbox, outbox = tmp_path / "in", tmp_path / "out"
    make_brats_case(str(inbox), "case_a")
    server = serve.main(["--inbox", str(inbox), "--outbox", str(outbox),
                         "--once", "--n_point", "4096"])
    assert server.args.device == "cuda"
    assert server.served == 0 and server.failures == {"case_a": 1}
    assert not any(outbox.iterdir())


def test_port_imports_no_jax():
    """Neither the port (its serving, segmenting and training entry
    points, both trainers, its kernels' wrappers, the Pancreas path, the
    offline prep and scoring tools, the host CLIs, the native ops, the
    checkpoint reader, the multi-device layer and the activation-sharded
    point net, the subpackages with their public names, the accuracy path;
    then every module
    of the package) nor chip_smoke.py loads
    JAX, any module of the JAX package (``pointunet_tpu``) or the
    exporter, which is the one file that imports both."""
    code = (
        "import sys\n"
        "import pointunet_tpu_torch.cli.serve, pointunet_tpu_torch.convert\n"
        "import pointunet_tpu_torch.ops, pointunet_tpu_torch.models\n"
        "import pointunet_tpu_torch.cli.run_brats\n"
        "import pointunet_tpu_torch.cli.profile_train\n"
        "import pointunet_tpu_torch.cli.segment\n"
        "import pointunet_tpu_torch.train.pointseg\n"
        "import pointunet_tpu_torch.ops.scatter_sorted\n"
        "import pointunet_tpu_torch.ops.scatter_window\n"
        "import pointunet_tpu_torch.ops.conv_cuda\n"
        "import pointunet_tpu_torch.ops.window\n"
        "import pointunet_tpu_torch.ops.cuda_build\n"
        "import pointunet_tpu_torch.models.fastconv\n"
        "import pointunet_tpu_torch.pipeline.end2end\n"
        "import pointunet_tpu_torch.pipeline.postprocess\n"
        "import pointunet_tpu_torch.data.pointcloud\n"
        "import pointunet_tpu_torch.core.checkpoint\n"
        "import pointunet_tpu_torch.data.datasets\n"
        "import pointunet_tpu_torch.train.saliency\n"
        "import pointunet_tpu_torch.cli.train_attention\n"
        "import pointunet_tpu_torch.data.sampler\n"
        "import pointunet_tpu_torch.data.volume\n"
        "import pointunet_tpu_torch.models.upsample\n"
        "import pointunet_tpu_torch.cli.run_pancreas\n"
        "import pointunet_tpu_torch.cli.data_prepare_pancreas\n"
        "import pointunet_tpu_torch.cli.data_prepare_brats\n"
        "import pointunet_tpu_torch.cli.evaluation\n"
        "import pointunet_tpu_torch.cli.gen_segmentation\n"
        "import pointunet_tpu_torch.cli.gen_binary_map\n"
        "import pointunet_tpu_torch.cli.fold_cv_report\n"
        "import pointunet_tpu_torch.cli.cvt_ct\n"
        "import pointunet_tpu_torch.cli.generate_kfold\n"
        "import pointunet_tpu_torch.ops.subsample\n"
        "import pointunet_tpu_torch.train.metrics\n"
        "import pointunet_tpu_torch.native\n"
        "import pointunet_tpu_torch.cli.n4_correction\n"
        "import pointunet_tpu_torch.cli.oversampling_analysis\n"
        "import pointunet_tpu_torch.cli.visualize\n"
        "import pointunet_tpu_torch.cli.data_prepare_blocks\n"
        "import pointunet_tpu_torch.parallel\n"
        "import pointunet_tpu_torch.parallel.collectives\n"
        "import pointunet_tpu_torch.ops.pyramid_sharded\n"
        "import pointunet_tpu_torch.ops.knn_sharded\n"
        "import pointunet_tpu_torch.models.randlanet\n"
        "import pointunet_tpu_torch.parallel.mesh\n"
        # the subpackages' public names, the reference's
        "import pointunet_tpu_torch.core, pointunet_tpu_torch.data\n"
        "import pointunet_tpu_torch.train, pointunet_tpu_torch.pipeline\n"
        "from pointunet_tpu_torch.ops import knn_with_distances, knn_batch\n"
        "from pointunet_tpu_torch.core import profile_trace\n"
        "from pointunet_tpu_torch.data.prefetch import prefetch_map\n"
        # the accuracy path and its synthetic volumes
        "import pointunet_tpu_torch.cli.accuracy\n"
        "import pointunet_tpu_torch.data.synthetic\n"
        # every other module of the port, new ones included
        "import importlib, pkgutil, pointunet_tpu_torch\n"
        "for m in pkgutil.walk_packages(pointunet_tpu_torch.__path__,\n"
        "                               'pointunet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in\n"
        "             ('jax', 'flax', 'orbax', 'optax', 'pointunet_tpu',\n"
        "              'export_jax_checkpoint'))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    ).stdout
    assert out.strip() == "[]", out


def test_no_port_module_imports_the_exporter():
    """``export_jax_checkpoint.py`` imports JAX and the JAX package; no
    source of the port, nor chip_smoke.py, names it in an import."""
    import re
    from pathlib import Path

    pattern = re.compile(r"^\s*(import|from)\s+export_jax_checkpoint\b", re.M)
    sources = list(Path(REPO, "pointunet_tpu_torch").rglob("*.py"))
    sources.append(Path(REPO, "chip_smoke.py"))
    assert len(sources) > 50
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offenders == []


# fields the port leaves out on purpose: TrainConfig's device mesh
# (nothing in the reference reads it; both trainers take the mesh as an
# argument) and donate_state (the port's trainer mutates its state in
# place, so there is nothing to donate)
OMITTED_FIELDS = {"TrainConfig": {"mesh", "donate_state"}}


@pytest.mark.parametrize(
    "name", ["PointSegConfig", "SaliencyConfig", "TrainConfig", "MeshConfig"]
)
def test_config_fields_match_reference(name):
    ref = getattr(ref_config, name)
    port = getattr(port_config, name)
    omitted = OMITTED_FIELDS.get(name, set())
    ref_fields = [(f.name, f.default) for f in dataclasses.fields(ref)
                  if f.name not in omitted]
    port_fields = [(f.name, f.default) for f in dataclasses.fields(port)]
    assert port_fields == ref_fields


@pytest.mark.parametrize("helper", [
    "brats_pointseg_config", "pancreas_pointseg_config",
    "brats_saliency_config", "pancreas_saliency_config",
])
def test_config_helpers_match_reference(helper):
    ref = getattr(ref_config, helper)(use_bfloat16=True)
    port = getattr(port_config, helper)(use_bfloat16=True)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    if "pointseg" in helper:
        assert port.level_sizes == ref.level_sizes
        assert port.class_weights() == ref.class_weights()


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=120, env=env,
    )


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """No CUDA device: non-zero exit and no result line, in the repo and
    in a directory that holds chip_smoke.py alone."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd in (REPO, str(alone)):
        proc = _run_smoke(cwd)
        assert proc.returncode != 0, cwd
        assert '"ok"' not in proc.stdout, cwd
