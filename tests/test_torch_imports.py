"""The PyTorch port never imports jax or the JAX package."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "v2ce_toolbox_tpu_torch",
    "v2ce_toolbox_tpu_torch.config",
    "v2ce_toolbox_tpu_torch.events",
    "v2ce_toolbox_tpu_torch.eval",
    "v2ce_toolbox_tpu_torch.eval.baseline_metrics",
    "v2ce_toolbox_tpu_torch.eval.stage2_metrics",
    "v2ce_toolbox_tpu_torch.cli",
    "v2ce_toolbox_tpu_torch.data",
    "v2ce_toolbox_tpu_torch.data.dummy_data_gen",
    "v2ce_toolbox_tpu_torch.data.event_chunk",
    "v2ce_toolbox_tpu_torch.data.eventgan",
    "v2ce_toolbox_tpu_torch.data.event_pack_dataset",
    "v2ce_toolbox_tpu_torch.data.loader",
    "v2ce_toolbox_tpu_torch.data.mvsec",
    "v2ce_toolbox_tpu_torch.data.voxelize",
    "v2ce_toolbox_tpu_torch.io.native",
    "v2ce_toolbox_tpu_torch.io.video",
    "v2ce_toolbox_tpu_torch.models",
    "v2ce_toolbox_tpu_torch.models.fastflownet",
    "v2ce_toolbox_tpu_torch.models.graph_pool",
    "v2ce_toolbox_tpu_torch.models.layers",
    "v2ce_toolbox_tpu_torch.models.resnet",
    "v2ce_toolbox_tpu_torch.models.unet2d",
    "v2ce_toolbox_tpu_torch.models.unet3d",
    "v2ce_toolbox_tpu_torch.models.unet_plain",
    "v2ce_toolbox_tpu_torch.models.v2ce3d",
    "v2ce_toolbox_tpu_torch.ops",
    "v2ce_toolbox_tpu_torch.ops._cuda",
    "v2ce_toolbox_tpu_torch.ops.barrier",
    "v2ce_toolbox_tpu_torch.ops.bitpack",
    "v2ce_toolbox_tpu_torch.ops.compact",
    "v2ce_toolbox_tpu_torch.ops.conv3d",
    "v2ce_toolbox_tpu_torch.ops.conv3d_quad",
    "v2ce_toolbox_tpu_torch.ops.conv3d_wino4",
    "v2ce_toolbox_tpu_torch.ops.correlation",
    "v2ce_toolbox_tpu_torch.ops.decoder",
    "v2ce_toolbox_tpu_torch.ops.gen",
    "v2ce_toolbox_tpu_torch.ops.ldati",
    "v2ce_toolbox_tpu_torch.ops.roofline",
    "v2ce_toolbox_tpu_torch.ops.samplers",
    "v2ce_toolbox_tpu_torch.parallel",
    "v2ce_toolbox_tpu_torch.parallel.mesh",
    "v2ce_toolbox_tpu_torch.pipeline.driver",
    "v2ce_toolbox_tpu_torch.pipeline.infer",
    "v2ce_toolbox_tpu_torch.pipeline.preprocess",
    "v2ce_toolbox_tpu_torch.pipeline.render",
    "v2ce_toolbox_tpu_torch.pipeline.windows",
    "v2ce_toolbox_tpu_torch.tools",
    "v2ce_toolbox_tpu_torch.tools.baseline_metric",
    "v2ce_toolbox_tpu_torch.tools.gen_phy_att",
    "v2ce_toolbox_tpu_torch.tools.overfit_demo",
    "v2ce_toolbox_tpu_torch.tools.perf_probe",
    "v2ce_toolbox_tpu_torch.tools.probes_stage1",
    "v2ce_toolbox_tpu_torch.tools.probes_stage2",
    "v2ce_toolbox_tpu_torch.tools.stage2_eval",
    "v2ce_toolbox_tpu_torch.tools.time_voxel_stat_calc",
    "v2ce_toolbox_tpu_torch.tools.vis_tools",
    "v2ce_toolbox_tpu_torch.train",
    "v2ce_toolbox_tpu_torch.train.gan",
    "v2ce_toolbox_tpu_torch.train.losses",
    "v2ce_toolbox_tpu_torch.train.main",
    "v2ce_toolbox_tpu_torch.train.metrics",
    "v2ce_toolbox_tpu_torch.train.state",
    "v2ce_toolbox_tpu_torch.train.step",
    "v2ce_toolbox_tpu_torch.train.voxel_encoder",
    "v2ce_toolbox_tpu_torch.utils.checkpoint",
    "v2ce_toolbox_tpu_torch.utils.image_derivative",
    "v2ce_toolbox_tpu_torch.utils.physical_att",
    "v2ce_toolbox_tpu_torch.utils.runtime",
    "v2ce_toolbox_tpu_torch.utils.v2e",
    "v2ce_toolbox_tpu_torch.utils.weights",
]


def test_every_module_is_listed():
    pkg = os.path.join(REPO, "v2ce_toolbox_tpu_torch")
    found = set()
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                found.add(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    assert found == set(MODULES) | {"v2ce_toolbox_tpu_torch.io",
                                    "v2ce_toolbox_tpu_torch.pipeline",
                                    "v2ce_toolbox_tpu_torch.utils"}


@pytest.mark.parametrize("chunk", [MODULES[: len(MODULES) // 2],
                                   MODULES[len(MODULES) // 2:]])
def test_port_imports_no_jax(chunk):
    # modules loaded at interpreter start (e.g. by a sitecustomize) are not
    # the port's doing: only what the imports below add is checked
    code = ("import sys\nbefore = set(sys.modules)\n"
            + "".join(f"import {m}\n" for m in chunk)
            + "new = set(sys.modules) - before\n"
            + "bad = sorted(m for m in new if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', 'v2ce_toolbox_tpu'))\n"
            + "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
