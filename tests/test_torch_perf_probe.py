"""The port's probe harness (`v2ce_toolbox_tpu_torch/tools/perf_probe.py`)
on the CPU at tiny shapes: each probe runs through its kernels' plain twins
and prints the JAX probe's lines; `wino_ablate` prints FAILED only for
'noinv', as the JAX probe does. Its numbers here are the CPU's."""

import re

import pytest
import torch

from v2ce_toolbox_tpu_torch.tools import perf_probe
from tests.test_torch_streaming import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def few_iters(monkeypatch):
    monkeypatch.setattr(perf_probe, "N_ITERS", 2)


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_compact_algo_prints_both_algos(capsys):
    res = perf_probe.probe_compact_algo(CPU, r=4, n=2048 * 3, chunks=(2048,))
    lines = _lines(capsys)
    assert set(res) == {("window", 2048), ("place", 2048)}
    for algo, line in zip(("window", "place"), lines):
        assert re.fullmatch(rf"compact\[{algo}\] chunk=2048 \+payload: [0-9.]+ ms "
                            r"\([0-9.]+ Gelem/s\)", line), line


def test_quad_prints_each_layer_and_dtype(capsys):
    res = perf_probe.probe_quad(CPU, layers=[("tiny", 9, 13, 16, 8)], frames=3)
    lines = _lines(capsys)
    assert set(res) == {("tiny", "bf16"), ("tiny", "f32")}
    assert [ln.split(":")[0] for ln in lines] == ["quad tiny bf16", "quad tiny f32"]
    assert all(re.search(r": [0-9.]+ ms  [0-9.]+ TF/s$", ln) for ln in lines), lines


def test_wino_pallas_checks_then_times(capsys):
    res = perf_probe.probe_wino_pallas(CPU, shapes=[("tiny", (1, 8, 9, 13, 16), 8)],
                                       blocks=((8, 8), (4, 4)))
    lines = _lines(capsys)
    assert lines[0].startswith("tiny wino-vs-direct bf16 rel err: ")
    # bf16 Winograd F(4,3) against the direct conv of the same values
    assert res[("tiny", "rel_err_bf16")] < 0.2
    heads = [ln.split(":")[0] for ln in lines[1:]]
    assert heads == ["tiny direct_bf16", "tiny wino4_bf16[lt=8,th=8]",
                     "tiny wino4_bf16[lt=4,th=4]", "tiny direct_f32",
                     "tiny wino4_f32[lt=8,th=8]", "tiny wino4_f32[lt=4,th=4]"]
    assert not any("FAILED" in ln for ln in lines)


def test_wino_ablate_fails_only_noinv(capsys):
    res = perf_probe.probe_wino_ablate(CPU, shape=(1, 4, 9, 13, 16), cout=8)
    lines = _lines(capsys)
    failed = [ln for ln in lines if "FAILED" in ln]
    assert [ln.split(":")[0] for ln in failed] == ["wino4 bf16 [noinv]", "wino4 f32 [noinv]"]
    assert res[("f32", "nodot")] is not None and res[("f32", "noinv")] is None


def test_cli_rejects_an_unknown_probe():
    with pytest.raises(SystemExit):
        perf_probe.main(["--device", "cpu", "no_such_probe"])
