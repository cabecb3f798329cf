"""The hand-written CUDA kernels with their wrappers and plain twins: the
stage-2 LDATI sampler's (K1-K5), the research stage-1 convs (K9, K10),
FastFlowNet's cost volume (K8) and the probe harness's (K2w, K7, K11-K16,
`tools/perf_probe.py`)."""

_MODULES = ("barrier", "compact", "conv3d", "conv3d_quad", "conv3d_wino4", "correlation",
            "decoder", "gen", "roofline")


def _modules():
    import importlib

    return [importlib.import_module(f"v2ce_toolbox_tpu_torch.ops.{m}") for m in _MODULES]


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for m in _modules():
        m.reset_launches()


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    counts = {}
    for m in _modules():
        counts.update(m.launches)
    return counts
