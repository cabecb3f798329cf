"""The hand-written CUDA kernels with their wrappers and plain twins: the
stage-2 LDATI sampler's (K1-K5), the research stage-1 convs (K9, K10) and
FastFlowNet's cost volume (K8)."""


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    from v2ce_toolbox_tpu_torch.ops import compact, conv3d, correlation, decoder, gen

    for m in (compact, conv3d, correlation, decoder, gen):
        m.reset_launches()


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    from v2ce_toolbox_tpu_torch.ops import compact, conv3d, correlation, decoder, gen

    return {**gen.launches, **compact.launches, **conv3d.launches, **decoder.launches,
            **correlation.launches}
