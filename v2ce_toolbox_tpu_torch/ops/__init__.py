"""Stage-2 ops: the LDATI sampler and its hand-written CUDA kernels."""


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    from v2ce_toolbox_tpu_torch.ops import compact, gen

    compact.reset_launches()
    gen.reset_launches()


def launch_counts() -> dict:
    """Launches of each kernel since the last reset."""
    from v2ce_toolbox_tpu_torch.ops import compact, gen

    return {**gen.launches, **compact.launches}
