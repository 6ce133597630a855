"""Hand-written CUDA kernels for Hopper (sources in ``sap3d_tpu_torch/csrc``)."""


def _counters() -> dict:
    """Kernel name -> (wrapper, attribute) of its launch counter: B1-B4,
    B5's forward, the row-stats kernel (RS: B6's pass 1, B5's lse) and B6's
    pass 2."""
    from sap3d_tpu_torch.ops.attention import flash_fwd_chunked_bwd
    from sap3d_tpu_torch.ops.cuda import flash_attention as fa
    from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb
    from sap3d_tpu_torch.ops.cuda import flash_attention_nolse as nolse

    return {"B1": (fa.flash_attend_tokens, "launches"), "B2": (fa.flash_forward_lse, "launches"),
            "B3": (fb.flash_backward, "launches"), "B4": (fb.flash_backward, "launches_lse"),
            "B5": (flash_fwd_chunked_bwd, "launches"), "RS": (fa.flash_row_stats, "launches"),
            "B6": (nolse.flash_nolse, "launches")}


def launch_counts(*names: str) -> dict[str, int]:
    """The launch counters of the kernels ``names`` (all of them if none is
    named).  Each counts its wrapper's Python calls on CUDA tensors, a
    captured CUDA graph's recording call included and its replays not."""
    counters = _counters()
    return {n: getattr(*counters[n]) for n in names or counters}


def reset_launch_counts(*names: str) -> None:
    """Set the launch counters of the kernels ``names`` (all if none) to 0."""
    counters = _counters()
    for n in names or counters:
        setattr(*counters[n], 0)
