"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (`ref`). Wrappers run the plain version for CPU tensors and the
kernel for CUDA tensors; kernels build on first use (`_build`)."""


def launch_counts() -> dict:
    """Each kernel's launches so far in this process, by its wrapper's
    counter: B1 `quantize_ef`, B2 `quantize_ef_dyn`, B3 `paged_attention`,
    B4 `flash_attention`, and B5's forward and backward calls
    `ssd_chunked` and `ssd_chunked_bwd`. A call on CPU or meta tensors
    runs the plain version and counts nothing."""
    from . import flash_attention as FA
    from . import quantize as Q
    from . import ssd as SSD
    return {"quantize_ef": Q.launches, "quantize_ef_dyn": Q.launches_dyn,
            "paged_attention": FA.launches,
            "flash_attention": FA.flash_launches,
            "ssd_chunked": SSD.ssd_launches,
            "ssd_chunked_bwd": SSD.ssd_bwd_launches}


def launches_since(before: dict) -> dict:
    """The launches each kernel made since `launch_counts()` gave
    `before`."""
    return {k: v - before[k] for k, v in launch_counts().items()}
