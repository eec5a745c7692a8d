"""The port's hand-written CUDA kernels, their plain versions and wrappers."""


def launch_counts() -> dict:
    """Every kernel wrapper's launch count so far in this process, by kernel
    name (the names of chip_smoke.py's kernels line)."""
    from .block_attention import block_attention_bwd, block_attention_fwd
    from .flash_attention import flash_attention_bwd, flash_attention_fwd
    from .paged_attention import paged_attention
    return {"flash_attention_fwd": flash_attention_fwd.launches,
            "flash_attention_bwd_dq": flash_attention_bwd.launches_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd.launches_dkv,
            "paged_attention": paged_attention.launches,
            "block_attention_fwd": block_attention_fwd.launches,
            "block_attention_bwd_dq": block_attention_bwd.launches_dq,
            "block_attention_bwd_dkv": block_attention_bwd.launches_dkv}
