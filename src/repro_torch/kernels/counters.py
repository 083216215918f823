"""The kernels' launch counters and their plain versions' CUDA-call counters,
read and reset together.  A run that sets them to 0, drives a path and reads
them shows which kernels the path launched, and that no plain version ran
on a CUDA tensor in their place."""
from __future__ import annotations

from repro_torch.kernels.gn_attention import ops as attention_ops
from repro_torch.kernels.gn_attention import ref as attention_ref
from repro_torch.kernels.gn_layernorm import ops as norm_ops
from repro_torch.kernels.gn_layernorm import ref as norm_ref
from repro_torch.kernels.gn_paged_attention import ops as paged_ops
from repro_torch.kernels.gn_paged_attention import ref as paged_ref
from repro_torch.kernels.gn_softmax import ops as softmax_ops
from repro_torch.kernels.gn_softmax import ref as softmax_ref

WRAPPERS = {"gn_rmsnorm": norm_ops, "gn_paged_attention": paged_ops,
            "gn_softmax": softmax_ops, "gn_attention": attention_ops}
PLAIN = {"gn_rmsnorm": norm_ref, "gn_paged_attention": paged_ref,
         "gn_softmax": softmax_ref, "gn_attention": attention_ref}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last ``reset``."""
    return {name: mod.launches for name, mod in WRAPPERS.items()}


def plain_cuda_calls() -> dict[str, int]:
    """Plain-version calls on CUDA tensors per kernel since the last ``reset``."""
    return {name: mod.cuda_calls for name, mod in PLAIN.items()}


def reset() -> None:
    for mod in WRAPPERS.values():
        mod.launches = 0
    for mod in PLAIN.values():
        mod.cuda_calls = 0
