"""Classes of device kernels by name: a frozen copy of the port's
``bench/device_profile.py: KINDS, kind_of``. The first four classes are the
port's hand-written kernels (``csrc/``); every other kernel is the PyTorch
glue's."""
from __future__ import annotations

KINDS = (("kernel_b", ("fused_expand_backward",)),
         ("kernel_c", ("ls_rollout_al",)),
         ("kernel_a", ("ls_rollout",)),
         # every kernel D body (its translation unit names B's kernels too,
         # which match first); before index/cat/copy, whose "cat" it holds
         ("kernel_d", ("riccati",)),
         ("gemm/gemv", ("gemm", "gemv", "cublas", "xmma", "cutlass")),
         ("reduction", ("reduce",)),
         ("elementwise", ("elementwise",)),
         ("index/cat/copy", ("index", "cat", "copy", "gather", "scatter")))
HAND_WRITTEN = ("kernel_a", "kernel_b", "kernel_c", "kernel_d")


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"
