"""The port's forward kernels as ``torch.library`` custom ops.

``torch.export`` (``serving.export_model``) and the FLOP count of
``serving.Predictor.cost_analysis`` trace a model with FakeTensors, which
hold no memory, so a kernel wrapper cannot launch there.  Each forward
kernel that serving reaches is therefore also an op ``vit_torch::<name>``
(``layernorm_rows``, ``gemm_bf16``, ``attention_rows``, ``stack_layers``
in ``fused_block.py``; ``flash_fwd`` in ``flash_attention.py``;
``short_attention`` in ``short_attention.py``) with:

- a real implementation: the wrapper's launch, which checks the operands,
  launches the kernel and counts the launch, so an exported program's
  launches are counted as the eager path's are;
- a fake implementation (``register_fake``) that gives the output shapes
  and dtypes from the operands' alone;
- for the products, a FLOP formula (2 FLOP a multiply-add, as
  ``torch.utils.flop_counter`` counts ``mm``), so the count on the card
  equals the count of the plain composite on the CPU.

A wrapper takes the op only while it is traced (:func:`traced`); an eager
call runs the same implementation directly, which saves the dispatcher's
cost on the host (16-18% of a layer's 7 launches at bs=1 on an H100,
``PERF.md`` §6).  Importing
``vit_pytorch_tpu_torch.ops`` registers every op, which is all a process
needs to run an exported program on the card.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

NAMESPACE = "vit_torch"


def traced(*tensors) -> bool:
    """Whether the wrapper runs under a tracer (``torch.export``,
    ``torch.compile``, a FakeTensor trace) rather than eagerly."""
    return torch.compiler.is_compiling() or any(isinstance(t, FakeTensor) for t in tensors)


def op_name(name: str) -> str:
    return f"{NAMESPACE}::{name}"
