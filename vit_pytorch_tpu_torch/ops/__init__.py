"""The port's kernels (``csrc/``, built at first use) and their wrappers.

Importing this package registers the forward kernels as ``torch.library``
ops (``vit_torch::*``, see ``_library.py``), which is what a process needs
to run a program exported on the card (``serving.load_model``).
"""

from . import flash_attention, fused_block, short_attention  # noqa: F401  (registers the ops)
