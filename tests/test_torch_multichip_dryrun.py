"""The port's ``entry.py::dryrun_multichip``, the counterpart of
tests/test_multichip_dryrun.py: ``dryrun_multichip(8)`` in a fresh
subprocess runs the DP + TP + FSDP step of the tiny ViT over a (4, 2) mesh
of 8 gloo CPU processes and prints its ``ok`` line, and the calling process
is left as it was: no CUDA initialised, no process group."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
sys.path.insert(0, {repo!r})
import torch
from vit_pytorch_tpu_torch.entry import dryrun_multichip

dryrun_multichip(8)
assert not torch.cuda.is_initialized(), "dryrun_multichip initialised CUDA"
assert not torch.distributed.is_initialized(), "dryrun_multichip left a process group"
assert "jax" not in sys.modules, "the port imported jax"
print("HERMETIC_OK")
"""


def test_dryrun_multichip_hermetic():
    out = subprocess.run([sys.executable, "-c", _SCRIPT.format(repo=REPO)], capture_output=True, text=True,
                         timeout=600, cwd=REPO)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    assert "HERMETIC_OK" in out.stdout
    assert "dryrun_multichip ok: mesh={'data': 4, 'model': 2} loss=" in out.stdout
