"""Platform pinning for entry points: an own copy of
``kubernetes_tpu/utils/platform.py``.

In the JAX package ``force_cpu()`` pins JAX to its CPU backend. In the port
it hides the card from this process (``CUDA_VISIBLE_DEVICES=""``), which
CUDA reads when it initialises: after it, ``torch.cuda.is_available()`` is
False, and an entry point called with ``device=None`` raises, as the device
rule says (``utils/device.py``). Call it before anything touches CUDA: once
CUDA was initialised, or its driver asked for the device count, the card
stays visible, and it raises instead of pretending to switch.
"""

from __future__ import annotations

import os


def force_cpu() -> None:
    import torch

    if torch.cuda.is_initialized():
        raise RuntimeError("force_cpu() after CUDA was initialised: the card stays "
                           "visible to this process")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    if torch.cuda.is_available():
        raise RuntimeError("force_cpu() after CUDA's driver counted the devices: the "
                           "card stays visible to this process")
