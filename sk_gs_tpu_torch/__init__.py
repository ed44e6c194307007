"""sk_gs_tpu_torch: the PyTorch / CUDA port of ``sk_gs_tpu``.

The layout mirrors the JAX package (``ops/``, ``render/``, ``models/``,
``framework/``) so that each module's counterpart is easy to find. Plain
tensor code is PyTorch; every Pallas kernel of the JAX package becomes a
CUDA kernel written for Hopper (``csrc/``), with a plain PyTorch version
beside it that runs when the tensors lie on the CPU.

The JAX package runs its float32 products at ``Precision.HIGHEST``
(``models/superpoints.py:171-176``); TF32 would keep only ~3 decimal digits,
so both TF32 switches are turned off here, explicitly.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument. A CUDA
    device on a machine without one raises: entry points never fall back to
    the CPU on their own."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU")
    return device
