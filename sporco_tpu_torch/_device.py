"""Device resolution and the fp32 contraction-precision context."""

import contextlib

import torch

__all__ = ["resolve_device", "fp32_precision"]


def resolve_device(device=None):
    """The device an entry point runs on.

    ``None`` means the CUDA device.  Without a GPU that raises: the port
    never falls back to the CPU unless the caller asks for it with
    ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU with the plain PyTorch kernels")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested, but no CUDA "
                           "device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@contextlib.contextmanager
def fp32_precision():
    """Pin float32 contractions to full float32 for the block.

    cuBLAS matmuls and cuDNN convolutions may otherwise run in TF32
    (about three decimal digits), far outside the forward product's
    error budget of about 5e-7 relative.  The previous settings are
    restored on exit.
    """
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
