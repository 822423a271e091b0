"""PyTorch/CUDA port of the split-inference system in ``src/repro``.

The port mirrors the JAX package's layout (``configs``, ``models``,
``kernels``, ``core``, ``data``) and imports nothing of it.  Entry points
take a ``device`` that defaults to ``"cuda"`` and raise when no card is
present; the plain PyTorch path runs only where the caller passes
``device="cpu"``.

Precision policy, set once here, as the JAX package's
``preferred_element_type=jnp.float32``:

  * float32 matrix products and cuDNN convolutions run in full float32.
    cuDNN's default would put the patch-embed conv and the 3x3 FPN/FCOS
    convs on TF32, about three decimal digits.
  * bf16 matrix products (the LM's projections) accumulate and reduce in
    float32 and round once at the end: cuBLAS may otherwise reduce split-K
    partial sums in bf16.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and no card is
    present: an entry point never drops to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev
