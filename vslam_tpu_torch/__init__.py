"""vslam_tpu_torch — the PyTorch + CUDA port of ``vslam_tpu``.

Same module layout and names as the JAX package, so each module's
counterpart is easy to find; ``vslam_tpu`` stays the reference and the
port's tests hold every ported function to it. The port imports torch and
numpy only — never jax or flax.

PyTorch idiom inside: state is dataclasses of tensors, functions are plain
functions on tensors, random draws take an explicit ``torch.Generator``,
nothing is traced or jitted. Descriptors are int32 bit-views of the
reference's uint32 words (torch has no uint32 shifts or scatters on CPU).

The two Pallas TPU kernels of the reference are hand-written CUDA kernels
here (``csrc/``, wrapped by ``ops/hamming.py`` and ``ops/associate.py``),
as are the batched Jacobi eigensolver (``ops/jacobi.py``) and one
iteration of RANSAC's Gauss-Newton polish (``ops/sampson_gn.py``); each
wrapper runs its plain-torch version on a CPU tensor and launches the
kernel on a CUDA tensor.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (8-point, triangulation, PnP) needs true f32 products — the same
# reason vslam_tpu pins jax_default_matmul_precision="highest". TF32 keeps
# ~3 decimal digits; turn it off for matmuls and cuDNN alike.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .config import VSLAMConfig, small_config  # noqa: E402,F401
