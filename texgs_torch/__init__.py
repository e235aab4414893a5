"""texgs_torch — the PyTorch + CUDA port of texgs (Texture-GS), for Hopper.

The JAX package ``texgs`` is the reference; this package keeps its module
names so each module's counterpart is easy to find.  Plain tensor code is
PyTorch; every kernel that ``texgs`` wrote in Pallas for the TPU is a CUDA
kernel under ``csrc/``, built on first use by ``texgs_torch._build`` (see
``kernels/uvtex_fused.py`` and ``kernels/tex_term.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
CPU tensors every kernel wrapper runs its plain PyTorch version.

Numerics: ``texgs`` runs its matmuls at "highest" precision because the
projection feeds matmul outputs into conic inverses and integer radii, so
TF32 is switched off here for both matmuls and cuDNN convolutions.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
