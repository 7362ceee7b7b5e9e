"""brax_torch: the PyTorch + CUDA port of brax_tpu for NVIDIA Hopper.

The port is batch-first: every state tensor carries the env batch as its
leading axis, and one call steps the whole batch.  Entry points take a
`device` argument that defaults to "cuda"; pass device="cpu" to run the
plain-torch twins instead of the hand-written kernels.

Physics runs in float32 with TF32 off (set below): a TF32 matmul or
convolution keeps about three decimal digits, which would silently round the
physics as the JAX package's default matmul precision once did.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
