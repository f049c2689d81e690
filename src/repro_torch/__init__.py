"""FedBWO in PyTorch for NVIDIA Hopper: the port of the ``repro`` package.

Parameters keep the reference's layout (nested dicts of tensors, conv
weights HWIO, dense ``w`` shaped (in, out), images NHWC), keys are
threefry2x32 words (``repro_torch.random``), and the BWO generation runs
through a hand-written CUDA kernel (``repro_torch.kernels.bwo_evolve``).

    PYTHONPATH=src python -m repro_torch.launch.fl_train --bwo-kernel
"""
import torch

# cuDNN runs float32 convolutions in TF32 unless told otherwise, which keeps
# about three decimal digits; the reference computes float32 throughout, so
# the port turns TF32 off for convolutions and for matrix products alike.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
