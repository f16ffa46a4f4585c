"""Device operations of the port (counterpart of ``qrkit_tpu/ops/``):
batched Householder QR in plain torch, and the hand-written CUDA kernels
with their plain PyTorch versions."""
