"""Applications of the port (counterpart of ``qrkit_tpu/examples``): the
ellipse fit so far."""
