"""Plain references that decide ``correct``.

Each works out its answer again from the benchmark's own inputs, in plain
PyTorch: it imports nothing of ``qrkit_tpu_torch`` (nor JAX) and takes
nothing the program made.  ``precision`` selects the reference's own
precision (float64) or the control's (one step below the configuration's).
"""
