"""The plain reference the benchmark holds the port to: a configuration's
model, loss and optimiser in plain torch, float32 with TF32 off, written
from the published description and the port's documented conventions. It
imports nothing of the port, of JAX or of the JAX package; it takes the
benchmark's inputs (traffic and weights) and works out everything the
port derives from them (self-loops, edge order, padding, dropout masks)
again. A configuration names its reference module (`"reference": "gat"`
is `reference/gat.py`).
"""
