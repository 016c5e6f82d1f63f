"""Attention analysis and visualisation (counterpart of
gat_pytorch_tpu/vis).

`attention` -- extraction and statistics (entropies, degree-scaled
weights, neighbourhood slices); `plots` -- the three matplotlib figures
(entropy dual histogram, neighbourhood star plot, weight histogram).
matplotlib is imported when a figure is drawn, not here.
"""

from . import attention, plots

__all__ = ["attention", "plots"]
