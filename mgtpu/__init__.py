"""mgtpu — multigrid neural architectures framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
buttomnutstoast/Multigrid-Neural-Architectures (Torch7). A multigrid
feature *pyramid* is represented as a tuple of NHWC arrays (finest
scale first); every multigrid op is a pure function pyramid -> pyramid.
"""

__version__ = "0.1.0"
