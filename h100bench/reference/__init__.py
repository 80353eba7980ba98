"""The plain reference that decides ``correct``: each family's forward
pass (``h100bench/families/``) in float32 PyTorch with TF32 off, built
from the blocks of ``model.py``. It imports nothing of the port, nor
``jax``, nor the JAX package."""
