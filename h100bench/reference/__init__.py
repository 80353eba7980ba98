"""The plain reference that decides ``correct``: Mistral's and Mixtral's
forward passes in float32 PyTorch with TF32 off. It imports nothing of
the port, nor ``jax``, nor the JAX package."""
