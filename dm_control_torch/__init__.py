"""PyTorch/CUDA port of dm_control_tpu: batched physics and environments
on a GPU, with the JAX package as its reference."""
