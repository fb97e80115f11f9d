"""Training scripts on PyTorch (counterpart of ``dm_control_tpu/scripts/``):
the models (``model``), PPO over host environments (``ppo``), vectorised
environments (``vec_env``) and PPO on mocap tracking (``ppo_tracking``).
"""
