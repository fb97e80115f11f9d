"""Training scripts on PyTorch (counterpart of ``dm_control_tpu/scripts/``):
the models (``model``), PPO over host environments (``ppo``), vectorised
environments (``vec_env``) and PPO on mocap tracking (``ppo_tracking``);
behaviour cloning: the CEM trajectory solver (``solver``), the dataset
(``create_dataset``, ``dataset``), the trainer (``trainer``, ``train``),
``evaluate`` and ``visualize``; ``ppo_box2d`` and ``print_profile``.
"""
