"""Props (counterpart of ``dm_control_tpu/entities/props/``): primitives,
Duplo bricks and the position detector (``position_detector.py``)."""
