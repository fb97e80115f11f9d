"""Model literal trees for the suite domains (models-as-code): the port's
copy of ``dm_control_tpu/suite/models/``."""
