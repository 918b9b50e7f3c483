"""Training stages 1-4 (port of ``jafpro_tpu/train``)."""
