from jafpro_tpu_torch.utils.profiling import step_timer, trace  # noqa: F401
