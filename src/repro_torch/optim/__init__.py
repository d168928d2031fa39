from repro_torch.optim.sgd import adamw_init, adamw_step, sgd_step, staircase_lr

__all__ = ["sgd_step", "staircase_lr", "adamw_init", "adamw_step"]
