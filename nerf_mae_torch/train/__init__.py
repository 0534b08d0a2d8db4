"""MAE pretraining: optimizer and schedule, trainer, checkpoints."""
