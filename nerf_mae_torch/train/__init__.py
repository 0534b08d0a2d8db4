"""Training: optimizer and schedule, the MAE, dense-head and detection
trainers, checkpoints."""
