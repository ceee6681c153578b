"""Training of the port: optimizers and schedules (`optim`), the train
state (`state`), the train / eval steps (`steps`), the checkpoints
(`checkpoint`) and the epoch loop (`trainer.Trainer`)."""
